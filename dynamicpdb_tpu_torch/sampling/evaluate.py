"""Evaluation driver: reverse-sample each window and compute the metrics of
record.

Port of ``dynamicpdb_tpu/sampling/evaluate.py``. For each raw window:
featurize -> t = 1 reference noise (``eval_init_window``) ->
``reverse_sample`` (num_t forwards, twice that with classifier-free
guidance) -> ``eval_window_metrics`` on the last frame, plus the
teacher-forced error decomposition with ``decompose``. Returns one row of
floats per window and the means over rows.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable

import numpy as np
import torch

from dynamicpdb_tpu_torch.analysis.metrics import eval_window_metrics
from dynamicpdb_tpu_torch.data.featurize import eval_init_window, featurize_window
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.sampling.reverse import reverse_sample
from dynamicpdb_tpu_torch.train.experiment import RAW_KEYS

log = logging.getLogger(__name__)


@torch.no_grad()
def evaluate(model, diffuser, windows: Iterable[dict], *, num_t: int = 10,
             min_t: float = 0.01, noise_scale: float = 0.1,
             cfg_gamma: float | None = None, save_dir: str | None = None,
             decompose: bool = False, aux_traj: bool = False,
             generator: torch.Generator | None = None):
    """Evaluate ``model`` on raw numpy windows (each with an optional
    "name"); every tensor goes to the model's device. The sampler's draws
    come from ``generator``. ``noise_scale`` defaults to the reference's
    eval setting; ``cfg_gamma`` turns classifier-free guidance on.

    With ``save_dir``, each window leaves ``{name}_pred.npz`` (rigids,
    atom37; with ``aux_traj`` also the reverse trajectory prot_traj and
    rigid_traj), ``{name}.pdb`` (the predicted window, one model a frame),
    ``{name}_gt.pdb`` and ``{name}.html`` (predicted against ground-truth
    C-alpha overlay). Returns (rows, means)."""
    device = next(model.parameters()).device
    rows = []
    for i, raw in enumerate(windows):
        raw = dict(raw)  # the caller's dict is not changed
        name = raw.pop("name", f"window_{i}")
        # under sequence parallelism only this rank's edge rows go over
        window = {k: torch.as_tensor(v, device=device) for k, v in
                  sp.host_edge_rows({k: raw[k] for k in RAW_KEYS}).items()}
        feats = eval_init_window(featurize_window(window), diffuser,
                                 generator=generator)
        out = reverse_sample(model, diffuser, feats, num_t=num_t, min_t=min_t,
                             noise_scale=noise_scale, cfg_gamma=cfg_gamma,
                             aux_traj=aux_traj, generator=generator)
        metrics = eval_window_metrics(
            out["rigids"], out["atom37"], feats["rigids_0"],
            feats["atom37_pos"], feats["atom37_mask"],
            res_mask=feats["res_mask"])
        if decompose:
            # teacher-forced: what GT rigids + torsions reconstruct to is
            # the floor no model can beat
            from dynamicpdb_tpu_torch.analysis.decomposition import (
                atom_error_decomposition,
            )

            dec = atom_error_decomposition(
                feats, {"rigids": out["rigids"], "angles": out["angles"]})
            for part, errs in dec.items():
                for m, v in errs.items():
                    metrics[f"{part}_{m}"] = v
        row = {"name": name, **{k: float(v) for k, v in metrics.items()}}
        rows.append(row)
        log.info(
            "eval %s: ave_rot=%.3f ave_trans=%.3f atom_mae=%.3f rmsd=%.3f "
            "(RefAsPred rot=%.3f trans=%.3f)",
            name, row["ave_rot"], row["ave_trans"], row["all_atom_mae"],
            row["all_atom_rmsd"], row["ref_ave_rot"], row["ref_ave_trans"],
        )
        if save_dir is not None:
            _save(save_dir, name, raw, out, aux_traj)

    means = {k: float(np.mean([r[k] for r in rows]))
             for k in rows[0] if k != "name"}
    log.info(
        "eval means: ave_rot=%.4f ave_trans=%.4f ave_atom_mae=%.4f "
        "ave_atom_rmsd=%.4f",
        means["ave_rot"], means["ave_trans"], means["all_atom_mae"],
        means["all_atom_rmsd"],
    )
    return rows, means


def _save(save_dir: str, name: str, raw: dict, out: dict, aux_traj: bool):
    from dynamicpdb_tpu_torch.analysis.interactive import (
        comparison_figure,
        write_html,
    )
    from dynamicpdb_tpu_torch.analysis.pdb_io import write_pdb

    os.makedirs(save_dir, exist_ok=True)
    arrays = {k: out[k].cpu().numpy() for k in ("rigids", "atom37")
              + (("prot_traj", "rigid_traj") if aux_traj else ())}
    np.savez_compressed(os.path.join(save_dir, f"{name}_pred.npz"), **arrays)
    aatype = np.asarray(raw["aatype"])
    gt = np.asarray(raw["atom37"])
    write_pdb(os.path.join(save_dir, f"{name}.pdb"), arrays["atom37"], aatype)
    write_pdb(os.path.join(save_dir, f"{name}_gt.pdb"), gt, aatype,
              np.asarray(raw["atom37_mask"]))
    write_html(comparison_figure(arrays["atom37"][-1, :, 1], gt[-1, :, 1],
                                 title=f"{name}: predicted vs GT (CA)"),
               os.path.join(save_dir, f"{name}.html"))

"""Evaluation CLI.

Port of ``dynamicpdb_tpu/eval_cli.py`` for one device:

    python -m dynamicpdb_tpu_torch.eval_cli --ckpt ckpt/step_1000.ckpt \\
        [--device cuda] [--config cfg.yaml] [--save-dir D] \\
        [--metrics-json m.json] [--ema] [--ref-ckpt] \\
        [--extension N [--save-dcd] [--fast-x0] [--refresh-conditioning] \\
         [--dt-ps 1.0]] data.test_csv_path=test.csv ...

Loads the weights (a ``train_cli`` checkpoint, whose saved model config
replaces the live one, or with ``--ref-ckpt`` a reference torch
checkpoint), builds the test split of the manifest and reverse-samples one
window per protein (``sampling/evaluate.py``), printing ave_rot,
ave_trans, ave_atom_mae and ave_atom_rmsd. Classifier-free guidance runs
when the model was trained with ``model.cfg_drop_rate > 0.01``. With
``--extension N`` each protein instead gets an N-step autoregressive
rollout, saved as ``{name}_extension.npz`` and, with ``--save-dcd``, as
``{name}_extension.dcd`` beside a matching ``{name}_topology.pdb``.
``--device`` defaults to cuda and raises without a card. ``main``
returns {"rows", "means"} (or {"extension": [npz paths]}).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

log = logging.getLogger("eval")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="a train_cli checkpoint, or (with --ref-ckpt) "
                             "a reference torch checkpoint (.pth/.pkl)")
    parser.add_argument("--ref-ckpt", action="store_true",
                        help="read --ckpt as a reference torch checkpoint")
    parser.add_argument("--config", default=None)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--metrics-json", default=None,
                        help="also write {rows, means} to this JSON path")
    parser.add_argument("--fast-x0", action="store_true",
                        help="extension only: 1 forward per rollout frame "
                             "instead of num_t (the same frames)")
    parser.add_argument("--extension", type=int, default=0,
                        help="if > 0, an N-step autoregressive rollout per "
                             "protein instead of the single-window eval")
    parser.add_argument("--refresh-conditioning", action="store_true",
                        help="extension only: re-derive velocities and "
                             "slide the torsion window from the predicted "
                             "frames (sampling/reverse.py "
                             "refresh_window_conditioning)")
    parser.add_argument("--dt-ps", type=float, default=1.0,
                        help="frame spacing (ps) for the velocities and the "
                             "DCD timestep")
    parser.add_argument("--ema", action="store_true",
                        help="evaluate the EMA weights of the checkpoint's "
                             "optimizer state (trained with "
                             "experiment.ema_decay)")
    parser.add_argument("--save-dcd", action="store_true",
                        help="extension only: also write "
                             "{name}_extension.dcd and {name}_topology.pdb")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="a.b=c config overrides")
    return parser.parse_args(argv)


def _model_overrides(saved_model: dict, prefix: str = "model.") -> list[str]:
    out = []
    for k, v in saved_model.items():
        if isinstance(v, dict):
            out.extend(_model_overrides(v, f"{prefix}{k}."))
        elif v is not None:
            out.append(f"{prefix}{k}={v}")
    return out


def config_from_args(args):
    from dynamicpdb_tpu_torch.config import Config, apply_overrides, load_yaml

    return (load_yaml(args.config, args.overrides) if args.config
            else apply_overrides(Config(), args.overrides))


def load_model(args, cfg, device):
    """(cfg, Trainer holding the weights to evaluate). A train_cli
    checkpoint's saved model config replaces the live one."""
    from dynamicpdb_tpu_torch.config import apply_overrides
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
    from dynamicpdb_tpu_torch.train.experiment import Trainer
    from dynamicpdb_tpu_torch.train.optim import ema_state_dict

    if args.ref_ckpt:
        if args.ema:
            raise SystemExit("--ema: a reference checkpoint holds no EMA "
                             "weights")
        from dynamicpdb_tpu_torch.train.import_torch import (
            import_reference_checkpoint,
        )

        trainer = Trainer(cfg, device=device)
        extras = import_reference_checkpoint(args.ckpt, trainer.model)
        log.info("imported reference checkpoint %s (step %s)", args.ckpt,
                 extras.get("step"))
        return cfg, trainer

    saved = ckpt_lib.load(args.ckpt).get("config")
    if saved:
        cfg = apply_overrides(cfg, _model_overrides(saved.get("model", {})))
    trainer = Trainer(cfg, device=device)
    state = ckpt_lib.restore(args.ckpt, trainer.model,
                             trainer.optimizer if args.ema else None)
    if args.ema:
        if state.get("optimizer") is None:
            raise SystemExit("--ema: the checkpoint has no optimizer state "
                             "to read the EMA weights from")
        trainer.model.load_state_dict(
            ema_state_dict(trainer.optimizer, trainer.model))
        log.info("evaluating with EMA weights")
    log.info("loaded %s (step %d)", args.ckpt, state["step"])
    return cfg, trainer


def run_extension(args, cfg, trainer, dataset, generator) -> list[str]:
    """An ``args.extension``-step rollout of every protein's window."""
    import numpy as np
    import torch

    from dynamicpdb_tpu_torch.data.dataset import eval_windows
    from dynamicpdb_tpu_torch.data.featurize import featurize_window
    from dynamicpdb_tpu_torch.sampling.reverse import rollout
    from dynamicpdb_tpu_torch.train.experiment import RAW_KEYS

    out_dir = args.save_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for raw in eval_windows(dataset):
        name = raw.pop("name")
        window = {k: torch.as_tensor(raw[k], device=trainer.device)
                  for k in RAW_KEYS}
        atom_traj, rigid_traj = rollout(
            trainer.model, trainer.diffuser, featurize_window(window),
            n_steps=args.extension, num_t=cfg.data.num_t,
            noise_scale=cfg.experiment.noise_scale, fast_x0=args.fast_x0,
            refresh_conditioning=args.refresh_conditioning,
            dt_ps=args.dt_ps, generator=generator)
        at = atom_traj.cpu().numpy()
        out = os.path.join(out_dir, f"{name}_extension.npz")
        np.savez_compressed(out, atom_traj=at,
                            rigid_traj=rigid_traj.cpu().numpy(),
                            aatype=raw["aatype"])
        written.append(out)
        log.info("extension saved: %s", out)
        if args.save_dcd:
            from dynamicpdb_tpu_torch.analysis.pdb_io import write_pdb
            from dynamicpdb_tpu_torch.chem import constants as chem
            from dynamicpdb_tpu_torch.preprocess.dcd import write_dcd

            aatype = np.asarray(raw["aatype"])
            mask = np.asarray(chem.restype_atom37_mask)[aatype]
            base = os.path.join(out_dir, name)
            # write_pdb's residue-major atom37 order, so the DCD columns
            # match the topology file
            write_pdb(f"{base}_topology.pdb", at[0], aatype, mask)
            write_dcd(f"{base}_extension.dcd", at[:, mask > 0.5],
                      timestep_ps=args.dt_ps)
            log.info("dcd saved: %s_extension.dcd", base)
    return written


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from dynamicpdb_tpu_torch.data.dataset import TrajectoryDataset, eval_windows
    from dynamicpdb_tpu_torch.sampling.evaluate import evaluate
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg, trainer = load_model(args, config_from_args(args), device)
    dataset = TrajectoryDataset(cfg.data, split="test",
                                pad_to=cfg.data.filtering.max_len)
    generator = torch.Generator(device=device).manual_seed(
        cfg.experiment.seed)
    if args.extension:
        return {"extension": run_extension(args, cfg, trainer, dataset,
                                           generator)}

    cfg_gamma = cfg.model.cfg_gamma if cfg.model.cfg_drop_rate > 0.01 else None
    rows, means = evaluate(
        trainer.model, trainer.diffuser, eval_windows(dataset),
        num_t=cfg.data.num_t, min_t=cfg.data.min_t,
        noise_scale=cfg.experiment.noise_scale, cfg_gamma=cfg_gamma,
        save_dir=args.save_dir, generator=generator)
    print("ave_rot:", means["ave_rot"])
    print("ave_trans:", means["ave_trans"])
    print("ave_atom_mae:", means["all_atom_mae"])
    print("ave_atom_rmsd:", means["all_atom_rmsd"])
    result = {"rows": rows, "means": means}
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

"""Sequence parallelism on each rank of a launcher: the collectives, the
DFOLD model's forward and backward, its rollout, and OmegaFold, under
``sp.activated(mesh)``, with what each rank got.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m dynamicpdb_tpu_torch.tools.sp_run --device cpu \\
        --payload P.pt --out DIR [--config cfg.yaml] [a.b=c ...]

The mesh is every rank on 'seq' (``experiment.mesh_shape`` and
``mesh_axes`` override it); without a launcher it runs in one process, the
reference of a split run. With ``--backend gloo --device cuda:0`` several
ranks share one card. ``--payload`` is a ``torch.save`` file of a dict
whose entries say what to run:

  * ``collectives``: {"x": [S, ...] each rank's rows (axis 1 the
    residues), "n_res", and the cotangents "g_rows", "g_replicated",
    "g_sum", "g_halo", each [S, ...] by rank; optionally "square" [N, N,
    ...] and "g_square" of the same shape}: every collective's output and
    the gradient of its input; with "square", the column view of this
    rank's rows of it and its input's gradient for this rank's rows of
    "g_square" (both [rows, N, ...]);
  * ``forward``: {"feats": a featurized window, "cotangents": {output
    key: tensor}}: the model's outputs, and the gradients of the sum of
    each output times its cotangent, summed over the 'seq' ranks;
  * ``rollout``: {"init_feats", "n_steps", "num_t", "noise_scale",
    "seed"}, or a list of such: ``sampling.reverse.rollout``'s frames, with
    the full sampler and with ``fast_x0``, from a generator seeded with
    ``seed`` (a list of results for a list);
  * ``rollout_float32``: the same with the model computing in float32
    (the same weights), beside a bfloat16 config's ``rollout``;
  * ``omegafold``: {"weights": a reference-layout OmegaFold state dict or
    the path of a ``torch.save`` of one, "sequences": a list of cycle
    input lists (the pipeline's {p_msa, p_msa_mask} dicts), and optionally
    "return_structure", "pad_safe" (default True), "time_sp" (time the
    collectives; default False)}: ``omegafold_embed`` on each sequence;
    per sequence the Embedding's fields (edge, node, pos14, plddt,
    confidence, cycle, confidences), every cycle's node, confidence and
    this rank's rows of its edge, its seconds, its GeoFormer kernel
    launches, its collectives' calls and seconds and its peak device
    memory;
  * ``omegafold_modules``: {"weights" as above, "cases": a list of
    {"plm": (tokens, mask)} or {"block": (node, edge, mask, pad_safe)}},
    the whole window's inputs: the PLM or the first GeoFormer block on
    this rank's rows, its outputs gathered whole.

The DFOLD model takes ``state_dict`` from the payload when it has one,
else random weights from ``--seed`` (``weights.randomize_``); it is built
only for the parts that run it. Each rank writes ``DIR/rank<r>.pt``: the
results, its seconds, its kernel launches and SP collective calls per
part, and its peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from dynamicpdb_tpu_torch.config import Config, apply_overrides, load_yaml
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.omegafold import geoformer
from dynamicpdb_tpu_torch.models.omegafold.model import (
    omegafold_embed,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.sampling.reverse import rollout
from dynamicpdb_tpu_torch.utils.platform import resolve_device
from dynamicpdb_tpu_torch.weights import randomize_

IPA_COUNTERS = tuple(ipa_mod.COUNTERS.values())


GEOM_COUNTERS = ("geom_launches", "node_launches", "geom_launches_128",
                 "node_launches_128")
TRI_COUNTERS = ("triangle_launches", "tri_proj_launches", "tri_mm_launches",
                "tri_out_launches")
DFOLD_PARTS = ("forward", "rollout", "rollout_float32")


def counts() -> dict:
    return {**{n: getattr(ipa_mod, n) for n in IPA_COUNTERS},
            **{n: getattr(geom_mod, n) for n in GEOM_COUNTERS},
            **{n: getattr(tri_mod, n) for n in TRI_COUNTERS}}


def reset_counts():
    for n in IPA_COUNTERS:
        setattr(ipa_mod, n, 0)
    for n in GEOM_COUNTERS:
        setattr(geom_mod, n, 0)
    for n in TRI_COUNTERS:
        setattr(tri_mod, n, 0)
    sp.reset_counts()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def run_collectives(spec: dict, device) -> dict:
    """Each collective on this rank's input and cotangent."""
    r = sp.index()
    out = {}
    if "x" in spec:
        n_res = spec["n_res"]
        for name, fn, g_key in (
                ("rows", lambda x: sp.gather_rows(x, n_res), "g_rows"),
                ("replicated", lambda x: sp.gather_replicated(x, n_res),
                 "g_replicated"),
                ("sum", sp.all_reduce_sum, "g_sum"),
                ("halo", lambda x: sp.halo_exchange(x, 2), "g_halo")):
            x = spec["x"][r].to(device).requires_grad_()
            y = fn(x)
            y.backward(spec[g_key][r].to(device))
            out[name] = (y.detach().cpu(), x.grad.cpu())
    if "square" in spec:
        n = spec["square"].shape[0]
        x = sp.take_rows(spec["square"].to(device), n, 0).requires_grad_()
        y = sp.column_view(x, n)
        y.backward(sp.take_rows(spec["g_square"].to(device), n, 0))
        out["column_view"] = (y.detach().cpu(), x.grad.cpu())
    return out


def run_forward(model, spec: dict, device) -> dict:
    feats = _to(sp.host_edge_rows(spec["feats"]), device)
    model.zero_grad(set_to_none=True)
    out = model(feats)
    loss = sum(torch.sum(out[k] * v.to(device))
               for k, v in spec["cotangents"].items())
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        grads[name] = sp.all_reduce_sum(g).cpu()  # the ranks' shares
    return {"outputs": {k: v.detach().cpu() for k, v in out.items()},
            "grads": grads}


def run_rollout(model, diffuser, spec, device):
    if isinstance(spec, list):
        return [run_rollout(model, diffuser, s, device) for s in spec]
    feats = _to(sp.host_edge_rows(spec["init_feats"]), device)
    res = {}
    with torch.no_grad():
        for mode, fast in (("full", False), ("fast_x0", True)):
            gen = torch.Generator(device=device).manual_seed(spec["seed"])
            atoms, rigids = rollout(
                model, diffuser, feats, n_steps=spec["n_steps"],
                num_t=spec["num_t"], noise_scale=spec["noise_scale"],
                fast_x0=fast, generator=gen)
            res[mode] = (atoms.cpu(), rigids.cpu())
    return res


def _omegafold(spec: dict, device):
    sd = spec["weights"]
    if isinstance(sd, str):
        sd = torch.load(sd, weights_only=True)
    return omegafold_from_state_dict(sd, device=device)


def run_omegafold(spec: dict, device, on_card: bool) -> list[dict]:
    """``omegafold_embed`` on each sequence of ``spec``; see the module
    docstring."""
    model = _omegafold(spec, device)
    sp.timed(bool(spec.get("time_sp", False)))
    results = []
    try:
        for cycle_inputs in spec["sequences"]:
            cycles = []

            def on_cycle(i, node, edge, conf):
                cycles.append({"node": node.float().cpu(),
                               "edge_rows": edge.float().cpu(),
                               "confidence": float(conf)})

            reset_counts()
            if on_card:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            emb = omegafold_embed(
                model, cycle_inputs, pad_safe=spec.get("pad_safe", True),
                return_structure=spec.get("return_structure", False),
                on_cycle=on_cycle)
            # the Embedding's scalars are on the host: the cycles are done
            seconds = time.perf_counter() - t0
            out = {k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in dataclasses.asdict(emb).items()}
            results.append(dict(
                out, cycles=cycles, seconds=seconds, launches=counts(),
                sp_calls=sp.calls, sp_seconds=sp.seconds,
                rows=sp.row_range(cycle_inputs[0]["p_msa"].shape[-1]),
                peak_bytes=(torch.cuda.max_memory_allocated(device)
                            if on_card else 0)))
    finally:
        sp.timed(False)
    return results


@torch.inference_mode()
def run_omegafold_modules(spec: dict, device) -> list:
    """The PLM or the first GeoFormer block of ``spec``'s cases on this
    rank's rows, the outputs gathered whole."""
    model = _omegafold(spec, device)
    out = []
    for case in spec["cases"]:
        if "plm" in case:
            tokens, mask = (t.to(device) for t in case["plm"])
            L = tokens.shape[-1]
            node, edges = model.omega_plm(tokens, mask)
            out.append((sp.gather_replicated(node, L, dim=1).cpu(),
                        sp.gather_replicated(edges, L, dim=1).cpu()))
            continue
        node, edge, mask, pad_safe = case["block"]
        L = mask.shape[-1]
        node, edge = geoformer.geoformer_block(
            model.omega_fold_cycle.geoformer.blocks[0],
            sp.take_rows(node.to(device), L, 1),
            sp.take_rows(edge.to(device), L, 0), mask.to(device),
            pad_safe=pad_safe)
        out.append((sp.gather_replicated(node, L, dim=1).cpu(),
                    sp.gather_replicated(edge, L, dim=0).cpu()))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--payload", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    cfg = (load_yaml(args.config, args.overrides) if args.config
           else apply_overrides(Config(), args.overrides))
    backend = args.backend or mesh_lib.default_backend(args.device)
    device = resolve_device(args.device, backend=backend)
    mesh_lib.maybe_initialize_distributed(backend, device)
    try:
        rank, world = mesh_lib.world()
        ec = cfg.experiment
        mesh = (mesh_lib.make_mesh(tuple(ec.mesh_shape), tuple(ec.mesh_axes))
                if ec.mesh_shape else
                mesh_lib.make_mesh((world,), ("seq",)) if world > 1 else None)
        payload = torch.load(args.payload, weights_only=False)
        model = diffuser = None
        if any(part in payload for part in DFOLD_PARTS):
            model = DFoldScoreNetwork(cfg.model, device=device)
            if payload.get("state_dict") is not None:
                model.load_state_dict(payload["state_dict"])
            else:
                randomize_(model, args.seed)
            diffuser = SE3Diffuser(cfg.diffuser, device=device)

        def float32_model():
            m = DFoldScoreNetwork(dataclasses.replace(
                cfg.model, compute_dtype="float32"), device=device)
            m.load_state_dict(model.state_dict())
            return m

        result = {"rank": rank, "mesh": None if mesh is None
                  else dict(mesh.sizes), "seconds": {}, "launches": {},
                  "sp_calls": {}}
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        with sp.activated(mesh):
            for part, run in (
                    ("collectives", lambda s: run_collectives(s, device)),
                    ("forward", lambda s: run_forward(model, s, device)),
                    ("rollout", lambda s: run_rollout(model, diffuser, s,
                                                      device)),
                    ("rollout_float32", lambda s: run_rollout(
                        float32_model(), diffuser, s, device)),
                    ("omegafold", lambda s: run_omegafold(s, device,
                                                          on_card)),
                    ("omegafold_modules", lambda s: run_omegafold_modules(
                        s, device))):
                if part not in payload:
                    continue
                reset_counts()
                t0 = time.perf_counter()
                result[part] = run(payload[part])
                if on_card:
                    torch.cuda.synchronize(device)
                result["seconds"][part] = time.perf_counter() - t0
                result["launches"][part] = counts()
                result["sp_calls"][part] = sp.calls
        result["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
        os.makedirs(args.out, exist_ok=True)
        torch.save(result, os.path.join(args.out, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

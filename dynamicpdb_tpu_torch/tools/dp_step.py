"""Data-parallel train steps of ``Trainer``, one process a rank, with what
each rank saw.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m dynamicpdb_tpu_torch.tools.dp_step --config configs/tiny.yaml \\
        --device cpu --steps 3 --csv train.csv --pad-to 16 --out DIR \\
        experiment.batch_size=2 [experiment.mesh_shape=(1,2) \\
        experiment.mesh_axes=(data,model) ...]

Without a launcher it runs the same steps in one process, the reference a
data-parallel run must equal. The batches are the global ones: ``--csv``
reads them through the dataset and the sampler (each rank its rows, as in
``train_cli``); ``--payload`` is a ``torch.save`` file holding
``batches`` ({key: [K, global B, ...]}) and optionally ``state_dict`` (the
starting parameters) and ``noises`` (K lists of global B per-window noise
dicts, as ``Trainer.draw_window_noise`` returns them), of which each rank
takes rows r, r + D, ... like the sampler's striding. With
``--backend gloo`` and ``--device cuda:0`` several ranks share one card.

Each rank writes ``DIR/rank<r>.pt``: the whole parameters and AMSGrad
state (gathered, as a checkpoint holds them), each step's aux, its seconds
and all-reduce seconds, the peak device memory and the memory the
parameters and optimizer state hold between steps, and its IPA kernel
launches.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from dynamicpdb_tpu_torch.config import Config, apply_overrides, load_yaml
from dynamicpdb_tpu_torch.data.dataset import (
    TrajectoryDataset,
    batch_iterator,
    make_sampler,
)
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
from dynamicpdb_tpu_torch.train.experiment import Trainer
from dynamicpdb_tpu_torch.train_cli import make_run_mesh
from dynamicpdb_tpu_torch.utils.platform import resolve_device

IPA_COUNTERS = ("launches", "bwd_dq_launches", "bwd_dkv_launches",
                "bwd_pair_launches", "wide_launches", "wide_bwd_dq_launches",
                "wide_bwd_dkv_launches", "wide_bwd_pair_launches")


def rank_batches(args, cfg, mesh, trainer):
    """K (this rank's batch, its noises or None) pairs."""
    D, r = mesh_lib.data_size(mesh), mesh_lib.data_index(mesh)
    if args.payload:
        payload = torch.load(args.payload, weights_only=True)
        if payload.get("state_dict") is not None:
            with trainer.whole_params():
                trainer.model.load_state_dict(payload["state_dict"])
        noises = payload.get("noises")
        out = []
        for k in range(args.steps):
            batch = {key: v[k][r::D] for key, v in payload["batches"].items()}
            out.append((batch, None if noises is None else noises[k][r::D]))
        return out
    dataset = TrajectoryDataset(cfg.data, split="train",
                                pad_to=args.pad_to or cfg.data.filtering.max_len)
    sampler = make_sampler(dataset, cfg.data,
                           batch_size=cfg.experiment.batch_size * D,
                           seed=cfg.experiment.seed, num_hosts=D, host_index=r)
    out, epoch = [], 0
    while len(out) < args.steps:
        out += [(b, None) for b in batch_iterator(dataset, sampler, epoch)]
        epoch += 1
    return out[: args.steps]


def state_bytes(trainer) -> int:
    """Bytes the parameters and the optimizer state hold between steps."""
    n = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    if trainer.layout is not None:
        n += sum(t.numel() * t.element_size()
                 for t in trainer.layout.shards.values())
    for st in trainer.optimizer.state.values():
        n += sum(t.numel() * t.element_size() for t in st.values()
                 if isinstance(t, torch.Tensor))
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None,
                        help="YAML config (default: the config defaults)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--steps", type=int, required=True)
    parser.add_argument("--csv", default=None)
    parser.add_argument("--pad-to", type=int, default=None,
                        help="default: data.filtering.max_len, as train_cli")
    parser.add_argument("--payload", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)
    if (args.csv is None) == (args.payload is None):
        parser.error("give one of --csv and --payload")
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    overrides = args.overrides + ([f"data.csv_path={args.csv}"]
                                  if args.csv else [])
    cfg = (load_yaml(args.config, overrides) if args.config
           else apply_overrides(Config(), overrides))
    backend = args.backend or mesh_lib.default_backend(args.device)
    device = resolve_device(args.device, backend=backend)
    mesh_lib.maybe_initialize_distributed(backend, device)
    try:
        mesh = make_run_mesh(cfg)
        trainer = Trainer(cfg, device=device, mesh=mesh)
        steps = rank_batches(args, cfg, mesh, trainer)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        for name in IPA_COUNTERS:
            setattr(ipa_mod, name, 0)
        auxs, seconds, comm = [], [], []
        for batch, noises in steps:
            t0 = time.perf_counter()
            auxs.append(trainer.train_step(batch, noises))  # floats: synced
            seconds.append(time.perf_counter() - t0)
            comm.append(trainer.comm_seconds)
        launches = {n: getattr(ipa_mod, n) for n in IPA_COUNTERS}
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        resident = state_bytes(trainer)
        with trainer.whole_params():
            params = {k: v.detach().cpu()
                      for k, v in trainer.model.state_dict().items()}
            opt = trainer.optimizer.state_dict()
        opt["state"] = {i: {k: v.cpu() for k, v in st.items()}
                        for i, st in opt["state"].items()}
        rank = mesh_lib.world()[0]
        os.makedirs(args.out, exist_ok=True)
        torch.save(dict(
            rank=rank, mesh=None if mesh is None else dict(mesh.sizes),
            params=params, optimizer=opt, aux=auxs, seconds=seconds,
            comm_seconds=comm, peak_bytes=peak, state_bytes=resident,
            launches=launches, device=str(device),
            rng=trainer.generator.get_state()),
            os.path.join(args.out, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

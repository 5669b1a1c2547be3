"""Training CLI.

Port of ``dynamicpdb_tpu/train_cli.py``, on one device or data-parallel
under a launcher, one process a device:

    python -m dynamicpdb_tpu_torch.train_cli [--config cfg.yaml] \\
        [--pad-to 256] [--max-steps N] [--resume] [--device cuda] \\
        [--backend nccl|gloo] data.csv_path=train.csv \\
        experiment.ckpt_dir=ckpt ...
    torchrun --nproc_per_node 8 -m dynamicpdb_tpu_torch.train_cli ...

Reads the manifest (``data/dataset.py``), trains with ``Experiment`` and
writes ``<experiment.ckpt_dir>/step_<n>.ckpt`` at the end; metrics go to
``<experiment.eval_dir>/logs/metrics.jsonl``. ``--resume`` continues from
the newest ``step_*.ckpt`` in ``experiment.ckpt_dir`` (model, optimizer,
step, epoch and noise generator); ``experiment.warm_start`` loads a given
checkpoint. Under a launcher (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
set) it joins ``torch.distributed`` (NCCL on cards, one rank a card; gloo
on the CPU or with ``--backend gloo``), ``--device cuda`` means
``cuda:{LOCAL_RANK}``, and the mesh is ``experiment.mesh_shape`` over
``experiment.mesh_axes`` ('slice', 'data', 'model', 'seq'), else
('slice', 'data') across several nodes, else 'data' over every rank.
``experiment.batch_size`` is the batch of one rank of the data-like axes:
the global batch is that times the product of the data-like axes
('slice', 'data'; not 'model' or 'seq', whose ranks share their rows),
and each rank trains on its rows of it; ``experiment.zero_opt_state``
shards the AMSGrad moments over 'data' (ZeRO-1). A 'seq' axis splits
each window's residues over its ranks (sequence parallelism,
``parallel/sp.py``), e.g.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dynamicpdb_tpu_torch.train_cli --device cpu --backend gloo \
        ... experiment.mesh_shape=(1,2) experiment.mesh_axes=(data,seq)

A mesh that does not cover the world raises. Rank 0 writes the metrics
and checkpoints (any mesh's checkpoint resumes on any other) and runs
``--eval-every`` (with the other ranks of its 'seq' group); the other
ranks wait for it.
``--eval-every N`` evaluates the model on the ``val`` split
(``sampling/evaluate.py``) after every N-th completed epoch, logs
``eval/ave_rot``, ``eval/ave_trans``, ``eval/all_atom_mae`` and
``eval/all_atom_rmsd`` and writes ``<experiment.ckpt_dir>/best.ckpt``
whenever one of them improves. ``main`` returns the ``Experiment``.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import re


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--pad-to", type=int, default=None,
                        help="pad the residue axis to this size "
                             "(default: data.filtering.max_len)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--eval-every", type=int, default=0,
                        help="epochs between eval passes on the val split "
                             "(0: none)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint in "
                             "experiment.ckpt_dir")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend under a launcher "
                             "(default: nccl on cuda, gloo on the cpu)")
    parser.add_argument("overrides", nargs="*", help="a.b=c config overrides")
    return parser.parse_args(argv)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    ckpts = glob.glob(os.path.join(ckpt_dir, "step_*.ckpt"))
    if not ckpts:
        return None
    return max(ckpts, key=lambda p: int(re.search(r"step_(\d+)", p).group(1)))


EVAL_METRICS = ("ave_rot", "ave_trans", "all_atom_mae", "all_atom_rmsd")


def make_eval_fn(cfg, val_dataset, device):
    """(model, diffuser) -> the means of ``EVAL_METRICS`` over one window
    per protein of ``val_dataset``, with the sampler's noise drawn from
    seed + 1 afresh at every call (the same draws every eval)."""
    import torch

    from dynamicpdb_tpu_torch.data.dataset import eval_windows
    from dynamicpdb_tpu_torch.sampling.evaluate import evaluate

    def eval_fn(model, diffuser):
        generator = torch.Generator(device=device).manual_seed(
            cfg.experiment.seed + 1)
        _, means = evaluate(
            model, diffuser, eval_windows(val_dataset),
            num_t=cfg.data.num_t, min_t=cfg.data.min_t,
            noise_scale=cfg.experiment.noise_scale, generator=generator)
        return {k: means[k] for k in EVAL_METRICS}

    return eval_fn


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    log = logging.getLogger("train")

    import torch.distributed as dist

    from dynamicpdb_tpu_torch.config import Config, apply_overrides, load_yaml
    from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    cfg = (
        load_yaml(args.config, args.overrides)
        if args.config
        else apply_overrides(Config(), args.overrides)
    )
    backend = args.backend or mesh_lib.default_backend(args.device)
    device = resolve_device(args.device, backend=backend)
    owns_group = not dist.is_initialized()
    mesh_lib.maybe_initialize_distributed(backend, device)
    try:
        exp = _train(args, cfg, device, log)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return exp


def make_run_mesh(cfg):
    """The mesh of this run (None for one process without one):
    ``experiment.mesh_shape`` over ``mesh_axes`` when given, else across a
    launcher's ranks ('slice', 'data') over several nodes or 'data'."""
    from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib

    ec = cfg.experiment
    if ec.mesh_shape:
        return mesh_lib.make_mesh(tuple(ec.mesh_shape), tuple(ec.mesh_axes))
    if mesh_lib.world()[1] > 1:
        return (mesh_lib.make_hybrid_mesh()
                if mesh_lib.detect_num_slices() > 1 else mesh_lib.make_mesh())
    return None


def _train(args, cfg, device, log):
    from dynamicpdb_tpu_torch.data.dataset import (
        TrajectoryDataset,
        batch_iterator,
        make_sampler,
    )
    from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
    from dynamicpdb_tpu_torch.train.experiment import Experiment
    from dynamicpdb_tpu_torch.utils.logging import MetricsWriter

    mesh = make_run_mesh(cfg)
    n_data, data_index = mesh_lib.data_size(mesh), mesh_lib.data_index(mesh)
    main_rank = mesh_lib.is_main_process()
    pad_to = args.pad_to or cfg.data.filtering.max_len
    dataset = TrajectoryDataset(cfg.data, split="train", pad_to=pad_to)
    global_batch = cfg.experiment.batch_size * n_data
    sampler = make_sampler(dataset, cfg.data, batch_size=global_batch,
                           seed=cfg.experiment.seed, num_hosts=n_data,
                           host_index=data_index)
    log.info("device=%s mesh=%s global_batch=%d (%d a rank) pad_to=%d",
             device, mesh, global_batch, cfg.experiment.batch_size, pad_to)

    eval_fn = None  # rank 0's 'seq' group calls it; all join run_eval
    if args.eval_every:
        eval_fn = make_eval_fn(
            cfg, TrajectoryDataset(cfg.data, split="val", pad_to=pad_to),
            device)

    writer = (MetricsWriter(os.path.join(cfg.experiment.eval_dir, "logs"))
              if main_rank else None)
    exp = Experiment(cfg, lambda epoch: batch_iterator(dataset, sampler, epoch),
                     device=device, mesh=mesh, metrics_writer=writer,
                     eval_fn=eval_fn, eval_every=args.eval_every)
    if cfg.experiment.warm_start:
        exp.load_checkpoint(cfg.experiment.warm_start)
        log.info("warm start from %s at step %d", cfg.experiment.warm_start,
                 exp.step)
    elif args.resume:
        latest = latest_checkpoint(cfg.experiment.ckpt_dir)
        if latest:
            exp.load_checkpoint(latest)
            log.info("resumed from %s (step %d, epoch %d)", latest, exp.step,
                     exp.epoch)
    try:
        exp.train(max_steps=args.max_steps)
        exp.save_checkpoint()
    finally:
        if writer is not None:
            writer.close()
    return exp


if __name__ == "__main__":
    main()

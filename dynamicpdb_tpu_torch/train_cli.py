"""Training CLI.

Port of ``dynamicpdb_tpu/train_cli.py`` for one device:

    python -m dynamicpdb_tpu_torch.train_cli [--config cfg.yaml] \\
        [--pad-to 256] [--max-steps N] [--resume] [--device cuda] \\
        data.csv_path=train.csv experiment.ckpt_dir=ckpt ...

Reads the manifest (``data/dataset.py``), trains with ``Experiment`` and
writes ``<experiment.ckpt_dir>/step_<n>.ckpt`` at the end; metrics go to
``<experiment.eval_dir>/logs/metrics.jsonl``. ``--resume`` continues from
the newest ``step_*.ckpt`` in ``experiment.ckpt_dir`` (model, optimizer,
step, epoch and noise generator); ``experiment.warm_start`` loads a given
checkpoint. ``experiment.batch_size`` is the batch of the one device.
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

    from dynamicpdb_tpu_torch.config import Config, apply_overrides, load_yaml
    from dynamicpdb_tpu_torch.data.dataset import (
        TrajectoryDataset,
        batch_iterator,
        make_sampler,
    )
    from dynamicpdb_tpu_torch.train.experiment import Experiment
    from dynamicpdb_tpu_torch.utils.logging import MetricsWriter
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    cfg = (
        load_yaml(args.config, args.overrides)
        if args.config
        else apply_overrides(Config(), args.overrides)
    )
    device = resolve_device(args.device)
    pad_to = args.pad_to or cfg.data.filtering.max_len
    dataset = TrajectoryDataset(cfg.data, split="train", pad_to=pad_to)
    sampler = make_sampler(dataset, cfg.data,
                           batch_size=cfg.experiment.batch_size,
                           seed=cfg.experiment.seed)
    log.info("device=%s batch=%d pad_to=%d", device,
             cfg.experiment.batch_size, pad_to)

    eval_fn = None
    if args.eval_every:
        eval_fn = make_eval_fn(
            cfg, TrajectoryDataset(cfg.data, split="val", pad_to=pad_to),
            device)

    writer = MetricsWriter(os.path.join(cfg.experiment.eval_dir, "logs"))
    exp = Experiment(cfg, lambda epoch: batch_iterator(dataset, sampler, epoch),
                     device=device, metrics_writer=writer, eval_fn=eval_fn,
                     eval_every=args.eval_every)
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
        writer.close()
    return exp


if __name__ == "__main__":
    main()

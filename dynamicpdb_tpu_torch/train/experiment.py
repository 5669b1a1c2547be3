"""Training runtime: the train step, the epoch loop, checkpoints.

Port of ``dynamicpdb_tpu/train/experiment.py`` (``Trainer``, ``Experiment``)
for one device. One step = featurization + forward diffusion + model
forward + ``dfold_loss`` on every window of the batch, the backward, and
one AMSGrad update.

JAX ``vmap``s the window loss over the batch; here the windows run one
after another, each with its own backward (``loss / B``), so the gradient
is the batch mean while only one window's activations are alive. Every
GlobalStatNorm statistic stays per window, as under ``vmap``. Running one
window at a time already gives what ``grad_accum`` asks of the JAX step
(micro-batches, one update, the same mean gradient), so here it is only
checked: k must divide the batch.

Every random draw of a step comes from ``draw_window_noise`` (a
``torch.Generator`` seeded from ``experiment.seed``) unless the caller
passes the noise, so a test can hand the port the numbers JAX drew. The
mesh, ZeRO sharding and ``multi_train_step`` of the JAX package are not
ported (one device).
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from dynamicpdb_tpu_torch.config import Config, to_dict
from dynamicpdb_tpu_torch.data.featurize import (
    diffuse_training_window,
    featurize_window,
    perturb_conditioning_rigids,
)
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import (
    DFoldScoreNetwork,
    score_forward,
)
from dynamicpdb_tpu_torch.train import checkpoint as ckpt
from dynamicpdb_tpu_torch.train.losses import dfold_loss
from dynamicpdb_tpu_torch.train.optim import global_norm, make_optimizer
from dynamicpdb_tpu_torch.utils.logging import StepTimer
from dynamicpdb_tpu_torch.utils.platform import resolve_device
from dynamicpdb_tpu_torch.weights import init_like_jax_

log = logging.getLogger(__name__)

RAW_KEYS = ("atom37", "atom37_mask", "aatype", "residue_index", "force",
            "vel", "node_repr", "edge_repr")


class Trainer:
    """Owns the model, diffuser, optimizer and noise generator."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = DFoldScoreNetwork(cfg.model, device=self.device)
        init_like_jax_(self.model, cfg.experiment.seed)
        self.diffuser = SE3Diffuser(cfg.diffuser, device=self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        cfg.experiment)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.experiment.seed)

    # -- noise ----------------------------------------------------------------
    def draw_window_noise(self, n_frames: int, n_res: int):
        """Every draw one window's loss takes: a dict for one denoising step,
        or a list of ``unroll_steps`` dicts. Keys: t, rot_axis, rot_u,
        trans_z (forward diffusion); drop (cfg_drop_rate > 0); sc
        (self-conditioning); cond = {u, rot, trans} (conditioning noise)."""
        ec, mc = self.cfg.experiment, self.cfg.model
        unroll = ec.unroll_steps
        F = n_frames - (unroll - 1) if unroll > 1 else n_frames
        g, dev = self.generator, self.device

        def one():
            min_t = self.cfg.data.min_t
            noise = {
                "t": min_t + (1.0 - min_t) * torch.rand((), generator=g,
                                                        device=dev),
                "rot_axis": torch.randn((F, n_res, 3), generator=g, device=dev),
                "rot_u": torch.rand((F, n_res), generator=g, device=dev),
                "trans_z": torch.randn((F, n_res, 3), generator=g, device=dev),
            }
            if mc.cfg_drop_rate > 0:
                noise["drop"] = (torch.rand((), generator=g, device=dev)
                                 < mc.cfg_drop_rate).float()
            if mc.embed.embed_self_conditioning:
                noise["sc"] = torch.rand((), generator=g, device=dev)
            if ec.cond_noise_trans > 0 or ec.cond_noise_rot_deg > 0:
                noise["cond"] = {
                    "u": torch.rand((), generator=g, device=dev),
                    "rot": torch.randn((F, n_res, 3), generator=g, device=dev),
                    "trans": torch.randn((F, n_res, 3), generator=g,
                                         device=dev),
                }
            return noise

        return [one() for _ in range(unroll)] if unroll > 1 else one()

    # -- the loss -------------------------------------------------------------
    def _one_step_loss(self, raw_window: dict, noise: dict,
                       rigid_overrides=()):
        """One denoising step's loss on one raw window (tensors on the
        device). Returns (loss, aux, pred_rigids_last [N, 7]).
        ``rigid_overrides``: ((position, [N, 7] tensor-7), ...) substituted
        into rigids_0 after featurization (the unrolled loss feeds earlier
        predictions back through here)."""
        ec, mc = self.cfg.experiment, self.cfg.model
        feats = featurize_window(raw_window)
        if rigid_overrides:
            rows = list(feats["rigids_0"].unbind(0))
            for pos, rig in rigid_overrides:
                rows[pos] = rig
            feats["rigids_0"] = torch.stack(rows)
        if ec.cond_noise_trans > 0 or ec.cond_noise_rot_deg > 0:
            feats["rigids_0"] = perturb_conditioning_rigids(
                feats["rigids_0"], ec.cond_noise_trans,
                ec.cond_noise_rot_deg * math.pi / 180.0, noise=noise["cond"])
        feats = diffuse_training_window(feats, self.diffuser,
                                        self.cfg.data.min_t, noise=noise)
        drop_ref = noise["drop"] if mc.cfg_drop_rate > 0 else False
        if mc.embed.embed_self_conditioning:
            # the reference's 50% self-conditioning forward; the DFOLDv2
            # embedder never reads sc_ca_t, so only the cost is kept
            feats["sc_ca_t"] = torch.zeros_like(feats["rigids_0"][..., 4:])
            if bool(noise["sc"] > 0.5):
                with torch.no_grad():
                    sc = score_forward(self.model, self.diffuser, feats,
                                       drop_ref=drop_ref)
                feats["sc_ca_t"] = sc["rigids"][..., 4:]
        out = score_forward(self.model, self.diffuser, feats,
                            drop_ref=drop_ref)
        loss, aux = dfold_loss(out, feats, ec)
        return loss, aux, out["rigids"][-1]

    def window_loss(self, raw_window: dict, noise):
        """Loss of one raw window. ``unroll_steps`` = K > 1: the raw window
        carries F+K-1 frames; step s takes frames [s, s+F) with every
        conditioning slot an earlier step predicted replaced by that
        prediction (gradients flow through it), and the K losses are
        averaged."""
        unroll = self.cfg.experiment.unroll_steps
        if unroll <= 1:
            loss, aux, _ = self._one_step_loss(raw_window, noise)
            return loss, aux
        f_raw = raw_window["atom37"].shape[0]
        need = f_raw - (unroll - 1)
        if need < 2:
            raise ValueError(
                f"unroll_steps={unroll} needs windows of >= {unroll + 1} "
                f"frames (got {f_raw}); raise data.frame_time"
            )
        preds, losses, auxs = [], [], []
        for s in range(unroll):
            raw_s = dict(raw_window, **{k: raw_window[k][s:s + need]
                                        for k in ("atom37", "force", "vel")})
            overrides = []
            for p in range(need - 1):
                j = s + p - (need - 1)  # raw frame s+p, predicted at step j
                if j >= 0:
                    overrides.append((p, preds[j]))
            loss, aux, pred = self._one_step_loss(raw_s, noise[s],
                                                  tuple(overrides))
            preds.append(pred)
            losses.append(loss)
            auxs.append(aux)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.stack(losses).mean(), aux

    def to_device(self, raw_batch: dict) -> dict:
        return {k: torch.as_tensor(raw_batch[k]).to(self.device)
                for k in RAW_KEYS}

    def loss_and_grads(self, raw_batch: dict, noises=None):
        """Mean loss and aux over a [B, ...] batch, with the parameters'
        .grad set to the gradient of the mean loss. ``noises``: one
        ``draw_window_noise`` result per window (drawn when None)."""
        batch = self.to_device(raw_batch)
        B = batch["atom37"].shape[0]
        accum = self.cfg.experiment.grad_accum
        if accum > 1 and B % accum:
            raise ValueError(
                f"grad_accum={accum} must divide the batch size ({B})")
        if noises is None:
            F, N = batch["atom37"].shape[1:3]
            noises = [self.draw_window_noise(F, N) for _ in range(B)]
        self.optimizer.zero_grad(set_to_none=True)
        losses, auxs = [], []
        for b in range(B):
            loss, aux = self.window_loss({k: v[b] for k, v in batch.items()},
                                         noises[b])
            (loss / B).backward()
            losses.append(loss.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.stack(losses).mean(), aux

    def train_step(self, raw_batch: dict, noises=None) -> dict:
        """One optimizer step on a [B, ...] batch; returns the step's mean
        aux metrics and grad_norm (of the unclipped gradient) as floats."""
        _, aux = self.loss_and_grads(raw_batch, noises)
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        aux["grad_norm"] = global_norm(grads)
        self.optimizer.step()
        return {k: float(v) for k, v in aux.items()}


class Experiment:
    """Epoch loop, logging, evaluation and checkpointing around a Trainer.

    ``eval_fn(model, diffuser) -> {metric: value}`` (lower is better) runs
    after every ``eval_every``-th completed epoch; its metrics go to the
    metrics writer as ``eval/<metric>``, ``best`` keeps each metric's best
    value, and ``<ckpt_dir>/best.ckpt`` is written whenever one improves."""

    def __init__(self, cfg: Config, data_iter_factory, *, device="cuda",
                 metrics_writer=None, eval_fn=None, eval_every: int = 0):
        self.cfg = cfg
        self.trainer = Trainer(cfg, device=device)
        self.data_iter_factory = data_iter_factory  # epoch -> raw batches
        self.metrics_writer = metrics_writer
        self.eval_fn = eval_fn
        self.eval_every = eval_every  # epochs between evals (0 = off)
        self.best: dict[str, float] = {}
        self.step = 0
        self.epoch = 0
        # every step's aux, its seconds in train_step and the seconds its
        # batch took to arrive from the data iterator
        self.step_metrics: list[dict] = []
        n_params = sum(p.numel() for p in self.trainer.model.parameters())
        log.info("model parameters: %.1fM", n_params / 1e6)

    def run_eval(self) -> dict:
        t = self.trainer
        metrics = {k: float(v)
                   for k, v in self.eval_fn(t.model, t.diffuser).items()}
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                self.step, {f"eval/{k}": v for k, v in metrics.items()})
        improved = []
        for k, v in metrics.items():
            if k not in self.best or v < self.best[k]:
                self.best[k] = v
                improved.append(k)
        log.info("eval @ step %d: %s%s", self.step,
                 " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                 f" (new best: {', '.join(improved)})" if improved else "")
        if improved and self.cfg.experiment.ckpt_dir:
            self.save_checkpoint(f"{self.cfg.experiment.ckpt_dir}/best.ckpt")
        return metrics

    def train(self, num_epochs: int | None = None,
              max_steps: int | None = None):
        cfg = self.cfg.experiment
        history, rolling = [], []
        timer = StepTimer()
        epochs = num_epochs if num_epochs is not None else cfg.num_epoch
        for epoch in range(self.epoch, self.epoch + epochs):
            batches = iter(self.data_iter_factory(epoch))
            while True:
                t_data = time.perf_counter()
                raw_batch = next(batches, None)
                if raw_batch is None:
                    break
                t0 = time.perf_counter()
                aux = self.trainer.train_step(raw_batch)  # floats: synced
                self.step += 1
                self.step_metrics.append(
                    dict(aux, step=self.step, data_seconds=t0 - t_data,
                         seconds=time.perf_counter() - t0))
                rolling.append(aux)
                timer.tick()
                if self.step == 1 or self.step % cfg.log_freq == 0:
                    means = {k: float(np.mean([a[k] for a in rolling]))
                             for k in rolling[0]}
                    sps = timer.steps_per_sec
                    log.info("epoch %d step %d: %s steps/sec=%.3f", epoch,
                             self.step, " ".join(f"{k}={v:.4f}"
                                                 for k, v in means.items()),
                             sps)
                    history.append({"step": self.step, **means,
                                    "steps_per_sec": sps})
                    if self.metrics_writer is not None:
                        self.metrics_writer.write(
                            self.step, {**means, "steps_per_sec": sps})
                    rolling = []
                    timer.reset()
                if max_steps is not None and self.step >= max_steps:
                    # partial epoch: resume restarts it
                    self.epoch = epoch
                    return history
            self.epoch = epoch + 1  # completed: resume starts the next one
            if (self.eval_fn is not None and self.eval_every
                    and epoch % self.eval_every == 0):
                self.run_eval()
            if cfg.ckpt_dir and epoch and epoch % cfg.ckpt_freq == 0:
                self.save_checkpoint()
        return history

    # -- checkpointing ---------------------------------------------------------
    def save_checkpoint(self, path: str | None = None) -> str:
        path = path or f"{self.cfg.experiment.ckpt_dir}/step_{self.step}.ckpt"
        t = self.trainer
        ckpt.save(path, t.model, t.optimizer, self.step, self.epoch,
                  to_dict(self.cfg), rng=t.generator.get_state())
        log.info("checkpoint written: %s", path)
        return path

    def load_checkpoint(self, path: str):
        t = self.trainer
        state = ckpt.restore(path, t.model, t.optimizer)
        if state.get("rng") is not None:
            t.generator.set_state(state["rng"])
        self.step = state["step"]
        self.epoch = state["epoch"]

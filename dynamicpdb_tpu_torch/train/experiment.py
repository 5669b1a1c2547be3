"""Training runtime: the train step, the epoch loop, checkpoints.

Port of ``dynamicpdb_tpu/train/experiment.py`` (``Trainer``, ``Experiment``).
One step = featurization + forward diffusion + model forward +
``dfold_loss`` on every window of the batch, the backward, and one AMSGrad
update.

JAX ``vmap``s the window loss over the batch; here the windows run one
after another, each with its own backward (``loss / B``), so the gradient
is the batch mean while only one window's activations are alive. Every
GlobalStatNorm statistic stays per window, as under ``vmap``. Running one
window at a time already gives what ``grad_accum`` asks of the JAX step
(micro-batches, one update, the same mean gradient), so here it is only
checked: k must divide the (local) batch.

Every random draw of a step comes from ``draw_window_noise`` (a
``torch.Generator`` seeded from ``experiment.seed``) unless the caller
passes the noise, so a test can hand the port the numbers JAX drew.

Data parallelism (``Trainer(cfg, device, mesh)``, ``parallel/``): one
process a device, started by a launcher. The global batch is split over
the mesh's data-like axes, rank r of D taking rows r, r + D, ... of it
(the sampler's host striding). Every rank draws the noise of the whole
global batch in order and keeps its rows, so the generators stay in lock
step and a D-rank step equals the one-process step on the global batch.
Each window's loss is divided by the global batch; after the window loop
one ``all_reduce`` sums the gradients and the aux sums in one flat bucket,
so every rank holds the global mean, its norm, and the logged means.
ZeRO-1 (``experiment.zero_opt_state``) and the 'model' axis split the
optimizer's work and state (``parallel/sharding.ParamLayout``).

Sequence parallelism (a 'seq' mesh axis, ``parallel/sp.py``): the ranks of
a 'seq' group share batch rows and draw the same noise; each window's
forward and backward run inside ``sp.activated``, each rank on its rows of
the residue axis (the model slices the whole-window features and gathers
its outputs back). The all-reduce stays one flat bucket a step, over the
data-like axes and 'seq' together. Why the scaling is right: a rank's
parameter gradient is its rows' share of d(loss / B_global) (every
parameter acts on this rank's rows only, and the output gather's backward
hands each rank its slice of the gradient every rank computed alike), so
the sum over 'seq' is the window's gradient and the sum over the data
axes the global batch's. The loss and aux, in contrast, are whole-window
values that every rank of a 'seq' group computed alike: only the rank at
'seq' index 0 puts them in the bucket, so the sum counts each window once.
ZeRO-1 regions stay split over 'data' alone: the ranks of a 'seq' group
hold the same regions and make the same update. The 'model' axis combines
with 'seq' unchanged (its ranks compute whole parameters on the same rows).
With remat, the backward re-runs IPA's key gather: every rank takes the
same path, so the collectives pair up.
``multi_train_step`` takes K steps over a [K, B, ...] stack, one
``train_step`` after another. The epoch loop takes its batches from
``data/prefetch.py``: the next batches are read, stacked and copied to the
device by a worker thread while the current step runs, as in the JAX loop.
Rank 0 alone writes checkpoints; the ranks of rank 0's 'seq' group
evaluate together (rank 0 alone without a 'seq' axis), and the others
wait.
"""
from __future__ import annotations

import contextlib
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
from dynamicpdb_tpu_torch.data.prefetch import (
    default_place,
    prefetch_to_device,
)
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import (
    DFoldScoreNetwork,
    score_forward,
)
from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.parallel.sharding import ParamLayout
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
    """Owns the model, diffuser, optimizer and noise generator; with a
    ``mesh`` (``parallel/mesh.Mesh``), this rank's share of a data-parallel
    step."""

    def __init__(self, cfg: Config, device="cuda", mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = DFoldScoreNetwork(cfg.model, device=self.device)
        init_like_jax_(self.model, cfg.experiment.seed)
        self.diffuser = SE3Diffuser(cfg.diffuser, device=self.device)
        self.layout = (None if mesh is None else ParamLayout(
            self.model, mesh, zero=cfg.experiment.zero_opt_state))
        self.optimizer = make_optimizer(self.model.parameters(),
                                        cfg.experiment, layout=self.layout)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        if self.layout is not None:
            self.layout.release()
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.experiment.seed)
        self.grad_group = (None if mesh is None
                           else mesh.group(*mesh_lib.grad_axes(mesh)))
        self.n_ranks = mesh_lib.data_size(mesh)
        self.rank_index = mesh_lib.data_index(mesh)
        self.seq_index = sp.index(mesh)
        # seconds of the last step's gradient all-reduce (device synced)
        self.comm_seconds = 0.0

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

    def host_rows(self, raw_batch: dict) -> dict:
        """A host batch as this rank copies it to the device: under a 'seq'
        axis its edge_repr cut to this rank's rows
        (``sp.host_edge_rows``)."""
        return sp.host_edge_rows(raw_batch, self.mesh)

    def to_device(self, raw_batch: dict) -> dict:
        """The batch's RAW_KEYS as tensors on the device; a tensor already
        there (the prefetcher's) passes through without a copy. A host
        edge_repr is cut to this rank's rows first (``host_rows``)."""
        raw_batch = {k: raw_batch[k] for k in RAW_KEYS}
        if not torch.is_tensor(raw_batch["edge_repr"]) or (
                raw_batch["edge_repr"].device != self.device):
            raw_batch = self.host_rows(raw_batch)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in raw_batch.items()}

    def loss_and_grads(self, raw_batch: dict, noises=None):
        """Mean loss and aux over the global batch, with the parameters'
        .grad set to the gradient of the mean loss. ``raw_batch``: this
        rank's [B, ...] rows; ``noises``: one ``draw_window_noise`` result
        per row of ``raw_batch`` (drawn when None: every rank draws the
        global batch's and keeps its rows)."""
        batch = self.to_device(raw_batch)
        B = batch["atom37"].shape[0]
        accum = self.cfg.experiment.grad_accum
        if accum > 1 and B % accum:
            raise ValueError(
                f"grad_accum={accum} must divide the batch size ({B})")
        n_global = B * self.n_ranks
        if noises is None:
            F, N = batch["atom37"].shape[1:3]
            noises = [self.draw_window_noise(F, N) for _ in range(n_global)]
            noises = noises[self.rank_index::self.n_ranks]
        if self.layout is not None:
            self.layout.materialize()
        self.optimizer.zero_grad(set_to_none=True)
        losses, auxs = [], []
        with sp.activated(self.mesh):  # the backward too: remat re-runs IPA
            for b in range(B):
                loss, aux = self.window_loss(
                    {k: v[b] for k, v in batch.items()}, noises[b])
                (loss / n_global).backward()
                losses.append(loss.detach())
                auxs.append({k: v.detach() for k, v in aux.items()})
        sums = torch.stack([torch.stack(losses).sum()] + [
            torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]])
        if self.mesh is not None:
            if self.seq_index:  # counted once, by 'seq' index 0
                sums = torch.zeros_like(sums)
            sums = self._all_reduce(sums)
        means = sums / n_global
        return means[0], dict(zip(auxs[0], means[1:]))

    def _all_reduce(self, sums: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and ``sums`` over the data-like and 'seq'
        ranks in one flat float32 bucket. A gradient that is None on every
        rank stays None (the optimizer skips it, as without a mesh)."""
        params = list(self.model.parameters())
        parts = [torch.zeros(p.shape, device=self.device) if p.grad is None
                 else p.grad.float() for p in params]
        has = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.float32, device=self.device)
        bucket = torch.cat([t.reshape(-1) for t in parts]
                           + [has, sums.float()])
        del parts
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        mesh_lib.all_reduce_(bucket, self.grad_group)
        if sync:
            torch.cuda.synchronize(self.device)
        self.comm_seconds = time.perf_counter() - t0
        off = 0
        for p in params:
            n = p.numel()
            p.grad = bucket[off:off + n].view(p.shape).to(p.dtype)
            off += n
        has, sums = bucket[off:off + len(params)], bucket[off + len(params):]
        for p, h in zip(params, has.tolist()):
            if not h:
                p.grad = None
        return sums

    def train_step(self, raw_batch: dict, noises=None) -> dict:
        """One optimizer step on a [B, ...] batch (this rank's rows);
        returns the global batch's mean aux metrics and grad_norm (of the
        unclipped gradient) as floats."""
        _, aux = self.loss_and_grads(raw_batch, noises)
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        aux["grad_norm"] = global_norm(grads)
        self.optimizer.step()
        if self.layout is not None:
            self.layout.gather_updates()
            self.layout.release()
            if self.layout.model_split:  # the whole gradients go too
                self.optimizer.zero_grad(set_to_none=True)
        return {k: float(v) for k, v in aux.items()}

    def whole_params(self):
        """A block in which every parameter is whole on every rank (a
        collective under a 'model' axis)."""
        return (contextlib.nullcontext() if self.layout is None
                else self.layout.whole())

    def multi_train_step(self, raw_batches: dict, noises=None) -> dict:
        """K optimizer steps over a [K, B, ...] stack of batches, one
        ``train_step`` after another (``noises``: K lists of per-window
        noise, or None); returns the last step's aux."""
        K = next(iter(raw_batches.values())).shape[0]
        for k in range(K):
            aux = self.train_step({key: v[k] for key, v in raw_batches.items()},
                                  None if noises is None else noises[k])
        return aux


class Experiment:
    """Epoch loop, logging, evaluation and checkpointing around a Trainer.

    ``eval_fn(model, diffuser) -> {metric: value}`` (lower is better) runs
    after every ``eval_every``-th completed epoch; its metrics go to the
    metrics writer as ``eval/<metric>``, ``best`` keeps each metric's best
    value, and ``<ckpt_dir>/best.ckpt`` is written whenever one improves."""

    def __init__(self, cfg: Config, data_iter_factory, *, device="cuda",
                 mesh=None, metrics_writer=None, eval_fn=None,
                 eval_every: int = 0):
        self.cfg = cfg
        self.trainer = Trainer(cfg, device=device, mesh=mesh)
        self.data_iter_factory = data_iter_factory  # epoch -> raw batches
        self.metrics_writer = metrics_writer
        self.eval_fn = eval_fn
        self.eval_every = eval_every  # epochs between evals (0 = off)
        self.best: dict[str, float] = {}
        self.step = 0
        self.epoch = 0
        # every step's aux, its seconds in train_step and the seconds it
        # waited for its batch from the prefetcher
        self.step_metrics: list[dict] = []
        log.info("model parameters: %.1fM", self.trainer.n_params / 1e6)
        # the prefetcher's placement: under a 'seq' axis only this rank's
        # edge rows cross to the device
        self._place = None
        if sp.size(mesh) > 1:
            place = default_place(self.trainer.device)
            self._place = lambda batch: place(self.trainer.host_rows(batch))

    def run_eval(self) -> dict:
        """Rank 0 evaluates, with the other ranks of its 'seq' group under
        sequence parallelism, while the other ranks wait for its metrics;
        every rank then keeps the best values, and a new best writes
        ``<ckpt_dir>/best.ckpt``."""
        t = self.trainer
        mesh = t.mesh
        evaluates = mesh_lib.is_main_process() or (
            mesh is not None and sp.size(mesh) > 1
            and all(c == 0 for a, c in mesh.coords.items() if a != "seq"))
        with t.whole_params():
            metrics = None
            if evaluates:
                with sp.activated(mesh):
                    metrics = {k: float(v) for k, v in
                               self.eval_fn(t.model, t.diffuser).items()}
            metrics = mesh_lib.broadcast_object(metrics)
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
            # close() on every exit path: an abandoned prefetcher leaves its
            # worker blocked in its put, holding device batches
            with prefetch_to_device(self.data_iter_factory(epoch),
                                    buffer_size=2,
                                    place=self._place,
                                    device=self.trainer.device) as prefetcher:
                batches = iter(prefetcher)
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
                             seconds=time.perf_counter() - t0,
                             comm_seconds=self.trainer.comm_seconds))
                    rolling.append(aux)
                    timer.tick()
                    if self.step == 1 or self.step % cfg.log_freq == 0:
                        means = {k: float(np.mean([a[k] for a in rolling]))
                                 for k in rolling[0]}
                        sps = timer.steps_per_sec
                        log.info("epoch %d step %d: %s steps/sec=%.3f",
                                 epoch, self.step,
                                 " ".join(f"{k}={v:.4f}"
                                          for k, v in means.items()), sps)
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
        """Every rank gathers the whole parameters and moments; rank 0
        writes them, and no rank returns before the file is in place."""
        path = path or f"{self.cfg.experiment.ckpt_dir}/step_{self.step}.ckpt"
        t = self.trainer
        with t.whole_params():
            opt_state = t.optimizer.state_dict()
            if mesh_lib.is_main_process():
                ckpt.save(path, t.model.state_dict(), opt_state, self.step,
                          self.epoch, to_dict(self.cfg),
                          rng=t.generator.get_state())
                log.info("checkpoint written: %s", path)
        mesh_lib.barrier()
        return path

    def load_checkpoint(self, path: str):
        """Any mesh's checkpoint (its moments are whole): each rank takes
        its share."""
        t = self.trainer
        with t.whole_params():
            state = ckpt.restore(path, t.model, t.optimizer)
        if state.get("rng") is not None:
            t.generator.set_state(state["rng"])
        self.step = state["step"]
        self.epoch = state["epoch"]

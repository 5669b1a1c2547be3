"""AMSGrad with a configurable state dtype, global-norm clipping, parameter
EMA and the learning-rate schedules.

Port of ``dynamicpdb_tpu/train/optim.py``. The JAX package chains optax
transforms (``clip_by_global_norm`` -> ``scale_by_amsgrad`` -> ``scale`` or
``scale_by_schedule`` -> ``track_ema``); here one ``torch.optim.Optimizer``
runs the same sequence in the same order:

  * two AMSGrad formulations: ``"optax"`` (the default) maxes the
    bias-corrected second moment ``nu_hat``; ``"torch"`` maxes the raw
    ``nu`` and bias-corrects the max, as ``torch.optim.Adam(amsgrad=True)``;
  * the three moments are stored in ``state_dtype`` (bfloat16 at release)
    and updated in float32; the bias corrections are float32, as optax
    computes them;
  * the learning rate of update n (n = 0, 1, ...) is ``schedule(n)``, as
    ``optax.scale_by_schedule`` counts;
  * with ``ema_decay`` the state also holds an EMA of the parameters,
    ``ema = decay * ema + (1 - decay) * new_params``, starting at the
    initial parameters; ``ema_state_dict`` gives the model's state dict
    with those EMA weights;
  * with a ``layout`` (``parallel/sharding.ParamLayout``) each rank updates
    only its region of each parameter and keeps the state of that region
    (ZeRO-1, 'model'); ``state_dict`` gathers the moments to the whole
    parameters' shapes (a collective) and ``load_state_dict`` takes this
    rank's regions of whole moments, so a checkpoint moves between meshes.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


class AMSGrad(torch.optim.Optimizer):
    def __init__(self, params, lr: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 state_dtype: torch.dtype | None = None,
                 formulation: str = "optax", clip_norm: float | None = None,
                 ema_decay: float | None = None, layout=None):
        if formulation not in ("optax", "torch"):
            raise ValueError(f"unknown amsgrad formulation: {formulation}")
        if ema_decay is not None and not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        self.schedule = lr if callable(lr) else (lambda count, _lr=lr: _lr)
        defaults = dict(b1=b1, b2=b2, eps=eps, count=0)
        super().__init__(params, defaults)
        self.state_dtype = state_dtype
        self.formulation = formulation
        self.clip_norm = clip_norm
        self.ema_decay = ema_decay
        self.layout = layout
        if ema_decay is not None:
            for p in self._params():
                self.state[p]["ema"] = self._region(p, p.detach()).float(
                ).clone()

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _region(self, p, t):
        """The part of ``t`` (shaped like ``p``) this rank updates."""
        return t if self.layout is None else self.layout.region(p, t)

    def state_dict(self):
        sd = super().state_dict()
        return sd if self.layout is None else self.layout.full_state(sd)

    def load_state_dict(self, state_dict):
        if self.layout is not None:
            state_dict = self.layout.local_state(state_dict)
        # torch casts loaded state to each parameter's dtype; put the
        # moments back in the state dtype (bf16 -> f32 -> bf16 is exact)
        super().load_state_dict(state_dict)
        for p in self._params():
            st = self.state.get(p, {})  # no empty entry for a stateless p
            for k in ("mu", "nu", "nu_max"):
                if k in st and self.state_dtype is not None:
                    st[k] = st[k].to(self.state_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AMSGrad.step takes no closure")
        params = [p for p in self._params() if p.grad is not None]
        grads = [p.grad.float() for p in params]
        if self.clip_norm:
            g_norm = global_norm(grads)
            if not bool(g_norm < self.clip_norm):
                grads = [g / g_norm * self.clip_norm for g in grads]
        for group in self.param_groups:
            group["count"] += 1
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        count = group["count"]
        lr = self.schedule(count - 1)
        dev = params[0].device if params else torch.device("cpu")
        cnt = torch.tensor(float(count), dtype=torch.float32, device=dev)
        if self.formulation == "optax":
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** cnt
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** cnt
        else:
            # torch computes 1 - b**step in float64; in float32 1 - b2**t
            # cancels, so use expm1 with the float64 log, as the JAX port
            c1 = -torch.expm1(cnt * math.log(b1))
            sqrt_c2 = torch.sqrt(-torch.expm1(cnt * math.log(b2)))
        dt = self.state_dtype
        for p, g in zip(params, grads):
            st = self.state[p]
            g, target = self._region(p, g), self._region(p, p)
            if "mu" not in st:
                for k in ("mu", "nu", "nu_max"):
                    st[k] = torch.zeros_like(target, dtype=dt or p.dtype)
            mu = b1 * st["mu"].float() + (1.0 - b1) * g
            nu = b2 * st["nu"].float() + (1.0 - b2) * (g * g)
            if self.formulation == "optax":
                nu_max = torch.maximum(st["nu_max"].float(), nu / c2)
                update = (mu / c1) / (torch.sqrt(nu_max) + eps)
            else:
                nu_max = torch.maximum(st["nu_max"].float(), nu)
                update = (mu / c1) / (torch.sqrt(nu_max) / sqrt_c2 + eps)
            update = (-lr) * update
            st["mu"] = mu.to(st["mu"].dtype)
            st["nu"] = nu.to(st["nu"].dtype)
            st["nu_max"] = nu_max.to(st["nu_max"].dtype)
            new = target.float() + update
            if self.ema_decay is not None:
                d = self.ema_decay
                st["ema"] = d * st["ema"] + (1.0 - d) * new
            target.copy_(new)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def make_lr_schedule(experiment_cfg):
    """A float (constant lr, the reference's behaviour) or a function
    count -> lr: linear warmup from 0, or warmup then cosine decay to 0 at
    ``lr_decay_steps`` (the total length, warmup included), with optax's
    formulas (``linear_schedule``, ``warmup_cosine_decay_schedule``)."""
    lr = experiment_cfg.learning_rate
    warmup = getattr(experiment_cfg, "warmup_steps", 0)
    kind = getattr(experiment_cfg, "lr_schedule", "constant")
    if kind not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule: {kind}")
    if kind == "constant" and not warmup:
        return lr

    def linear(count, init, end, steps):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    if kind == "cosine":
        decay = getattr(experiment_cfg, "lr_decay_steps", 1000000)
        if decay <= warmup:
            raise ValueError(
                f"lr_decay_steps ({decay}) is the TOTAL schedule length "
                f"and must exceed warmup_steps ({warmup})"
            )
        init = 0.0 if warmup else lr

        def cosine(count):
            if count < warmup:
                return linear(count, init, lr, warmup)
            c = min(float(count - warmup), float(decay - warmup))
            return lr * 0.5 * (1 + math.cos(math.pi * c / (decay - warmup)))

        return cosine
    return lambda count: linear(count, 0.0, lr, warmup)


def make_optimizer(params, experiment_cfg, layout=None) -> AMSGrad:
    """The training optimizer from ExperimentConfig: AMSGrad as in the
    reference, optional global-norm clipping, low-precision state and
    parameter EMA; ``layout``: the regions each rank updates."""
    state_dtype = None
    name = getattr(experiment_cfg, "opt_state_dtype", None)
    if name:
        state_dtype = getattr(torch, name)
        if state_dtype == torch.float32:
            state_dtype = None
    return AMSGrad(
        params, make_lr_schedule(experiment_cfg), state_dtype=state_dtype,
        formulation=getattr(experiment_cfg, "amsgrad_formulation", "optax"),
        clip_norm=experiment_cfg.grad_clip_norm or None,
        ema_decay=getattr(experiment_cfg, "ema_decay", None),
        layout=layout,
    )


def ema_state_dict(optimizer: AMSGrad, model: torch.nn.Module) -> dict:
    """``model``'s state dict with every parameter replaced by its EMA from
    ``optimizer``'s state (the counterpart of the JAX package's
    ``ema_params``). Raises ValueError when the state holds no EMA (train
    with ``experiment.ema_decay``)."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        ema = optimizer.state.get(p, {}).get("ema")
        if ema is None:
            raise ValueError(
                f"no EMA of {name} in the optimizer state: the checkpoint "
                "was trained without experiment.ema_decay")
        sd[name] = ema.to(p.dtype)
    return sd

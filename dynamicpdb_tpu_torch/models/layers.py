"""Shared building blocks of the score network.

Port of ``dynamicpdb_tpu/models/layers.py`` with the parameter names of the
reference torch layout (``train/export_torch.py``), so a state dict mapped
from JAX params loads with ``strict=True``. Parameters are float32; a
``compute_dtype`` of bfloat16 runs a layer's matmul or convolution in bf16.
Weights come from a checkpoint (or ``weights.randomize_``); the layers keep
torch's default init.

Under sequence parallelism (``parallel/sp.py``) x holds this rank's rows of
the window: ``global_stat_norm`` sums its statistics over the ranks and
``ConvNet`` takes two rows of each neighbour before every convolution.

The JAX module's ``GlobalStatNorm`` flax module holds no parameters; it
is the function ``global_stat_norm`` here.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamicpdb_tpu_torch.parallel import sp


class Linear(nn.Linear):
    """nn.Linear computing in ``compute_dtype`` (None: the promotion of the
    input's and the weight's dtype, i.e. float32), like flax ``Dense(dtype=)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def global_stat_norm(x, mask=None, eps: float = 1e-4):
    """(x - mean) / sqrt(var + eps), mean and unbiased variance over every
    real element of the window (``layers.py:61-92`` of the JAX package).

    ``mask`` ([..., N], broadcast over x's leading dims) keeps padded
    residues out of the statistics, so real-residue outputs do not depend on
    the padding. Statistics are float32; the result has x's dtype.

    Under sequence parallelism x and mask hold this rank's rows, and the
    statistics take two reductions over the ranks, as one process takes
    them in two passes: n and the masked sum of x give the mean, then the
    masked sum of (x - mean)^2 the variance. The mask is required there
    (the pad rows must stay out)."""
    x32 = x.float()
    if mask is None:
        if sp.is_active():
            raise ValueError("global_stat_norm under sequence parallelism "
                             "needs the mask of this rank's rows")
        mean = torch.mean(x32)
        var = torch.sum((x32 - mean) ** 2) / max(x.numel() - 1, 1)
    else:
        m = mask.float()[..., None].expand(x32.shape)
        n, s = sp.all_reduce_sum(torch.stack([torch.sum(m),
                                              torch.sum(x32 * m)])).unbind(0)
        mean = s / torch.clamp(n, min=1.0)
        var = sp.all_reduce_sum(torch.sum((x32 - mean) ** 2 * m)) / (
            torch.clamp(n - 1.0, min=1.0))
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


class MLPEmbedder(nn.Sequential):
    """Linear -> SiLU -> Linear -> GlobalStatNorm -> SiLU; the Linears are
    entries 0 and 2, as in the reference's nn.Sequential."""

    def __init__(self, in_features: int, features: int, compute_dtype=None):
        super().__init__(
            Linear(in_features, features, compute_dtype=compute_dtype),
            nn.SiLU(),
            Linear(features, features, compute_dtype=compute_dtype),
        )

    def forward(self, x, mask=None):
        x = self[2](F.silu(self[0](x)))
        return F.silu(global_stat_norm(x, mask=mask))


class _ConvPair(nn.Sequential):
    """Conv(dim -> dim/2) and Conv(dim/2 -> dim), 5x5 SAME, as entries 0
    and 2 (the reference's nn.Sequential)."""

    def __init__(self, dim: int):
        super().__init__(
            nn.Conv2d(dim, dim // 2, 5, padding=2),
            nn.ReLU(),
            nn.Conv2d(dim // 2, dim, 5, padding=2),
        )


def _conv5x5(conv: nn.Conv2d, x, dtype):
    """5x5 SAME convolution over the [F, N] grid of x [F, N, C]; the
    [1, C, F, N] view is channels-last, so no copy is made. Under sequence
    parallelism x is this rank's rows: two rows of each neighbour (zeros
    at the window's ends, as SAME pads) join them, and the residue axis
    takes no padding."""
    w = conv.weight.to(dtype)
    b = conv.bias.to(dtype)
    x = x.to(dtype)
    padding = 2
    if sp.is_active():
        x, padding = sp.halo_exchange(x, 2, dim=1), (2, 0)
    y = F.conv2d(x[None].permute(0, 3, 1, 2), w, b, padding=padding)
    return y.permute(0, 2, 3, 1)[0]


class ConvNet(nn.Module):
    """4 residual double-conv 5x5 blocks over the [F, N] grid: the only
    mixing across frames. ``mask`` [F, N] re-zeroes pad rows after every
    conv (``layers.py:168-199``), so real rows do not depend on pad_to."""

    def __init__(self, dim: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        for i in range(1, 5):
            self.add_module(f"conv{i}", _ConvPair(dim))

    def forward(self, x, mask=None):
        dt = self.compute_dtype or x.dtype
        z = None if mask is None else mask[..., None].to(x.dtype)

        def m(v):
            return v if z is None else v * z

        h = m(x)
        for i in range(1, 5):
            pair = getattr(self, f"conv{i}")
            r = m(F.relu(_conv5x5(pair[0], h, dt)))
            r = m(F.relu(_conv5x5(pair[2], r, dt)))
            h = h + r
        return h


class BackboneUpdate(nn.Module):
    """Linear c -> 6 quaternion + translation update (float32)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.linear = Linear(c_in, 6)

    def forward(self, s):
        return self.linear(s)


class AngleResnetBlock(nn.Module):
    def __init__(self, c_hidden: int, compute_dtype=None):
        super().__init__()
        self.linear_1 = Linear(c_hidden, c_hidden, compute_dtype=compute_dtype)
        self.linear_2 = Linear(c_hidden, c_hidden, compute_dtype=compute_dtype)

    def forward(self, a):
        s = self.linear_1(F.relu(a))
        s = self.linear_2(F.relu(s))
        return a + s


class AngleResnet(nn.Module):
    """AF2 Algorithm 20 lines 11-14, with c_in = c_hidden = 5*c_s."""

    def __init__(self, c_hidden: int, no_blocks: int = 2, no_angles: int = 7,
                 eps: float = 1e-12, compute_dtype=None):
        super().__init__()
        self.no_angles = no_angles
        self.eps = eps
        self.linear_initial = Linear(c_hidden, c_hidden, compute_dtype=compute_dtype)
        self.linear_in = Linear(c_hidden, c_hidden, compute_dtype=compute_dtype)
        self.layers = nn.ModuleList(
            AngleResnetBlock(c_hidden, compute_dtype=compute_dtype)
            for _ in range(no_blocks)
        )
        # float32 (promotion) as the JAX head's last Dense
        self.linear_out = Linear(c_hidden, no_angles * 2)

    def forward(self, s, s_initial):
        s_initial = self.linear_initial(F.relu(s_initial))
        s = self.linear_in(F.relu(s))
        s = s + s_initial
        for layer in self.layers:
            s = layer(s)
        s = self.linear_out(F.relu(s)).float()
        s = s.reshape(s.shape[:-1] + (self.no_angles, 2))
        norm = torch.sqrt(torch.clamp(torch.sum(s**2, -1, keepdim=True), min=self.eps))
        return s, s / norm

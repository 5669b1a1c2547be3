"""The port's IPA autograd function and the plain versions of its three
backward kernels (``dynamicpdb_tpu_torch/ops/ipa_attention.py``) against
the JAX package, on the CPU.

  * the Function's gradients against JAX's custom VJP with the fused
    three-kernel backward (Pallas in interpret mode) at a block-divisible N;
  * the Function's gradients against autograd of the dense plain forward at
    a ragged N with masked rows;
  * each kernel's plain version against the matching outputs of JAX's
    ``_fused_ipa_backward(interpret=True)`` on the same inputs.

Inputs are made with numpy from seeds and handed to both packages.

Tolerances. Cotangents zeroed on pad query rows: float32 on both sides,
sums in another order; the JAX package's gradient bar, 2e-4
(tests/test_pallas_ipa.py). Cotangents on every row: a pad row's logits sit
near -inf = -1e5 where float32 steps by 2^-7, so its softmax weights differ
between two implementations by up to 2 x 2^-7 relative, and every gradient
that sums over query rows carries that: 2 x 2^-7 of the gradient's largest
magnitude."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.ops.pallas.ipa_attention import (
    _fused_ipa_backward,
    fused_ipa_attention,
)
from dynamicpdb_tpu.ops.pallas.ipa_attention import ipa_attention as jax_ipa
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from tests.test_torch_kernels import NAMES, _torch, make_inputs

torch.set_num_threads(1)

C_B = math.sqrt(1.0 / 3)
GRAD_NAMES = [n for n in NAMES if n != "mask"]
ZERO_PAD_ATOL = 2e-4
PAD_RTOL = 2 * 2.0 ** -7


def _cotangents(d, c_qk, seed, zero_pad):
    """Seeded cotangents for (o, o_pt, o_pair), zero on pad query rows when
    ``zero_pad``."""
    rng = np.random.default_rng(seed)
    o, o_pt, o_pair, _ = ipa_mod.ipa_attention_plain(*_torch(d), c_qk)
    mask = d["mask"]
    out = []
    for x in (o, o_pt, o_pair):
        w = rng.normal(size=x.shape).astype(np.float32)
        if zero_pad:
            w = w * mask.reshape(mask.shape + (1,) * (x.dim() - 2))
        out.append(w)
    return out


def _port_grads(d, c_qk, cots, fn=None):
    args = [t.requires_grad_(n != "mask") for t, n in zip(_torch(d), NAMES)]
    outs = (fn or ipa_mod.ipa_attention)(*args, c_qk)
    loss = sum((o * torch.as_tensor(w)).sum() for o, w in zip(outs[:3], cots))
    grads = torch.autograd.grad(loss, [a for a in args if a.requires_grad])
    return dict(zip(GRAD_NAMES, (g.numpy() for g in grads)))


def test_function_matches_jax_custom_vjp_interpret():
    """N = 16 with 8 x 8 Pallas blocks, the last 3 residues masked."""
    d, c_qk = make_inputs(11, F=2, N=16, H=2, C=8, Pq=4, Pv=6, Dz=4,
                          masked=3)
    cots = _cotangents(d, c_qk, 12, zero_pad=True)
    before = (ipa_mod.launches, ipa_mod.bwd_dq_launches)
    got = _port_grads(d, c_qk, cots)
    assert (ipa_mod.launches, ipa_mod.bwd_dq_launches) == before  # CPU: plain

    args = [jnp.asarray(d[n]) for n in NAMES]
    _, vjp = jax.vjp(
        lambda *a: jax_ipa(*a, c_qk, C_B, 1e5, 8, 8, True, True), *args)
    want = vjp(tuple(jnp.asarray(w) for w in cots))
    for name, w in zip(NAMES, want):
        if name == "mask":
            continue
        np.testing.assert_allclose(got[name], np.asarray(w),
                                   atol=ZERO_PAD_ATOL, err_msg=name)


@pytest.mark.parametrize("zero_pad", [True, False],
                         ids=["pad-cotangents-zero", "pad-cotangents-random"])
@pytest.mark.parametrize("n,masked", [(13, 4), (21, 0)])
def test_function_matches_dense_autograd_at_ragged_n(n, masked, zero_pad):
    d, c_qk = make_inputs(n, F=2, N=n, H=2, C=8, Pq=4, Pv=6, Dz=4,
                          masked=masked)
    cots = _cotangents(d, c_qk, 13, zero_pad)
    got = _port_grads(d, c_qk, cots)
    want = _port_grads(d, c_qk, cots, fn=ipa_mod.ipa_attention_plain)
    for name in GRAD_NAMES:
        scale = max(1.0, float(np.abs(want[name]).max()))
        tol = ZERO_PAD_ATOL if zero_pad or not masked else PAD_RTOL * scale
        np.testing.assert_allclose(got[name], want[name], atol=tol,
                                   rtol=0, err_msg=name)


def test_function_returns_no_mask_gradient_and_keeps_dtypes():
    d, c_qk = make_inputs(3, N=9, masked=2)
    args = [t.requires_grad_(n != "mask") for t, n in zip(_torch(d), NAMES)]
    o, o_pt, o_pair, lse = ipa_mod.ipa_attention(*args, c_qk)
    assert not lse.requires_grad
    (o.sum() + o_pt.sum() + o_pair.sum()).backward()
    assert args[8].grad is None
    for a, n in zip(args, NAMES):
        if n != "mask":
            assert a.grad.dtype == a.dtype and a.grad.shape == a.shape, n


def test_plain_backward_kernels_match_jax_fused_backward():
    """The three plain kernel functions against _fused_ipa_backward's
    outputs (interpret mode) on the same saved lse, D and cotangents."""
    F, N, H, C, Pq, Pv, Dz = 2, 16, 2, 8, 4, 6, 4
    d, c_qk = make_inputs(17, F=F, N=N, H=H, C=C, Pq=Pq, Pv=Pv, Dz=Dz,
                          masked=3)
    cots = _cotangents(d, c_qk, 18, zero_pad=True)
    jargs = [jnp.asarray(d[n]) for n in NAMES]
    o, o_pt, o_pair, lse = fused_ipa_attention(
        *jargs, c_qk=c_qk, c_b=C_B, inf=1e5, blk_q=8, blk_k=8,
        interpret=True, return_lse=True)

    def fh(x):
        x = jnp.asarray(x)
        return x.transpose(0, 2, 1, *range(3, x.ndim)).reshape(F, H, N, -1)

    go, gopt, gpair = (fh(w) for w in cots)
    dvec = (jnp.sum(go * fh(o), -1) + jnp.sum(gopt * fh(o_pt), -1)
            + jnp.sum(gpair * fh(o_pair), -1))
    want = _fused_ipa_backward(
        fh(jargs[0]), fh(jargs[1]), fh(jargs[2]), fh(jargs[3]), fh(jargs[4]),
        fh(jargs[5]), jnp.transpose(jargs[6], (2, 0, 1)), jargs[7],
        jargs[8].reshape(F, N, 1), jargs[9].reshape(H, 1), lse[..., None],
        dvec[..., None], go, gopt, gpair, c_qk=c_qk, c_b=C_B, inf=1e5,
        blk_q=8, blk_k=8, interpret=True)
    want = dict(zip(("dq", "dk", "dv", "dqp", "dkp", "dvp", "dbias", "dpz",
                     "dhw"), (np.asarray(w) for w in want)))

    # the port's layouts: [F, N, H, D]; dbias [N, N, H]
    def unfh(x):
        return x.transpose(0, 2, 1, 3)

    saved = tuple(_torch(d)) + tuple(torch.as_tensor(np.array(x))
                                     for x in (o, o_pt, o_pair, lse))
    inputs = ipa_mod.backward_inputs(saved, *(torch.as_tensor(w)
                                              for w in cots))
    torch.testing.assert_close(inputs[11], torch.as_tensor(np.array(dvec)),
                               atol=1e-5, rtol=1e-5)
    kw = dict(c_qk=c_qk, c_b=C_B, inf=1e5)
    dq, dqp, dhw_rows = ipa_mod.ipa_bwd_dq_plain(*inputs, **kw)
    dk, dkp, dv, dvp = ipa_mod.ipa_bwd_dkv_plain(*inputs, **kw)
    dbias, dpz = ipa_mod.ipa_bwd_pair_plain(*inputs, **kw)
    got = dict(dq=dq, dk=dk, dv=dv, dqp=dqp, dkp=dkp, dvp=dvp, dbias=dbias,
               dpz=dpz, dhw=dhw_rows.sum((0, 2)))
    layouts = dict(dbias=lambda x: x.transpose(1, 2, 0), dpz=lambda x: x,
                   dhw=lambda x: x)
    for name, g in got.items():
        w = layouts.get(name, unfh)(want[name])
        np.testing.assert_allclose(g.numpy(), w, atol=ZERO_PAD_ATOL,
                                   err_msg=name)

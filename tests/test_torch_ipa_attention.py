"""IPA attention forward of the PyTorch port (ops/ipa_attention.py).

On the CPU the wrapper runs its plain version, which is held here against
the JAX package: against the Pallas kernel in interpret mode at a
block-divisible N (all four outputs, the row log-sum-exp included), and
against ``models/ipa.py:dense_ipa_attention`` at a ragged N with masked
rows. Both sides are float32 over contractions of at most 64 terms, so
they agree to 3e-6 on unit-scale outputs; the lse of a masked row sits near
-1e5, where a float32 ulp is 8e-3, so it is compared to 1e-7 relative.
The CUDA kernel itself is held against the plain version in
test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.models.ipa import dense_ipa_attention
from dynamicpdb_tpu.ops.pallas.ipa_attention import fused_ipa_attention
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from tests.test_torch_kernels import NAMES, _check_lse, _torch, make_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [0, 3])
def test_plain_matches_pallas_kernel_in_interpret_mode(masked):
    d, c_qk = make_inputs(0, masked=masked)
    want = fused_ipa_attention(
        *(jnp.asarray(d[n]) for n in NAMES), c_qk=c_qk, blk_q=8, blk_k=8,
        interpret=True, return_lse=True)
    before = ipa_mod.launches
    got = ipa_mod.ipa_attention(*_torch(d), c_qk)
    assert ipa_mod.launches == before  # CPU tensors: the plain version ran
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6)
    _check_lse(got[3].numpy(), np.asarray(want[3]), d["mask"])


@pytest.mark.parametrize("n,masked", [(13, 4), (21, 0)])
def test_plain_matches_dense_at_ragged_n(n, masked):
    d, c_qk = make_inputs(1, N=n, masked=masked)
    want = dense_ipa_attention(*(jnp.asarray(d[x]) for x in NAMES), c_qk)
    got = ipa_mod.ipa_attention_plain(*_torch(d), c_qk)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6)


def test_mixed_devices_raise():
    d, c_qk = make_inputs(2)
    args = _torch(d)
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        ipa_mod.ipa_attention(*args, c_qk)

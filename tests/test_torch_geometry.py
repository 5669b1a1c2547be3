"""Geometry of the PyTorch port (ops/so3, ops/rigid, ops/frames) against
the JAX package on the same random inputs, and against the reference
goldens the JAX tests use.

Tolerances: both sides compute in float32 with the same formulas, so they
agree to a few float32 ulps of the values' scale (2e-5 on unit-scale
quaternions and rotations, 1e-4 on coordinates of ~10 A). Against the
goldens (torch openfold in float64/float32) the bounds are those of the
JAX package's own golden tests."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.ops import frames as jframes
from dynamicpdb_tpu.ops import so3 as jso3
from dynamicpdb_tpu.ops.rigid import Rigid as JRigid
from dynamicpdb_tpu_torch.ops import frames as tframes
from dynamicpdb_tpu_torch.ops import so3 as tso3
from dynamicpdb_tpu_torch.ops.rigid import Rigid as TRigid

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n=64):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    # angles spanning the small-angle branch (<= 1e-3), moderate and near pi
    scale = np.concatenate([np.full(n // 4, 1e-4), np.full(n // 4, 5e-4),
                            rng.uniform(0.1, 3.1, n - n // 2)])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)
            * scale[:, None]).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jso3, fn_name)(*(jnp.asarray(a) for a in arrays))
    t = getattr(tso3, fn_name)(*(torch.as_tensor(a) for a in arrays))
    return np.asarray(j), t.numpy()


UNARY_Q = ["quat_normalize", "quat_conjugate", "quat_invert", "quat_to_rotmat",
           "quat_to_rotvec"]


@pytest.mark.parametrize("name", UNARY_Q)
def test_so3_quat_functions(name):
    q = _quats(_rng(1))
    q[:8] = [1.0, 2e-4, -1e-4, 3e-4]  # small angles: the Taylor branch
    q[8:12] *= -1  # w < 0: the sign flip
    j, t = _both(name, q)
    np.testing.assert_allclose(t, j, atol=2e-5)


def test_so3_rotvec_to_quat():
    j, t = _both("rotvec_to_quat", _rotvecs(_rng(2)))
    np.testing.assert_allclose(t, j, atol=2e-5)


def test_so3_rotmat_to_quat():
    m = np.asarray(jso3.quat_to_rotmat(jnp.asarray(_quats(_rng(3)))))
    j, t = _both("rotmat_to_quat", m)
    np.testing.assert_allclose(t, j, atol=2e-5)


def test_so3_quat_multiply():
    rng = _rng(4)
    j, t = _both("quat_multiply", _quats(rng), _quats(rng))
    np.testing.assert_allclose(t, j, atol=5e-5)


def test_so3_compose_rotvec():
    rng = _rng(5)
    j, t = _both("compose_rotvec", _rotvecs(rng), _rotvecs(rng))
    np.testing.assert_allclose(t, j, atol=5e-5)


@pytest.fixture(scope="module")
def rigid_inputs():
    rng = _rng(6)
    q = _quats(rng)
    t7 = np.concatenate([q, 10 * rng.normal(size=(64, 3))], -1).astype(np.float32)
    pts = (10 * rng.normal(size=(64, 3))).astype(np.float32)
    upd = (0.3 * rng.normal(size=(64, 6))).astype(np.float32)
    mask = (rng.uniform(size=(64, 1)) > 0.3).astype(np.float32)
    return t7, pts, upd, mask


@pytest.mark.parametrize("op", ["apply", "invert_apply", "compose_q_update_vec",
                                "rotmat", "from_rotmat"])
def test_rigid_ops(rigid_inputs, op):
    t7, pts, upd, mask = rigid_inputs
    jr = JRigid.from_tensor_7(jnp.asarray(t7))
    tr = TRigid.from_tensor_7(torch.as_tensor(t7))
    if op in ("apply", "invert_apply"):
        j = getattr(jr, op)(jnp.asarray(pts))
        t = getattr(tr, op)(torch.as_tensor(pts))
    elif op == "compose_q_update_vec":
        j = jr.compose_q_update_vec(jnp.asarray(upd), jnp.asarray(mask))
        t = tr.compose_q_update_vec(torch.as_tensor(upd), torch.as_tensor(mask))
        j, t = j.to_tensor_7(), t.to_tensor_7()
    elif op == "rotmat":
        j, t = jr.rotmat(), tr.rotmat()
    else:
        j = JRigid.from_rotmat(jr.rotmat(), jr.trans).to_tensor_7()
        t = TRigid.from_rotmat(tr.rotmat(), tr.trans).to_tensor_7()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


@pytest.fixture(scope="module")
def rigid_golden():
    with np.load(os.path.join(GOLDENS, "rigid_golden.npz")) as z:
        return {k: z[k] for k in z.files}


def test_rigid_golden(rigid_golden):
    g = rigid_golden
    r = TRigid.from_tensor_7(torch.as_tensor(g["t7"], dtype=torch.float32))
    got = r.compose_q_update_vec(
        torch.as_tensor(g["update"], dtype=torch.float32)).to_tensor_7().numpy()
    ref = g["composed_t7"]
    sign = np.sign(np.sum(got[:, :4] * ref[:, :4], -1, keepdims=True))
    np.testing.assert_allclose(got[:, :4] * sign, ref[:, :4], atol=2e-5)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], atol=2e-4)
    pts = torch.as_tensor(g["pts"], dtype=torch.float32)
    np.testing.assert_allclose(r.apply(pts).numpy(), g["applied"], atol=2e-4)
    np.testing.assert_allclose(r.invert_apply(pts).numpy(), g["inv_applied"],
                               atol=2e-4)
    q = torch.as_tensor(g["t7"][:, :4], dtype=torch.float32)
    np.testing.assert_allclose(
        tso3.quat_multiply(q, torch.as_tensor(g["quat2"], dtype=torch.float32))
        .numpy(), g["qmul"], atol=2e-5)
    np.testing.assert_allclose(tso3.quat_invert(q).numpy(), g["qinv"],
                               atol=2e-5)


@pytest.fixture(scope="module")
def frames_golden():
    with np.load(os.path.join(GOLDENS, "frames_golden.npz")) as z:
        g = {k: z[k] for k in z.files}
    aatype = torch.as_tensor(g["aatype"])
    atom37 = torch.as_tensor(g["atom37"], dtype=torch.float32)
    mask = torch.as_tensor(g["atom37_mask"], dtype=torch.float32)
    ours = {
        "frames": tframes.atom37_to_frames(aatype, atom37, mask),
        "torsions": tframes.atom37_to_torsion_angles(aatype, atom37, mask),
    }
    return g, ours


def test_frames_golden_gt_frames(frames_golden):
    g, ours = frames_golden
    fr = ours["frames"]
    np.testing.assert_allclose(fr["gt_frames"].to_tensor_4x4().numpy(),
                               g["rigidgroups_gt_frames"], atol=2e-4)
    np.testing.assert_allclose(fr["alt_gt_frames"].to_tensor_4x4().numpy(),
                               g["rigidgroups_alt_gt_frames"], atol=2e-4)
    np.testing.assert_array_equal(fr["gt_exists"].numpy(),
                                  g["rigidgroups_gt_exists"])
    np.testing.assert_array_equal(fr["is_ambiguous"].numpy(),
                                  g["rigidgroups_is_ambiguous"])


def test_frames_golden_torsions(frames_golden):
    g, ours = frames_golden
    t = ours["torsions"]
    m = g["torsion_angles_mask"][..., None]
    np.testing.assert_allclose(t["torsion_angles_sin_cos"].numpy() * m,
                               g["torsion_angles_sin_cos"] * m, atol=2e-4)
    np.testing.assert_allclose(t["alt_torsion_angles_sin_cos"].numpy() * m,
                               g["alt_torsion_angles_sin_cos"] * m, atol=2e-4)
    np.testing.assert_array_equal(t["torsion_angles_mask"].numpy(),
                                  g["torsion_angles_mask"])


def test_frames_golden_torsion_angles_to_frames(frames_golden):
    g, _ = frames_golden
    aatype = torch.as_tensor(g["aatype"])
    bb = TRigid(torch.as_tensor(g["taf_quat"], dtype=torch.float32),
                torch.as_tensor(g["taf_trans"], dtype=torch.float32))
    angles = torch.as_tensor(g["taf_angles"], dtype=torch.float32)
    fr = tframes.torsion_angles_to_frames(bb, angles, aatype)
    np.testing.assert_allclose(fr.to_tensor_4x4().numpy(), g["taf_all_frames"],
                               atol=2e-4)
    np.testing.assert_allclose(tframes.frames_to_atom14_pos(fr, aatype).numpy(),
                               g["taf_atom14"], atol=5e-4)


@pytest.fixture(scope="module")
def window():
    """A two-frame synthetic window with side-chain rotations, so every
    torsion and rigid group is exercised."""
    return make_window(n_res=24, frame_time=2, seed=3, rot_wiggle=0.2)


def test_frames_match_jax_on_a_window(window):
    w = window
    aatype, atom37, mask = w["aatype"], w["atom37"], w["atom37_mask"]
    jf = [jframes.atom37_to_frames(jnp.asarray(aatype), jnp.asarray(a),
                                   jnp.asarray(mask)) for a in atom37]
    tf = tframes.atom37_to_frames(torch.as_tensor(aatype).long(),
                                  torch.as_tensor(atom37), torch.as_tensor(mask))
    np.testing.assert_allclose(
        tf["gt_frames"].to_tensor_4x4().numpy(),
        np.stack([np.asarray(f["gt_frames"].to_tensor_4x4()) for f in jf]),
        atol=1e-4)
    np.testing.assert_allclose(
        tf["backbone_rigid"].to_tensor_7().numpy(),
        np.stack([np.asarray(f["backbone_rigid"].to_tensor_7()) for f in jf]),
        atol=1e-4)
    jt = [jframes.atom37_to_torsion_angles(jnp.asarray(aatype), jnp.asarray(a),
                                           jnp.asarray(mask)) for a in atom37]
    tt = tframes.atom37_to_torsion_angles(torch.as_tensor(aatype).long(),
                                          torch.as_tensor(atom37),
                                          torch.as_tensor(mask))
    for key in ("torsion_angles_sin_cos", "alt_torsion_angles_sin_cos",
                "torsion_angles_mask"):
        np.testing.assert_allclose(
            tt[key].numpy(), np.stack([np.asarray(x[key]) for x in jt]),
            atol=2e-5, err_msg=key)


def test_atoms_from_torsions_match_jax(window):
    rng = _rng(7)
    aatype = window["aatype"]
    n = aatype.shape[0]
    q, tr = _quats(rng, n), (5 * rng.normal(size=(n, 3))).astype(np.float32)
    ang = rng.normal(size=(n, 7, 2)).astype(np.float32)
    ang /= np.linalg.norm(ang, axis=-1, keepdims=True)
    jfr = jframes.torsion_angles_to_frames(
        JRigid(jnp.asarray(q), jnp.asarray(tr)), jnp.asarray(ang),
        jnp.asarray(aatype))
    tfr = tframes.torsion_angles_to_frames(
        TRigid(torch.as_tensor(q), torch.as_tensor(tr)), torch.as_tensor(ang),
        torch.as_tensor(aatype).long())
    j14 = jframes.frames_to_atom14_pos(jfr, jnp.asarray(aatype))
    t14 = tframes.frames_to_atom14_pos(tfr, torch.as_tensor(aatype).long())
    np.testing.assert_allclose(t14.numpy(), np.asarray(j14), atol=1e-4)
    j37, jm = jframes.atom14_to_atom37(j14, jnp.asarray(aatype))
    t37, tm = tframes.atom14_to_atom37(t14, torch.as_tensor(aatype).long())
    np.testing.assert_allclose(t37.numpy(), np.asarray(j37), atol=1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

"""The eval slice's numpy and metric modules of the PyTorch port against the
JAX package: analysis/metrics.py, analysis/pdb_io.py, preprocess/dcd.py,
analysis/interactive.py and analysis/decomposition.py.

Inputs are made with numpy from a seed and go through both. Tolerances:
float32 on both sides with the same formulas, so 1e-5 relative on sums
and means; ave_rot and the other quaternion angles 1e-3 degrees, since
arccos near 1 turns a float32 rounding of the dot product (6e-8) into up
to 0.02 degrees at a residue whose angle is near 0; Kabsch alignments 1e-4
absolute at a coordinate scale of 10 (two SVDs of 3x3 matrices, LAPACK's
against XLA's). The writers are held byte for byte against the JAX
package's files."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.analysis import decomposition as jdec
from dynamicpdb_tpu.analysis import interactive as jiv
from dynamicpdb_tpu.analysis import metrics as jm
from dynamicpdb_tpu.analysis import pdb_io as jpdb
from dynamicpdb_tpu.data.featurize import featurize_window as j_featurize
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.preprocess import dcd as jdcd
from dynamicpdb_tpu_torch.analysis import decomposition as pdec
from dynamicpdb_tpu_torch.analysis import interactive as piv
from dynamicpdb_tpu_torch.analysis import metrics as pm
from dynamicpdb_tpu_torch.analysis import pdb_io as ppdb
from dynamicpdb_tpu_torch.data.featurize import featurize_window as p_featurize
from dynamicpdb_tpu_torch.preprocess import dcd as pdcd

torch.set_num_threads(1)

ANGLE_ATOL = 1e-3  # degrees
RTOL = 1e-5
ALIGN_ATOL = 1e-4


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               equal_nan=True)


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mask(rng, shape, p=0.25):
    return (rng.uniform(size=shape) > p).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_rigid_frame_errors(masked):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, (3, 11)), _quats(rng, (3, 11))
    # a residue whose two quaternions are equal up to sign: the angle is 0
    q2[0, 0] = -q1[0, 0]
    t1 = (5 * rng.normal(size=(3, 11, 3))).astype(np.float32)
    t2 = (5 * rng.normal(size=(3, 11, 3))).astype(np.float32)
    mask = _mask(rng, (11,)) if masked else None
    pmask = None if mask is None else _t(mask)
    _close(pm.quaternion_distance_deg(_t(q1), _t(q2)),
           jm.quaternion_distance_deg(q1, q2), atol=ANGLE_ATOL)
    _close(pm.average_quaternion_distances(_t(q1), _t(q2), pmask),
           jm.average_quaternion_distances(q1, q2, mask), atol=ANGLE_ATOL)
    for measurement in ("MAE", "MSE"):
        _close(pm.average_translation_distances(_t(t1), _t(t2), measurement,
                                                pmask),
               jm.average_translation_distances(t1, t2, measurement, mask))


def test_masked_atom_error():
    rng = np.random.default_rng(1)
    a = (3 * rng.normal(size=(2, 9, 37, 3))).astype(np.float32)
    b = (3 * rng.normal(size=(2, 9, 37, 3))).astype(np.float32)
    m = _mask(rng, (2, 9, 37), 0.5)
    for got, want in zip(pm.masked_atom_error(_t(a), _t(b), _t(m)),
                         jm.masked_atom_error(a, b, m)):
        _close(got, want)


def _clouds(case, rng):
    """(a, b, weights) for a Kabsch case."""
    a = (10 * rng.normal(size=(2, 17, 3))).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))
    b = (a @ rot.T + rng.normal(size=3) + 0.3 * rng.normal(size=a.shape))
    w = None
    if case == "weighted":
        w = _mask(rng, (2, 17))
    elif case == "reflected":
        b = b * np.array([1.0, 1.0, -1.0])  # only a reflection would fit
    elif case == "collinear":
        line = rng.normal(size=3)
        a = (np.linspace(-5, 5, 17)[:, None] * line + 1.0)[None].repeat(2, 0)
        b = a @ rot.T + 2.0
    elif case == "all-pad":
        w = np.zeros((2, 17), np.float32)
        w[0] = 1.0  # frame 1 is all pad: 0/0 in the means, NaN as in JAX
    return a.astype(np.float32), b.astype(np.float32), w


@pytest.mark.parametrize("case", ["plain", "weighted", "reflected",
                                  "collinear", "all-pad"])
def test_kabsch_and_superimposed_rmsd(case):
    a, b, w = _clouds(case, np.random.default_rng(2))
    pw = None if w is None else _t(w)
    got = pm.kabsch_align(_t(a), _t(b), pw)
    want = jm.kabsch_align(a, b, w)
    _close(got, want, rtol=0, atol=ALIGN_ATOL)
    _close(pm.superimposed_rmsd(_t(b), _t(a), pw),
           jm.superimposed_rmsd(b, a, w), rtol=0, atol=ALIGN_ATOL)
    if case == "all-pad":
        assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()


def test_superimposed_rmsd_atom37_rmsd_and_drmsd():
    rng = np.random.default_rng(3)
    a = (8 * rng.normal(size=(2, 10, 37, 3))).astype(np.float32)
    b = (a + rng.normal(size=a.shape)).astype(np.float32)
    m = _mask(rng, (2, 10, 37), 0.6)
    _close(pm.superimposed_rmsd_atom37(_t(b), _t(a), _t(m)),
           jm.superimposed_rmsd_atom37(b, a, m), rtol=0, atol=ALIGN_ATOL)
    ca, cb, cm = a[..., 1, :], b[..., 1, :], m[..., 1]
    for mask in (None, cm):
        pmask = None if mask is None else _t(mask)
        _close(pm.rmsd(_t(cb), _t(ca), pmask), jm.rmsd(cb, ca, mask))
        _close(pm.drmsd(_t(cb), _t(ca), pmask), jm.drmsd(cb, ca, mask))


@pytest.mark.parametrize("frames", [3, 1])
def test_eval_window_metrics(frames):
    """Every metric of the summary; with one frame the RefAsPred baselines
    are NaN on both sides (JAX checks F < 2 explicitly; torch would raise
    on index -2)."""
    rng = np.random.default_rng(4)
    n = 12
    pred_r = np.concatenate([_quats(rng, (frames, n)),
                             5 * rng.normal(size=(frames, n, 3))], -1)
    gt_r = np.concatenate([_quats(rng, (frames, n)),
                           5 * rng.normal(size=(frames, n, 3))], -1)
    pred_a = (8 * rng.normal(size=(frames, n, 37, 3))).astype(np.float32)
    gt_a = (pred_a + rng.normal(size=pred_a.shape)).astype(np.float32)
    m37 = np.broadcast_to(_mask(rng, (n, 37), 0.5), (frames, n, 37)).copy()
    m37[:, -2:] = 0.0  # two pad residues
    m37[:, :-2, 1] = 1.0
    res = m37[..., 1]
    args = [x.astype(np.float32) for x in (pred_r, pred_a, gt_r, gt_a, m37)]
    got = pm.eval_window_metrics(*map(_t, args), res_mask=_t(res))
    want = jax.jit(jm.eval_window_metrics)(*args, res_mask=res)
    assert sorted(got) == sorted(want)
    for k in want:
        atol = ANGLE_ATOL if "rot" in k else (ALIGN_ATOL if "rmsd" in k
                                              else 1e-6)
        _close(got[k], want[k], atol=atol)
    assert np.isnan(float(got["ref_ave_rot"])) == (frames == 1)


# ---------------------------------------------------------------------------
# writers: byte for byte
# ---------------------------------------------------------------------------
def _structure(rng, frames, n):
    aatype = rng.integers(0, 20, n).astype(np.int32)
    atom37 = (10 * rng.normal(size=(frames, n, 37, 3))).astype(np.float32)
    return atom37, aatype


@pytest.mark.parametrize("frames,with_mask", [(1, False), (3, True)])
def test_pdb_writer_and_reader(tmp_path, frames, with_mask):
    rng = np.random.default_rng(5)
    atom37, aatype = _structure(rng, frames, 7)
    mask = _mask(rng, (7, 37), 0.3) if with_mask else None
    a, b = str(tmp_path / "port.pdb"), str(tmp_path / "jax.pdb")
    ppdb.write_pdb(a, atom37 if frames > 1 else atom37[0], aatype, mask)
    jpdb.write_pdb(b, atom37 if frames > 1 else atom37[0], aatype, mask)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for got, want in zip(ppdb.read_pdb(a), jpdb.read_pdb(b)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [None, (30.0, 31.5, 29.25)])
def test_dcd_writer_and_reader(tmp_path, box):
    rng = np.random.default_rng(6)
    xyz = (20 * rng.normal(size=(4, 23, 3))).astype(np.float32)
    a, b = str(tmp_path / "port.dcd"), str(tmp_path / "jax.dcd")
    pdcd.write_dcd(a, xyz, box_lengths=box, timestep_ps=2.0)
    jdcd.write_dcd(b, xyz, box_lengths=box, timestep_ps=2.0)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, want = pdcd.read_dcd(a), jdcd.read_dcd(b)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["xyz"], xyz)


def test_dcd_reader_refuses_what_is_not_a_dcd(tmp_path):
    path = tmp_path / "x.dcd"
    path.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="not a DCD"):
        pdcd.read_dcd(str(path))


def test_comparison_html(tmp_path):
    rng = np.random.default_rng(7)
    pred, gt = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    title = "p0</script>: predicted vs GT (CA)"
    a, b = str(tmp_path / "port.html"), str(tmp_path / "jax.html")
    piv.write_html(piv.comparison_figure(pred, gt, title=title), a)
    jiv.write_html(jiv.comparison_figure(pred, gt, title=title), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# the all-atom error decomposition
# ---------------------------------------------------------------------------
def test_atom_error_decomposition():
    w = make_window(n_res=9, frame_time=2, seed=8, rot_wiggle=0.2)
    keys = ("atom37", "atom37_mask", "aatype", "residue_index", "force",
            "vel", "node_repr", "edge_repr")
    jf = jax.jit(j_featurize)({k: jnp.asarray(w[k]) for k in keys})
    pf = p_featurize({k: torch.as_tensor(w[k]) for k in keys})
    rng = np.random.default_rng(9)
    pred_r = np.asarray(jf["rigids_0"]).copy()
    pred_r[..., 4:] += rng.normal(size=pred_r[..., 4:].shape) * 0.5
    ang = np.asarray(jf["torsion_angles_sin_cos"])
    pred_a = (ang + 0.2 * rng.normal(size=ang.shape)).astype(np.float32)
    got = pdec.atom_error_decomposition(
        pf, {"rigids": _t(pred_r.astype(np.float32)), "angles": _t(pred_a)})
    want = jax.jit(jdec.atom_error_decomposition)(
        jf, {"rigids": jnp.asarray(pred_r, jnp.float32),
             "angles": jnp.asarray(pred_a)})
    assert sorted(got) == sorted(want) == sorted(
        ("floor", "rigids_only", "torsion_only", "model"))
    for part in want:
        for m in ("mae", "rmsd"):
            _close(got[part][m], want[part][m], rtol=1e-4, atol=ALIGN_ATOL)
    assert float(got["model"]["mae"]) > float(got["floor"]["mae"])
    assert sorted(pdec.atom_error_decomposition(pf)) == ["floor"]

"""Analysis in the PyTorch port against the JAX package, on the CPU: the AF2
violation metrics (``analysis/violations.py``), the structure checks
(TM-score, Kabsch-Sander DSSP, radius of gyration, ``protein_metrics``),
contact order (torch there, jnp in JAX), plotting (skipped without
matplotlib) and the interactive figures.

Tolerances: the numpy modules run the same code on the same inputs, so
every value is equal; contact order sums float32 separations in another
order than XLA does, 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.analysis import contact_order as jco
from dynamicpdb_tpu.analysis import interactive as jiv
from dynamicpdb_tpu.analysis import structure_checks as jsc
from dynamicpdb_tpu.analysis import violations as jviol
from dynamicpdb_tpu_torch.analysis import contact_order as co
from dynamicpdb_tpu_torch.analysis import interactive as iv
from dynamicpdb_tpu_torch.analysis import structure_checks as sc
from dynamicpdb_tpu_torch.analysis import violations as viol
from dynamicpdb_tpu_torch.chem import constants as chem
from dynamicpdb_tpu_torch.data.synthetic import make_window

torch.set_num_threads(1)


def structure(n_res: int, seed: int, noise: float = 0.3):
    """atom37 frames of a synthetic helix with noise, a PRO and a CYS pair,
    one residue missing its side chain and a gap in residue_index."""
    w = make_window(n_res=n_res, frame_time=2, node_dim=1, edge_dim=1,
                    seed=seed)
    rng = np.random.default_rng(seed)
    aatype = w["aatype"].astype(np.int64)
    aatype[[2, 5, 9]] = [chem.RESTYPE_ORDER["P"], chem.RESTYPE_ORDER["C"],
                         chem.RESTYPE_ORDER["C"]]
    mask = np.asarray(chem.restype_atom37_mask, np.float32)[aatype]
    mask[4, 5:] = 0.0
    atom37 = (w["atom37"] + noise * rng.normal(size=w["atom37"].shape)) \
        * mask[None, ..., None]
    ridx = np.arange(n_res, dtype=np.int64)
    ridx[n_res // 2:] += 3
    return atom37.astype(np.float32), mask, aatype, ridx


def assert_tree_equal(got, want, path="out"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
        assert type(got) is type(want) or isinstance(got, np.ndarray), path


@pytest.mark.parametrize("seed", [0, 1])
def test_violations_match_jax(seed):
    atom37, mask, aatype, ridx = structure(20, seed)
    a14 = viol.atom37_to_atom14(atom37[0], mask, aatype)
    assert_tree_equal(a14, jviol.atom37_to_atom14(atom37[0], mask, aatype))
    got = viol.compute_violation_metrics(atom37[0], mask, aatype, ridx)
    want = jviol.compute_violation_metrics(atom37[0], mask, aatype, ridx)
    assert_tree_equal(got, want)
    assert got["num_residue_violations"] > 0  # the noise breaks bonds
    seq_mask = np.ones(20, np.float32)
    seq_mask[-3:] = 0
    assert_tree_equal(
        viol.compute_violation_metrics(atom37[1], mask, aatype, ridx,
                                       seq_mask),
        jviol.compute_violation_metrics(atom37[1], mask, aatype, ridx,
                                        seq_mask))


@pytest.mark.parametrize("n_res", [1, 2, 3, 12, 24])
def test_structure_checks_match_jax(n_res):
    atom37, mask, aatype, ridx = structure(max(n_res, 10), 2)
    atom37, mask, aatype, ridx = (atom37[:, :n_res], mask[:n_res],
                                  aatype[:n_res], ridx[:n_res])
    pred, gt = atom37[0], atom37[1] + 0.5
    same = np.testing.assert_equal  # NaN equals NaN (a chain of one)
    same(sc.tm_score(pred[:, 1], gt[:, 1]), jsc.tm_score(pred[:, 1], gt[:, 1]))
    same(sc.radius_of_gyration(pred, mask), jsc.radius_of_gyration(pred, mask))
    assert_tree_equal(sc.assign_secondary_structure(pred, mask),
                      jsc.assign_secondary_structure(pred, mask))
    same(sc.secondary_structure_fractions(pred),
         jsc.secondary_structure_fractions(pred))
    same(sc.ca_ca_distance(pred[:, 1]), jsc.ca_ca_distance(pred[:, 1]))
    same(sc.ca_ca_clashes(pred[:, 1]), jsc.ca_ca_clashes(pred[:, 1]))
    got = sc.protein_metrics(pred, mask, gt, aatype, ridx)
    same(got, jsc.protein_metrics(pred, mask, gt, aatype, ridx))
    assert "violations_per_residue" in got and "tm_score" in got
    same(sc.protein_metrics(pred, mask), jsc.protein_metrics(pred, mask))


def test_dssp_finds_the_helix_as_jax_does():
    """A realistic window's backbone (data/realistic.py): both assign the
    same classes, a helix among them."""
    from dynamicpdb_tpu_torch.data.realistic import make_realistic_window

    w = make_realistic_window(n_res=16, frame_time=1, seed=0)
    x, m = w["atom37"][0], w["atom37_mask"]
    got = sc.assign_secondary_structure(x, m)
    assert_tree_equal(got, jsc.assign_secondary_structure(x, m))
    assert (got == "H").sum() >= 4


@pytest.mark.parametrize("cutoff,min_sep", [(8.0, 1), (6.0, 3)])
def test_contact_order_matches_jax(cutoff, min_sep):
    atom37, *_ = structure(30, 4, noise=1.0)
    ca = atom37[:, :, 1]  # [2, N, 3]: a leading batch axis
    got = co.contact_order(torch.as_tensor(ca), cutoff, min_sep)
    want = np.asarray(jco.contact_order(ca, cutoff, min_sep))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        co.contact_matrix(torch.as_tensor(ca), cutoff, min_sep).numpy(),
        np.asarray(jco.contact_matrix(ca, cutoff, min_sep)))
    assert float(got.min()) > 0


def test_interactive_figures_match_jax():
    rng = np.random.default_rng(0)
    ca = rng.normal(size=(3, 5, 3))
    forces = rng.normal(size=(3, 5, 3))
    assert iv.cones(ca[0], forces[0], name="f", opacity=0.5, sizeref=2.0) \
        == jiv.cones(ca[0], forces[0], name="f", opacity=0.5, sizeref=2.0)
    assert iv.dynamic_layout(title="t", scene_range=(-1, 1), frame_ms=10) \
        == jiv.dynamic_layout(title="t", scene_range=(-1, 1), frame_ms=10)
    for kw in ({}, {"forces": forces, "stride": 2, "title": "x"}):
        assert iv.trajectory_figure(ca, **kw) == jiv.trajectory_figure(ca, **kw)
    atom37 = rng.normal(size=(2, 5, 37, 3))
    assert iv.to_json(iv.trajectory_figure(atom37)) == jiv.to_json(
        jiv.trajectory_figure(atom37))


def test_plotting_writes_the_files_jax_writes(tmp_path):
    pytest.importorskip("matplotlib")
    from dynamicpdb_tpu_torch.analysis import plotting

    rng = np.random.default_rng(0)
    traj = rng.normal(size=(3, 6, 37, 3))
    rigids = np.concatenate([np.tile([1.0, 0, 0, 0], (6, 1)),
                             rng.normal(size=(6, 3))], -1)
    history = [{"step": i, "time": 0.0, "loss": 1.0 / (i + 1)}
               for i in range(4)]
    paths = [
        plotting.plot_loss_curves(history, str(tmp_path / "a" / "loss.png")),
        plotting.plot_rot_trans_curves({"rot": [1, 2], "ref_rot": [2, 2],
                                        "trans": [0.1, 0.2]},
                                       str(tmp_path / "rt.png")),
        plotting.plot_ca_trace(traj, str(tmp_path / "ca.png")),
        plotting.plot_sample_grid(traj, str(tmp_path / "grid.png"),
                                  true_bb=traj[0]),
        plotting.viz_frames(rigids, str(tmp_path / "frames.png"), title="f"),
        plotting.write_traj_animation(traj, str(tmp_path / "t.gif")),
    ]
    for p in paths:
        assert p.startswith(str(tmp_path)) and open(p, "rb").read(4)


def test_chip_smoke_score_phase_rehearsal():
    """chip_smoke.py's phase 11e on the CPU, on served trajectories of
    noisy synthetic frames: its key sets are JAX's, every metric finite."""
    import chip_smoke

    results = []
    for n, fast in ((14, 0), (12, 0), (12, 1)):
        atom37, mask, aatype, ridx = structure(n, n)
        results.append(dict(n=n, fast_x0=fast, aatype=aatype,
                            out={"atom_traj": atom37}))
    chip_smoke.score_phase(torch, results, device="cpu", lengths=(14, 12))
    atom37, mask, aatype, ridx = structure(14, 14)
    vm = jviol.compute_violation_metrics(atom37[1], mask, aatype, ridx)
    pm = jsc.protein_metrics(atom37[1], mask, atom37[0], aatype, ridx)
    assert chip_smoke.VIOLATION_KEYS == set(vm)
    assert chip_smoke.PROTEIN_METRIC_KEYS == set(pm)

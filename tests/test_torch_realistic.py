"""The port's data side against the JAX package, on the CPU: the three
``ops/frames`` functions the realistic generator and the violation
metrics use, the realistic window generator (``data/realistic.py``) helper
by helper and whole, mmCIF read and write across the two packages, and
``StaticPdbDataset`` on ``.npz``, ``.cif`` and ``.pdb`` inputs.

Tolerances: the frames functions 1e-5 of the coordinates' scale (float32,
gathers and a few products in another order). The realistic generator's
numpy parts are the same code on the same draws, so they are held equal;
its geometry runs through torch here and XLA there, so the coordinates it
builds are held to 1e-6 of their scale (a few float32 ulps; measured
7.6e-6 A at most, on coordinates of tens of A) and every decision the
generator takes from them (the clash tests, the rotamers, the chi angles)
must come out the same. mmCIF and the static datasets are numpy on both
sides and held equal."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.analysis import pdb_io as jpdb
from dynamicpdb_tpu.data import dataset as jdata
from dynamicpdb_tpu.data import realistic as jreal
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.ops import frames as jframes
from dynamicpdb_tpu.ops.rigid import Rigid as JRigid
from dynamicpdb_tpu.preprocess import mmcif as jmmcif
from dynamicpdb_tpu_torch.data import dataset as pdata
from dynamicpdb_tpu_torch.data import realistic as preal
from dynamicpdb_tpu_torch.ops import frames as pframes
from dynamicpdb_tpu_torch.ops.rigid import Rigid as PRigid
from dynamicpdb_tpu_torch.preprocess import mmcif as pmmcif

torch.set_num_threads(1)

FRAMES_REL = 1e-5
GEOM_REL = 1e-6


def _close(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def _frames_inputs(seed, n=13, frames=2):
    rng = np.random.default_rng(seed)
    aatype = rng.integers(0, 21, n).astype(np.int32)
    q = rng.normal(size=(frames, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = (rng.normal(size=(frames, n, 3)) * 5).astype(np.float32)
    ang = rng.normal(size=(frames, n, 7, 2)).astype(np.float32)
    return aatype, q, t, ang


# ---------------------------------------------------------------------------
# ops/frames
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_frames_to_atom37_pos_and_compute_backbone_atom37(seed):
    aatype, q, t, ang = _frames_inputs(seed)
    ab = np.tile(aatype, (q.shape[0], 1))  # aatype per frame
    jbb, pbb = JRigid(jnp.asarray(q), jnp.asarray(t)), PRigid(
        torch.as_tensor(q), torch.as_tensor(t))
    jf8 = jframes.torsion_angles_to_frames(jbb, jnp.asarray(ang),
                                           jnp.asarray(ab))
    pab = torch.as_tensor(ab).long()
    pf8 = pframes.torsion_angles_to_frames(pbb, torch.as_tensor(ang), pab)
    _close(pframes.frames_to_atom37_pos(pf8, pab),
           jframes.frames_to_atom37_pos(jf8, jnp.asarray(ab)), FRAMES_REL)
    want, wmask = jframes.compute_backbone_atom37(jbb, jnp.asarray(ab),
                                                  jnp.asarray(ang))
    got, gmask = pframes.compute_backbone_atom37(pbb, pab,
                                                 torch.as_tensor(ang))
    _close(got, want, FRAMES_REL)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert gmask.dtype == torch.bool and gmask.shape == (2, 13, 37)


@pytest.mark.parametrize("seed", [0, 1])
def test_atom37_to_atom14(seed):
    rng = np.random.default_rng(seed)
    n = 13
    aatype = rng.integers(0, 21, n).astype(np.int32)
    atom37 = rng.normal(size=(n, 37, 3)).astype(np.float32)
    mask = (rng.random((n, 37)) > 0.3).astype(np.float32)
    want, wexists = jframes.atom37_to_atom14(
        jnp.asarray(atom37), jnp.asarray(aatype), jnp.asarray(mask))
    got, gexists = pframes.atom37_to_atom14(
        torch.as_tensor(atom37), torch.as_tensor(aatype).long(),
        torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gexists.numpy(), np.asarray(wexists))
    # frames of leading dims broadcast against one residue-type row
    got2, _ = pframes.atom37_to_atom14(
        torch.as_tensor(np.stack([atom37, atom37])),
        torch.as_tensor(aatype).long(), torch.as_tensor(mask))
    assert torch.equal(got2[1], got)


# ---------------------------------------------------------------------------
# data/realistic: helpers on identical inputs, then whole windows
# ---------------------------------------------------------------------------
def test_numpy_geometry_helpers_are_the_jax_packages():
    rng = np.random.default_rng(3)
    a, b, c = (rng.normal(size=(5, 3)) for _ in range(3))
    args = (a, b, c, 1.5, 110.0, rng.uniform(-180, 180, 5))
    np.testing.assert_array_equal(preal.nerf_extend(*args),
                                  jreal.nerf_extend(*args))
    d = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(preal.dihedral(a, b, c, d),
                                  jreal.dihedral(a, b, c, d))
    np.testing.assert_array_equal(preal.ideal_cb(a, b, c),
                                  jreal.ideal_cb(a, b, c))
    ss = jreal.sample_ss_plan(np.random.default_rng(1), 40)
    assert preal.sample_ss_plan(np.random.default_rng(1), 40) == ss
    for got, want in zip(
            preal.sample_backbone_torsions(np.random.default_rng(2), ss),
            jreal.sample_backbone_torsions(np.random.default_rng(2), ss)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            preal.build_self_avoiding_backbone(np.random.default_rng(4), ss),
            jreal.build_self_avoiding_backbone(np.random.default_rng(4), ss)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def backbone():
    rng = np.random.default_rng(5)
    n = 20
    aatype = rng.integers(0, 20, n).astype(np.int32)
    ss = jreal.sample_ss_plan(rng, n)
    phi, psi, omega = jreal.build_self_avoiding_backbone(rng, ss)
    N, CA, C = jreal.build_backbone(phi, psi, omega)
    chi = rng.uniform(-180, 180, (n, 4))
    return aatype, N, CA, C, psi, chi


def test_torch_geometry_pipelines_match_jax(backbone):
    """The three pipelines the JAX package jits, here on ops/frames."""
    aatype, N, CA, C, psi, chi = backbone
    want_bb = jreal._backbone_rigid(aatype, N, CA, C)
    got_bb = preal._backbone_rigid(aatype, N, CA, C)
    for g, w in zip(got_bb, want_bb):
        _close(g, w, GEOM_REL)
    _close(preal._psi_group_angles(aatype, N, CA, C, psi),
           jreal._psi_group_angles(aatype, N, CA, C, psi), GEOM_REL)
    got, gmask = preal._all_atom_from_torsions(aatype, N, CA, C, psi, chi)
    want, wmask = jreal._all_atom_from_torsions(aatype, N, CA, C, psi, chi)
    _close(got, want, GEOM_REL)
    np.testing.assert_array_equal(gmask, wmask)
    assert got.dtype == np.float32


def test_pack_sidechains_takes_the_jax_packages_decisions(backbone):
    aatype, N, CA, C, psi, _ = backbone
    got = preal.pack_sidechains(np.random.default_rng(7), aatype, N, CA, C,
                                psi)
    want = jreal.pack_sidechains(np.random.default_rng(7), aatype, N, CA, C,
                                 psi)
    np.testing.assert_array_equal(got, want)


GEOMETRY_KEYS = ("atom37", "vel", "force")


@pytest.mark.parametrize("seed,n_res", [(0, 16), (1, 24), (2, 32), (3, 20)])
def test_make_realistic_window_matches_jax(seed, n_res):
    kw = dict(n_res=n_res, seed=seed, frame_time=3, node_dim=8, edge_dim=4)
    got = preal.make_realistic_window(**kw)
    want = jreal.make_realistic_window(**kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in GEOMETRY_KEYS:
            _close(g, w, GEOM_REL, k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_realistic_window_featurizes_in_the_port():
    from dynamicpdb_tpu_torch.data.featurize import featurize_window

    w = preal.make_realistic_window(n_res=12, frame_time=2, seed=1,
                                    node_dim=8, edge_dim=4)
    feats = featurize_window({k: torch.as_tensor(w[k]) for k in (
        "atom37", "atom37_mask", "aatype", "residue_index", "force", "vel",
        "node_repr", "edge_repr")})
    assert feats["rigids_0"].shape == (2, 12, 7)
    assert torch.isfinite(feats["torsion_angles_sin_cos"]).all()
    # the frames rotate between the two frames (torsion-space dynamics)
    q = feats["rigids_0"][..., :4]
    assert float((q[0] - q[1]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# mmCIF
# ---------------------------------------------------------------------------
def _chains_equal(got, want):
    assert got.resolution == want.resolution
    assert sorted(got.chains) == sorted(want.chains)
    for cid, w in want.chains.items():
        g = got.chains[cid]
        assert g.sequence == w.sequence
        for k in ("aatype", "atom37", "atom37_mask", "residue_index"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k),
                                          err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mmcif_written_by_one_package_parses_in_the_other(tmp_path, writer):
    w = make_window(n_res=11, frame_time=1, seed=2)
    write, parsers = ((jmmcif.write_mmcif, (pmmcif, jmmcif))
                      if writer == "jax" else
                      (pmmcif.write_mmcif, (jmmcif, pmmcif)))
    path = str(tmp_path / "x.cif")
    write(path, w["atom37"][0], w["atom37_mask"], w["aatype"],
          chain_id="B", resolution=2.1)
    other, same = (p.parse_mmcif(path) for p in parsers)
    _chains_equal(other, same)
    assert other.file_id == "x" and other.resolution == 2.1
    np.testing.assert_allclose(other.chains["B"].atom37,
                               w["atom37"][0] * w["atom37_mask"][..., None],
                               atol=5e-4)


def test_mmcif_writers_write_the_same_file(tmp_path):
    w = make_window(n_res=7, frame_time=1, seed=4)
    a, b = str(tmp_path / "a.cif"), str(tmp_path / "a2.cif")
    jmmcif.write_mmcif(a, w["atom37"][0], w["atom37_mask"], w["aatype"])
    pmmcif.write_mmcif(b, w["atom37"][0], w["atom37_mask"], w["aatype"])
    with open(a) as fa, open(b) as fb:
        assert fa.read().replace("data_a\n", "") == fb.read().replace(
            "data_a2\n", "")


PDBX = """data_1XYZ
#
_refine.ls_d_res_high 1.80
#
loop_
_atom_site.group_PDB
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.label_asym_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.pdbx_PDB_ins_code
_atom_site.label_alt_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.pdbx_PDB_model_num
ATOM N ALA A A 1 . . 0.0 0.0 0.0 1
ATOM CA ALA A A 1 . . 1.458 0.0 0.0 1
ATOM "C" ALA A A 1 . . 2.0 1.4 0.0 1
ATOM N GLY A A 2 . A 3.3 1.5 0.0 1
ATOM N GLY A A 2 . B 9.9 9.9 9.9 1
ATOM CA GLY A A 2 A . 4.0 2.7 0.0 1
HETATM SE MSE A A 3 . . 5.0 3.0 0.1 1
HETATM O HOH A A 4 . . 7.0 7.0 7.0 1
ATOM N LYS C C 5 . . 1.0 2.0 3.0 2
ATOM N 'SER' C C
7 . . 1.0 1.0 1.0 1
#
"""


@pytest.mark.parametrize("gz", [False, True], ids=["cif", "cif.gz"])
def test_parse_mmcif_matches_jax_on_pdbx_features(tmp_path, gz):
    """Quoted tokens, a row continued on the next line, insertion codes,
    alternate locations, a modified residue, waters and a second model."""
    import gzip

    path = tmp_path / ("1xyz.cif.gz" if gz else "1xyz.cif")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(PDBX)
    else:
        path.write_text(PDBX)
    got, want = pmmcif.parse_mmcif(str(path)), jmmcif.parse_mmcif(str(path))
    _chains_equal(got, want)
    assert got.chains["A"].sequence == want.chains["A"].sequence == "AGGM"
    assert pmmcif._tokenize("a 'b c' \"d'e\" f") == jmmcif._tokenize(
        "a 'b c' \"d'e\" f")


def test_process_mmcif_dir_matches_jax(tmp_path):
    src = tmp_path / "cif"
    src.mkdir()
    for i, n in enumerate((9, 30, 12)):
        w = make_window(n_res=n, frame_time=1, seed=i)
        jmmcif.write_mmcif(str(src / f"p{i}.cif"), w["atom37"][0],
                           w["atom37_mask"], w["aatype"],
                           resolution=[2.0, 2.0, 6.0][i])
    kw = dict(max_len=20, min_file_size=10)
    got = pmmcif.process_mmcif_dir(str(src), str(tmp_path / "port"), **kw)
    want = jmmcif.process_mmcif_dir(str(src), str(tmp_path / "jax"), **kw)
    assert len(got) == len(want) == 1  # too long and too coarse skipped
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "npz_path"} == {
            k: v for k, v in w.items() if k != "npz_path"}
        with np.load(g["npz_path"]) as zg, np.load(w["npz_path"]) as zw:
            assert sorted(zg.files) == sorted(zw.files)
            for k in zw.files:
                np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
    with open(tmp_path / "port" / "metadata.csv") as a, \
            open(tmp_path / "jax" / "metadata.csv") as b:
        assert a.read().replace("port", "X") == b.read().replace("jax", "X")


# ---------------------------------------------------------------------------
# StaticPdbDataset
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def structures(tmp_path_factory):
    d = tmp_path_factory.mktemp("static")
    w = make_window(n_res=9, frame_time=1, seed=8)
    pdb = str(d / "x.pdb")
    jpdb.write_pdb(pdb, w["atom37"][0], w["aatype"], w["atom37_mask"])
    cif = str(d / "y.cif")
    jmmcif.write_mmcif(cif, w["atom37"][0], w["atom37_mask"], w["aatype"],
                       residue_index=np.arange(3, 12))
    (d / "cif").mkdir()
    jmmcif.write_mmcif(str(d / "cif" / "z.cif"), w["atom37"][0],
                       w["atom37_mask"], w["aatype"])
    npz = jmmcif.process_mmcif_dir(str(d / "cif"), str(d / "npz"),
                                   min_file_size=10)[0]["npz_path"]
    rng = np.random.default_rng(0)
    embeds = []
    for i in range(3):
        e = str(d / f"e{i}.npz")
        np.savez(e, node_repr=rng.normal(size=(9, 256)).astype(np.float32),
                 edge_repr=rng.normal(size=(9, 9, 128)).astype(np.float32))
        embeds.append(e)
    return [npz, cif, pdb], embeds


@pytest.mark.parametrize("embed", [False, True], ids=["zero-embed", "embed"])
@pytest.mark.parametrize("pad_to", [None, 12], ids=["exact", "padded"])
def test_static_pdb_dataset_matches_jax(structures, pad_to, embed):
    paths, embeds = structures
    kw = dict(frame_time=3, pad_to=pad_to,
              embed_paths=embeds if embed else None)
    got_ds = pdata.StaticPdbDataset(paths, **kw)
    want_ds = jdata.StaticPdbDataset(paths, **kw)
    assert len(got_ds) == len(want_ds) == 3
    for i, suffix in enumerate((".npz", ".cif", ".pdb")):
        assert paths[i].endswith(suffix)
        got, want = got_ds.get_window(i), want_ds.get_window(i)
        assert sorted(got) == sorted(want)
        assert got.pop("name") == want.pop("name")
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=f"{suffix} {k}")
        n = pad_to or 9
        assert got["atom37"].shape == (3, n, 37, 3)
        np.testing.assert_array_equal(got["atom37"][0], got["atom37"][2])


def test_static_window_featurizes_in_the_port(structures):
    from dynamicpdb_tpu_torch.data.featurize import featurize_window

    raw = pdata.StaticPdbDataset(structures[0], frame_time=3,
                                 pad_to=12).get_window(2)
    assert raw.pop("name") == "x"
    feats = featurize_window({k: torch.as_tensor(v) for k, v in raw.items()})
    assert feats["rigids_0"].shape == (3, 12, 7)
    assert os.path.basename(structures[0][0]) == "z_A.npz"

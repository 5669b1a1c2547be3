"""Ingestion in the PyTorch port against the JAX package, on the CPU: the
periodic-box unwrap (``preprocess/pbc.py``), the MD state tables
(``preprocess/energies.py``), packing (``preprocess/pack.py``), the DCD
segments and CLIs (``preprocess/dcd.py``), and the port's
``tools/ingest_release.py`` against the repository's JAX tool on a
synthetic release directory (``data/synthetic.write_release_protein``).

Tolerances: the numpy code is the same code on the same inputs, so every
array, printed line and written byte must be equal. The OmegaFold
embeddings of ``--weights`` are float32 through the PLM, two GeoFormer
blocks, the structure module and ten recycles on each side:
``test_torch_extract``'s bar, 1e-4 of their scale; against a direct
``omegafold_embed`` of the same sequence in the port, bit-equal.
"""
import csv
import gzip
import logging
import os
import pickle
import shutil
import zlib

import numpy as np
import pytest
import torch

from dynamicpdb_tpu.preprocess import dcd as jdcd
from dynamicpdb_tpu.preprocess import energies as jenergies
from dynamicpdb_tpu.preprocess import pack as jpack
from dynamicpdb_tpu.preprocess import pbc as jpbc
from dynamicpdb_tpu_torch.data.synthetic import (
    STATEDATA_HEADER,
    write_release_protein,
)
from dynamicpdb_tpu_torch.preprocess import dcd, energies, pack, pbc
from dynamicpdb_tpu_torch.tools import ingest_release

torch.set_num_threads(1)

N_RES, N_FRAMES, BOX = 12, 8, 60.0
GOOD, DCD_ONLY, BROKEN = "1abc_A", "2def_B", "3bad_C"


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A release root with three proteins: segmented pickles and a gzipped
    State XML; a combined DCD and no XML (packs without unwrapping); a
    topology alone (skipped)."""
    root = tmp_path_factory.mktemp("release") / "dynamicPDB"
    good = write_release_protein(str(root), GOOD, n_res=N_RES,
                                 n_frames=N_FRAMES, seed=0, box=BOX)
    other = write_release_protein(str(root), DCD_ONLY, n_res=9,
                                  n_frames=N_FRAMES, seed=1, box=BOX)
    d = other["dir"]
    with open(os.path.join(d, f"{DCD_ONLY}_T", f"{DCD_ONLY}_T_0.pkl"),
              "rb") as f:
        first = pickle.load(f)
    shutil.rmtree(os.path.join(d, f"{DCD_ONLY}_T"))
    os.remove(os.path.join(d, f"{DCD_ONLY}_state_npt100000.0.xml.gz"))
    dcd.write_dcd(os.path.join(d, f"{DCD_ONLY}_T.dcd"),
                  np.concatenate([first] * 4))
    bad = write_release_protein(str(root), BROKEN, n_res=7, n_frames=4,
                                seed=2)
    shutil.rmtree(os.path.join(bad["dir"], f"{BROKEN}_T"))
    (root / "assets").mkdir()  # not a protein: ignored
    return dict(root=str(root), good=good, other=other)


def assert_npz_equal(a: str, b: str, close=()):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k in close:
                scale = max(float(np.abs(zb[k]).max()), 1.0)
                np.testing.assert_allclose(za[k], zb[k], rtol=0,
                                           atol=1e-4 * scale, err_msg=k)
            else:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# ---------------------------------------------------------------------------
# pbc
# ---------------------------------------------------------------------------
def test_unwrap_matches_jax():
    rng = np.random.default_rng(0)
    pos = np.cumsum(rng.normal(size=(10, 6, 3)) * 0.5, axis=0)
    pos[4:, :, 0] += 30.0  # the whole molecule crosses a face
    pos[7:, 2, 1] -= 30.0  # one atom crosses another
    for box in (30.0, [30.0, 30.0, 40.0]):
        for fn in ("unwrap_trajectory", "unwrap_per_atom"):
            np.testing.assert_array_equal(getattr(pbc, fn)(pos, box),
                                          getattr(jpbc, fn)(pos, box))
    assert np.abs(np.diff(pbc.unwrap_per_atom(pos, 30.0), axis=0)).max() < 15


@pytest.mark.parametrize("kind", ["plain", "gzip", "zlib"])
def test_state_xml_boxes_match_jax(tmp_path, kind):
    xml = ('<State><PeriodicBoxVectors>\n<A x="6.1" y="0" z="0"/>\n'
           '<B x="0" y="5.2" z="0"/>\n<C x="0" y="0" z="7.3"/>\n'
           '</PeriodicBoxVectors></State>\n').encode()
    blob = {"plain": xml, "gzip": gzip.compress(xml),
            "zlib": zlib.compress(xml)}[kind]
    path = tmp_path / "p_state_npt1.xml"
    path.write_bytes(blob)
    np.testing.assert_array_equal(pbc.box_vectors_from_state_xml(str(path)),
                                  jpbc.box_vectors_from_state_xml(str(path)))
    np.testing.assert_array_equal(pbc.box_from_state_xml(str(path)),
                                  [61.0, 52.0, 73.0])
    np.testing.assert_array_equal(pbc.box_from_release_dir(str(tmp_path), "p"),
                                  jpbc.box_from_release_dir(str(tmp_path), "p"))


def test_box_refusals_match_jax(tmp_path):
    tri = tmp_path / "t.xml"
    tri.write_text('<A x="6" y="0" z="0"/><B x="2" y="5" z="0"/>'
                   '<C x="0" y="0" z="7"/>')
    for mod in (pbc, jpbc):
        with pytest.raises(ValueError, match="triclinic"):
            mod.box_from_state_xml(str(tri))
        with pytest.raises(ValueError, match="no periodic box"):
            (tmp_path / "e.xml").write_text("<State/>")
            mod.box_vectors_from_state_xml(str(tmp_path / "e.xml"))
        with pytest.raises(FileNotFoundError, match="pass box_size"):
            mod.box_from_release_dir(str(tmp_path), "none")


# ---------------------------------------------------------------------------
# energies
# ---------------------------------------------------------------------------
def _tables_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_energies_match_jax(release, tmp_path, capsys):
    dat = os.path.join(release["good"]["dir"], f"{GOOD}_npt_sim.dat")
    t = energies.read_statedata(dat)
    _tables_equal(t, jenergies.read_statedata(dat))
    assert energies.energy_summary(t) == jenergies.energy_summary(t)
    assert len(t["potential_kj_mol"]) == N_FRAMES
    # segments _0, _2, _10: numeric order, tab-separated bare header
    seg = tmp_path / f"{GOOD}_npt_sim_data"
    seg.mkdir()
    rows = open(dat).read().splitlines()[1:]
    header = "#" + "\t".join(STATEDATA_HEADER[1:].replace('"', "").split(","))
    for i, part in zip((0, 2, 10), (rows[:3], rows[3:5], rows[5:])):
        (seg / f"{GOOD}_npt_sim_{i}.dat").write_text(
            header + "\n" + "\n".join(r.replace(",", "\t") for r in part))
    s = energies.read_statedata_segments(str(seg), f"{GOOD}_npt_sim")
    _tables_equal(s, jenergies.read_statedata_segments(str(seg),
                                                       f"{GOOD}_npt_sim"))
    np.testing.assert_array_equal(s["step"], t["step"])
    # the CLI: the same lines and the same npz
    outs = []
    for mod, tag in ((energies, "port"), (jenergies, "jax")):
        npz = str(tmp_path / f"{tag}.npz")
        assert mod.main([str(seg), "--out", npz]) == 0
        assert mod.main([dat]) == 0
        outs.append(capsys.readouterr().out.replace(npz, "OUT"))
    assert outs[0] == outs[1]
    with np.load(tmp_path / "port.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "jax.npz", allow_pickle=True) as b:
        _tables_equal(dict(a), dict(b))


def test_malformed_tables_raise_as_jax(tmp_path):
    cases = {"nohead.dat": "1,2,3\n", "ragged.dat": "#a,b\n1,2\n3\n",
             "text.dat": "#a,b\n1,x\n"}
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        for mod in (energies, jenergies):
            with pytest.raises(ValueError):
                mod.read_statedata(str(tmp_path / name))


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------
def _topology(release):
    good = release["good"]
    names, resseq = [], []
    with open(os.path.join(good["dir"], f"{GOOD}.pdb")) as f:
        for line in f:
            if line.startswith("ATOM"):
                names.append(line[12:16].strip())
                resseq.append(int(line[22:26]))
    return names, np.asarray(resseq)


def test_pack_functions_match_jax(release, tmp_path):
    good = release["good"]
    names, resseq = _topology(release)
    traj = jpack.load_segmented_pkl(good["dir"], GOOD, "T")
    np.testing.assert_array_equal(
        pack.load_segmented_pkl(good["dir"], GOOD, "T"), traj)
    assert pack.load_segmented_pkl(good["dir"], GOOD, "X") is None
    for a, b in zip(pack.atom37_from_full_atoms(traj, names, resseq),
                    jpack.atom37_from_full_atoms(traj, names, resseq)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pack.select_ca_rows(traj, names),
                                  jpack.select_ca_rows(traj, names))
    topo = os.path.join(good["dir"], f"{GOOD}.pdb")
    forces = jpack.load_segmented_pkl(good["dir"], GOOD, "F")
    for mod, tag in ((pack, "port"), (jpack, "jax")):
        mod.pack_trajectory(str(tmp_path / f"{tag}.npz"), topo, traj, names,
                            resseq, forces=forces)
        mod.pack_reference_layout(str(tmp_path / tag), GOOD, topo, traj,
                                  names, resseq, forces=forces,
                                  velocities=forces)
    assert_npz_equal(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        if name.endswith(".npz"):
            assert_npz_equal(str(tmp_path / "port" / name),
                             str(tmp_path / "jax" / name))
        else:
            assert (tmp_path / "port" / name).read_bytes() == (
                tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("protein,unwrap,max_frames",
                         [(GOOD, True, None), (GOOD, False, 6),
                          (DCD_ONLY, False, 5)])
def test_pack_from_release_matches_jax(release, tmp_path, protein, unwrap,
                                       max_frames):
    d = release["good" if protein == GOOD else "other"]["dir"]
    for mod, tag in ((pack, "port"), (jpack, "jax")):
        mod.pack_from_dynamicpdb_release(
            str(tmp_path / f"{tag}.npz"), d, protein, unwrap=unwrap,
            max_frames=max_frames)
    assert_npz_equal(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as z:
        pos = z["all_atom_positions"]
    if unwrap:  # the box jump is gone: the synthetic frames come back
        want = release["good"]["atom37"]
        np.testing.assert_allclose(pos, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# dcd
# ---------------------------------------------------------------------------
def test_dcd_segments_and_cli_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    seg = tmp_path / "x_dcd"
    seg.mkdir()
    parts = [rng.normal(size=(n, 5, 3)).astype(np.float32) for n in (2, 3, 1)]
    for i, part in zip((0, 1, 10), parts):
        dcd.write_dcd(str(seg / f"x_dcd_{i}.dcd"), part, box_lengths=[30, 31, 32])
    got = dcd.read_dcd_segments(str(seg), "x_dcd")
    want = jdcd.read_dcd_segments(str(seg), "x_dcd")
    _tables_equal(got, want)
    np.testing.assert_array_equal(got["xyz"], np.concatenate(parts))
    with pytest.raises(FileNotFoundError):
        dcd.read_dcd_segments(str(seg), "none")
    np.savez(tmp_path / "roll.npz", atom_traj=rng.normal(size=(3, 4, 37, 3)))
    outs = []
    for mod, tag in ((dcd, "port"), (jdcd, "jax")):
        assert mod.main([str(seg), "--out", str(tmp_path / f"{tag}.npz")]) == 0
        assert mod.main([str(seg / "x_dcd_1.dcd")]) == 0
        assert mod.main([str(tmp_path / "roll.npz"), "--out",
                         str(tmp_path / f"{tag}.dcd")]) == 0
        outs.append(capsys.readouterr().out.replace(tag, "T"))
    assert outs[0] == outs[1]
    assert (tmp_path / "port.dcd").read_bytes() == (
        tmp_path / "jax.dcd").read_bytes()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        _tables_equal(dict(a), dict(b))


# ---------------------------------------------------------------------------
# ingest_release against the JAX tool
# ---------------------------------------------------------------------------
def _rows(manifest: str) -> dict:
    with open(manifest) as f:
        return {r["name"]: r for r in csv.DictReader(f)}


def _run_both(release, tmp_path, *flags, port_flags=()):
    from tools.ingest_release import main as jax_main

    out = {}
    for tag, main, extra in (("port", ingest_release.main, port_flags),
                             ("jax", jax_main, ())):
        out_dir = str(tmp_path / tag)
        assert main(["--data-root", release["root"], "--out-dir", out_dir,
                     *flags, *extra]) == 0
        out[tag] = _rows(os.path.join(out_dir, "manifest.csv"))
    return out


def test_ingest_release_matches_jax_tool(release, tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="ingest_release")
    rows = _run_both(release, tmp_path, "--unwrap")
    port_log = [r.getMessage() for r in caplog.records]
    assert sorted(rows["port"]) == sorted(rows["jax"]) == [GOOD, DCD_ONLY]
    for name, row in rows["port"].items():
        assert row["seq_len"] == rows["jax"][name]["seq_len"]
        assert_npz_equal(row["atlas_npz"], rows["jax"][name]["atlas_npz"])
    # the broken protein was logged and skipped, not raised; the one without
    # a State XML was packed as it is, with a warning
    assert any(m.startswith(f"{BROKEN}: SKIPPED") for m in port_log)
    assert any(m.startswith(f"{DCD_ONLY}: cannot unwrap") for m in port_log)
    # the manifest drives the port's dataset
    from dynamicpdb_tpu_torch.config import DataConfig
    from dynamicpdb_tpu_torch.data.dataset import TrajectoryDataset

    cfg = DataConfig(csv_path=str(tmp_path / "port" / "manifest.csv"),
                     frame_time=2)
    ds = TrajectoryDataset(cfg, split="train")
    assert len(ds) == 2


def test_ingest_release_refusals(release, tmp_path):
    with pytest.raises(SystemExit, match="pids not found"):
        ingest_release.main(["--data-root", release["root"], "--out-dir",
                             str(tmp_path), "--pids", "9zzz_Z"])
    with pytest.raises(SystemExit, match="every protein failed"):
        ingest_release.main(["--data-root", release["root"], "--out-dir",
                             str(tmp_path), "--pids", BROKEN])


def test_ingest_release_weights_matches_jax_tool(release, tmp_path):
    """``--weights``: a seeded random OmegaFold at the DFOLD contract's
    widths and a narrow depth, through both tools' extraction."""
    from dynamicpdb_tpu_torch.models.omegafold.model import (
        omegafold_embed,
        omegafold_from_state_dict,
    )
    from dynamicpdb_tpu_torch.models.omegafold.pipeline import fasta2inputs
    from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict
    from tests.test_torch_extract import cli_cfg

    sd = random_omegafold_state_dict(cli_cfg(), 5)
    weights = str(tmp_path / "omegafold.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights)
    rows = _run_both(release, tmp_path, "--pids", GOOD, "--weights", weights,
                     port_flags=("--device", "cpu"))
    got, want = rows["port"][GOOD]["atlas_npz"], rows["jax"][GOOD]["atlas_npz"]
    assert_npz_equal(got, want, close=("node_repr", "edge_repr"))
    seq = ingest_release.pdb_sequence(GOOD, release["good"]["dir"])
    model = omegafold_from_state_dict(sd, device="cpu")
    (_, cycles), = fasta2inputs([f">{GOOD}", seq])
    emb = omegafold_embed(model, cycles)
    with np.load(got) as z:
        assert z["node_repr"].shape == (N_RES, 256)
        np.testing.assert_array_equal(z["node_repr"], emb.node.numpy())
        np.testing.assert_array_equal(z["edge_repr"], emb.edge.numpy())


def test_chip_smoke_ingest_phase_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 11a on the CPU: a tiny OmegaFold at the DFOLD
    contract's widths and a 20-residue protein; its checks (one manifest
    row, the reprs equal to a direct omegafold_embed, the unwrapped
    frames, the energies) run as they do on the card."""
    import chip_smoke
    from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict
    from tests.test_torch_extract import cli_cfg

    monkeypatch.setitem(chip_smoke.RELEASE_PROTEIN, "n_res", 20)
    monkeypatch.setitem(chip_smoke.RELEASE_PROTEIN, "n_frames", 8)
    cfg = cli_cfg()
    weights = str(tmp_path / "omegafold.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                random_omegafold_state_dict(cfg, 0).items()}, weights)
    out = chip_smoke.ingest_phase(torch, str(tmp_path), weights, cfg,
                                  device="cpu")
    assert out["launches"] == {"geom_attention": 0, "node_attention": 0}
    assert _rows(out["csv"])[chip_smoke.RELEASE_PROTEIN["pid"]]["seq_len"] \
        == "20"

"""One-command dynamicPDB release ingestion: download root -> training CSV.

The port's counterpart of the repository's ``tools/ingest_release.py``: for
every protein of a release checkout it unwraps the periodic box
(``preprocess/pbc.py``), packs the trajectory into a training bundle
(``preprocess/pack.py``) and attaches OmegaFold embeddings, then writes the
manifest ``train_cli`` and ``eval_cli`` read:

    python -m dynamicpdb_tpu_torch.tools.ingest_release \\
        --data-root ./dynamicPDB --out-dir packed/ \\
        [--pids 1a62_A,1ah7_A] [--unwrap] [--max-frames N] \\
        [--embeddings-dir D]  # precomputed {pid}.npz OmegaFold reprs
        [--weights release.pt]  # or extract them with the port's OmegaFold
        [--csv-name manifest.csv] [--device cuda]

Protein directories follow the release naming
``{pid}_npt100000.0_ts0.001/`` or plain ``{pid}/``; every published
coordinate layout works (combined or segmented pickles, combined or
segmented DCD). ``--weights`` loads a reference-layout OmegaFold state
dict once and runs ``omegafold_embed`` through
``preprocess/extract_embeddings`` on each protein's sequence, on the card
unless ``--device cpu``. A protein that fails is logged and skipped, and
the run carries on; the manifest lists the proteins packed. Output:
``{out_dir}/{pid}.npz`` bundles and ``{out_dir}/{csv_name}``.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os
import re

import numpy as np

log = logging.getLogger("ingest_release")

_PID_RE = re.compile(r"^(?P<pid>.+?)(_npt[\d.]+(_ts[\d.]+)?)?$")
FIELDS = ("name", "atlas_npz", "seq_len")


def discover_proteins(data_root: str) -> dict[str, str]:
    """Map pid -> protein directory for every release-layout subdir."""
    out: dict[str, str] = {}
    for name in sorted(os.listdir(data_root)):
        d = os.path.join(data_root, name)
        if not os.path.isdir(d):
            continue
        pid = _PID_RE.match(name).group("pid")
        if os.path.exists(os.path.join(d, f"{pid}.pdb")):
            out[pid] = d
    return out


def pdb_sequence(pid: str, pid_dir: str) -> str:
    """The one-letter sequence of the protein's topology ``{pid}.pdb``."""
    from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb
    from dynamicpdb_tpu_torch.chem import constants as chem

    _, _, aatype, _ = read_pdb(os.path.join(pid_dir, f"{pid}.pdb"))
    return "".join(chem.RESTYPES_WITH_X[a] for a in aatype)


def _embeddings_for(pid: str, pid_dir: str, args, omegafold):
    """(node_repr, edge_repr), or (None, None): zeros in the bundle."""
    if args.embeddings_dir:
        p = os.path.join(args.embeddings_dir, f"{pid}.npz")
        if os.path.exists(p):
            from dynamicpdb_tpu_torch.preprocess.embeddings import validate

            validate(p)
            with np.load(p) as z:
                return z["node_repr"], z["edge_repr"]
        log.warning("%s: no %s in --embeddings-dir; using zeros", pid, p)
        return None, None
    if omegafold is not None:
        from dynamicpdb_tpu_torch.preprocess.extract_embeddings import (
            extract_embeddings,
        )

        lines = [f">{pid}", pdb_sequence(pid, pid_dir)]
        for _, arrays, _ in extract_embeddings(lines, omegafold):
            return arrays["node_repr"], arrays["edge_repr"]
    return None, None


def ingest(args) -> list[dict]:
    """Pack every protein of ``args.data_root``; one manifest row for each
    protein packed."""
    from dynamicpdb_tpu_torch.preprocess import pbc
    from dynamicpdb_tpu_torch.preprocess.pack import pack_from_dynamicpdb_release

    proteins = discover_proteins(args.data_root)
    if args.pids:
        wanted = args.pids.split(",")
        missing = [p for p in wanted if p not in proteins]
        if missing:
            raise SystemExit(f"pids not found under {args.data_root}: {missing}")
        proteins = {p: proteins[p] for p in wanted}
    if not proteins:
        raise SystemExit(f"no release-layout protein dirs under {args.data_root}")
    log.info("found %d proteins under %s", len(proteins), args.data_root)

    omegafold = None
    if args.weights and not args.embeddings_dir:
        from dynamicpdb_tpu_torch.preprocess.extract_embeddings import (
            load_release_weights,
        )
        from dynamicpdb_tpu_torch.utils.platform import resolve_device

        omegafold = load_release_weights(args.weights,
                                         device=resolve_device(args.device))

    os.makedirs(args.out_dir, exist_ok=True)
    rows: list[dict] = []
    for pid, pid_dir in proteins.items():
        bundle = os.path.join(args.out_dir, f"{pid}.npz")
        try:
            unwrap = args.unwrap
            if unwrap:
                try:  # a protein without the state XML still packs
                    pbc.box_from_release_dir(pid_dir, pid)
                except Exception as e:
                    log.warning("%s: cannot unwrap (%s); packing as-is", pid, e)
                    unwrap = False
            node, edge = _embeddings_for(pid, pid_dir, args, omegafold)
            pack_from_dynamicpdb_release(
                bundle, pid_dir, pid, node_repr=node, edge_repr=edge,
                max_frames=args.max_frames, unwrap=unwrap)
            with np.load(bundle) as z:
                n_res = int(z["aatype"].shape[0])
                n_frames = int(z["all_atom_positions"].shape[0])
            rows.append({"name": pid, "atlas_npz": os.path.abspath(bundle),
                         "seq_len": n_res})
            log.info("%s: packed %d frames x %d residues -> %s",
                     pid, n_frames, n_res, bundle)
        except Exception as e:  # skip and carry on over a 12.6k-protein run
            log.error("%s: SKIPPED (%s: %s)", pid, type(e).__name__, e)
    return rows


def write_manifest(path: str, rows: list[dict]) -> str:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(FIELDS))
        w.writeheader()
        w.writerows(rows)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--data-root", required=True,
                    help="release checkout: one subdir per protein")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--pids", default=None, help="comma-separated subset")
    ap.add_argument("--unwrap", action="store_true",
                    help="PBC-unwrap coordinates using the box from the "
                         "release's {pid}_state_npt*.xml")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--embeddings-dir", default=None,
                    help="directory of precomputed {pid}.npz OmegaFold reprs")
    ap.add_argument("--weights", default=None,
                    help="reference-layout OmegaFold state dict: extract the "
                         "embeddings with the port's OmegaFold")
    ap.add_argument("--csv-name", default="manifest.csv")
    ap.add_argument("--device", default="cuda",
                    help="where --weights runs: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = parse_args(argv)
    rows = ingest(args)
    if not rows:
        raise SystemExit("every protein failed to ingest; see log above")
    manifest = write_manifest(os.path.join(args.out_dir, args.csv_name), rows)
    print(f"{manifest}: {len(rows)} proteins "
          f"(max seq_len {max(r['seq_len'] for r in rows)})")
    print("train: python -m dynamicpdb_tpu_torch.train_cli "
          f"data.csv_path={manifest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

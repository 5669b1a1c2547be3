"""mmCIF (PDBx) ingestion: parse -> per-chain atom37 features -> dataset.

Port of ``dynamicpdb_tpu/preprocess/mmcif.py`` (numpy only): a PDBx
tokenizer and loop parser for the `_atom_site` loop and the resolution
records, per-chain atom37 featurization, a minimal writer, the reference's
filters (file size, resolution, length), and a processing CLI that writes
one npz per chain plus a metadata CSV usable by
``data/dataset.StaticPdbDataset`` or as a training manifest.

    python -m dynamicpdb_tpu_torch.preprocess.mmcif --mmcif-dir DIR \
        --write-dir OUT [--max-resolution 5.0] [--max-len 512] \
        [--min-file-size 1000] [--max-file-size 3000000]
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import gzip
import logging
import os

import numpy as np

from dynamicpdb_tpu_torch.chem import constants as chem

log = logging.getLogger(__name__)

# AF2's MODRES handling: selenomethionine etc. map to standard residues
MOD_RES = {"MSE": "MET", "SEC": "CYS", "PYL": "LYS", "MLY": "LYS",
           "HYP": "PRO", "SEP": "SER", "TPO": "THR", "PTR": "TYR"}


# ---------------------------------------------------------------------------
# PDBx tokenizer (the subset the atom_site/refine records need)
# ---------------------------------------------------------------------------
def _tokenize(line: str) -> list[str]:
    """Split a PDBx data line honoring single/double quotes."""
    out, i, n = [], 0, len(line)
    while i < n:
        ch = line[i]
        if ch in " \t":
            i += 1
            continue
        if ch in "'\"":
            j = line.find(ch, i + 1)
            # a closing quote must be followed by whitespace/EOL (PDBx rule)
            while j != -1 and j + 1 < n and line[j + 1] not in " \t":
                j = line.find(ch, j + 1)
            if j == -1:
                j = n
            out.append(line[i + 1 : j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


def _parse_loops(text: str, prefixes: tuple[str, ...]) -> dict:
    """Extract loop_ (or single-row key-value) categories by prefix.

    Returns {prefix: (field_names, rows)}."""
    lines = text.splitlines()
    found = {p: ([], []) for p in prefixes}
    i, n = 0, len(lines)
    while i < n:
        line = lines[i].strip()
        if line == "loop_":
            fields = []
            i += 1
            while i < n and lines[i].strip().startswith("_"):
                fields.append(lines[i].strip().split()[0])
                i += 1
            prefix = fields[0].split(".")[0] + "." if fields else ""
            if prefix.rstrip(".") in [p.rstrip(".") for p in prefixes]:
                names = [f.split(".", 1)[1] for f in fields]
                rows = []
                while i < n:
                    s = lines[i].strip()
                    if (not s or s.startswith("#") or s.startswith("_")
                            or s == "loop_" or s.startswith("data_")):
                        break
                    if s.startswith(";"):  # multiline values: skip block
                        i += 1
                        while i < n and not lines[i].startswith(";"):
                            i += 1
                        i += 1
                        continue
                    toks = _tokenize(lines[i])
                    # continuation: a row may span lines until field count met
                    while len(toks) < len(names) and i + 1 < n:
                        i += 1
                        toks += _tokenize(lines[i])
                    rows.append(toks)
                    i += 1
                key = prefix.rstrip(".")
                found[key] = (names, rows)
                continue
        elif line.startswith("_"):
            # single key-value (non-loop) records
            toks = _tokenize(line)
            cat, _, item = toks[0].partition(".")
            if cat in [p.rstrip(".") for p in prefixes]:
                names, rows = found[cat]
                if rows and not isinstance(rows[0], dict):
                    # category already captured as a loop_ (token-list rows);
                    # stray single key-value records for the same category
                    # (mixed style occurs in real PDBx archives) must not be
                    # indexed like a dict — the loop data wins
                    i += 1
                    continue
                if not rows:
                    found[cat] = (names, [{}])
                if len(toks) > 1:
                    found[cat][1][0][item] = toks[1]
                elif i + 1 < n and lines[i + 1].startswith(";"):
                    found[cat][1][0][item] = lines[i + 1][1:].strip()
        i += 1
    return found


@dataclasses.dataclass
class MmcifChain:
    chain_id: str
    aatype: np.ndarray  # [N]
    atom37: np.ndarray  # [N, 37, 3]
    atom37_mask: np.ndarray  # [N, 37]
    residue_index: np.ndarray  # [N]
    sequence: str


@dataclasses.dataclass
class MmcifObject:
    file_id: str
    resolution: float | None
    chains: dict  # chain_id -> MmcifChain


def parse_mmcif(path: str, file_id: str | None = None) -> MmcifObject:
    """Parse one .cif/.cif.gz into per-chain atom37 features (model 1,
    polymer ATOM records; MSE-style modified residues mapped to their
    standard parents)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    cats = _parse_loops(
        text,
        ("_atom_site", "_refine", "_reflns", "_em_3d_reconstruction"),
    )

    resolution = None
    for cat, item in (
        ("_refine", "ls_d_res_high"),
        ("_reflns", "d_resolution_high"),
        ("_em_3d_reconstruction", "resolution"),
    ):
        names, rows = cats[cat]
        if rows:
            if isinstance(rows[0], dict):
                val = rows[0].get(item)
            else:
                val = (
                    rows[0][names.index(item)] if item in names else None
                )
            try:
                resolution = float(val)
                break
            except (TypeError, ValueError):
                continue

    names, rows = cats["_atom_site"]
    if not rows:
        raise ValueError(f"{path}: no _atom_site loop")
    col = {k: names.index(k) for k in names}

    def get(row, key, default="?"):
        idx = col.get(key)
        return row[idx] if idx is not None and idx < len(row) else default

    chains: dict[str, dict] = {}
    for row in rows:
        if get(row, "group_PDB") != "ATOM" and not (
            get(row, "group_PDB") == "HETATM"
            and get(row, "label_comp_id") in MOD_RES
        ):
            continue
        if get(row, "pdbx_PDB_model_num", "1") not in ("1", ".", "?"):
            continue
        alt = get(row, "label_alt_id", ".")
        if alt not in (".", "?", "A"):
            continue
        res3 = get(row, "label_comp_id")
        res3 = MOD_RES.get(res3, res3)
        if res3 not in chem.RESTYPE_3TO1:
            continue
        atom = get(row, "label_atom_id")
        if atom == "SE" and res3 == "MET":
            atom = "SD"
        if atom not in chem.ATOM_ORDER:
            continue
        chain_id = get(row, "auth_asym_id")
        if chain_id in ("?", "."):
            chain_id = get(row, "label_asym_id")
        seq_id = get(row, "auth_seq_id")
        if seq_id in ("?", "."):
            seq_id = get(row, "label_seq_id")
        seq_id = int(seq_id)
        # insertion code: residues 100, 100A, 100B share auth_seq_id and are
        # distinct residues — keying on the int alone would merge them and
        # silently drop/mix their atoms (common in antibody CDR loops)
        ins = get(row, "pdbx_PDB_ins_code", ".")
        ins = "" if ins in (".", "?") else ins
        xyz = (
            float(get(row, "Cartn_x")),
            float(get(row, "Cartn_y")),
            float(get(row, "Cartn_z")),
        )
        ch = chains.setdefault(chain_id, {})
        res = ch.setdefault((seq_id, ins), {"res3": res3, "atoms": {}})
        res["atoms"].setdefault(atom, xyz)

    out_chains = {}
    for chain_id, residues in chains.items():
        seq_ids = sorted(residues)
        N = len(seq_ids)
        aatype = np.zeros(N, np.int32)
        atom37 = np.zeros((N, 37, 3), np.float32)
        mask37 = np.zeros((N, 37), np.float32)
        seq = []
        for i, sid in enumerate(seq_ids):
            r = residues[sid]
            one = chem.RESTYPE_3TO1.get(r["res3"], "X")
            seq.append(one)
            aatype[i] = chem.RESTYPE_ORDER.get(one, chem.UNK_RESTYPE)
            for atom, xyz in r["atoms"].items():
                ai = chem.ATOM_ORDER[atom]
                atom37[i, ai] = xyz
                mask37[i, ai] = 1.0
        out_chains[chain_id] = MmcifChain(
            chain_id=chain_id,
            aatype=aatype,
            atom37=atom37,
            atom37_mask=mask37,
            # author numbering; inserted residues (100A/100B...) keep their
            # parent number, matching the AF2/openfold convention
            residue_index=np.asarray([sid for sid, _ in seq_ids], np.int32),
            sequence="".join(seq),
        )
    return MmcifObject(
        file_id=file_id or os.path.basename(path).split(".")[0],
        resolution=resolution,
        chains=out_chains,
    )


def write_mmcif(path: str, atom37, mask37, aatype, chain_id: str = "A",
                residue_index=None, resolution: float | None = None):
    """Minimal mmCIF writer (roundtrips through parse_mmcif; also lets users
    exchange artifacts with PDBx tools)."""
    if residue_index is None:
        residue_index = np.arange(1, len(aatype) + 1)
    lines = [f"data_{os.path.basename(path).split('.')[0]}", "#"]
    if resolution is not None:
        lines += [f"_refine.ls_d_res_high {resolution}", "#"]
    lines += [
        "loop_",
        "_atom_site.group_PDB", "_atom_site.id", "_atom_site.label_atom_id",
        "_atom_site.label_comp_id", "_atom_site.label_asym_id",
        "_atom_site.auth_asym_id", "_atom_site.auth_seq_id",
        "_atom_site.label_alt_id", "_atom_site.Cartn_x", "_atom_site.Cartn_y",
        "_atom_site.Cartn_z", "_atom_site.pdbx_PDB_model_num",
    ]
    serial = 1
    for i in range(len(aatype)):
        res3 = chem.RESTYPE_1TO3[chem.RESTYPES[aatype[i]]] \
            if aatype[i] < 20 else "UNK"
        for ai in range(37):
            if not mask37[i, ai]:
                continue
            x, y, z = atom37[i, ai]
            lines.append(
                f"ATOM {serial} {chem.ATOM37_NAMES[ai]} {res3} {chain_id} "
                f"{chain_id} {residue_index[i]} . {x:.3f} {y:.3f} {z:.3f} 1"
            )
            serial += 1
    lines.append("#")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def process_mmcif_dir(
    mmcif_dir: str,
    write_dir: str,
    *,
    max_resolution: float = 5.0,
    max_len: int = 512,
    min_file_size: int = 1000,
    max_file_size: int = 3_000_000,
) -> list[dict]:
    """The reference's preprocessing CLI semantics
    (process_pdb_dataset.py:40-140): size filter, parse, resolution and
    length filters, then one npz per chain + metadata.csv."""
    os.makedirs(write_dir, exist_ok=True)
    rows = []
    for root, _dirs, files in os.walk(mmcif_dir):
        for fname in sorted(files):
            if not (fname.endswith(".cif") or fname.endswith(".cif.gz")):
                continue
            path = os.path.join(root, fname)
            size = os.path.getsize(path)
            if not (min_file_size <= size <= max_file_size):
                log.info("skip %s: file size %d", fname, size)
                continue
            try:
                obj = parse_mmcif(path)
            except Exception as e:
                log.warning("parse failed %s: %s", fname, e)
                continue
            if obj.resolution is not None and obj.resolution > max_resolution:
                log.info("skip %s: resolution %.2f", fname, obj.resolution)
                continue
            for chain_id, ch in obj.chains.items():
                if len(ch.aatype) > max_len or len(ch.aatype) < 2:
                    log.info("skip %s_%s: len %d", obj.file_id, chain_id,
                             len(ch.aatype))
                    continue
                name = f"{obj.file_id}_{chain_id}"
                out = os.path.join(write_dir, f"{name}.npz")
                np.savez_compressed(
                    out,
                    atom37=ch.atom37,
                    atom37_mask=ch.atom37_mask,
                    aatype=ch.aatype,
                    residue_index=ch.residue_index,
                )
                rows.append({
                    "name": name,
                    "npz_path": out,
                    "seq_len": len(ch.aatype),
                    "resolution": obj.resolution,
                    "sequence": ch.sequence,
                })
    meta = os.path.join(write_dir, "metadata.csv")
    if rows:
        with open(meta, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        log.info("wrote %d chains -> %s", len(rows), meta)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mmcif-dir", required=True)
    parser.add_argument("--write-dir", required=True)
    parser.add_argument("--max-resolution", type=float, default=5.0)
    parser.add_argument("--max-len", type=int, default=512)
    parser.add_argument("--min-file-size", type=int, default=1000)
    parser.add_argument("--max-file-size", type=int, default=3_000_000)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rows = process_mmcif_dir(
        args.mmcif_dir, args.write_dir,
        max_resolution=args.max_resolution, max_len=args.max_len,
        min_file_size=args.min_file_size, max_file_size=args.max_file_size,
    )
    print(f"processed {len(rows)} chains")


if __name__ == "__main__":
    main()

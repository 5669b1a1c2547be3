"""The dynamicPDB release's MD state tables (energies, temperature, box).

Port of ``dynamicpdb_tpu/preprocess/energies.py`` (numpy only). The
release ships, per protein, OpenMM StateDataReporter tables:
``{pid}_npt_sim.dat`` with per-frame potential / kinetic / total energy
(kJ/mole), temperature (K), box volume (nm^3) and density (g/mL), the
equilibration stages' ``{pid}_nvt_equi.dat`` / ``{pid}_npt_equi.dat``, and
the production table split into tenth-of-trajectory segments
``{pid}_npt_sim_data/{pid}_npt_sim_{i}.dat``.

StateDataReporter format: one comment header line
``#"Step","Potential Energy (kJ/mole)",...`` followed by
delimiter-separated numeric rows; comma (OpenMM's default), tab or
whitespace delimiters and quoted or bare column names are accepted.

    python -m dynamicpdb_tpu_torch.preprocess.energies {pid}_npt_sim.dat
    python -m dynamicpdb_tpu_torch.preprocess.energies {pid}_npt_sim_data \
        --prefix {pid}_npt_sim --out {pid}_energies.npz
"""
from __future__ import annotations

import os
import re

import numpy as np

__all__ = [
    "read_statedata",
    "read_statedata_segments",
    "energy_summary",
]

# canonical short names for the columns the release documents
_CANON = {
    "step": "step",
    "time": "time_ps",
    "potential energy": "potential_kj_mol",
    "kinetic energy": "kinetic_kj_mol",
    "total energy": "total_kj_mol",
    "temperature": "temperature_k",
    "box volume": "box_volume_nm3",
    "density": "density_g_ml",
}


def _canon_name(raw: str) -> str:
    """'Potential Energy (kJ/mole)' -> 'potential_kj_mol'; unknown columns
    keep a sanitized version of their own name."""
    base = re.sub(r"\(.*?\)", "", raw).strip().lower()
    if base in _CANON:
        return _CANON[base]
    return re.sub(r"\W+", "_", raw.strip().lower()).strip("_")


def _split_row(line: str, delim: str | None) -> list[str]:
    if delim is None:
        return line.split()
    return [c.strip() for c in line.split(delim)]


def read_statedata(path: str) -> dict[str, np.ndarray]:
    """Parse one OpenMM StateDataReporter table into named float64 columns.

    Returns a dict mapping canonical column names (see module docstring;
    e.g. ``potential_kj_mol``, ``temperature_k``) to 1-D arrays, plus
    ``"columns"`` -> the original header strings (as a numpy object array
    so the result round-trips through ``np.savez``). Raises ValueError on
    a malformed table (no header, ragged rows, non-numeric cells).
    """
    header: list[str] | None = None
    delim: str | None = None
    rows: list[list[float]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                # header: #"Step","Potential Energy (kJ/mole)",...
                body = line.lstrip("#").strip()
                quoted = re.findall(r'"([^"]*)"', body)
                if quoted:
                    header = quoted
                    delim = ","
                else:
                    delim = "," if "," in body else ("\t" if "\t" in body else None)
                    header = _split_row(body, delim)
                continue
            if header is None:
                raise ValueError(
                    f"{path}: no '#'-prefixed StateDataReporter header "
                    "before data rows"
                )
            if delim == "," and "," not in line:
                # header was comma-separated but rows are not: fall back
                delim = None
            cells = _split_row(line, delim)
            if len(cells) != len(header):
                raise ValueError(
                    f"{path}:{lineno}: row has {len(cells)} cells, "
                    f"header has {len(header)} columns"
                )
            try:
                rows.append([float(c) for c in cells])
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: non-numeric cell: {e}") from None
    if header is None:
        raise ValueError(f"{path}: empty file")
    data = (
        np.asarray(rows, dtype=np.float64)
        if rows
        else np.zeros((0, len(header)), dtype=np.float64)
    )
    out: dict[str, np.ndarray] = {
        _canon_name(name): data[:, i] for i, name in enumerate(header)
    }
    out["columns"] = np.asarray(header, dtype=object)
    return out


def _segment_index(name: str, prefix: str) -> int | None:
    m = re.fullmatch(re.escape(prefix) + r"_(\d+)\.dat", name)
    return int(m.group(1)) if m else None


def read_statedata_segments(seg_dir: str, prefix: str) -> dict[str, np.ndarray]:
    """Concatenate the release's segmented tables in chronological order.

    ``seg_dir`` is e.g. ``{pid}_npt_sim_data/`` holding
    ``{prefix}_0.dat .. {prefix}_9.dat`` (prefix = ``{pid}_npt_sim``,
    README.md:120-127). Segments are ordered numerically (so ``_10`` sorts
    after ``_9``), must agree on their column sets, and are stacked into
    the same dict layout as :func:`read_statedata`.
    """
    found = sorted(
        (
            (idx, name)
            for name in os.listdir(seg_dir)
            if (idx := _segment_index(name, prefix)) is not None
        ),
    )
    if not found:
        raise FileNotFoundError(f"no {prefix}_<i>.dat segments in {seg_dir}")
    parts = [read_statedata(os.path.join(seg_dir, name)) for _, name in found]
    cols0 = list(parts[0]["columns"])
    for (_, name), part in zip(found, parts):
        if list(part["columns"]) != cols0:
            raise ValueError(
                f"{name}: column set {list(part['columns'])} differs from "
                f"first segment's {cols0}"
            )
    out: dict[str, np.ndarray] = {
        k: np.concatenate([p[k] for p in parts])
        for k in parts[0]
        if k != "columns"
    }
    out["columns"] = parts[0]["columns"]
    return out


def energy_summary(table: dict[str, np.ndarray]) -> dict[str, float]:
    """Per-column mean/std/min/max for the numeric columns — the quick
    sanity check (energy conservation drift, temperature stability) one
    runs before training on a trajectory."""
    out: dict[str, float] = {}
    for k, v in table.items():
        if k == "columns" or v.size == 0:
            continue
        out[f"{k}_mean"] = float(v.mean())
        out[f"{k}_std"] = float(v.std())
        out[f"{k}_min"] = float(v.min())
        out[f"{k}_max"] = float(v.max())
    return out


def main(argv=None):
    """CLI: summarize a state table (or segment dir) or convert to npz.

    python -m dynamicpdb_tpu_torch.preprocess.energies {pid}_npt_sim.dat
    python -m dynamicpdb_tpu_torch.preprocess.energies {pid}_npt_sim_data \
        --prefix {pid}_npt_sim --out {pid}_energies.npz
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("path", help=".dat file or directory of segments")
    ap.add_argument("--prefix", default=None,
                    help="segment prefix when path is a directory "
                         "(default: inferred as <dirname minus '_data'>)")
    ap.add_argument("--out", default=None, help="write columns to this .npz")
    args = ap.parse_args(argv)

    if os.path.isdir(args.path):
        prefix = args.prefix
        if prefix is None:
            base = os.path.basename(os.path.normpath(args.path))
            prefix = base[: -len("_data")] if base.endswith("_data") else base
        table = read_statedata_segments(args.path, prefix)
    else:
        table = read_statedata(args.path)
    n = next((len(v) for k, v in table.items() if k != "columns"), 0)
    print(f"{args.path}: {n} rows, columns {list(table['columns'])}")
    print(json.dumps(energy_summary(table), indent=1))
    if args.out:
        np.savez(args.out, **{k: v for k, v in table.items()})
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

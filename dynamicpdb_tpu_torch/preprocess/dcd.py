"""DCD trajectory I/O (CHARMM/X-PLOR binary format; numpy only).

Port of ``dynamicpdb_tpu/preprocess/dcd.py``, byte for byte in what it
writes: ``eval_cli --extension N --save-dcd`` hands a rollout to VMD,
PyMOL or mdtraj through ``write_dcd``; ``read_dcd`` reads such files and
the release's ``{pid}_T.dcd``, ``read_dcd_segments`` its
tenth-of-trajectory segments ``{pid}_dcd/{pid}_dcd_{i}.dcd``, and the CLI
inspects a DCD or converts between DCD and npz:

    python -m dynamicpdb_tpu_torch.preprocess.dcd traj.dcd [--out traj.npz]
    python -m dynamicpdb_tpu_torch.preprocess.dcd 1a62_A_dcd --prefix 1a62_A_dcd
    python -m dynamicpdb_tpu_torch.preprocess.dcd rollout.npz --out traj.dcd \
        --key atom_traj

Format (the classic VMD dcdplugin layout, which OpenMM writes):

- Fortran "unformatted" records, each bracketed by int32 byte counts.
- Header record (84 bytes): magic ``CORD`` + 20 int32 control slots --
  slot 0 frame count, 1 first step, 2 save interval, 9 timestep
  (float32 in CHARMM files), 10 unit-cell flag, 19 CHARMM version.
- Title record: int32 count, then count x 80-byte strings.
- Atom-count record: one int32.
- Per frame: optional unit-cell record (6 float64: A, gamma, B, beta,
  alpha, C) followed by X, Y, Z records of ``natoms`` float32 each, in
  Angstroms.

Both byte orders are read (detected from the header record marker);
frames are read until EOF rather than trusting the header's frame count.
"""
from __future__ import annotations

import os
import re
import struct

import numpy as np

__all__ = ["read_dcd", "read_dcd_segments", "write_dcd"]

_HDR84 = 84
_MAGIC = b"CORD"


def _read_exact(f, n: int, what: str) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"truncated DCD: expected {n} bytes for {what}, "
                         f"got {len(b)}")
    return b


def _read_record(f, endian: str, what: str) -> bytes:
    head = f.read(4)
    if not head:
        raise EOFError
    if len(head) != 4:
        raise ValueError(f"truncated DCD record marker before {what}")
    (n,) = struct.unpack(endian + "i", head)
    if n < 0 or n > 1 << 30:
        raise ValueError(f"corrupt DCD record length {n} before {what}")
    body = _read_exact(f, n, what)
    (tail,) = struct.unpack(endian + "i", _read_exact(f, 4, f"{what} tail"))
    if tail != n:
        raise ValueError(f"DCD record bracket mismatch for {what}: "
                         f"{n} != {tail}")
    return body


def _angles_deg(three: np.ndarray) -> np.ndarray:
    """CHARMM >= c36 stores unit-cell angles as cosines; older files store
    degrees. Values in [-1, 1] are cosines (the mdtraj/VMD heuristic)."""
    out = np.empty(3, np.float64)
    for i, v in enumerate(three):
        out[i] = np.degrees(np.arccos(v)) if -1.0 <= v <= 1.0 else v
    return out


def read_dcd(path: str) -> dict[str, np.ndarray]:
    """Read a DCD trajectory.

    Returns ``{"xyz": [F, A, 3] float32 Angstroms,
    "box_lengths": [F, 3] float64 or absent,
    "box_angles_deg": [F, 3] float64 or absent}``.
    """
    with open(path, "rb") as f:
        first = _read_exact(f, 4, "header marker")
        for endian in ("<", ">"):
            if struct.unpack(endian + "i", first)[0] == _HDR84:
                break
        else:
            raise ValueError(f"{path}: not a DCD file (header record is "
                             f"{first!r}, expected 84 in either byte order)")
        hdr = _read_exact(f, _HDR84, "header")
        (tail,) = struct.unpack(endian + "i", _read_exact(f, 4, "header tail"))
        if tail != _HDR84 or hdr[:4] != _MAGIC:
            raise ValueError(f"{path}: bad DCD header (magic {hdr[:4]!r})")
        icntrl = struct.unpack(endian + "20i", hdr[4:])
        has_box = icntrl[10] != 0
        if icntrl[11]:
            raise ValueError(f"{path}: 4-dimensional DCD not supported")

        _read_record(f, endian, "title")
        (natoms,) = struct.unpack(
            endian + "i", _read_record(f, endian, "atom count")
        )
        if natoms <= 0:
            raise ValueError(f"{path}: nonsensical atom count {natoms}")
        if icntrl[8] != 0:
            # fixed atoms use a shorter record for frames > 0; the release's
            # OpenMM files never do this
            raise ValueError(f"{path}: fixed-atom DCD not supported "
                             f"({icntrl[8]} fixed atoms)")

        frames, lengths, angles = [], [], []
        while True:
            try:
                if has_box:
                    cell = np.frombuffer(
                        _read_record(f, endian, "unit cell"),
                        dtype=endian + "f8",
                    )
                    if cell.size != 6:
                        raise ValueError(
                            f"{path}: unit-cell record has {cell.size} "
                            "doubles, expected 6"
                        )
                    # layout: A, gamma, B, beta, alpha, C
                    lengths.append([cell[0], cell[2], cell[5]])
                    angles.append(_angles_deg(cell[[4, 3, 1]]))
                x = _read_record(f, endian, "x coordinates")
            except EOFError:
                break
            try:
                y = _read_record(f, endian, "y coordinates")
                z = _read_record(f, endian, "z coordinates")
            except EOFError:
                raise ValueError(f"{path}: truncated mid-frame "
                                 f"(frame {len(frames)})") from None
            xyz = np.stack(
                [np.frombuffer(b, dtype=endian + "f4") for b in (x, y, z)],
                axis=1,
            )
            if xyz.shape[0] != natoms:
                raise ValueError(
                    f"{path}: frame has {xyz.shape[0]} atoms, header says "
                    f"{natoms}"
                )
            frames.append(xyz)

    out = {
        "xyz": (
            np.asarray(frames, dtype=np.float32)
            if frames
            else np.zeros((0, natoms, 3), np.float32)
        )
    }
    if has_box:
        out["box_lengths"] = np.asarray(lengths, np.float64)
        out["box_angles_deg"] = np.asarray(angles, np.float64)
    return out


def read_dcd_segments(seg_dir: str, prefix: str) -> dict[str, np.ndarray]:
    """Concatenate the release's segmented DCDs ``{prefix}_{i}.dcd`` from
    ``seg_dir`` in numeric order (README.md:120-140)."""
    pat = re.compile(re.escape(prefix) + r"_(\d+)\.dcd$")
    found = sorted(
        (int(m.group(1)), name)
        for name in os.listdir(seg_dir)
        if (m := pat.fullmatch(name))
    )
    if not found:
        raise FileNotFoundError(f"no {prefix}_<i>.dcd segments in {seg_dir}")
    parts = [read_dcd(os.path.join(seg_dir, name)) for _, name in found]
    keys = set(parts[0])
    for (_, name), p in zip(found, parts):
        if set(p) != keys or p["xyz"].shape[1] != parts[0]["xyz"].shape[1]:
            raise ValueError(f"{name}: atom count or box presence differs "
                             "from the first segment")
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def write_dcd(
    path: str,
    xyz: np.ndarray,  # [F, A, 3] Angstroms
    *,
    box_lengths: np.ndarray | None = None,  # [3] or [F, 3] Angstroms
    timestep_ps: float = 0.001,
    first_step: int = 0,
    save_interval: int = 1,
    title: str = "written by dynamicpdb_tpu",
) -> str:
    """Write an orthorhombic little-endian CHARMM-format DCD (the layout
    OpenMM writes and every MD viewer reads). Use it to hand a sampled
    rollout (eval_cli --extension) to VMD/PyMOL/mdtraj."""
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be [F, A, 3], got {xyz.shape}")
    nframes, natoms = xyz.shape[:2]
    has_box = box_lengths is not None
    if has_box:
        box_lengths = np.broadcast_to(
            np.asarray(box_lengths, np.float64), (nframes, 3)
        )

    # AKMA time unit: 1 AKMA = 0.04888821 ps (CHARMM stores delta in AKMA)
    delta_akma = np.float32(timestep_ps / 0.04888821)
    icntrl = [0] * 20
    icntrl[0] = nframes
    icntrl[1] = first_step
    icntrl[2] = save_interval
    icntrl[3] = nframes * save_interval
    icntrl[9] = struct.unpack("<i", struct.pack("<f", delta_akma))[0]
    icntrl[10] = 1 if has_box else 0
    icntrl[19] = 24  # CHARMM version marker

    with open(path, "wb") as f:
        f.write(struct.pack("<i", _HDR84) + _MAGIC)
        f.write(struct.pack("<20i", *icntrl))
        f.write(struct.pack("<i", _HDR84))
        t = title.encode()[:80].ljust(80)
        f.write(struct.pack("<ii", 4 + 80, 1) + t + struct.pack("<i", 4 + 80))
        f.write(struct.pack("<iii", 4, natoms, 4))
        for fi in range(nframes):
            if has_box:
                a, b, c = box_lengths[fi]
                # A, gamma, B, beta, alpha, C; 0.0 = cos(90 deg)
                f.write(struct.pack("<i", 48))
                f.write(struct.pack("<6d", a, 0.0, b, 0.0, 0.0, c))
                f.write(struct.pack("<i", 48))
            for axis in range(3):
                col = np.ascontiguousarray(xyz[fi, :, axis], "<f4")
                f.write(struct.pack("<i", 4 * natoms))
                f.write(col.tobytes())
                f.write(struct.pack("<i", 4 * natoms))
    return path


def main(argv=None):
    """CLI: inspect a DCD (or segment dir), optionally convert to npz, or
    convert a rollout/extension npz to DCD.

    python -m dynamicpdb_tpu_torch.preprocess.dcd traj.dcd [--out traj.npz]
    python -m dynamicpdb_tpu_torch.preprocess.dcd 1a62_A_dcd --prefix 1a62_A_dcd
    python -m dynamicpdb_tpu_torch.preprocess.dcd rollout.npz --out traj.dcd \
        --key atom_traj
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("path", help=".dcd file, segment dir, or .npz to convert")
    ap.add_argument("--prefix", default=None,
                    help="segment prefix when path is a directory "
                         "(default: the directory's own name)")
    ap.add_argument("--out", default=None, help=".npz or .dcd output")
    ap.add_argument("--key", default="atom_traj",
                    help="npz key holding [F, ..., 3] coords for npz->dcd")
    args = ap.parse_args(argv)

    if args.path.endswith(".npz"):
        with np.load(args.path) as z:
            coords = np.asarray(z[args.key])
        coords = coords.reshape(coords.shape[0], -1, 3)
        if not args.out:
            raise SystemExit("npz->dcd conversion needs --out traj.dcd")
        write_dcd(args.out, coords)
        print(f"wrote {args.out}: {coords.shape[0]} frames x "
              f"{coords.shape[1]} atoms")
        return 0

    if os.path.isdir(args.path):
        prefix = args.prefix or os.path.basename(os.path.normpath(args.path))
        traj = read_dcd_segments(args.path, prefix)
    else:
        traj = read_dcd(args.path)
    msg = f"{args.path}: {traj['xyz'].shape[0]} frames x " \
          f"{traj['xyz'].shape[1]} atoms"
    if "box_lengths" in traj and len(traj["box_lengths"]):
        msg += f", box {traj['box_lengths'][0].round(3).tolist()} A"
    print(msg)
    if args.out:
        np.savez(args.out, **traj)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

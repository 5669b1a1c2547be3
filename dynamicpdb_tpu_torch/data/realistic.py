"""Realistic synthetic protein windows: Ramachandran-valid torsions, ideal
covalent geometry, all-atom placement through the rigid-group machinery,
and torsion-space MD-like dynamics.

Port of ``dynamicpdb_tpu/data/realistic.py``. The numpy parts are the JAX
package's as they are (NeRF chain extension from Engh & Huber bond
lengths and angles, secondary-structure plans, the self-avoiding backbone
walk, clash-aware rotamer packing, Ornstein-Uhlenbeck dynamics in torsion
space, Ca velocities by finite difference and OU forces); the three
geometry pipelines the JAX package jits (backbone rigid from N/CA/C,
atoms from torsion angles, the psi group angle) run on this package's
``ops/frames`` functions on CPU float32 tensors.

``make_realistic_window`` returns the ``data/featurize.py`` window
contract (the keys of ``synthetic.make_window``) plus 'ss', 'sequence',
'chi' and 'chi_mask'.
"""
from __future__ import annotations

import numpy as np
import torch

from dynamicpdb_tpu_torch.chem import constants as chem
from dynamicpdb_tpu_torch.ops import frames as frame_ops
from dynamicpdb_tpu_torch.ops.rigid import Rigid

# Engh & Huber ideal backbone internal coordinates (degrees / angstroms),
# matching AF2's rigid-group literature values.
_B_N_CA, _B_CA_C, _B_C_N = 1.458, 1.525, 1.329
_A_N_CA_C, _A_CA_C_N, _A_C_N_CA = 111.2, 116.2, 121.7

# (phi, psi) basin centers by secondary structure
_SS_BASINS = {
    "H": (-62.0, -42.0),   # alpha helix
    "E": (-120.0, 130.0),  # beta strand
}
# loop-region basins (sampled per residue): alpha-L, PPII, bridge, turn
_LOOP_BASINS = [(-62.0, -42.0), (-75.0, 145.0), (-90.0, 0.0), (55.0, 45.0)]
_LOOP_P = [0.25, 0.40, 0.20, 0.15]


def _unit(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)


def nerf_extend(a, b, c, length, angle_deg, torsion_deg):
    """Place atom d on chain a-b-c with |c-d| = length,
    angle(b,c,d) = angle_deg, dihedral(a,b,c,d) = torsion_deg (IUPAC sign).
    Vectorized over leading dims."""
    ang = np.deg2rad(angle_deg)
    tor = np.deg2rad(torsion_deg)
    bc = _unit(c - b)
    n = _unit(np.cross(b - a, bc))
    m = np.cross(n, bc)
    d_local = np.stack(
        np.broadcast_arrays(
            -length * np.cos(ang),
            length * np.sin(ang) * np.cos(tor),
            length * np.sin(ang) * np.sin(tor),
        ),
        axis=-1,
    )
    return c + (
        d_local[..., 0:1] * bc + d_local[..., 1:2] * m + d_local[..., 2:3] * n
    )


def dihedral(p0, p1, p2, p3):
    """IUPAC-signed dihedral (degrees) for 4 points, vectorized.

    b0 points BACKWARD (p0 - p1): flipping it shifts the result by 180
    degrees — caught against the framework's AF2-parity torsion
    extraction (an ideal (-57, -47) helix must read back (-57, -47))."""
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    b1u = _unit(b1)
    v = b0 - np.sum(b0 * b1u, -1, keepdims=True) * b1u
    w = b2 - np.sum(b2 * b1u, -1, keepdims=True) * b1u
    x = np.sum(v * w, -1)
    y = np.sum(np.cross(b1u, v) * w, -1)
    return np.rad2deg(np.arctan2(y, x))


def sample_ss_plan(rng: np.random.Generator, n_res: int) -> str:
    """Secondary-structure string, e.g. 'LLHHHHHHHHLLLEEEEEL...'. Segment
    lengths follow protein-like distributions (helix 6-18, strand 4-9,
    loop 2-7)."""
    out = []
    # chains start in a loop more often than not
    kinds, probs = ["H", "E", "L"], [0.40, 0.25, 0.35]
    prev = "L"
    while len(out) < n_res:
        k = rng.choice(kinds, p=probs)
        if k == prev and k != "L":  # no back-to-back identical SS segments
            k = "L"
        n = {
            "H": int(rng.integers(6, 19)),
            "E": int(rng.integers(4, 10)),
            "L": int(rng.integers(2, 8)),
        }[k]
        out.extend(k * n)
        prev = k
    return "".join(out[:n_res])


def sample_backbone_torsions(rng, ss: str, noise_scale: float = 1.0):
    """(phi, psi, omega) [N] degrees for an SS plan; Ramachandran-valid."""
    n = len(ss)
    phi = np.empty(n)
    psi = np.empty(n)
    for i, s in enumerate(ss):
        if s in _SS_BASINS:
            mu_phi, mu_psi = _SS_BASINS[s]
            sd = 6.0 if s == "H" else 13.0
        else:
            mu_phi, mu_psi = _LOOP_BASINS[rng.choice(len(_LOOP_P), p=_LOOP_P)]
            sd = 15.0
        phi[i] = mu_phi + rng.normal() * sd * noise_scale
        psi[i] = mu_psi + rng.normal() * sd * noise_scale
    omega = 180.0 + rng.normal(size=n) * 2.5 * noise_scale
    return phi, psi, omega


def build_backbone(phi, psi, omega):
    """NeRF chain: (phi, psi, omega) [N] degrees -> N/CA/C coords [N, 3]
    with ideal bond lengths/angles. phi[0] and omega[-1] are unused (chain
    ends)."""
    n = len(phi)
    N = np.empty((n, 3))
    CA = np.empty((n, 3))
    C = np.empty((n, 3))
    # seed residue: ideal internal geometry, arbitrary global placement
    N[0] = (0.0, 0.0, 0.0)
    CA[0] = (_B_N_CA, 0.0, 0.0)
    ang = np.deg2rad(_A_N_CA_C)
    C[0] = CA[0] + _B_CA_C * np.array([-np.cos(ang), np.sin(ang), 0.0])
    for i in range(1, n):
        # psi_{i-1}: N(i-1)-CA(i-1)-C(i-1)-N(i)
        N[i] = nerf_extend(N[i - 1], CA[i - 1], C[i - 1],
                           _B_C_N, _A_CA_C_N, psi[i - 1])
        # omega_{i-1}: CA(i-1)-C(i-1)-N(i)-CA(i)
        CA[i] = nerf_extend(CA[i - 1], C[i - 1], N[i],
                            _B_N_CA, _A_C_N_CA, omega[i - 1])
        # phi_i: C(i-1)-N(i)-CA(i)-C(i)
        C[i] = nerf_extend(C[i - 1], N[i], CA[i],
                           _B_CA_C, _A_N_CA_C, phi[i])
    return N, CA, C


def ideal_cb(n, ca, c):
    """CB from backbone atoms (AF2's idealized construction)."""
    b = ca - n
    cc = c - ca
    a = np.cross(b, cc)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca


# vdW radii for the SAW's backbone clash check (N, CA, C, CB)
_BB_RADII = np.array([1.55, 1.7, 1.7, 1.7])


def build_self_avoiding_backbone(rng, ss, clash_d: float = 4.2,
                                 draws_per_site: int = 40,
                                 backtrack: int = 4,
                                 overlap_margin: float = 1.35):
    """Self-avoiding NeRF build (greedy SAW with retry + shallow
    backtrack). Real chains are self-avoiding; raw torsion sampling is
    blind to sterics and self-intersects most of the time past ~50
    residues, and even short-range (phi, psi) draws put backbone/CB atoms
    inside each other's van-der-Waals radii (measured: C(i)-CB(i+2),
    CB-CB(i+1) overlaps past the AF2 clash tolerance). Per residue: the
    first draw keeps the SS plan's torsions; a draw is accepted only if
    (a) the new Ca is >= ``clash_d`` from every Ca >= 3 residues back AND
    (b) the residue's N/CA/C/idealized-CB atoms keep pairwise distance >=
    r_i + r_j - ``overlap_margin`` from every previously placed backbone
    atom (peptide-bonded C-N pair exempt) — slightly tighter than AF2's
    1.5 A clash tolerance so built structures pass the violation metric
    with margin. Rejected draws resample (psi[i-1], phi[i]) from loop
    basins, then with growing bias toward the EXTENDED (PPII/beta) basin,
    which steers the chain out of the pocket it walked into. If a site
    exhausts its draws, backtrack a few residues and re-walk. Returns
    (phi, psi, omega); redrawn residues are effectively loop."""
    n = len(ss)
    phi, psi, omega = sample_backbone_torsions(rng, ss)
    N = np.empty((n, 3))
    CA = np.empty((n, 3))
    C = np.empty((n, 3))
    CB = np.empty((n, 3))
    N[0] = (0.0, 0.0, 0.0)
    CA[0] = (_B_N_CA, 0.0, 0.0)
    ang = np.deg2rad(_A_N_CA_C)
    C[0] = CA[0] + _B_CA_C * np.array([-np.cos(ang), np.sin(ang), 0.0])
    CB[0] = ideal_cb(N[0], CA[0], C[0])

    def place(i):
        N[i] = nerf_extend(N[i - 1], CA[i - 1], C[i - 1],
                           _B_C_N, _A_CA_C_N, psi[i - 1])
        CA[i] = nerf_extend(CA[i - 1], C[i - 1], N[i],
                            _B_N_CA, _A_C_N_CA, omega[i - 1])
        C[i] = nerf_extend(C[i - 1], N[i], CA[i],
                           _B_CA_C, _A_N_CA_C, phi[i])
        CB[i] = ideal_cb(N[i], CA[i], C[i])

    O = np.empty((n, 3))  # carbonyl O; O[j] is final once psi[j] is accepted

    def clash_free(i) -> bool:
        prior_ca = CA[: max(i - 2, 0)]
        if prior_ca.size and (
            np.linalg.norm(prior_ca - CA[i], axis=-1).min() < clash_d
        ):
            return False
        # vdW check of the site's new atoms — residue i's N/CA/C/CB plus
        # O(i-1), which depends on psi[i-1], the very torsion redrawn at
        # this site — against all settled atoms (residues < i, O's < i-1)
        O[i - 1] = nerf_extend(N[i - 1], CA[i - 1], C[i - 1],
                               1.231, 120.8, psi[i - 1] - 180.0)
        new = np.stack([N[i], CA[i], C[i], CB[i], O[i - 1]])  # [5, 3]
        new_r = np.array([1.55, 1.7, 1.7, 1.7, 1.52])
        old = np.stack([N[:i], CA[:i], C[:i], CB[:i]], 1)  # [i, 4, 3]
        old_r = np.array([1.55, 1.7, 1.7, 1.7])
        d = np.linalg.norm(old[:, :, None] - new[None, None], axis=-1)
        lim = old_r[None, :, None] + new_r[None, None, :] - overlap_margin
        ok = d >= lim  # [i, 4, 5]
        ok[i - 1, 2, 0] = True  # peptide bond C(i-1)-N(i)
        ok[i - 1, :, 4] = True  # O(i-1) vs its own residue (ideal geometry)
        if not ok.all():
            return False
        if i >= 2:  # new atoms vs settled carbonyl O's
            d_o = np.linalg.norm(O[: i - 1, None] - new[None], axis=-1)
            if (d_o < 1.52 + new_r[None] - overlap_margin).any():
                return False
        return True

    def redraw(i, k):
        """k-th retry draw for site i: loop basins early, extended later."""
        if k < draws_per_site // 2 and rng.random() > 0.3:
            mu_phi, mu_psi = _LOOP_BASINS[rng.choice(len(_LOOP_P), p=_LOOP_P)]
        else:  # extended (PPII / beta): pushes the chain outward
            mu_phi, mu_psi = -110.0, 140.0
        psi[i - 1] = mu_psi + rng.normal() * 20.0
        phi[i] = mu_phi + rng.normal() * 20.0

    i, stuck = 1, 0
    while i < n:
        placed = False
        for k in range(draws_per_site):
            place(i)
            if clash_free(i):
                placed = True
                break
            redraw(i, k)
        if placed:
            stuck = 0
            i += 1
        elif i > 1 and stuck < 50:
            stuck += 1
            for j in range(max(i - backtrack, 1), i):
                redraw(j, draws_per_site)  # loosen the approach path too
            i = max(i - backtrack, 1)
        else:  # pathological; accept the clash rather than loop forever
            stuck = 0
            i += 1
    return phi, psi, omega


def _backbone_rigid_fn(aatype, bb_atoms, bb_mask):
    r = frame_ops.atom37_to_frames(aatype, bb_atoms, bb_mask)[
        "backbone_rigid"]
    return r.quat, r.trans


def _atoms_from_angles_fn(quat, trans, angles, aatype):
    frames8 = frame_ops.torsion_angles_to_frames(Rigid(quat, trans), angles,
                                                 aatype)
    return frame_ops.frames_to_atom37_pos(frames8, aatype)


def _psi_from_atoms_fn(aatype, atoms, mask):
    tor = frame_ops.atom37_to_torsion_angles(aatype, atoms, mask)
    return tor["torsion_angles_sin_cos"][:, 2, :]


def _t(x):
    """A host array as a CPU tensor (int64 for integer arrays, float32
    otherwise)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return torch.as_tensor(x, dtype=torch.long)
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def _geom(fn, *args):
    """One of the three geometry pipelines on CPU float32 tensors (the
    port's ops/frames), back as numpy."""
    out = fn(*(_t(a) for a in args))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _backbone_rigid(aatype, N, CA, C):
    n = len(aatype)
    bb_atoms = np.zeros((n, 37, 3), np.float32)
    bb_mask = np.zeros((n, 37), np.float32)
    bb_atoms[:, 0], bb_atoms[:, 1], bb_atoms[:, 2] = N, CA, C
    bb_mask[:, :3] = 1.0
    return _geom(_backbone_rigid_fn, aatype, bb_atoms, bb_mask)


def _psi_group_angles(aatype, N, CA, C, psi):
    """AF2 psi-GROUP (sin, cos) for desired IUPAC psi, derived through the
    framework's own extraction (no convention guessing): place O by NeRF
    at dihedral(N, CA, C, O) = psi - 180 (the carbonyl O is anti to the
    next N; Engh-Huber C=O 1.231 A, CA-C-O 120.8 deg), then read the psi
    group angle back with ops.frames.atom37_to_torsion_angles."""
    n = len(aatype)
    O = nerf_extend(N, CA, C, 1.231, 120.8, psi - 180.0)
    atoms = np.zeros((n, 37, 3), np.float32)
    mask = np.zeros((n, 37), np.float32)
    atoms[:, 0], atoms[:, 1], atoms[:, 2], atoms[:, 4] = N, CA, C, O
    mask[:, :3] = 1.0
    mask[:, 4] = 1.0
    return _geom(_psi_from_atoms_fn, aatype, atoms, mask)


def _all_atom_from_torsions(aatype, N, CA, C, psi, chi, bb=None,
                            psi_sc=None):
    """Idealized atom37 from the NeRF backbone + psi/chi angles, through
    the framework's own rigid-group pipeline (so featurizer round-trips
    are exact). ``bb`` is a (quat, trans) pair from _backbone_rigid."""
    n = len(aatype)
    if bb is None:
        bb = _backbone_rigid(aatype, N, CA, C)
    if psi_sc is None:
        psi_sc = _psi_group_angles(aatype, N, CA, C, psi)

    # 7 torsions as (sin, cos): omega/phi are baked into the backbone
    # trace already and only place H atoms in AF2's groups (absent in the
    # atom37 heavy-atom world) -> identity. psi places O (group angle from
    # _psi_group_angles); chi1..4 place the side chain.
    angles = np.zeros((n, 7, 2), np.float32)
    angles[:, :, 1] = 1.0  # cos=1 (identity) where unused
    angles[:, 2] = psi_sc
    chi_rad = np.deg2rad(chi)
    angles[:, 3:, 0] = np.sin(chi_rad)
    angles[:, 3:, 1] = np.cos(chi_rad)

    atom37 = _geom(_atoms_from_angles_fn, bb[0], bb[1], angles, aatype)
    mask37 = np.asarray(chem.restype_atom37_mask)[aatype].astype(np.float32)
    return atom37 * mask37[..., None], mask37


_ROTAMER_CHI = [-60.0, 60.0, 180.0]


def pack_sidechains(rng, aatype, N, CA, C, psi, sweeps: int = 3,
                    neighbor_ca_d: float = 12.0):
    """Greedy clash-aware rotamer packing (SCWRL-lite).

    Random rotamers crash sequence-neighbors' side chains into each other
    (measured: overlaps up to 3 A, 91% of residues flagged by the AF2
    clash metric). Candidates are the 9 staggered (chi1, chi2) rotamer
    combos (chi3/chi4 anti); placement goes through the same idealized
    rigid-group pipeline as the final structure, and a few best-response
    sweeps pick per-residue the combo minimizing van-der-Waals overlap
    with the current choice of every residue within ``neighbor_ca_d`` of
    its Ca. Returns chi [N, 4] degrees."""
    n = len(aatype)
    bb = _backbone_rigid(aatype, N, CA, C)
    psi_sc = _psi_group_angles(aatype, N, CA, C, psi)
    combos = [(c1, c2) for c1 in _ROTAMER_CHI for c2 in _ROTAMER_CHI]
    cand = np.empty((len(combos), n, 37, 3), np.float32)
    for k, (c1, c2) in enumerate(combos):
        chi_k = np.tile([c1, c2, 180.0, 180.0], (n, 1))
        cand[k], mask37 = _all_atom_from_torsions(
            aatype, N, CA, C, psi, chi_k, bb=bb, psi_sc=psi_sc
        )
    vdw = np.asarray(chem.atom37_vdw_radius, np.float32)  # [37]

    ca = CA.astype(np.float32)
    ca_d = np.linalg.norm(ca[None] - ca[:, None], axis=-1)
    neighbors = [
        np.where((ca_d[i] < neighbor_ca_d) & (np.arange(n) != i))[0]
        for i in range(n)
    ]
    choice = rng.integers(0, len(combos), n)
    side = np.arange(37) >= 5  # sidechain atoms beyond CB/O
    for _ in range(sweeps):
        changed = 0
        cur = cand[choice, np.arange(n)]  # [N, 37, 3]
        for i in range(n):
            nb = neighbors[i]
            if nb.size == 0:
                continue
            smask = (mask37[i] > 0) & side
            if not smask.any():
                continue
            other = cur[nb]  # [M, 37, 3]
            omask = mask37[nb] > 0  # [M, 37]
            # [K, A_i, M, 37] pairwise overlap of candidate sidechain
            # atoms vs neighbors' current atoms
            p = cand[:, i][:, smask]  # [K, A, 3]
            d = np.linalg.norm(
                p[:, :, None, None] - other[None, None], axis=-1
            )
            rsum = vdw[smask][None, :, None, None] + vdw[None, None, None, :]
            ov = np.maximum(rsum - d - 0.6, 0.0) * omask[None, None]
            cost = ov.sum(axis=(1, 2, 3))
            best = int(np.argmin(cost))
            if best != choice[i]:
                changed += 1
                choice[i] = best
                cur[i] = cand[best, i]
        if changed == 0:
            break
    chi = np.array([combos[c] for c in choice], np.float32)
    chi = np.concatenate(
        [chi, np.tile([180.0, 180.0], (n, 1))], axis=-1
    )
    chi = chi + rng.normal(size=(n, 4)) * 3.0

    # refinement: residues the coarse 9-rotamer grid could not place
    # cleanly get a fine chi1 x chi2 scan (15-degree grid), one at a time
    cur, mask = _all_atom_from_torsions(
        aatype, N, CA, C, psi, chi, bb=bb, psi_sc=psi_sc
    )

    def residue_cost(atoms, i, margin=0.2):
        nb = neighbors[i]
        if nb.size == 0:
            return 0.0
        smask = (mask[i] > 0) & side
        if not smask.any():
            return 0.0
        p = atoms[i][smask]
        other = atoms[nb]
        d = np.linalg.norm(p[:, None, None] - other[None], axis=-1)
        rsum = vdw[smask][:, None, None] + vdw[None, None, :]
        ov = np.maximum(rsum - d - (1.5 - margin), 0.0) * (mask[nb] > 0)[None]
        return float(ov.sum())

    flagged = [i for i in range(n) if residue_cost(cur, i) > 0]
    if flagged:
        grid1 = np.arange(-180.0, 180.0, 15.0)
        grid2 = np.array(_ROTAMER_CHI, np.float32)
        for i in flagged:
            best_cost, best_chi = residue_cost(cur, i), None
            for c1 in grid1:
                for c2 in grid2:
                    trial_chi = chi.copy()
                    trial_chi[i, 0], trial_chi[i, 1] = c1, c2
                    atoms_i, _ = _all_atom_from_torsions(
                        aatype, N, CA, C, psi, trial_chi, bb=bb, psi_sc=psi_sc
                    )
                    trial = cur.copy()
                    trial[i] = atoms_i[i]
                    cost = residue_cost(trial, i)
                    if cost < best_cost - 1e-9:
                        best_cost, best_chi = cost, (c1, c2)
                    if cost == 0.0:
                        break
                if best_cost == 0.0:
                    break
            if best_chi is not None:
                chi[i, 0], chi[i, 1] = best_chi
                atoms_i, _ = _all_atom_from_torsions(
                    aatype, N, CA, C, psi, chi, bb=bb, psi_sc=psi_sc
                )
                cur[i] = atoms_i[i]
    return chi


def make_realistic_window(
    n_res: int = 64,
    frame_time: int = 2,
    node_dim: int = 256,
    edge_dim: int = 128,
    seed: int = 0,
    dyn_backbone_deg: float = 0.15,
    dyn_chi_deg: float = 5.0,
    dt_ps: float = 1.0,
) -> dict:
    """One raw training window with realistic geometry and dynamics.

    Returns the data/featurize.py contract dict (same keys as
    synthetic.make_window) plus extras: 'ss' (the secondary-structure
    plan) and 'sequence' (one-letter string) for drills that write
    mmCIF/fasta.

    ``dyn_backbone_deg`` defaults to 0.15: backbone torsion noise
    amplifies down the chain (lever arm) — 2.5 deg/torsion moved Ca's
    8+ A/frame (measured), far beyond MD's ~0.3-0.8 A at 1 ps. 0.15 deg
    lands in the MD range while chi motion (no lever arm) stays at
    rotamer-libration scale."""
    rng = np.random.default_rng(seed)
    aatype = rng.integers(0, 20, n_res).astype(np.int32)
    ss = sample_ss_plan(rng, n_res)
    phi, psi, omega = build_self_avoiding_backbone(rng, ss)

    # clash-aware rotamer packing for the equilibrium side chains
    chi_mask = np.asarray(chem.chi_angles_mask)[aatype]  # [N, 4]
    eq_n, eq_ca, eq_c = build_backbone(phi, psi, omega)
    chi = pack_sidechains(rng, aatype, eq_n, eq_ca, eq_c, psi)

    # torsion-space OU dynamics (temporally correlated, like MD)
    frames_atoms = []
    cur_phi, cur_psi, cur_omega, cur_chi = phi, psi, omega, chi
    for _ in range(frame_time):
        atoms_n, atoms_ca, atoms_c = build_backbone(cur_phi, cur_psi, cur_omega)
        a37, mask37 = _all_atom_from_torsions(
            aatype, atoms_n, atoms_ca, atoms_c, cur_psi, cur_chi
        )
        frames_atoms.append(a37)
        theta = 0.15  # mean reversion toward the fold's equilibrium angles
        cur_phi = cur_phi + theta * (phi - cur_phi) + rng.normal(size=n_res) * dyn_backbone_deg
        cur_psi = cur_psi + theta * (psi - cur_psi) + rng.normal(size=n_res) * dyn_backbone_deg
        cur_omega = (cur_omega + theta * (omega - cur_omega)
                     + rng.normal(size=n_res) * dyn_backbone_deg * 0.5)
        cur_chi = cur_chi + theta * (chi - cur_chi) + rng.normal(size=(n_res, 4)) * dyn_chi_deg
    atom37 = np.stack(frames_atoms).astype(np.float32)

    # physical channels from the BUILT trajectory: vel = d(Ca)/dt; force =
    # harmonic restoring toward the window mean + OU noise
    ca = atom37[:, :, 1]  # [F, N, 3]
    vel = np.zeros_like(ca)
    if frame_time > 1:
        vel[1:] = (ca[1:] - ca[:-1]) / dt_ps
        vel[0] = vel[1]
    force = -1.0 * (ca - ca.mean(0, keepdims=True))
    noise = np.zeros_like(force)
    for f in range(frame_time):
        prev = noise[f - 1] if f else 0.0
        noise[f] = 0.8 * prev + rng.normal(size=(n_res, 3)) * 0.3
    force = (force + noise).astype(np.float32)

    seq = "".join(chem.RESTYPES[a] for a in aatype)
    return {
        "atom37": atom37,
        "atom37_mask": mask37.astype(np.float32),
        "aatype": aatype,
        "residue_index": np.arange(n_res, dtype=np.int32),
        "force": force,
        "vel": vel.astype(np.float32),
        "node_repr": rng.normal(size=(n_res, node_dim)).astype(np.float32),
        "edge_repr": rng.normal(size=(n_res, n_res, edge_dim)).astype(np.float32),
        "ss": ss,
        "sequence": seq,
        "chi": chi * chi_mask,
        "chi_mask": chi_mask,
    }

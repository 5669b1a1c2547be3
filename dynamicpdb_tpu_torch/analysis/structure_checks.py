"""Structural-quality metrics: C-alpha geometry and clashes, TM-score,
secondary-structure fractions, radius of gyration (numpy only).

Port of ``dynamicpdb_tpu/analysis/structure_checks.py``, the dependency-free
counterpart of the reference's ``protein_metrics`` surface: C-alpha bond
deviation, validity and steric clashes; the exact AF2 violation metrics
(``analysis/violations.py``); TM-score with the Zhang-Skolnick multi-seed
iterative superposition; a Kabsch-Sander DSSP reduced to helix / strand /
coil; the radius of gyration.
"""
from __future__ import annotations

import numpy as np

CA_CA_IDEAL = 3.80209737096  # AF2 residue_constants.ca_ca
C_N_IDEAL = 1.329  # peptide bond length (proline 1.341)
CA_C_N_COS_IDEAL = -0.5203  # cos of ideal CA-C-N angle (~121.7 deg)


# --- C-alpha geometry (metrics.py:120-132 parity) ---------------------------
def ca_ca_distance(ca_pos: np.ndarray, tol: float = 0.1):
    d = np.linalg.norm(ca_pos[1:] - ca_pos[:-1], axis=-1)
    return float(np.mean(np.abs(d - CA_CA_IDEAL))), float(
        np.mean(d < CA_CA_IDEAL + tol)
    )


def ca_ca_clashes(ca_pos: np.ndarray, tol: float = 1.5):
    d = np.linalg.norm(ca_pos[:, None] - ca_pos[None, :], axis=-1)
    iu = np.triu_indices(len(ca_pos), k=1)
    clashes = d[iu] < tol
    return int(np.sum(clashes)), float(np.mean(clashes))


# --- backbone covalent-geometry violations ----------------------------------
# Exact AF2 semantics live in analysis/violations.py (golden-tested vs the
# reference torch implementation); protein_metrics below reports its keys.


# --- TM-score ----------------------------------------------------------------
def _fit_transform(src: np.ndarray, dst: np.ndarray,
                   w: np.ndarray | None = None):
    """Kabsch R, t minimizing sum w |src @ R + t - dst|^2
    (reflection-corrected; uniform weights when w is None)."""
    if w is None:
        w = np.ones(len(src))
    w = w / w.sum()
    src_mean = (src * w[:, None]).sum(0)
    dst_mean = (dst * w[:, None]).sum(0)
    A = src - src_mean
    B = dst - dst_mean
    u, _, vh = np.linalg.svd((A * w[:, None]).T @ B)
    sgn = np.sign(np.linalg.det(u @ vh))
    u[:, -1] *= sgn
    R = u @ vh
    t = dst_mean - src_mean @ R
    return R, t


def tm_score(pred_ca: np.ndarray, gt_ca: np.ndarray, n_iter: int = 20):
    """TM-score (Zhang & Skolnick 2004), normalized by len(gt), full
    multi-seed search as in the published TM-score program: seed
    superpositions from gapless fragments of length L, L/2, L/4, L/8 at
    multiple offsets, refine each by iterating 'superpose on residues with
    d < d_cut' with an escalating cutoff, and keep the maximum
    mean 1 / (1 + (d/d0)^2)."""
    L = len(gt_ca)
    d0 = max(1.24 * max(L - 15, 1) ** (1.0 / 3) - 1.8, 0.5)

    def irls_refine(R, t, iters=20):
        """TM-weighted Kabsch ascent (majorize-minimize on the TM
        objective, weights = d(score)/d(d^2) ~ (1+(d/d0)^2)^-2 — the same
        rotation-refinement idea TM-align uses). Escapes the inlier
        search's hard-threshold local optima on dissimilar structures
        (found by the brute-force oracle, tests/test_tm_oracle.py)."""
        best_local = 0.0
        for _ in range(iters):
            d = np.linalg.norm(pred_ca @ R + t - gt_ca, axis=-1)
            score = float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))
            if score <= best_local + 1e-9:
                break
            best_local = score
            w = 1.0 / (1.0 + (d / d0) ** 2) ** 2
            R, t = _fit_transform(pred_ca, gt_ca, w)
        else:
            # iteration budget exhausted while still improving: the last
            # refit was computed but not yet scored — score it rather than
            # discard a paid-for SVD
            d = np.linalg.norm(pred_ca @ R + t - gt_ca, axis=-1)
            best_local = max(
                best_local, float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))
            )
        return best_local

    def score_from(idx):
        best_local = 0.0
        for d_cut in (d0, d0 + 1.0, d0 + 2.0):
            sel = idx
            last_Rt = None
            for _ in range(n_iter):
                if len(sel) < 3:
                    break
                R, t = _fit_transform(pred_ca[sel], gt_ca[sel])
                last_Rt = (R, t)
                d = np.linalg.norm(pred_ca @ R + t - gt_ca, axis=-1)
                best_local = max(
                    best_local, float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))
                )
                new_sel = np.where(d < d_cut)[0]
                if len(new_sel) >= 3 and (
                    len(new_sel) == len(sel) and np.all(new_sel == sel)
                ):
                    break
                if len(new_sel) >= 3:
                    sel = new_sel
                else:
                    d_cut += 0.5  # too few inliers: widen (TM-score program)
            # ONE IRLS ascent per (fragment, d_cut), from the converged
            # superposition — inside the inlier loop it multiplied
            # tm_score's cost ~20x for the same maximum
            if last_Rt is not None:
                best_local = max(best_local, irls_refine(*last_Rt))
        return best_local

    if L == 0:
        return 0.0
    if L == 1:
        return 1.0  # a single point is always exactly superposable
    if L == 2:
        # two points are NOT always superposable: the best rigid motion
        # aligns midpoints and directions, leaving |d_pred - d_gt| / 2
        # residual on each point
        r = abs(
            float(np.linalg.norm(pred_ca[1] - pred_ca[0]))
            - float(np.linalg.norm(gt_ca[1] - gt_ca[0]))
        ) / 2.0
        return 1.0 / (1.0 + (r / d0) ** 2)
    # always seed from the full chain (the fragment loop below skips it for
    # L < 4, which used to return a spurious 0.0 on tiny/heavily-masked
    # chains even for identical structures)
    best = score_from(np.arange(L))
    frag = L // 2
    while frag >= max(4, L // 8):
        step = max(frag // 2, 1)
        for start in range(0, L - frag + 1, step):
            best = max(best, score_from(np.arange(start, start + frag)))
        if frag == 4:
            break
        frag = max(frag // 2, 4)
    return best


# --- shape metrics -----------------------------------------------------------
def radius_of_gyration(atom37: np.ndarray, mask37: np.ndarray) -> float:
    flat = atom37.reshape(-1, 3)[mask37.reshape(-1).astype(bool)]
    com = flat.mean(0)
    return float(np.sqrt(np.mean(np.sum((flat - com) ** 2, -1))))


def _ks_hbond_energy(
    atom37: np.ndarray, mask37: np.ndarray | None = None
) -> np.ndarray:
    """Kabsch-Sander hydrogen-bond energies E[donor_i, acceptor_j] in
    kcal/mol (DSSP, Kabsch & Sander 1983; the criterion mdtraj's DSSP uses).

    Donor = backbone N-H of residue i (H placed on the N-H direction
    opposite the previous residue's C=O); acceptor = C=O of residue j.
    E = 0.084 * 332 * (1/r_ON + 1/r_CH - 1/r_OH - 1/r_CN).

    mask37: optional [L, 37] atom-presence mask. Residues with missing
    backbone atoms sit at the origin in atom37; without masking, two
    origin-placed atoms are ~0 A apart and fabricate E ~ -28 kcal/mol
    "bonds" (mdtraj skips incomplete residues the same way).
    """
    n, ca, c, o = atom37[:, 0], atom37[:, 1], atom37[:, 2], atom37[:, 4]
    L = len(atom37)
    # amide H: along (N - C_prev) + (N - O_prev), the standard DSSP placement
    h = n.copy()
    co = c[:-1] - o[:-1]
    co /= np.linalg.norm(co, axis=-1, keepdims=True) + 1e-9
    h[1:] = n[1:] + co
    has_h = np.ones(L, bool)
    has_h[0] = False  # N-terminus has no defined amide H
    can_accept = np.ones(L, bool)
    if mask37 is not None:
        m = np.asarray(mask37, bool)
        has_n, has_c, has_o = m[:, 0], m[:, 2], m[:, 4]
        # donor needs its own N plus the previous residue's C=O (H placement)
        has_h &= has_n
        has_h[1:] &= has_c[:-1] & has_o[:-1]
        can_accept = has_c & has_o

    def dist(a, b):
        return np.linalg.norm(a[:, None] - b[None, :], axis=-1) + 1e-9

    q1q2f = 0.084 * 332.0
    E = q1q2f * (
        1.0 / dist(n, o) + 1.0 / dist(h, c) - 1.0 / dist(h, o)
        - 1.0 / dist(n, c)
    )
    E[~has_h, :] = 0.0
    E[:, ~can_accept] = 0.0
    # no bond to self or sequence neighbors (|i-j| < 2), DSSP convention
    idx = np.arange(L)
    E[np.abs(idx[:, None] - idx[None, :]) < 2] = 0.0
    return E


def assign_secondary_structure(
    atom37: np.ndarray, mask37: np.ndarray | None = None
) -> np.ndarray:
    """Simplified DSSP assignment ('H'/'E'/'C', the 3-class reduction
    mdtraj.compute_dssp(simplified=True) reports): Kabsch-Sander H-bonds ->
    n-turns -> helices (two consecutive 4/3/5-turns), and parallel/
    antiparallel bridges -> strands."""
    L = len(atom37)
    ss = np.full(L, "C", dtype=object)
    if L < 5:
        return ss
    E = _ks_hbond_energy(atom37, mask37)
    hbond = E < -0.5  # [donor, acceptor]

    # n-turns: acceptor i, donor i+n
    def turn(nn):
        t = np.zeros(L, bool)
        t[: L - nn] = hbond[nn:, :][np.arange(L - nn), np.arange(L - nn)]
        return t

    t3, t4, t5 = turn(3), turn(4), turn(5)
    helix = np.zeros(L, bool)
    for t, nn in ((t4, 4), (t3, 3), (t5, 5)):
        # helix at i..i+n-1 when turns start at i-1 AND i
        for i in range(1, L - nn):
            if t[i - 1] and t[i]:
                helix[i : i + nn] = True

    # bridges: parallel (Hb(i-1, j) and Hb(j, i+1)) or (Hb(j-1, i), Hb(i, j+1))
    # antiparallel (Hb(i, j) and Hb(j, i)) or (Hb(i-1, j+1) and Hb(j-1, i+1))
    # NOTE hbond[d, a] = donor d -> acceptor a; DSSP's Hb(i, j) means
    # "CO of i accepts from NH of j", i.e. hbond[j, i].
    # Vectorized over the (i, j) plane: shift Hb so entry [i, j] of each
    # shifted matrix reads the required offset lookup, then reduce. The
    # predicate is symmetric under i<->j, so restricting to the j >= i+3
    # upper triangle and OR-ing both axes reproduces the pairwise loop.
    Hb = hbond.T  # Hb[i, j]: CO(i) <- NH(j)
    z = np.zeros((1, L), bool)
    zc = np.zeros((L, 1), bool)
    down = np.vstack([z, Hb[:-1]])     # [i, j] -> Hb[i-1, j]
    left = np.hstack([Hb[:, 1:], zc])  # [i, j] -> Hb[i, j+1]
    c1 = down & left.T                 # Hb[i-1, j] & Hb[j, i+1]
    para = c1 | c1.T                   # second clause = c1 with i<->j
    ur = np.zeros((L, L), bool)
    ur[1:, : L - 1] = Hb[:-1, 1:]      # ur[i, j] = Hb[i-1, j+1]
    anti = (Hb & Hb.T) | (ur & ur.T)   # (ur.T)[i, j] = Hb[j-1, i+1]
    ii, jj = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    valid = (jj >= ii + 3) & (ii >= 1) & (jj <= L - 2)
    bridge = (para | anti) & valid
    strand = bridge.any(axis=1) | bridge.any(axis=0)

    ss[strand] = "E"
    ss[helix] = "H"  # helix wins ties (DSSP priority H > E)
    return ss


def secondary_structure_fractions(
    atom37: np.ndarray, mask37: np.ndarray | None = None
) -> dict:
    """Helix/strand/coil fractions via the Kabsch-Sander criterion (the
    reference reports mdtraj DSSP fractions, metrics.py:55-69)."""
    ss = assign_secondary_structure(atom37, mask37)
    return {
        "helix_percent": float(np.mean(ss == "H")),
        "strand_percent": float(np.mean(ss == "E")),
        "coil_percent": float(np.mean(ss == "C")),
    }


def protein_metrics(atom37: np.ndarray, mask37: np.ndarray,
                    gt_atom37: np.ndarray | None = None,
                    aatype: np.ndarray | None = None,
                    residue_index: np.ndarray | None = None) -> dict:
    """Aggregate (metrics.py:75-118 equivalent). With aatype, the exact AF2
    violation metrics (analysis/violations.py, golden-tested vs the
    reference) are included under their reference keys."""
    bb_ok = mask37[:, 1].astype(bool)
    ca = atom37[bb_ok, 1]
    # CA-CA bonds only between residues adjacent in the FULL chain (both
    # CAs present, and consecutive residue_index when given) — compressing
    # to bb_ok first would make gap-separated residues look bonded and
    # count the ~7-8 A gap-spanning pair as a broken bond
    ca_all = atom37[:, 1]
    pair_ok = bb_ok[1:] & bb_ok[:-1]
    if residue_index is not None:
        ridx = np.asarray(residue_index)
        pair_ok = pair_ok & ((ridx[1:] - ridx[:-1]) == 1)
    d = np.linalg.norm(ca_all[1:] - ca_all[:-1], axis=-1)[pair_ok]
    if len(d):
        dev = float(np.mean(np.abs(d - CA_CA_IDEAL)))
        valid = float(np.mean(d < CA_CA_IDEAL + 0.1))
    else:
        dev, valid = 0.0, 1.0
    n_clash, clash_pct = ca_ca_clashes(ca)
    # secondary structure on the FULL arrays (mask-aware): sequence
    # adjacency in the turn/bridge logic must follow chain position, not
    # the compressed present-residue index; fractions are reported over
    # residues with backbone present (mdtraj marks incomplete residues NA)
    ss = assign_secondary_structure(atom37, mask37)
    ss_obs = ss[bb_ok] if bb_ok.any() else ss
    out = {
        "ca_ca_bond_dev": dev,
        "ca_ca_valid_percent": valid,
        "num_ca_steric_clashes": n_clash,
        "ca_steric_clash_percent": clash_pct,
        "radius_of_gyration": radius_of_gyration(atom37, mask37),
        "helix_percent": float(np.mean(ss_obs == "H")),
        "strand_percent": float(np.mean(ss_obs == "E")),
        "coil_percent": float(np.mean(ss_obs == "C")),
    }
    if aatype is not None:
        from dynamicpdb_tpu_torch.analysis.violations import (
            compute_violation_metrics,
        )

        if residue_index is None:
            residue_index = np.arange(len(aatype), dtype=np.int64)
        vm = compute_violation_metrics(
            atom37, mask37, np.asarray(aatype, np.int64), residue_index
        )
        out.update({
            k: vm[k] for k in (
                "violations_extreme_ca_ca_distance",
                "violations_between_residue_bond",
                "violations_between_residue_clash",
                "violations_within_residue",
                "violations_per_residue",
                "num_residue_violations",
            )
        })
    if gt_atom37 is not None:
        out["tm_score"] = tm_score(ca, gt_atom37[bb_ok, 1])
    return out

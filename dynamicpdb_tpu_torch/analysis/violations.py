"""AF2 structural-violation metrics (numpy only).

Port of ``dynamicpdb_tpu/analysis/violations.py``: Jumper et al. (2021)
Suppl. Sec. 1.9.11 (eqs 44-46) with the semantics of the reference's
violation stack (openfold ``utils/loss.py`` and
``np/relax/amber_minimize.py``): peptide-bond length and angle violations,
between-residue van-der-Waals clashes (with the C-N peptide and CYS-SG
disulfide exclusions), within-residue distance-bound violations, and the
aggregate metric keys of ``compute_violation_metrics``. The constants come
from the port's own ``chem/tables.npz`` (byte-identical to the JAX
package's): van-der-Waals radii, bond and angle statistics, atom14
distance bounds at overlap 1.5 and tolerance 12 sigma.

``atom37_to_atom14(atom37, mask37, aatype)`` keeps the JAX module's
argument order; ``ops/frames.atom37_to_atom14`` takes its arguments in
another order and is the model's tensor version.
"""
from __future__ import annotations

import numpy as np

from dynamicpdb_tpu_torch.chem import constants as chem

PRO_IDX = 14  # 'P' in the AF2 restype order
CYS_SG_ATOM14_IDX = 5  # 'SG' slot in CYS's atom14 layout


def _tables():
    return chem._tables()


def _relu(x):
    return np.maximum(x, 0.0)


def atom37_to_atom14(atom37, mask37, aatype):
    """Gather atom14 positions/masks (make_atom14_positions equivalent)."""
    t = _tables()
    a14_to_a37 = np.asarray(t["restype_atom14_to_atom37"])[aatype]  # [N, 14]
    a14_exists = np.asarray(t["restype_atom14_mask"])[aatype]
    gather = np.take_along_axis(mask37, a14_to_a37, axis=1)
    atom14_mask = a14_exists * gather
    pos = np.take_along_axis(atom37, a14_to_a37[..., None], axis=1)
    return pos * atom14_mask[..., None], atom14_mask, a14_to_a37


def between_residue_bond_violations(
    pred_pos, pred_mask, residue_index, aatype,
    tolerance_factor: float = 12.0, eps: float = 1e-6,
):
    """loss.py:714-872 (soft == hard tolerance, as find_structural_violations
    uses)."""
    t = _tables()
    (cn_len, cn_len_pro, cn_std, cn_std_pro, ca_c_n_cos, _ca_c_n_std,
     c_n_ca_cos, c_n_ca_std, _) = np.asarray(t["violation_scalars"])

    this_ca, this_c = pred_pos[:-1, 1], pred_pos[:-1, 2]
    next_n, next_ca = pred_pos[1:, 0], pred_pos[1:, 1]
    this_ca_m, this_c_m = pred_mask[:-1, 1], pred_mask[:-1, 2]
    next_n_m, next_ca_m = pred_mask[1:, 0], pred_mask[1:, 1]
    no_gap = (residue_index[1:] - residue_index[:-1]) == 1.0

    c_n = np.sqrt(eps + np.sum((this_c - next_n) ** 2, -1))
    next_is_pro = aatype[1:] == PRO_IDX
    gt_len = np.where(next_is_pro, cn_len_pro, cn_len)
    gt_std = np.where(next_is_pro, cn_std_pro, cn_std)
    c_n_err = np.sqrt(eps + (c_n - gt_len) ** 2)
    c_n_loss_pr = _relu(c_n_err - tolerance_factor * gt_std)
    mask = this_c_m * next_n_m * no_gap
    c_n_loss = np.sum(mask * c_n_loss_pr) / (np.sum(mask) + eps)
    c_n_viol = mask * (c_n_err > tolerance_factor * gt_std)

    ca_c = np.sqrt(eps + np.sum((this_ca - this_c) ** 2, -1))
    n_ca = np.sqrt(eps + np.sum((next_n - next_ca) ** 2, -1))
    c_ca_u = (this_ca - this_c) / ca_c[:, None]
    c_n_u = (next_n - this_c) / c_n[:, None]
    n_ca_u = (next_ca - next_n) / n_ca[:, None]

    ca_c_n = np.sum(c_ca_u * c_n_u, -1)
    # reference quirk preserved: the ca_c_n angle check uses the C-N BOND
    # stddev, not the angle stddev (loss.py:812)
    ca_c_n_err = np.sqrt(eps + (ca_c_n - ca_c_n_cos) ** 2)
    ca_c_n_loss_pr = _relu(ca_c_n_err - tolerance_factor * cn_std)
    mask2 = this_ca_m * this_c_m * next_n_m * no_gap
    ca_c_n_loss = np.sum(mask2 * ca_c_n_loss_pr) / (np.sum(mask2) + eps)
    ca_c_n_viol = mask2 * (ca_c_n_err > tolerance_factor * cn_std)

    c_n_ca = np.sum((-c_n_u) * n_ca_u, -1)
    c_n_ca_err = np.sqrt(eps + (c_n_ca - c_n_ca_cos) ** 2)
    c_n_ca_loss_pr = _relu(c_n_ca_err - tolerance_factor * c_n_ca_std)
    mask3 = this_c_m * next_n_m * next_ca_m * no_gap
    c_n_ca_loss = np.sum(mask3 * c_n_ca_loss_pr) / (np.sum(mask3) + eps)
    c_n_ca_viol = mask3 * (c_n_ca_err > tolerance_factor * c_n_ca_std)

    per_res = c_n_loss_pr + ca_c_n_loss_pr + c_n_ca_loss_pr
    per_res = 0.5 * (np.pad(per_res, (0, 1)) + np.pad(per_res, (1, 0)))
    viol = np.max(np.stack([c_n_viol, ca_c_n_viol, c_n_ca_viol]), axis=0)
    viol = np.maximum(np.pad(viol, (0, 1)), np.pad(viol, (1, 0)))
    return {
        "c_n_loss_mean": c_n_loss,
        "ca_c_n_loss_mean": ca_c_n_loss,
        "c_n_ca_loss_mean": c_n_ca_loss,
        "per_residue_loss_sum": per_res,
        "per_residue_violation_mask": viol,
    }


def between_residue_clashes(
    atom14_pos, atom14_mask, atom14_radius, residue_index,
    overlap_tolerance: float = 1.5, eps: float = 1e-10,
):
    """loss.py:873-1018."""
    dists = np.sqrt(
        eps + np.sum(
            (atom14_pos[:, None, :, None] - atom14_pos[None, :, None, :]) ** 2,
            -1,
        )
    )
    dmask = atom14_mask[:, None, :, None] * atom14_mask[None, :, None, :]
    dmask = dmask * (
        residue_index[:, None, None, None] < residue_index[None, :, None, None]
    )
    c_one = np.eye(14)[2]
    n_one = np.eye(14)[0]
    neighbour = (
        residue_index[:, None, None, None] + 1
    ) == residue_index[None, :, None, None]
    dmask = dmask * (
        1.0 - neighbour * c_one[None, None, :, None] * n_one[None, None, None, :]
    )
    sg = np.eye(14)[CYS_SG_ATOM14_IDX]
    dmask = dmask * (
        1.0 - sg[None, None, :, None] * sg[None, None, None, :]
    )

    lower = dmask * (
        atom14_radius[:, None, :, None] + atom14_radius[None, :, None, :]
    )
    err = dmask * _relu(lower - overlap_tolerance - dists)
    mean_loss = np.sum(err) / (1e-6 + np.sum(dmask))
    per_atom_loss = np.sum(err, axis=(0, 2)) + np.sum(err, axis=(1, 3))
    clash = dmask * (dists < lower - overlap_tolerance)
    per_atom_clash = np.maximum(
        np.max(clash, axis=(0, 2)), np.max(clash, axis=(1, 3))
    )
    return {
        "mean_loss": mean_loss,
        "per_atom_loss_sum": per_atom_loss,
        "per_atom_clash_mask": per_atom_clash,
    }


def within_residue_violations(
    atom14_pos, atom14_mask, lower_bound, upper_bound, eps: float = 1e-10,
):
    """loss.py:1020-1105 (tighten_bounds_for_loss = 0)."""
    dmask = (1.0 - np.eye(14))[None] * (
        atom14_mask[:, :, None] * atom14_mask[:, None, :]
    )
    dists = np.sqrt(
        eps + np.sum(
            (atom14_pos[:, :, None] - atom14_pos[:, None, :]) ** 2, -1
        )
    )
    low_err = _relu(lower_bound - dists)
    high_err = _relu(dists - upper_bound)
    loss = dmask * (low_err + high_err)
    per_atom_loss = np.sum(loss, -2) + np.sum(loss, -1)
    viol = dmask * ((dists < lower_bound) | (dists > upper_bound))
    per_atom_viol = np.maximum(np.max(viol, -2), np.max(viol, -1))
    return {
        "per_atom_loss_sum": per_atom_loss,
        "per_atom_violations": per_atom_viol,
    }


def find_structural_violations(
    atom37, mask37, aatype, residue_index,
    violation_tolerance_factor: float = 12.0,
    clash_overlap_tolerance: float = 1.5,
):
    """loss.py:1107-1218 on atom37 inputs (the atom14 gather is internal)."""
    t = _tables()
    atom14_pos, atom14_mask, a14_to_a37 = atom37_to_atom14(
        atom37, mask37, aatype
    )
    conn = between_residue_bond_violations(
        atom14_pos, atom14_mask, residue_index, aatype,
        tolerance_factor=violation_tolerance_factor,
    )
    radius = atom14_mask * np.asarray(t["atom37_vdw_radius"])[a14_to_a37]
    clashes = between_residue_clashes(
        atom14_pos, atom14_mask, radius, residue_index,
        overlap_tolerance=clash_overlap_tolerance,
    )
    # bounds tables are generated at exactly (1.5, 12); other configs need a
    # regenerated chem/tables.npz
    assert clash_overlap_tolerance == 1.5 and violation_tolerance_factor == 12
    within = within_residue_violations(
        atom14_pos, atom14_mask,
        np.asarray(t["atom14_dists_lower_bound"])[aatype],
        np.asarray(t["atom14_dists_upper_bound"])[aatype],
    )
    total_mask = np.max(
        np.stack(
            [
                conn["per_residue_violation_mask"],
                np.max(clashes["per_atom_clash_mask"], -1),
                np.max(within["per_atom_violations"], -1),
            ]
        ),
        axis=0,
    )
    return {
        "between_residues": {
            "bonds_c_n_loss_mean": conn["c_n_loss_mean"],
            "angles_ca_c_n_loss_mean": conn["ca_c_n_loss_mean"],
            "angles_c_n_ca_loss_mean": conn["c_n_ca_loss_mean"],
            "connections_per_residue_loss_sum": conn["per_residue_loss_sum"],
            "connections_per_residue_violation_mask": conn[
                "per_residue_violation_mask"
            ],
            "clashes_mean_loss": clashes["mean_loss"],
            "clashes_per_atom_loss_sum": clashes["per_atom_loss_sum"],
            "clashes_per_atom_clash_mask": clashes["per_atom_clash_mask"],
        },
        "within_residues": dict(within),
        "total_per_residue_violations_mask": total_mask,
        "_atom14": (atom14_pos, atom14_mask),
    }


def compute_violation_metrics(
    atom37, mask37, aatype, residue_index, seq_mask=None,
):
    """The reference's metric keys (loss.py:1274-1335 +
    amber_minimize.get_violation_metrics:393-403)."""
    t = _tables()
    ca_ca_ideal = float(np.asarray(t["violation_scalars"])[8])
    v = find_structural_violations(atom37, mask37, aatype, residue_index)
    atom14_pos, atom14_mask = v.pop("_atom14")
    if seq_mask is None:
        seq_mask = np.ones_like(aatype, np.float32)

    def masked_mean(mask, value):
        return float(np.sum(mask * value) / (np.sum(mask) + 1e-10))

    this_ca, next_ca = atom14_pos[:-1, 1], atom14_pos[1:, 1]
    no_gap = (residue_index[1:] - residue_index[:-1]) == 1.0
    d = np.sqrt(1e-6 + np.sum((this_ca - next_ca) ** 2, -1))
    ext_mask = atom14_mask[:-1, 1] * atom14_mask[1:, 1] * no_gap
    ret = {
        "violations_extreme_ca_ca_distance": masked_mean(
            ext_mask, (d - ca_ca_ideal) > 1.5
        ),
        "violations_between_residue_bond": masked_mean(
            seq_mask,
            v["between_residues"]["connections_per_residue_violation_mask"],
        ),
        "violations_between_residue_clash": masked_mean(
            seq_mask,
            np.max(v["between_residues"]["clashes_per_atom_clash_mask"], -1),
        ),
        "violations_within_residue": masked_mean(
            seq_mask, np.max(v["within_residues"]["per_atom_violations"], -1)
        ),
        "violations_per_residue": masked_mean(
            seq_mask, v["total_per_residue_violations_mask"]
        ),
    }
    viol_idx = np.flatnonzero(v["total_per_residue_violations_mask"])
    ret["residue_violations"] = viol_idx
    ret["num_residue_violations"] = len(viol_idx)
    ret["structural_violations"] = v
    return ret

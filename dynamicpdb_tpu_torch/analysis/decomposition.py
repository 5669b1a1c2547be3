"""Teacher-forced decomposition of the all-atom error.

Port of ``dynamicpdb_tpu/analysis/decomposition.py``. The all-atom metrics
compare the model's idealised-geometry reconstruction (rigids + 7 torsions
-> atom positions, ``ops/frames.py``) with raw ground-truth atoms. Where
those atoms are not in the decoder's image (MD bond lengths and angles
fluctuate) there is a floor no model can beat. Atoms are rebuilt from
every combination of {GT, predicted} rigids x {GT, predicted} torsions:

  floor        = decode(GT rigids,   GT torsions)   vs GT atoms
  rigids_only  = decode(pred rigids, GT torsions)   vs GT atoms
  torsion_only = decode(GT rigids,   pred torsions) vs GT atoms
  model        = decode(pred rigids, pred torsions) vs GT atoms
"""
from __future__ import annotations

import torch

from dynamicpdb_tpu_torch.analysis.metrics import (
    masked_atom_error,
    superimposed_rmsd_atom37,
)
from dynamicpdb_tpu_torch.ops import frames as frame_ops
from dynamicpdb_tpu_torch.ops.rigid import Rigid


def _decode_atom37(rigids7, angles, aatype):
    all_frames = frame_ops.torsion_angles_to_frames(
        Rigid.from_tensor_7(rigids7), angles, aatype)
    atom14 = frame_ops.frames_to_atom14_pos(all_frames, aatype)
    atom37, _ = frame_ops.atom14_to_atom37(atom14, aatype)
    return atom37


def _errors(pred37, gt37, mask37) -> dict:
    mae, _ = masked_atom_error(pred37, gt37, mask37)
    sup = superimposed_rmsd_atom37(pred37, gt37, mask37)
    return {"mae": mae[-1], "rmsd": sup[-1]}


def atom_error_decomposition(feats: dict, model_out: dict | None = None):
    """Last-frame all-atom error decomposition of one window.

    feats: a featurized window (``featurize_window``) with rigids_0,
    torsion_angles_sin_cos, aatype, atom37_pos and atom37_mask.
    model_out: optional, with the predicted 'rigids' and 'angles'.
    Returns {part: {"mae", "rmsd"}} of 0-d tensors."""
    aatype = feats["aatype"].long()
    gt37 = feats["atom37_pos"]
    mask37 = torch.broadcast_to(feats["atom37_mask"],
                                gt37.shape[:-1]).float()
    gt_rigids = feats["rigids_0"]
    gt_angles = feats["torsion_angles_sin_cos"]
    out = {"floor": _errors(_decode_atom37(gt_rigids, gt_angles, aatype),
                            gt37, mask37)}
    if model_out is not None:
        pred_rigids, pred_angles = model_out["rigids"], model_out["angles"]
        out["rigids_only"] = _errors(
            _decode_atom37(pred_rigids, gt_angles, aatype), gt37, mask37)
        out["torsion_only"] = _errors(
            _decode_atom37(gt_rigids, pred_angles, aatype), gt37, mask37)
        out["model"] = _errors(
            _decode_atom37(pred_rigids, pred_angles, aatype), gt37, mask37)
    return out

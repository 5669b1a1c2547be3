"""Checkpoint save and restore.

Port of ``dynamicpdb_tpu/train/checkpoint.py``: one ``torch.save`` file
holding the model state dict, the optimizer state, the step, the epoch,
the config as a dict and the noise generator's state, all restored on
resume. A data-parallel run gathers the whole parameters and moments on
every rank and rank 0 writes them, so the file is the same whatever the
mesh, and any mesh restores it. The write is atomic (a temporary file, then a rename),
so a preempted job never leaves a truncated checkpoint. ``serve_cli
--ckpt`` reads the model from such a file as well as from a bare state
dict (``model_state_dict``).
"""
from __future__ import annotations

import os

import torch


def save(path: str, model, optimizer, step: int, epoch: int,
         config: dict | None = None, rng: torch.Tensor | None = None):
    """``model`` and ``optimizer``: the objects or their state dicts (a
    data-parallel run gathers them on every rank, and rank 0 writes)."""
    if isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer.state_dict()
    payload = {
        "model": (model.state_dict() if isinstance(model, torch.nn.Module)
                  else model),
        "optimizer": optimizer,
        "step": int(step),
        "epoch": int(epoch),
        "config": config,
        "rng": rng,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(path: str, model: torch.nn.Module, optimizer=None) -> dict:
    """Load the checkpoint into ``model`` (strict) and ``optimizer`` (when
    given and saved); returns the payload (step, epoch, config, rng)."""
    device = next(model.parameters()).device
    payload = load(path, map_location=device)
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None and payload.get("optimizer") is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if payload.get("rng") is not None:
        payload["rng"] = payload["rng"].cpu()
    return payload


def model_state_dict(path: str, map_location="cpu") -> tuple[dict, int]:
    """(model state dict, step) from a training checkpoint, or from a bare
    state dict (step -1)."""
    payload = load(path, map_location)
    if isinstance(payload.get("model"), dict):
        return payload["model"], int(payload.get("step", -1))
    return payload, -1

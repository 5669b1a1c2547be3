"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device="cuda", backend: str | None = None) -> torch.device:
    """The torch.device for ``device``; raises when a CUDA device is asked
    for and none is present (nothing falls back to the CPU). On CUDA it
    turns TF32 off for matmuls and cuDNN convolutions, so float32 work stays
    float32 as it is in the JAX package.

    Under a launcher (``LOCAL_RANK`` set), ``"cuda"`` without an index is
    ``cuda:{LOCAL_RANK}``, made the current device. With ``backend`` NCCL
    (the default for CUDA) it raises when the node's ranks outnumber its
    cards: NCCL refuses two ranks on one card (gloo takes them, given an
    explicit ``cuda:0``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
        cards = torch.cuda.device_count()
        if (backend or "nccl") == "nccl" and local_world > cards:
            raise ValueError(
                f"{local_world} ranks on this node under NCCL need "
                f"{local_world} cards, torch sees {cards}: NCCL refuses two "
                "ranks on one card")
        if local_rank >= cards:
            raise ValueError(f"local rank {local_rank} has no card: torch "
                             f"sees {cards}")
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is not None:
            torch.cuda.set_device(dev)
    return dev

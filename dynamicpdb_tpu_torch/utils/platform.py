"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device``; raises when a CUDA device is asked
    for and none is present (nothing falls back to the CPU). On CUDA it
    turns TF32 off for matmuls and cuDNN convolutions, so float32 work stays
    float32 as it is in the JAX package."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

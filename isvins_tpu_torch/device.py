"""Device resolution and the precision policy of the port.

Every function of the port takes its device explicitly; this module only
turns a user's request into a `torch.device` and sets the global float32
policy once. TF32 is switched off for matmuls and cuDNN: the f32 steady
solve is held to f32 references, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device when a card is present, else the
    CPU. A CUDA request without a card raises (no silent CPU run)."""
    set_precision()
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev

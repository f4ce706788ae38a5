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
    """`None` -> the current CUDA device; the CPU only when the caller says
    `device="cpu"`. Without a card, `None` and any CUDA request raise (no
    silent CPU run)."""
    set_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} needs a CUDA card and none is available; "
                'pass device="cpu" to run on the CPU')
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

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


def device_const(values, dtype, device) -> torch.Tensor:
    """A small constant on `device` without a host sync: made on the host
    and copied with non_blocking=True (a copy from pageable memory is staged
    at once, so the calling thread does not wait for the device, where a
    blocking copy, as torch.tensor(..., device=cuda) makes, synchronizes)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


_SHARED = {}  # (values, dtype, device) -> the tensor shared_const made


def shared_const(values, dtype, device) -> torch.Tensor:
    """A small read-only constant on `device`, made on the first call for
    its values, dtype and device and returned to every later one. The first
    call copies it with a blocking copy, so it is on the device when the
    call returns and any stream may read it; a later call enqueues nothing,
    so it may sit inside a CUDA graph capture (the tracker's steady step)."""
    key = (tuple(values), dtype, torch.device(device))
    t = _SHARED.get(key)
    if t is None:
        t = _SHARED[key] = torch.tensor(values, dtype=dtype, device=device)
    return t

"""Build and load the hand-written CUDA kernels (csrc/*.cu).

All kernels compile into ONE shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/libisvins_kernels_<hash>.so csrc/*.cu

at first use, from the checkout's own sources, into `build/kernels/` at
the repository root (git-ignored). The file name carries a hash of the
sources, so an edited kernel is rebuilt and a stale library is never
loaded. `-fmad=false` keeps every multiply and add separately rounded, as
the plain PyTorch versions' elementwise ops are: contracted FMAs change the
last bits, which the projection chain amplifies ~1e5x for a landmark near
the camera plane (|z| ~ 1e-6 after the clamp). The library is loaded
with ctypes; every pointer and the stream are passed as c_void_p. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# C entry points: name -> argument kinds ("p" pointer, "i" int). Every
# function takes the stream last and returns cudaGetLastError() as int.
_SIGNATURES = {
    "isv_proj_rows": "p" * 14 + "i",
    "isv_imu_rows": "p" * 20 + "i",
    "isv_schur_corr": "p" * 6 + "ii",
    "isv_linstep_solve": "p" * 10 + "iiii",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # seconds, ptxas report, path of the last build/load


def _sources():  # the flags and every source file key the library
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed library (no-op when present)."""
    out = BUILD_DIR / f"libisvins_kernels_{source_hash()}.so"
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info["path"] = str(out)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp)] + [
        str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr, path=str(out))
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, kinds in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                               for k in kinds] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(t: torch.Tensor, name: str, shape, dtype=torch.float32, device=None):
    """Raise unless t has exactly this shape/dtype/device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: device {t.device} != {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(name: str, *args, device: torch.device):
    """Call a C entry point on the current stream of `device`; raise on a
    non-zero CUDA error. Tensors are passed by data pointer; the caller
    keeps them alive across the call."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib(), name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")

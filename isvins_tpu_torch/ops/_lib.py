"""Build and load the hand-written CUDA kernels (csrc/*.cu).

All kernels compile into ONE shared library with a plain C interface: one

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu

per source, all started together, then one `nvcc -shared` link into
build/kernels/libisvins_kernels_<hash>.so, at first use, from the
checkout's own sources, into `build/kernels/` at the repository root
(git-ignored). The file name carries a hash of the
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
    "isv_proj_rows": "p" * 14 + "ii",
    "isv_imu_rows": "p" * 20 + "ii",
    "isv_schur_corr": "p" * 6 + "i" * 6,
    "isv_linstep_solve": "p" * 10 + "iiii",
    "isv_chol_solve_batched": "ppp" + "ii",
    "isv_chol_plan": "ip",
    "isv_retrieval_scores": "p" * 5 + "ii",
    "isv_schur_reduce": "p" * 7 + "i" * 6,
    "isv_noop": "",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)

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
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    # one compile per source, all running at once; then one link
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
    logs = [(obj, proc, proc.communicate()[1]) for obj, proc in jobs]
    try:
        for obj, proc, err in logs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {obj.name}:\n{err[-6000:]}")
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp)] + [str(o) for o, _, _ in logs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-6000:]}")
        os.replace(tmp, out)
    finally:
        for obj, _, _ in logs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(out),
                      ptxas="".join(err for _, _, err in logs))
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


def seq_rows(n: int, per_seq: torch.Tensor, name: str) -> int:
    """Rows per sequence when `n` rows are S equal runs laid end to end and
    `per_seq` is one vector (k,) for all of them or one per run (S,k)."""
    S = per_seq.shape[0] if per_seq.dim() == 2 else 1
    if S < 1 or n % S:
        raise ValueError(f"{name}: {n} rows do not split into {S} sequences")
    return max(n // S, 1)


def launch(name: str, *args, device: torch.device):
    """Call a C entry point on the current stream of `device`, with
    `device` the current device while it runs (the CUDA runtime launches
    on the thread's current device, whatever the stream's); raise on a
    non-zero CUDA error. Tensors are passed by data pointer; the caller
    keeps them alive across the call."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")

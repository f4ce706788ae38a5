"""ctypes bindings for the native host runtime (port of isvins_tpu/native.py
over the repository's native/isvins_native.cpp): fast EuRoC CSV ingestion
and the IMU/image measurement aligner, the C++ counterpart of the
reference's driver readers (run_euroc.cpp) and of System.cpp's
getMeasurements with mid-frame interpolation.

The library is built at first use with

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o build/native/libisvins_native_<hash>.so
        native/isvins_native.cpp

into `build/native/` at the repository root (git-ignored); the name
carries a hash of the source and flags, so an edited source is rebuilt.
Without a compiler `available()` is False and the EuRoC loader parses with
numpy instead. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "isvins_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_D = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _build() -> Optional[Path]:
    """The library for this source, built with g++ if it is not there yet;
    None without a compiler or source."""
    cxx = shutil.which("g++")
    if not SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libisvins_native_{h}.so"
    if so.exists():
        return so
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    tmp.replace(so)  # atomic: a concurrent loader never sees half a file
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        so = _build()  # a compiler that fails raises here
        if so is None:
            _tried = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.parse_csv_ns.restype = ctypes.c_long
        lib.parse_csv_ns.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long, _D, _D]
        lib.aligner_create.restype = ctypes.c_void_p
        lib.aligner_destroy.argtypes = [ctypes.c_void_p]
        lib.aligner_push_imu.argtypes = [ctypes.c_void_p, ctypes.c_double, _D, _D]
        lib.aligner_ready.restype = ctypes.c_int
        lib.aligner_ready.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.aligner_collect.restype = ctypes.c_long
        lib.aligner_collect.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_long, _D]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def parse_csv_ns(path: str, cols: int, max_rows: int = 2_000_000):
    """Parse a CSV whose first column is a nanosecond stamp. Returns
    (ts_seconds (n,), data (n, cols)), or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    ts = np.empty(max_rows)
    data = np.empty((max_rows, cols))
    n = lib.parse_csv_ns(str(path).encode(), cols, max_rows, _ptr(ts), _ptr(data))
    if n < 0:
        raise FileNotFoundError(path)
    return ts[:n].copy(), data[:n].copy()


class NativeAligner:
    """IMU/image measurement aligner (System.cpp:160-202, 279-296
    semantics) on the C++ ring buffer."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (no g++)")
        self._lib = lib
        self._h = lib.aligner_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.aligner_destroy(self._h)
            self._h = None

    def push_imu(self, t: float, acc, gyr):
        acc = np.ascontiguousarray(acc, dtype=np.float64)
        gyr = np.ascontiguousarray(gyr, dtype=np.float64)
        self._lib.aligner_push_imu(self._h, t, _ptr(acc), _ptr(gyr))

    def ready(self, t_img: float) -> bool:
        return bool(self._lib.aligner_ready(self._h, t_img))

    def collect(self, t_img: float, max_rows: int = 4096):
        """(dts (n,), accs (n,3), gyrs (n,3)), or None if not ready."""
        out = np.empty((max_rows, 7))
        n = self._lib.aligner_collect(self._h, t_img, max_rows, _ptr(out))
        if n < 0:
            return None
        return out[:n, 0].copy(), out[:n, 1:4].copy(), out[:n, 4:7].copy()

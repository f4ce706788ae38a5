#!/usr/bin/env python3
"""Where the time of the blocked Cholesky routine (csrc/chol.cuh, shared by
K4 and K5) goes, on one card.

    python3 chol_breakdown.py

Builds K5 (csrc/chol_batched.cu) several times into build/chol_breakdown/,
each from this checkout's sources with one part of the routine cut out by a
text patch, and times each by graph replay (chip_smoke.graph_ms) at D = 276
and NB = 1 and 16 on chip_smoke.chol_inputs: the whole routine, then without
the trailing update, without the look-ahead factor of the next diagonal
tile, without the triangular solves, the tile fill alone, and an empty
block. The differences are what each part adds to the critical path (a part
that overlaps others shows only what it adds beyond them). Only the whole
routine computes x; it is held against the plain version. Prints the card,
one line per build and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

FACTOR_AND_SOLVE = ("  chol_factor_tiles(tiles, plan.T, bad);\n"
                    "  if (!*bad) chol_solve_tiles(tiles, vec, plan.T);\n")
# name -> ([(old, new)] patches of chol.cuh, [(old, new)] of chol_batched.cu)
CUTS = {
    "whole": ([], []),
    "no_trailing_update": ([("chol_tile_product<true, false>(chol_tile(tiles, i, j)",
                             "if (0) chol_tile_product<true, false>(chol_tile(tiles, i, j)")], []),
    "no_next_diagonal_factor": ([("      if (!chol_diag(Dn, lane) && lane == 0) *bad = 1;", "")],
                                []),
    "no_solves": ([], [("  if (!*bad) chol_solve_tiles(tiles, vec, plan.T);\n", "")]),
    "fill_only": ([], [(FACTOR_AND_SOLVE, "")]),
    "empty_block": ([], [(FACTOR_AND_SOLVE, ""),
                         ("  chol_fill(tiles, plan.T, D, [&](int a, int k) "
                          "{ return Hn[(size_t)a * D + k]; });\n", "")]),
}


def build(name, patches, out):
    """Compile chol_batched.cu with the cut applied; returns the Popen."""
    from isvins_tpu_torch.ops import _lib

    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for src, cuts in (("chol.cuh", patches[0]), ("chol_batched.cu", patches[1])):
        text = (_lib.CSRC / src).read_text()
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: {src} no longer holds {old!r}")
            text = text.replace(old, new)
        (d / src).write_text(text)
    (d / "common.cuh").write_text((_lib.CSRC / "common.cuh").read_text())
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(d), "-o", str(d / "lib.so"),
           str(d / "chol_batched.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main():
    import torch

    import chip_smoke
    from isvins_tpu_torch import ops

    if not torch.cuda.is_available():
        print("no CUDA card")
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out = ROOT / "build" / "chol_breakdown"
    procs = {name: build(name, cut, out) for name, cut in CUTS.items()}
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.isv_chol_solve_batched.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        libs[name] = lib
    dev = torch.device("cuda")
    rec = {}
    for NB in (1, 16):
        H, b = chip_smoke.chol_inputs(dev, NB)
        x = torch.empty_like(b)
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.isv_chol_solve_batched(H.data_ptr(), b.data_ptr(), x.data_ptr(), NB,
                                                H.shape[-1], stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if name == "whole":
                ref = ops.chol_solve_batched_ref(H, b)
                chip_smoke._assert_close("whole routine", (x,), (ref,), 2e-3,
                                         lambda r: 2e-3 * float(r.abs().max()))
            rec[f"{name}@NB{NB}"] = chip_smoke.graph_ms(call)
            print(f"NB={NB} {name}: {rec[f'{name}@NB{NB}'] * 1e3:.2f} us")
    print(json.dumps({"card": smi, "chol_breakdown_ms": rec}))


if __name__ == "__main__":
    main()

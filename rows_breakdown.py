#!/usr/bin/env python3
"""Where the time of the factor kernels K1 (csrc/proj_rows.cu) and K2
(csrc/imu_rows.cu) goes, on one card.

    python3 rows_breakdown.py

Builds each kernel several times into build/rows_breakdown/, each from
this checkout's sources with one part cut out by a text patch, and times
each by graph replay (chip_smoke.graph_ms) at the main paths' shapes: K1 at
N = 3072 rows and 16 x 3072 (chip_smoke.proj_case), K2 at n = 17 and 272
factors (chip_smoke.imu_case). The cuts: the whole kernel; without the
stores of the staged outputs to device memory (`no_out`: the block returns
after staging them, on a condition the compiler cannot fold, so the math
stays); without the math (`no_math`: loads, zero
fill, staging and stores); an empty block (`empty`: the launch alone). Only
the whole kernel's outputs are right; they are held against the plain
version. Prints the card, one line per build and shape, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# kernel -> (source, entry point, {cut: [(old, new)] patches of the source})
KERNELS = {
    "imu_rows": ("imu_rows.cu", "isv_imu_rows", {
        "whole": [],
        "no_out": [("  float2 out[8];\n", "  if (rows_per_seq > 0) return;\n  float2 out[8];\n")],
        "no_math": [("  if (lane < 15) {\n", "  if (false) {\n"),
                    ("  if (lane < 9) {\n", "  if (false) {\n")],
        "empty": [("  if (k >= n) return;", "  return;")],
    }),
    "proj_rows": ("proj_rows.cu", "isv_proj_rows", {
        "whole": [],
        "no_out": [("  if (full) {  // J_pi and J_pj",
                    "  if (rows_per_seq > 0) return;\n  if (full) {  // J_pi and J_pj")],
        "no_math": [("  if (lane < rows) {\n    const float* row_i",
                     "  if (false) {\n    const float* row_i")],
        "empty": [("  const int base = blockIdx.x * PROJ_ROWS;",
                   "  return;\n  const int base = 0;")],
    }),
}


def build(kernel, cut, patches, out):
    """Compile one kernel's source with the cut applied; returns the Popen."""
    from isvins_tpu_torch.ops import _lib

    src = KERNELS[kernel][0]
    d = out / f"{kernel}.{cut}"
    d.mkdir(parents=True, exist_ok=True)
    text = (_lib.CSRC / src).read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{kernel}/{cut}: {src} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / src).write_text(text)
    (d / "common.cuh").write_text((_lib.CSRC / "common.cuh").read_text())
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(d), "-o", str(d / "lib.so"),
           str(d / src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main():
    import torch

    import chip_smoke
    from isvins_tpu_torch import ops
    from isvins_tpu_torch.ops import _lib

    if not torch.cuda.is_available():
        print("no CUDA card")
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out = ROOT / "build" / "rows_breakdown"
    procs = {(k, cut): build(k, cut, patches, out)
             for k, (_, _, cuts) in KERNELS.items() for cut, patches in cuts.items()}
    fns = {}
    for (k, cut), proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {k}/{cut}:\n{err[-4000:]}")
        entry = KERNELS[k][1]
        fn = getattr(ctypes.CDLL(str(out / f"{k}.{cut}" / "lib.so")), entry)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in _lib._SIGNATURES[entry]] + [ctypes.c_void_p]
        fns[(k, cut)] = fn
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{k}/{cut} ptxas: {line.strip()}")
    dev = torch.device("cuda")
    shapes = {"proj_rows": [(f"N={N}", chip_smoke.proj_case(dev, N, S), (N, 2), (N, 2, 6),
                             (N, 2, 6), (N, 2), N) for N, S in ((3072, 1), (3072 * 16, 16))],
              "imu_rows": [(f"n={n}", chip_smoke.imu_case(dev, n), (n, 15), (n, 15, 30), n)
                           for n in (17, 272)]}
    plain = {"proj_rows": ops.proj_rows_ref, "imu_rows": ops.imu_rows_ref}
    tol = {"proj_rows": (3e-4, lambda r: 1e-4),
           "imu_rows": (1e-5, lambda r: 2e-6 * float(r.abs().max()))}
    rec = {}
    for k, cases in shapes.items():
        for what, args, *out_shapes in cases:
            n, out_shapes = out_shapes[-1], out_shapes[:-1]
            outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in out_shapes]
            rows = _lib.seq_rows(n, args[6] if k == "proj_rows" else args[17], k)
            for cut in KERNELS[k][2]:
                def call(fn=fns[(k, cut)], cut=cut):
                    stream = torch.cuda.current_stream().cuda_stream
                    rc = fn(*[a.data_ptr() for a in (*args, *outs)], n, rows, stream)
                    if rc:
                        raise RuntimeError(f"{k}/{cut}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                if cut == "whole":
                    chip_smoke._assert_close(f"{k} {what}", outs, plain[k](*args), *tol[k])
                rec[f"{k}/{cut}@{what}"] = chip_smoke.graph_ms(call)
                print(f"{k} {what} {cut}: {rec[f'{k}/{cut}@{what}'] * 1e3:.2f} us")
    print(json.dumps({"card": smi, "rows_breakdown_ms": rec}))


if __name__ == "__main__":
    main()

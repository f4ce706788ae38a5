#!/usr/bin/env python3
"""Where the time of the retrieval kernel K6 (csrc/hamming.cu) goes, on one
card.

    python3 k6_breakdown.py [--versus FILE]

Builds the kernel several times into build/k6_breakdown/, each from this
checkout's source with one change made by a text patch, and times each by
graph replay (chip_smoke.graph_ms) at K = 1, 23, 256 and 4096 keyframes
(chip_smoke.retrieval_inputs). The builds: the kernel as it is (`whole`);
its wgmma commented out of its asm block, the operands kept (`no_mma`: the
loads, barriers and reductions alone); without the count of |b_j| a row
(`no_popc`); one block per keyframe instead of at most BLOCKS_PER_SM
blocks per SM walking the keyframes (`grid_k`); at most 2 or 8 blocks per
SM (`bps2`, `bps8`); a ring of four stages instead of three (`s4`); an
empty block at the kernel's grid (`empty`: the launch alone); with
--versus, FILE (another design of the same entry point, with this
checkout's common.cuh) as `versus`. Only the outputs of the builds that
keep the arithmetic are held against the plain version (exactly). Prints the card, one line per build and size, and one
JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SOURCE, ENTRY = "hamming.cu", "isv_retrieval_scores"
GRID = "  const int blocks = K < BLOCKS_PER_SM * sms ? K : BLOCKS_PER_SM * sms;\n"
BPS = "constexpr int BLOCKS_PER_SM = 4;\n"
STAGES = "constexpr int STAGES = 3;"
CUTS = {
    "whole": [],
    # the instruction commented out inside its asm block: the operands stay
    "no_mma": [('      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "\n',
                '      "// wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "\n')],
    "no_popc": [("      if ((threadIdx.x & 1) == 0) pb[n] = p + (st.valid[n] ? 0 : 1024);\n", "")],
    "grid_k": [(GRID, "  const int blocks = K;\n")],
    "bps2": [(BPS, "constexpr int BLOCKS_PER_SM = 2;\n")],
    "bps8": [(BPS, "constexpr int BLOCKS_PER_SM = 8;\n")],
    "s4": [(STAGES, "constexpr int STAGES = 4;")],
    "empty": [("  __shared__ Stage ring[STAGES];\n",
               "  if (K > 0) return;\n  __shared__ Stage ring[STAGES];\n")],
}
EXACT = ("whole", "grid_k", "bps2", "bps8", "s4")
SIZES = (1, 23, 256, 4096)


def build(cut, patches, out, source=None):
    """Compile the source (this checkout's, or `source`) with the patches
    applied; returns the Popen."""
    from isvins_tpu_torch.ops import _lib

    d = out / cut
    d.mkdir(parents=True, exist_ok=True)
    text = Path(source or _lib.CSRC / SOURCE).read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{cut}: {SOURCE} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    (d / "common.cuh").write_text((_lib.CSRC / "common.cuh").read_text())
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(d), "-o", str(d / "lib.so"),
           str(d / SOURCE)]
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
    out = ROOT / "build" / "k6_breakdown"
    procs = {cut: build(cut, patches, out) for cut, patches in CUTS.items()}
    exact = EXACT
    if "--versus" in sys.argv:
        procs["versus"] = build("versus", [], out, sys.argv[sys.argv.index("--versus") + 1])
        exact += ("versus",)
    fns = {}
    for cut, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cut}:\n{err[-4000:]}")
        fn = getattr(ctypes.CDLL(str(out / cut / "lib.so")), ENTRY)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in _lib._SIGNATURES[ENTRY]] + [ctypes.c_void_p]
        fns[cut] = fn
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{cut} ptxas: {line.strip()}")
    dev = torch.device("cuda")
    rec = {}
    for K in SIZES:
        qd, qv, dbd, dbv, thresh = chip_smoke.retrieval_inputs(dev, K)
        ref = ops.retrieval_scores_ref(qd, qv, dbd, dbv, thresh)
        scores = torch.empty((K,), dtype=torch.float32, device=dev)
        for cut, fn in fns.items():
            def call(fn=fn, cut=cut):
                stream = torch.cuda.current_stream().cuda_stream
                rc = fn(*[a.data_ptr() for a in (qd, qv, dbd, dbv, scores)], K, thresh, stream)
                if rc:
                    raise RuntimeError(f"{cut}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if cut in exact and not torch.equal(scores, ref):
                raise AssertionError(f"{cut} at K={K}: not equal to the plain version")
            rec[f"{cut}@K={K}"] = chip_smoke.graph_ms(call)
            print(f"K={K} {cut}: {rec[f'{cut}@K={K}'] * 1e3:.2f} us")
    print(json.dumps({"card": smi, "k6_breakdown_ms": rec}))


if __name__ == "__main__":
    main()

"""The benchmark of isvins_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. The cell's configuration
(benchmark/configs/), traffic (benchmark/traffic/) and per-layer readers
(benchmark/metrics/) are found by the names in BENCHMARK.json. The run
renders its frames on the card from the seed, builds the System as
run_euroc does (tracker pipeline, pose-graph worker thread, synchronous
solve), drives the set-up the traffic asks for, then feeds frames in a
closed loop for `--seconds`; with `--trace 1` it reads the per-layer
metrics (utils.perf over the window, torch.profiler over a slice of it),
else the end-to-end ones. Then it compares what the window produced with
the plain reference (benchmark/reference) and prints one JSON line last.

It exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), when the port cannot be imported, and when
a module whose top-level name is jax, jaxlib, flax, isvins_tpu or a
top-level script of the repository has been loaded."""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")

    import importlib.util

    if importlib.util.find_spec("isvins_tpu_torch") is None:
        _fail("the port isvins_tpu_torch is not in this checkout")
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA card: torch.cuda.is_available() is false")
    from benchmark import harness

    spec, wl, _, _ = harness.cell(args.workload, ROOT)
    if torch.cuda.device_count() < int(wl["chips"]):
        _fail(f"the cell asks for {wl['chips']} cards, {torch.cuda.device_count()} are visible")
    info = harness.card_info(0)
    harness.log(f"card: {info}")
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_PROC0,
                           device="cuda:0", root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        _fail(f"forbidden modules were loaded: {bad}")
    lines = res.pop("_lines")
    extra = res.pop("_extra")
    extra["card"] = info
    harness.log(f"run: {json.dumps(extra)}")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

"""Readings for the limits of `correct`: for each seed, one run of a cell
(set-up, a window of `--seconds`, the comparison), and on the same sample
of answers the control: the reference put in the program's place in the
precision below the configuration's (benchmark/reference/precision.py for
the float32 layers, float32 for the float64 ones).

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 20 [--fault <name>]

`--fault` plants one of benchmark/faults.py's faults under the timed path
before each window: the program's readings are then the fault's. It
prints one JSON line per seed: {"seed", "correct" (the program's),
"control_correct" (the control judged by the same limits, through the
same comparison), "program": {number: reading}, "control": {number:
reading}, ...}. The benchmark's own runs never run it; the limits in
benchmark/configs/*.json were set from its readings (PERF.md)."""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description="program and control readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--answers", type=int, default=0,
                    help="compare up to this many answers of each layer (default: the traffic's)")
    ap.add_argument("--fault", default=None, help="a fault of benchmark/faults.py to plant")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        sys.exit(2)
    from benchmark import harness
    from benchmark.faults import FAULTS

    fault = FAULTS[args.fault] if args.fault else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, t0, device="cuda:0",
                               root=ROOT, control=True, fault=fault,
                               counts=({k: args.answers for k in ("tracks", "solves", "margs",
                                                                  "loops", "optimizes")}
                                       if args.answers else None))
        ctl = res.pop("_control")
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": res["correct"],
                          "control_correct": res["_control_correct"],
                          "control_checks": res["_control_checks"],
                          "program": {k: v["program"] for k, v in ctl.items()},
                          "control": {k: v["control"] for k, v in ctl.items()},
                          "answers": {k: v["answers"] for k, v in ctl.items()},
                          "program_each": {k: v["program_each"] for k, v in ctl.items()},
                          "control_each": {k: v["control_each"] for k, v in ctl.items()},
                          "metrics": res["metrics"]}), flush=True)


if __name__ == "__main__":
    main()

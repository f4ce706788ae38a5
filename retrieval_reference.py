#!/usr/bin/env python3
"""The JAX package's loop-retrieval sweep (retrieval_bench.py) on the CPU:
the reference run that chip_smoke.py's `retrieval` phase holds the port to.

    JAX_PLATFORMS=cpu python3 retrieval_reference.py [--keyframes 500 250]

For each count, retrieval_bench.build_db (a RoomRenderer world of about 63
keyframes a lap on an r = 3 m circle, Shi-Tomasi + NMS corners, BRIEF,
ray-cast ground-truth depths, KeyframeDB) and retrieval_bench.evaluate
(KeyframeDB.query and PoseGraphBuilder._find_connection with skip_recent
50, min_loop_matches 15), imported: importing retrieval_bench runs
nothing, and this script writes no file (retrieval_bench.main writes
RETRIEVAL_r05.json into the working directory). Prints one JSON line per
count with RETRIEVAL_r05.json's nine fields, unrounded, and the CPU
seconds of the build and the evaluation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def fields(st, n_keyframes):
    """retrieval_bench.py:211-229's nine fields from evaluate's stats,
    unrounded."""
    errs = np.array(st["rel_errs"]) if st["rel_errs"] else np.zeros((0, 2))
    q = max(st["q_with_truth"], 1)
    return {
        "keyframes": int(n_keyframes), "queries_with_truth": st["q_with_truth"],
        "retrieval_recall_at_4": st["q_recall_hits"] / q,
        "retrieval_precision": st["cand_true"] / max(st["cand_total"], 1),
        "verified_loop_recall": st["q_ver_hits"] / q,
        "verified_loop_precision": st["ver_true"] / max(st["ver_fired"], 1),
        "loops_fired": st["ver_fired"],
        "loop_rel_t_err_median_m": float(np.median(errs[:, 0])) if len(errs) else None,
        "loop_rel_yaw_err_median_deg": float(np.median(errs[:, 1])) if len(errs) else None,
    }


def main():
    from isvins_tpu.config import PoseGraphConfig
    from retrieval_bench import build_db, evaluate

    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, nargs="+", default=[500])
    args = ap.parse_args()
    pg = PoseGraphConfig(skip_recent=50, min_loop_matches=15)
    for n in args.keyframes:
        t0 = time.time()
        db, gt_t, gt_yaw, _, _ = build_db(n)
        t1 = time.time()
        st = evaluate(db, gt_t, gt_yaw, pg)
        t2 = time.time()
        print(json.dumps({"reference": "isvins_tpu retrieval_bench build_db + evaluate on the CPU",
                          "backend": jax.default_backend(), **fields(st, db.n),
                          "counts": {k: v for k, v in st.items() if k != "rel_errs"},
                          "cpu_build_s": round(t1 - t0, 1), "cpu_evaluate_s": round(t2 - t1, 1)}),
              flush=True)


if __name__ == "__main__":
    main()

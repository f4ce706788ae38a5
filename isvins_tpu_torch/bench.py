"""The port's benchmark (port of bench.py): the window-solve throughput and
the end-to-end pipeline stage, with bench.py's field names.

    python -m isvins_tpu_torch.bench [--device cpu] [--budget-s 1500]

Prints bench.py's headline JSON line first ({"metric":
"vio_window_solve_frames_per_s", "value", "unit", "vs_baseline",
"batched_x8/x16/x32_throughput", "e2e_pipeline_fps": null}), then runs the
end-to-end stage and prints a final JSON line with `e2e_pipeline_fps` and
bench.py's ten `e2e_*` detail fields (bench.py:302-313), unrounded. The
per-phase breakdown goes to stderr as '#' lines. Runs on the CUDA card
unless `--device cpu`; writes no file. A failure raises (bench.py prints
null instead): the process exits non-zero.

Solve stage: 1 / the median wall time of one 10-iteration f32
`solve_window` on make_batch_problem(1, (18, 8, 1000, 3072)), with the
host clock around `torch.cuda.synchronize()` (bench.py's chained
fori_loop timing works around a TPU runtime and is not copied);
`per_lm_iteration_marginal` is the 20-iteration solve's median less the
10-iteration one's, over 10; the batched throughputs come from
`sharded_batch_solve` on one device.

E2E stage (bench.py:173-324, its configuration unchanged): rendered 320x240
frames -> System(enable_loop=True, pipeline=True, pg_thread=True,
solve_async=True) after `wait_pg_ready()`; a frame is its pub_imu calls and
its pub_image (flush() on the last), timed whole on the host clock with no
synchronize(); the median, p90 and max over the second half of the steady
frames. Baseline: the reference's 8 ms solver budget, 125 frames/s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .solver import WindowDims

BASELINE_FPS = 125.0  # the reference's <= 8 ms per-frame solver budget
PRODUCT_DIMS = WindowDims(B=18, Vo=8, F=1000, N=3072)
SOLVE_REPS = 30  # timed single solves per median (a third as many batched)
BATCHES = (8, 16, 32)  # bench.py's batched sizes: x8 is its headline, x16/x32 the plateau
E2E_FIELDS = ("e2e_ate_vio_m", "e2e_ate_loop_m", "e2e_median_ms", "e2e_p90_ms", "e2e_max_ms",
              "e2e_loops_closed", "e2e_keyframes", "e2e_ramp_to_steady_s",
              "e2e_frames_measured", "e2e_frames_processed")
# bench.py:216-221: 1.34 laps of the room, so the revisit closes loops
E2E_WORLD = dict(n_frames=130, frame_hz=10.0, imu_hz=200.0, n_landmarks=300, seed=1,
                 traj_r=3.0, traj_w=0.65)


def _log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_s(fn, reps, dev):
    """Median host-clock seconds of fn(), the device synchronized at both
    ends."""
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_solve(device=None) -> dict:
    """The solve stage at PRODUCT_DIMS: {"vio_window_solve_frames_per_s",
    "solve_median_ms", "per_lm_iteration_marginal_ms", "batched": {NB:
    frames/s}}."""
    import torch

    from .device import resolve_device
    from .parallel import make_batch_problem, sharded_batch_solve
    from .solver import solve_window
    from .utils.convert import tree_map

    dims, reps = PRODUCT_DIMS, SOLVE_REPS
    dev = resolve_device(device)
    prob = make_batch_problem(1, dims, torch.float32, device=dev)
    args = [tree_map(lambda a: a[0].contiguous(), t) for t in prob[:4]] + list(prob[4:])
    med = {}
    for iters in (10, 20):
        solve_window(*args, dims, iters=iters)  # warm-up
        med[iters] = median_s(lambda: solve_window(*args, dims, iters=iters), reps, dev)
    fps = 1.0 / med[10]
    marginal = (med[20] - med[10]) / 10
    _log(f"window_solve_single_stream: {med[10] * 1e3:.3f} ms -> {fps:.2f} frames/s (median of "
         f"{reps}, host clock around synchronize())")
    _log(f"per_lm_iteration_marginal: {marginal * 1e3:.3f} ms")
    batched = {}
    step, shard = sharded_batch_solve([dev], dims, iters=10)
    for nb in BATCHES:
        p = make_batch_problem(nb, dims, torch.float32, device=dev)
        trees, G, psi = shard(p[:4]), p[4], p[5]
        step(*trees, G, psi)  # warm-up
        dt = median_s(lambda: step(*trees, G, psi), max(reps // 3, 1), dev)
        batched[nb] = nb / dt
        _log(f"window_solve_batched_x{nb}: {dt * 1e3:.3f} ms -> {nb / dt:.2f} frames/s "
             f"throughput")
    return {"vio_window_solve_frames_per_s": fps, "solve_median_ms": med[10] * 1e3,
            "per_lm_iteration_marginal_ms": marginal * 1e3, "batched": batched}


def headline(fps: float, batched: dict) -> dict:
    """bench.py:337-346's headline line."""
    return {
        "metric": "vio_window_solve_frames_per_s", "value": fps,
        "unit": "frames/s (18-frame window, 1000 lm, 3072 obs, 10 LM iters, fp32)",
        "vs_baseline": fps / BASELINE_FPS,
        "batched_x8_throughput": batched.get(8, 0.0),
        "batched_x16_throughput": batched.get(16, 0.0),
        "batched_x32_throughput": batched.get(32, 0.0),
        "e2e_pipeline_fps": None,
    }


def final_line(head: dict, e2e: dict) -> dict:
    """bench.py:347-354's final line: the headline with the e2e fields."""
    return {**head, "e2e_pipeline_fps": e2e["e2e_pipeline_fps"],
            **{k: e2e[k] for k in E2E_FIELDS}}


def e2e_config():
    """bench.py:190-208: a 320x240 f = 200 pinhole camera, max_cnt 150,
    min_dist 10, 4 LK levels of 21x21, no CLAHE; window 18/8/1000, N =
    3072; bench's noise and excitation threshold 0.08; the pose graph with
    a 0.3 m keyframe gate, skip_recent 25, 15 loop matches, 256 keyframes
    and 256 keypoints per keyframe."""
    from .config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                         WindowConfig, euroc_config)

    H, W, f = 240, 320, 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=150, min_dist=10, freq=100, lk_levels=4, lk_win=21,
                              equalize=False, border=4),
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=256, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)))
    return cfg, PRODUCT_DIMS


def e2e_world():
    """bench.py:209-222's world and its RoomRenderer: (world, renderer)."""
    from .geom.hostmath import mat_to_quat_np
    from .utils.synthetic import RoomRenderer, make_world

    cfg, _ = e2e_config()
    world = make_world(**E2E_WORLD)
    return world, RoomRenderer(world, cfg.camera, np.zeros(3),
                               mat_to_quat_np(np.asarray(cfg.ric_np)))


def drive_e2e(sys_, world, frames, budget_s: float = 1500.0) -> dict:
    """bench.py:247-313's frame loop over `frames` through a built System:
    wait_pg_ready(), then per frame the pub_imu calls before it and its
    pub_image (flush() on the last), timed whole; stops at budget_s of wall
    time. Returns bench.py's ten e2e fields (unrounded), e2e_pipeline_fps,
    the VIO trajectory, the steady frame times and utils.perf's phases over
    the steady frames. Fewer than 8 steady frames raise."""
    from .estimator.estimator import NON_LINEAR
    from .utils import perf
    from .utils.evaluation import ate_rmse

    sys_.wait_pg_ready()
    n_frames = len(frames)
    steady_dts, t_steady0, frames_done = [], None, 0
    perf.reset()
    perf.enable(True)
    try:
        t_wall0 = time.perf_counter()
        for k in range(n_frames):
            if k % 10 == 0:
                _log(f"e2e frame {k}/{n_frames} t={time.perf_counter() - t_wall0:.0f}s "
                     f"flag={sys_.estimator.solver_flag}")
            if time.perf_counter() - t_wall0 > budget_s:
                _log(f"e2e budget {budget_s:.0f}s spent at frame {k}; reporting "
                     f"{len(steady_dts)} steady frames")
                break
            t0 = time.perf_counter()
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            sys_.pub_image(world.frame_times[k], frames[k])
            if k == n_frames - 1:
                sys_.flush()
            dt = time.perf_counter() - t0
            frames_done = k + 1
            if sys_.estimator.solver_flag == NON_LINEAR:
                if t_steady0 is None:
                    t_steady0 = time.perf_counter() - t_wall0
                    _log(f"e2e ramp-to-steady: {t_steady0:.1f}s (init done at frame {k})")
                    perf.reset()  # attribute only the steady frames
                steady_dts.append(dt)
        phases = perf.stats()
        report = perf.report(n_frames=len(steady_dts))
    finally:
        perf.enable(False)
    if len(steady_dts) < 8:
        raise RuntimeError(f"only {len(steady_dts)} steady frames of {frames_done}")
    # the median over the second half of the steady frames leaves out the
    # first steady frames' one-off costs
    tail = np.array(steady_dts[len(steady_dts) // 2:])
    med = float(np.median(tail))
    traj = sys_.vio_trajectory
    pg = sys_.pgbuilder
    ate_vio = ate_opt = None
    if len(traj) >= 10:
        t_est = np.array([t for (t, _, _) in traj])
        p_est = np.array([P for (_, P, _) in traj])
        ate_vio = float(ate_rmse(t_est, p_est, world.frame_times, world.P, align="se3"))
        if pg is not None and pg.db.n >= 5:
            ts_k, t_opt, _ = pg.trajectory()
            ate_opt = float(ate_rmse(ts_k, t_opt, world.frame_times, world.P, align="se3"))
    out = {
        "e2e_pipeline_fps": 1.0 / med,
        "e2e_ate_vio_m": ate_vio, "e2e_ate_loop_m": ate_opt,
        "e2e_median_ms": med * 1e3, "e2e_p90_ms": float(np.percentile(tail, 90)) * 1e3,
        "e2e_max_ms": float(np.max(tail)) * 1e3,
        "e2e_loops_closed": int(pg.n_loops) if pg is not None else 0,
        "e2e_keyframes": int(pg.db.n) if pg is not None else 0,
        "e2e_ramp_to_steady_s": t_steady0,
        "e2e_frames_measured": int(len(tail)), "e2e_frames_processed": int(frames_done),
        "trajectory": list(traj), "steady_ms": [d * 1e3 for d in steady_dts],
        "phases": phases,
    }
    _log(f"e2e_pipeline (tracker+estimator, steady state): median {med * 1e3:.1f} ms/frame "
         f"(p90 {out['e2e_p90_ms']:.1f}) over {len(tail)} frames -> {1.0 / med:.2f} frames/s")
    _log("--- per-frame phase breakdown (steady state) ---")
    for line in report.splitlines():
        _log(line)
    return out


def bench_e2e(device=None, solve_async: bool = True, frames=None,
              budget_s: float = 1500.0) -> dict:
    """The e2e stage at e2e_config() on e2e_world() (`frames`: its rendered
    frames, rendered here when None): drive_e2e's result, plus the closed
    System under "system" for a caller that reads its map."""
    from .system import System

    cfg, dims = e2e_config()
    world, renderer = e2e_world()
    if frames is None:
        t0 = time.perf_counter()
        frames = [renderer.render(k)[0] for k in range(len(world.frame_times))]
        _log(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True,
                  solve_async=solve_async, device=device)
    try:
        out = drive_e2e(sys_, world, frames, budget_s)
    finally:
        sys_.close()
    out["system"] = sys_
    return out


def main(argv=None):
    import torch

    from .device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="wall-clock budget of the e2e stage")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _log(f"device {dev} ({name})")
    solve = bench_solve(dev)
    head = headline(solve["vio_window_solve_frames_per_s"], solve["batched"])
    print(json.dumps(head), flush=True)  # the headline first, as bench.py
    e2e = bench_e2e(dev, budget_s=args.budget_s)
    print(json.dumps(final_line(head, e2e)), flush=True)


if __name__ == "__main__":
    main()

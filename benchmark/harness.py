"""One run of one cell: inputs from the seed, the System built as
run_euroc builds it, set-up, the measured window, the traced slice, the
readers and the comparison with the reference.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is data found by name (BENCHMARK.json, benchmark/configs/,
benchmark/traffic/, benchmark/metrics/); this module only knows how to
drive a System frame by frame."""

from __future__ import annotations

import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# modules that no run may load (compared by the whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "isvins_tpu")


def log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(workload: str, root: Path = ROOT):
    """(BENCHMARK.json, its workload entry, the configuration's JSON, the
    traffic's JSON) of a cell, all found by name."""
    spec = load_json(root / "BENCHMARK.json")
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    return spec, w, load_json(root / c["file"]), load_json(BENCH / "traffic" / f"{w['traffic']}.json")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is a forbidden one or a
    top-level script of the repository (chip_smoke.py, bench.py, ...)."""
    names = set(FORBIDDEN) | {p.stem for p in ROOT.glob("*.py")}
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in names})


def child_seeds(seed: int):
    """Three independent seeds from the run's: the world's IMU noise, the
    renderer's generator (textures and sensor noise), the sample of answers
    the check compares."""
    kids = np.random.SeedSequence(int(seed)).spawn(3)
    return [int(k.generate_state(1, np.uint64)[0]) for k in kids]


def quat_from_mat(R):
    """wxyz quaternion of a rotation matrix (Shepperd)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = [0.0] * 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def make_inputs(cfg: dict, traffic: dict, seconds: int, seed: int, device, chunk: int = 4):
    """(world, frames (n, H, W) uint8 host array, n_frames): the world's
    trajectory and IMU from make_world, the frames rendered on `device`
    from the seed. n_frames covers the longest set-up the traffic allows
    and `seconds` of frames at the traffic's window rate."""
    import torch

    from .traffic.render import RoomRenderer
    from .traffic.world import make_world

    wseed, rseed, _ = child_seeds(seed)
    n = int(traffic["warmup"]["max_frames"]) + int(math.ceil(seconds * traffic["window_frames_per_s"]))
    wkw = dict(traffic["world"])
    wkw["ba"], wkw["bg"] = tuple(wkw["ba"]), tuple(wkw["bg"])
    world = make_world(n_frames=n, seed=wseed, **wkw)
    eng = cfg["engine"]
    gen = torch.Generator(device=device)
    gen.manual_seed(rseed)
    renderer = RoomRenderer(world, eng["camera"], eng["tic"], quat_from_mat(eng["ric"]),
                            traffic["room"], gen, device)
    H, W = int(eng["camera"]["height"]), int(eng["camera"]["width"])
    frames = np.empty((n, H, W), np.uint8)
    for i in range(0, n, chunk):
        ks = range(i, min(i + chunk, n))
        frames[i:i + len(ks)] = renderer.render(ks).cpu().numpy()
    del renderer
    return world, frames


def engine_config(cfg: dict):
    """The port's (EngineConfig, WindowDims) from the configuration file."""
    from isvins_tpu_torch.config import (CameraConfig, EngineConfig, NoiseConfig,
                                         PoseGraphConfig, SolverConfig, TrackerConfig,
                                         WindowConfig)
    from isvins_tpu_torch.solver import WindowDims

    e = cfg["engine"]
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    ec = EngineConfig(camera=CameraConfig(**tup(e["camera"])),
                      tracker=TrackerConfig(**e["tracker"]), window=WindowConfig(**e["window"]),
                      noise=NoiseConfig(**e["noise"]), solver=SolverConfig(**e["solver"]),
                      posegraph=PoseGraphConfig(**e["posegraph"]),
                      ric=tuple(tuple(r) for r in e["ric"]), tic=tuple(e["tic"]),
                      estimate_extrinsic=int(e["estimate_extrinsic"]))
    return ec, WindowDims(**cfg["dims"])


class Drive:
    """Feeds the System frame by frame as run_euroc does: the IMU samples
    of segment k - 1 (pub_imu), then frame k (pub_image), and notes when
    each frame's feed began and when its pose came out."""

    def __init__(self, system, world, frames):
        self.sys, self.world, self.frames = system, world, frames
        self.k = 0
        self.index = {float(t): i for i, t in enumerate(world.frame_times)}
        self.fed = {}  # frame -> host time its feed began
        self.out = {}  # frame -> host time the call that put out its pose returned

    def feed_imu(self, k: int):
        """pub_imu for IMU segment k - 1 (the samples up to frame k)."""
        w = self.world
        acc_t = w.frame_times[k - 1]
        for s in range(int(np.sum(w.imu_dts[k - 1] > 0))):
            acc_t += w.imu_dts[k - 1][s]
            self.sys.pub_imu(acc_t, w.imu_accs[k - 1][s], w.imu_gyrs[k - 1][s])

    def step(self):
        sys_, w, k = self.sys, self.world, self.k
        if k >= len(self.frames):
            raise RuntimeError(f"the traffic's {len(self.frames)} frames ran out before the "
                               "window ended; the window is never shortened")
        t0 = time.perf_counter()
        n0 = len(sys_.vio_trajectory)
        if k > 0:
            self.feed_imu(k)
        sys_.pub_image(w.frame_times[k], self.frames[k])
        t1 = time.perf_counter()
        self.fed[k] = t0
        new = [self.index[float(t)] for t, _, _ in sys_.vio_trajectory[n0:]]
        for j in new:
            self.out[j] = t1
        self.k += 1
        return t0, t1, len(new)


def warmup_counter(system, name: str) -> int:
    """The set-up's stopping counters: verified loops, keyframes, steady
    solves, frames whose pose came out."""
    if name == "loops":
        return system.pgbuilder.n_loops if system.pgbuilder is not None else 0
    if name == "keyframes":
        return system.pgbuilder.db.n if system.pgbuilder is not None else 0
    if name == "steady_solves":
        return system.estimator.steady_solves
    if name == "poses":
        return len(system.vio_trajectory)
    raise KeyError(f"unknown set-up counter {name!r}")


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def load_reader(name: str):
    """benchmark/metrics/<name>.py's `read(ctx)`."""
    return importlib.import_module(f"benchmark.metrics.{name}").read


def card_info(device) -> dict:
    import torch

    info = {"name": torch.cuda.get_device_name(device)}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                            "-i", str(torch.device(device).index or 0)],
                           capture_output=True, text=True, timeout=20)
        info["nvidia_smi"] = r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def run_cell(workload: str, seed: int, seconds: int, trace: bool, t_proc0: float,
             device="cuda", root: Path = ROOT, cell_data=None, fault=None,
             control: bool = False, counts=None):
    """One run; returns the result dict of the JSON line a run prints last (and
    `checks`). `cell_data` (spec, workload entry, config, traffic) replaces
    the files found by name (the CPU tests' cut cell); `fault`, a callable
    given the System before the window, breaks the timed path (the tests'
    faults); `control` also reads the control (the reference in the
    precision below the configuration's) on the same sample, under
    "_control", and judges it by the same limits ("_control_correct",
    "_control_checks"); `counts` replaces the traffic's sample sizes."""
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.system import System
    from isvins_tpu_torch.utils import perf

    from .capture import Captures
    from .reference import check
    from .trace import Slice, warm_up

    spec, wl, cfg, traffic = cell_data or cell(workload, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_in = time.perf_counter()
    world, frames = make_inputs(cfg, traffic, seconds, seed, dev)
    log(f"inputs: {len(frames)} frames of {frames.shape[2]}x{frames.shape[1]} rendered in "
        f"{time.perf_counter() - t_in:.2f} s")
    ecfg, dims = engine_config(cfg)
    system = System(ecfg, dims, enable_loop=bool(cfg["enable_loop"]), pipeline=True,
                    pg_thread=True, device=dev)
    system.wait_pg_ready()
    drive = Drive(system, world, frames)

    # set-up: drive until the traffic's condition holds, then a few frames more
    wu = traffic["warmup"]
    while warmup_counter(system, wu["until"]) < int(wu["at_least"]):
        if drive.k >= int(wu["max_frames"]):
            raise RuntimeError(f"set-up reached {wu['max_frames']} frames before "
                               f"{wu['until']} >= {wu['at_least']}")
        drive.step()
    for _ in range(int(wu["then_frames"])):
        drive.step()
    system.wait_pg_ready()
    if cuda:
        torch.cuda.synchronize(dev)
    warm_frames = drive.k
    log(f"set-up: {warm_frames} frames; loops {warmup_counter(system, 'loops')}, "
        f"keyframes {warmup_counter(system, 'keyframes')}, steady solves "
        f"{system.estimator.steady_solves}")

    if fault is not None:
        fault(system)
    chk = traffic["check"]
    cap = Captures(system, seed=child_seeds(seed)[2] + 1, kernel_stride=int(chk["kernel_stride"]),
                   kernel_cap=int(chk["kernels"]), solve_cap=int(chk["solves"]),
                   lift_cap=int(chk["tracks"]))
    cap.install()
    tr = traffic["trace"]
    slicer = None
    if trace:
        warm_up(dev)
        slicer = Slice(dev, int(tr["start_frame"]), int(tr["frames"]), int(tr["sessions"]))
    perf.reset()
    perf.enable(bool(trace))
    launches0 = ops.launch_counts()

    # the measured window
    t_start = time.perf_counter()
    setup_s = t_start - t_proc0
    deadline = t_start + seconds
    first = drive.k
    n_out, t_end = 0, t_start
    cap.armed = True
    try:
        while time.perf_counter() < deadline:
            w_i = drive.k - first
            if slicer is not None:
                slicer.before(w_i, system)
            _, t_end, n_new = drive.step()
            n_out += n_new
            cap.track_state(drive.k - 2)
            if slicer is not None:
                slicer.after(w_i, system)
    finally:
        cap.armed = False
        perf.enable(False)
    window_s = t_end - t_start
    last = drive.k
    if slicer is not None:
        slicer.close(system)
    phases = perf.stats()
    samples = _perf_samples(perf)
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}

    # after the window: the IMU up to the next frame lets the last frame's
    # estimator step run; drain, read the peak, free the program's state
    if drive.k < len(frames):
        drive.feed_imu(drive.k)
    system.flush()
    system.close()
    cap.uninstall()
    cap.finish()
    mem = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    traj = list(system.vio_trajectory)
    pg = system.pgbuilder
    n_loops, n_kf = (pg.n_loops, pg.db.n) if pg is not None else (0, 0)
    out_ts = {drive.index[float(t)] for t, _, _ in traj}
    fed = [k for k in range(first, last)]
    lat = [drive.out[k] - drive.fed[k] for k in fed if k in drive.out]
    failed = sum(1 for k in fed if k not in out_ts)
    ate = _ate(traj, world)
    ate_kf = None
    if pg is not None and pg.db.n >= 10:
        ts_kf, t_opt, q_opt = pg.trajectory()
        ate_kf = _ate(list(zip(ts_kf, t_opt, q_opt)), world)
    del system, pg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window: {last - first} frames fed, {n_out} poses out in {window_s:.3f} s; "
        f"{len(lat)} latencies; {failed} frames with no pose; loops {n_loops}, keyframes {n_kf}; "
        f"ATE (se3) of the VIO poses {ate} m, of the loop-optimized keyframes {ate_kf} m; "
        f"launches {launches}")

    # the comparison with the reference
    t_chk = time.perf_counter()
    _, _, cseed = child_seeds(seed)
    counts = counts or traffic["check"]
    notes = {}
    readings = check.evaluate(cap, frames, cfg, counts, cseed, dev, notes=notes)
    limits = {k: v for k, v in cfg["correct_limits"].items()
              if cfg["enable_loop"] or k not in check.LOOP_NUMBERS}
    correct, rows = check.judge(readings, limits)
    log(f"check: {time.perf_counter() - t_chk:.2f} s; left out by the rules: "
        f"{notes['tracks_left_out']} of {notes['tracks']} tracks, "
        f"{notes['k1_rows_left_out']} of {notes['k1_rows']} K1 rows")
    ctl = None
    if control:
        t_ctl = time.perf_counter()
        ctl = check.evaluate(cap, frames, cfg, counts, cseed, dev, control=True)
        log(f"control: {time.perf_counter() - t_ctl:.2f} s")

    ctx = {"phases": phases, "samples": samples, "launches": launches, "dims": cfg["dims"],
           "excluded": slicer.excluded if slicer is not None else {},
           "trace": slicer.summary if slicer is not None else None,
           "window_frames": last - first}
    metrics = {}
    names = (spec["per_layer"] if trace else spec["end_to_end"])
    for m in names:
        if "workloads" in m and wl["name"] not in m["workloads"]:
            continue
        if not trace:
            v = {"frames_per_s": lambda: n_out / window_s,
                 "pose_latency_ms_p90": lambda: percentile(lat, 90) * 1e3 if lat else None,
                 "setup_s": lambda: setup_s}[m["name"]]()
        else:
            v = load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": len(fed), "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if slicer is not None:
        s = slicer.summary
        dev_info["busy_s"] = s["busy_s"] if s else 0.0
        dev_info["window_s"] = s["window_s"] if s else 0.0
        if s:
            result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["checks"] = {name: {"value": _num(v), "limit": lim, "answers": n}
                        for name, v, lim, n in rows}
    if ctl is not None:
        ctl_correct, ctl_rows = check.judge(ctl, limits)
        result["_control_correct"] = bool(ctl_correct)
        result["_control_checks"] = {name: {"value": _num(v), "limit": lim, "answers": n}
                                     for name, v, lim, n in ctl_rows}
        result["_control"] = {k: {"program": readings[k].value, "control": r.value,
                                  "answers": r.count, "program_each": readings[k].values,
                                  "control_each": r.values} for k, r in ctl.items()}
    result["_lines"] = [f"check {name} {v!r} limit {lim!r} over {n} answers"
                        for name, v, lim, n in rows]
    result["_extra"] = {"setup_frames": warm_frames, "window_frames": last - first,
                        "poses_out": n_out, "window_s": window_s, "ate_se3_m": ate,
                        "ate_se3_m_loop_opt": ate_kf,
                        "loops": n_loops, "keyframes": n_kf, "phases": phases,
                        "launches": launches, "latency_ms": [x * 1e3 for x in lat]}
    if slicer is not None and slicer.summary:
        s = slicer.summary
        result["_extra"]["trace"] = {k: s[k] for k in ("frames", "launches", "busy_s", "window_s",
                                                       "consistent", "session", "launch_counts")}
    return result


def _num(v: float):
    """A reading for the JSON line: a finite float as it is, else the
    string "inf" or "nan" (strict JSON has neither)."""
    return v if math.isfinite(v) else ("nan" if math.isnan(v) else "inf")


def _perf_samples(perf) -> dict:
    """Every sample of each utils.perf phase (seconds), as recorded; the
    phases' stats where the registry is not reachable."""
    reg, lock = getattr(perf, "_SAMPLES", None), getattr(perf, "_LOCK", None)
    if reg is None or lock is None:
        return {}
    with lock:
        return {k: list(v) for k, v in reg.items()}


def _ate(traj, world):
    """RMS position error (m) of the VIO poses against ground truth after
    the best rigid alignment (se3), or None with fewer than 10 poses."""
    if len(traj) < 10:
        return None
    idx = {float(t): i for i, t in enumerate(world.frame_times)}
    est = np.array([P for _, P, _ in traj])
    gt = world.P[[idx[float(t)] for t, _, _ in traj]]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    err = (est - mu_e) @ R.T + mu_g - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))

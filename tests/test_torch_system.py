"""The port's System (isvins_tpu_torch.system) on the CPU.

Mirrors of tests/test_pipeline_mode.py's three equivalences on the port
(pipeline against sync, solve_async against sync, pg_thread against the
inline builder across a stream gap); the port's System held to the JAX
package's System on the same 320x240, 16-frame drive with the pose graph
off and on; the worker's parked failure and the card-only default device.
Slow-marked, as the reference marks them: test_system_e2e.py's two drives
and test_adversarial.py's nuisance drive, on the port.

Both packages take the host epipolar RANSAC (fused_ransac=False): on the
CPU each resolves its tracker to that route anyway, and the card's fused
route is held to the JAX run on the card (chip_smoke.py)."""

import time

import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
from isvins_tpu_torch.utils.evaluation import ate_rmse
from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

N_FRAMES = 16
R_BC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
LOOP_PG = dict(enabled=True, keyframe_min_dist=0.15, skip_recent=100, max_keyframes=64,
               max_kp_per_kf=128)

# Port against JAX on the 16-frame drive. Both packages publish the same
# packets and solve in f32 in different summation orders; the weakest
# direction of the window (the accelerometer bias) carries that rounding
# into the positions, as in test_torch_estimator's TF_TOL. Measured: 6.8e-5
# m in position, 5.6e-6 in the quaternion, 1.7e-5 m in the optimized
# keyframe positions; bound 1e-3 for all three. Keyframe timestamps are
# equal.
POSE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(pkg: str, loop: bool):
    """test_pipeline_mode._build's configuration in package `pkg`."""
    if pkg == "jax":
        from isvins_tpu import config as c
    else:
        from isvins_tpu_torch import config as c
    H, W, f = 240, 320, 200.0
    cam = c.CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                         k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    return c.euroc_config().replace(
        camera=cam,
        tracker=c.TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4, lk_win=21,
                                equalize=False, border=4, fused_ransac=False),
        window=c.WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        noise=c.NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=f),
        solver=c.euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=c.PoseGraphConfig(**LOOP_PG) if loop else c.PoseGraphConfig(enabled=False),
        tic=(0.0, 0.0, 0.0), ric=R_BC)


def _dims(pkg: str):
    if pkg == "jax":
        from isvins_tpu.solver import WindowDims
    else:
        from isvins_tpu_torch.solver import WindowDims
    return WindowDims(B=10, Vo=4, F=256, N=2048)


@pytest.fixture(scope="module")
def scene():
    """test_pipeline_mode._build's world and frames."""
    cam = _config("torch", False).camera
    world = make_world(n_frames=N_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=500, seed=3)
    renderer = RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(np.array(R_BC)))
    return world, [renderer.render(k)[0] for k in range(N_FRAMES)]


def _system(pkg: str, loop: bool, **kw):
    if pkg == "jax":
        from isvins_tpu.system import System

        return System(_config(pkg, loop), _dims(pkg), enable_loop=loop, **kw)
    from isvins_tpu_torch.system import System

    return System(_config(pkg, loop), _dims(pkg), enable_loop=loop, device="cpu", **kw)


def _drive(sys_, world, frames, gap=False):
    """Feed the world's IMU and frames (a 2.5 s gap before the last frame
    with gap=True), flush, and return the packets the estimator took as
    (t, ids)."""
    packets = []
    process_image = sys_.estimator.process_image

    def recording(ids, pts, t, vels=None):
        packets.append((float(t), np.array(ids)))
        return process_image(ids, pts, t, vels=vels)

    sys_.estimator.process_image = recording
    n = len(frames)
    for k in range(n):
        if k > 0:
            acc_t = world.frame_times[k - 1]
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        sys_.pub_image(world.frame_times[k] + (2.5 if gap and k == n - 1 else 0.0), frames[k])
    sys_.flush()
    return packets


def _assert_same_trajectory(a, b, atol):
    assert len(a.vio_trajectory) == len(b.vio_trajectory) > 0
    for (ta, Pa, Qa), (tb, Pb, Qb) in zip(a.vio_trajectory, b.vio_trajectory):
        assert ta == tb
        np.testing.assert_allclose(Pa, Pb, rtol=0, atol=atol)
        np.testing.assert_allclose(Qa, Qb, rtol=0, atol=atol)


# --------------------------------------------------- mode equivalences (port)

@pytest.fixture(scope="module")
def sync_run(scene):
    """The synchronous port System on the drive, and its packets."""
    a = _system("torch", False)
    packets = _drive(a, *scene)
    a.close()
    return a, packets


def test_pipeline_equivalent_to_sync(scene, sync_run):
    """System(pipeline=True) processes the same packets in the same order
    with the same values as the synchronous mode, one pub_image later."""
    a, pa = sync_run
    b = _system("torch", False, pipeline=True)
    pb = _drive(b, *scene)
    assert [t for t, _ in pa] == [t for t, _ in pb]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(pa, pb))
    _assert_same_trajectory(a, b, atol=1e-9)
    b.close()


def test_solve_async_equivalent_to_sync(scene, sync_run):
    """System(solve_async=True): the same solve on the same inputs in the
    same order, collected at the next frame before its IMU feed."""
    a, _ = sync_run
    b = _system("torch", False, solve_async=True)
    _drive(b, *scene)
    assert b.estimator.steady_solves == a.estimator.steady_solves > 0
    _assert_same_trajectory(a, b, atol=1e-9)
    b.close()


def test_pg_thread_equivalent_to_sync(scene):
    """System(pg_thread=True) consumes the same packet stream in the same
    order as the inline builder: after flush the keyframe db and both
    trajectories are identical. The gap before the last frame starts
    sequence 2 through the worker's queue, in packet order."""
    a = _system("torch", True, pg_thread=False)
    b = _system("torch", True, pg_thread=True)
    _drive(a, *scene, gap=True)
    _drive(b, *scene, gap=True)
    assert a.pgbuilder.db.n == b.pgbuilder.db.n > 0
    assert a.pgbuilder.sequence == b.pgbuilder.sequence == 2
    n = a.pgbuilder.db.n
    np.testing.assert_allclose(a.pgbuilder.db.vio_t[:n], b.pgbuilder.db.vio_t[:n], atol=1e-12)
    assert a.loop_tum() == b.loop_tum()
    assert a.vio_tum() == b.vio_tum()
    assert a.covariance_tum() == b.covariance_tum()
    a.close()
    b.close()


# ------------------------------------------- spans with frame ids (utils.perf)

@pytest.fixture(scope="module")
def traced(scene):
    """The loop-on drive through System(pipeline=True, pg_thread=True) with
    utils.perf on while frames are fed (and the worker drains), off for the
    flush, as the benchmark's window records them: (spans by id, the frame
    thread, the trajectory, the world's frame times)."""
    from isvins_tpu_torch.utils import perf

    world, frames = scene
    sys_ = _system("torch", True, pipeline=True, pg_thread=True)
    sys_.wait_pg_ready()
    perf.reset()
    perf.enable(True)
    try:
        for k in range(len(frames)):
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            sys_.pub_image(world.frame_times[k], frames[k])
        sys_.wait_pg_ready()
    finally:
        perf.enable(False)
    spans = {s.id: s for s in perf.spans()}
    perf.reset()
    traj = list(sys_.vio_trajectory)
    sys_.flush()
    sys_.close()
    thread = {s.thread for s in spans.values() if s.name == "sys.frame"}
    assert len(thread) == 1
    return spans, thread.pop(), traj, world.frame_times


def _root(spans, s):
    while s.parent is not None:
        s = spans[s.parent]
    return s


def test_traced_every_pose_has_one_pose_out_of_its_frame(traced):
    spans, _, traj, frame_times = traced
    outs = [s for s in spans.values() if s.name == "sys.pose_out"]
    assert len(traj) >= 3 and len(outs) == len(traj)
    assert sorted(float(frame_times[s.frame]) for s in outs) == sorted(t for t, _, _ in traj)
    # a pose comes out in the next call: its instant sits under that call's root
    assert all(_root(spans, s).frame == s.frame + 1 for s in outs)


def test_traced_frame_thread_spans_have_a_root_and_serve_their_frame(traced):
    """Every span on the frame thread has a root ancestor (`sys.frame` or
    `sys.pub_imu`); with pipeline=True call k dispatches frame k's tracker
    step (`trk.dispatch` and the step's span inside it, `trk.replay` or
    `trk.step_eager`), collects frame k - 1's, and the estimator serves
    frame k - 1."""
    spans, thread, _, _ = traced
    mine = [s for s in spans.values() if s.thread == thread]
    layers = [s for s in mine if s.name.startswith(("trk.", "est.", "pg.", "sys."))]
    assert len(layers) == len(mine) and any(s.name.startswith("est.") for s in mine)
    for s in mine:
        root = _root(spans, s)
        assert root.name in ("sys.frame", "sys.pub_imu") and root.thread == thread, s
        if root.name != "sys.frame" or s is root:
            continue
        up, dispatched = s, False
        while up is not None and not dispatched:
            dispatched = up.name == "trk.dispatch"
            up = spans.get(up.parent)
        want = root.frame if dispatched else root.frame - 1
        if s.name.startswith(("trk.", "est.")):
            assert s.frame == want, (s, root)


def test_traced_pg_push_names_its_frame_and_the_span_that_queued_it(traced):
    spans, thread, _, _ = traced
    pushes = [s for s in spans.values() if s.name == "pg.push"]
    assert pushes
    for s in pushes:
        parent = spans[s.parent]
        assert s.thread != thread and s.frame is not None
        assert parent.name == "sys.feed_pose_graph" and parent.frame == s.frame
    kf = [s for s in spans.values() if s.name == "pg.kf_device_step"]
    assert kf and all(spans[s.parent].name == "pg.push" for s in kf)


def test_traced_marg_job_is_a_child_of_its_marginalize(traced):
    spans, thread, _, _ = traced
    jobs = [s for s in spans.values() if s.name == "est.marg_job"]
    assert jobs
    for s in jobs:
        parent = spans[s.parent]
        assert parent.name == "est.marginalize" and parent.frame == s.frame is not None
        assert s.thread != thread and parent.thread == thread


# ------------------------------------------------ the port held to the JAX one

@pytest.mark.parametrize("loop", [False, True], ids=["loop_off", "loop_on"])
def test_system_matches_reference(scene, loop):
    """The port's System and the JAX package's on the same drive: equal
    packets (timestamps and track ids), equal pose timestamps, poses within
    POSE_TOL; with the pose graph on, equal keyframe timestamps and the
    optimized keyframe positions within POSE_TOL."""
    j = _system("jax", loop)
    t = _system("torch", loop)
    pj, pt = _drive(j, *scene), _drive(t, *scene)
    assert [x for x, _ in pt] == [x for x, _ in pj] and len(pt) >= N_FRAMES - 3
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(pt, pj))
    _assert_same_trajectory(t, j, atol=POSE_TOL)
    if loop:
        jts, jt_opt, _ = j.pgbuilder.trajectory()
        ts, t_opt, _ = t.pgbuilder.trajectory()
        assert len(ts) >= 3
        np.testing.assert_array_equal(ts, jts)
        np.testing.assert_allclose(t_opt, jt_opt, rtol=0, atol=POSE_TOL)
    else:
        assert t.pgbuilder is None and t.loop_tum() == "" and t.covariance_tum() == ""
    t.close()


# -------------------------------------------------------- failures, devices

def test_worker_failure_is_raised_at_join(monkeypatch):
    """An exception on the pose-graph worker is parked, then raised on the
    caller's thread at the next join (wait_pg_ready, flush, the outputs),
    chained to the worker's error."""
    from isvins_tpu_torch.posegraph import PoseGraphBuilder

    def broken(self):
        raise ValueError("prewarm failed")

    monkeypatch.setattr(PoseGraphBuilder, "prewarm", broken)
    sys_ = _system("torch", True, pg_thread=True)
    with pytest.raises(RuntimeError, match="pose-graph worker failed") as e:
        sys_.wait_pg_ready()
    assert isinstance(e.value.__cause__, ValueError)
    sys_.wait_pg_ready()  # raised once; the queue is drained
    sys_.close()
    assert sys_._pg_worker_thread is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_default_device_is_the_card():
    """System(device=None) means the CUDA card: without one it raises
    instead of running on the CPU."""
    from isvins_tpu_torch.system import System

    with pytest.raises(RuntimeError, match="CUDA"):
        System(_config("torch", False), _dims("torch"))


# ------------------------------------------------------------ slow mirrors

def _e2e_config(pg, noise, equalize=False):
    from isvins_tpu_torch.config import (CameraConfig, NoiseConfig, TrackerConfig,
                                         WindowConfig, euroc_config)

    H, W, f = 240, 320, 200.0
    return euroc_config().replace(
        camera=CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0),
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4, lk_win=21,
                              equalize=equalize, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        noise=NoiseConfig(**noise, pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=pg, tic=(0.0, 0.0, 0.0), ric=R_BC)


def _feed_frame(sys_, world, renderer, k):
    if k > 0:
        acc_t = world.frame_times[k - 1]
        for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
            acc_t += world.imu_dts[k - 1][s]
            sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
    sys_.pub_image(world.frame_times[k], renderer.render(k)[0])


@pytest.mark.slow
def test_system_pixels_to_trajectory():
    """tests/test_system_e2e.py::test_system_pixels_to_trajectory on the port."""
    from isvins_tpu_torch.config import PoseGraphConfig
    from isvins_tpu_torch.system import System

    cfg = _e2e_config(PoseGraphConfig(enabled=False),
                      dict(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5))
    world = make_world(n_frames=40, frame_hz=10.0, imu_hz=200.0, n_landmarks=900, seed=1)
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), mat_to_quat_np(np.array(R_BC)))
    sys_ = System(cfg, _dims("torch"), enable_loop=False, device="cpu")
    for k in range(40):
        _feed_frame(sys_, world, renderer, k)
    traj = sys_.vio_trajectory
    assert len(traj) >= 15, f"only {len(traj)} poses estimated"
    t_est = np.array([t for (t, P, Q) in traj])
    p_est = np.array([P for (t, P, Q) in traj])
    rmse = ate_rmse(t_est, p_est, world.frame_times, world.P, align="sim3")
    assert rmse < 0.15, rmse
    sys_.close()


@pytest.mark.slow
def test_system_loop_closure_reduces_drift():
    """tests/test_system_e2e.py::test_system_loop_closure_reduces_drift on
    the port: 1.24 laps with the production threading (tracker pipeline,
    pose-graph worker), at least one loop, the async optimization collected,
    no frame stalling on worker work, and the loop-optimized keyframe ATE at
    most half the keyframe VIO ATE."""
    from isvins_tpu_torch.config import PoseGraphConfig
    from isvins_tpu_torch.system import System

    cfg = _e2e_config(PoseGraphConfig(skip_recent=25, min_loop_matches=15, keyframe_min_dist=0.3,
                                      max_keyframes=256, max_kp_per_kf=256),
                      dict(acc_n=0.01, gyr_n=0.001, acc_w=1e-4, gyr_w=1e-5))
    n_frames = 130
    world = make_world(n_frames=n_frames, frame_hz=10.0, imu_hz=200.0, n_landmarks=300, seed=4,
                       traj_r=3.0, traj_w=0.6, noise_acc=0.05, noise_gyr=0.005,
                       ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), mat_to_quat_np(np.array(R_BC)),
                            seed=5)
    sys_ = System(cfg, _dims("torch"), enable_loop=True, pipeline=True, pg_thread=True,
                  device="cpu")
    frame_dts = []
    for k in range(n_frames):
        t0 = time.perf_counter()
        _feed_frame(sys_, world, renderer, k)
        if sys_.estimator.solver_flag == 2:
            frame_dts.append(time.perf_counter() - t0)
    assert len(sys_.vio_trajectory) >= 50
    db = sys_.pgbuilder.db
    assert db.n >= 20, f"only {db.n} keyframes"
    sys_.flush()
    assert sys_.pgbuilder.n_loops >= 1, "no loop closure fired on revisit"
    assert sys_.pgbuilder.n_async_collects >= 1
    assert sys_.pgbuilder._pending_opt is None
    tail = np.array(frame_dts[len(frame_dts) // 2:])
    assert len(tail) >= 20
    med = float(np.median(tail))
    p90 = float(np.percentile(tail, 90))
    assert p90 <= 3.0 * med, (med, p90)
    assert float(tail.max()) <= 8.0 * med, (med, float(tail.max()))
    ts, t_opt, _ = sys_.pgbuilder.trajectory()
    rmse_vio = ate_rmse(ts, db.vio_t[: db.n], world.frame_times, world.P, align="se3")
    rmse_opt = ate_rmse(ts, t_opt, world.frame_times, world.P, align="se3")
    assert rmse_opt <= 0.5 * rmse_vio, (rmse_vio, rmse_opt)
    assert rmse_opt < 2.0, rmse_opt
    sys_.close()


@pytest.mark.slow
def test_system_nuisance_trajectory_bounded():
    """tests/test_adversarial.py::test_system_nuisance_trajectory_bounded on
    the port: blur, exposure flicker, noise bursts and occluders; the
    estimator initializes and the ATE stays under 0.30 m."""
    from isvins_tpu_torch.config import PoseGraphConfig
    from isvins_tpu_torch.system import System
    from test_adversarial import NUISANCE

    cfg = _e2e_config(PoseGraphConfig(enabled=False),
                      dict(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5), equalize=True)
    world = make_world(n_frames=40, frame_hz=10.0, imu_hz=200.0, n_landmarks=10, seed=1)
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), mat_to_quat_np(np.array(R_BC)),
                            **NUISANCE)
    sys_ = System(cfg, _dims("torch"), enable_loop=False, device="cpu")
    for k in range(40):
        _feed_frame(sys_, world, renderer, k)
    sys_.flush()
    traj = sys_.vio_trajectory
    assert len(traj) >= 15, f"only {len(traj)} poses under nuisances"
    t_est = np.array([t for (t, P, Q) in traj])
    p_est = np.array([P for (t, P, Q) in traj])
    rmse = ate_rmse(t_est, p_est, world.frame_times, world.P, align="sim3")
    assert rmse < 0.30, f"nuisance ATE {rmse:.3f} m"
    sys_.close()

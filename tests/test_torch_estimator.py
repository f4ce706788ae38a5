"""The port's estimator slice against the JAX estimator, on the world and
config of tests/test_estimator_e2e.run_sequence (26 frames, B=10, Vo=4,
F=256, N=2048, ground-truth init, noiseless):
(a) teacher-forced: the JAX estimator's steady-state snapshot
    (utils/checkpoint.save_estimator) loaded into the port, one more frame
    stepped by both, with the steady solve in f32 and in f64;
(b) free-running: both packages run the whole sequence;
(c) the f64 and the on-device DLT triangulations against the JAX one;
(d) no jax: every isvins_tpu_torch module imports without jax.
The JAX estimator runs once per file (module fixture); the snapshot is taken
during that same run."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.estimator.estimator import Estimator as JEstimator
from isvins_tpu.geom import mat_to_quat
from isvins_tpu.solver import WindowDims as JDims
from isvins_tpu.utils.checkpoint import load_estimator as jax_load_estimator
from isvins_tpu.utils.checkpoint import save_estimator
from isvins_tpu_torch.estimator.estimator import Estimator as TEstimator
from isvins_tpu_torch.solver import WindowDims as TDims
from isvins_tpu_torch.utils.checkpoint import load_estimator

from test_estimator_e2e import ate, run_sequence  # noqa: F401  (config/world source)

N_FRAMES = 26
SNAP_FRAME = 18  # steady state: init at frame 9, then 9 solved frames


def _config():
    from isvins_tpu.config import WindowConfig, euroc_config

    return euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01),
        ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )


def _world():
    from isvins_tpu.utils.synthetic import make_world

    return make_world(n_frames=N_FRAMES, n_landmarks=240, seed=0)


def _feed(est, world, k, tic, qic):
    from isvins_tpu.utils.synthetic import project

    if k > 0:
        for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
            est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                            world.imu_gyrs[k - 1][s])
    pts, _, vis = project(world, k, tic, qic)
    return est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])


def _gt_hook(world):
    def hook(e):
        e.set_ground_truth_init(world.P, world.Q, world.V)
        e.f_manager.depth[:] = -1.0

    return hook


def _snapshot_state(est):
    return {"P": est.Ps.copy(), "Q": est.Qs.copy(), "V": est.Vs.copy(),
            "Ba": est.Bas.copy(), "Bg": est.Bgs.copy(),
            "priors": [np.array(a) for a in _prior_leaves(est.priors)]}


def _prior_leaves(pr):
    out = []
    for a in pr:
        out.extend(_prior_leaves(a) if isinstance(a, tuple) else [np.asarray(a)])
    return out


def _run(est, world, tic, qic, on_frame=None):
    flags, traj = [], []
    for k in range(N_FRAMES):
        info = _feed(est, world, k, tic, qic)
        flags.append(bool(info["keyframe"]))
        if est.solver_flag == 2:
            traj.append((world.frame_times[k], est.latest_pose()[1].copy(), k))
        if on_frame is not None:
            on_frame(k)
    return flags, traj


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg, world = _config(), _world()
    tic = np.asarray(cfg.tic_np)
    qic = np.asarray(mat_to_quat(jnp.asarray(cfg.ric_np)))
    est = JEstimator(cfg, JDims(B=10, Vo=4, F=256, N=2048))
    est._gt_init = _gt_hook(world)
    snap = {"path": str(tmp_path_factory.mktemp("snap") / "est.npz")}

    def on_frame(k):
        if k == SNAP_FRAME:
            save_estimator(est, snap["path"])
        if k == SNAP_FRAME + 1:
            est.collect_marg()  # land this frame's marginalization
            snap["after"] = _snapshot_state(est)
            snap["packet"] = [np.asarray(a) for a in est.pose_graph_packets[-1]]
            snap["kfp"] = est.keyframe_points[-1]

    flags, traj = _run(est, world, tic, qic, on_frame)
    return cfg, world, est, flags, traj, snap, tic, qic


def _port_config():
    from isvins_tpu_torch.config import WindowConfig, euroc_config

    return euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01),
        ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )


def _with_solve_dtype(cfg, solve_dtype):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, solve_dtype=solve_dtype))


# Per-dtype bounds of the teacher-forced frame. float64: the two packages
# run the same math, so only summation order separates them (measured
# ~1e-13); the marginalized information matrices (normalized by their
# largest entry) get 1e-7, since their eigendecomposition and eigenvalue
# truncation amplify that rounding (measured 7e-9). float32: Ps/Vs 1e-4,
# Qs 1e-5, Bgs 1e-5; Bas gets 1e-4, because the accelerometer bias is the
# window's weakest direction: each package's own f32 step lands 3.5e-4 from
# its f64 step on this frame, and the two f32 steps (different summation
# orders) sit 4.3e-5 apart. The keyframe points exported with the packet
# follow the poses and depths: measured 2.5e-5 m (f32) and 1.1e-13 m (f64)
# in points_w, 1.3e-7 and 1.8e-15 on the normalized plane.
TF_TOL = {
    "float32": dict(P=1e-4, V=1e-4, Q=1e-5, Ba=1e-4, Bg=1e-5, prior=1e-4, info=1e-3,
                    points_w=1e-4, pts_norm=1e-6),
    "float64": dict(P=1e-9, V=1e-9, Q=1e-9, Ba=1e-9, Bg=1e-9, prior=1e-9, info=1e-7,
                    points_w=1e-9, pts_norm=1e-9),
}


@pytest.mark.parametrize("solve_dtype", ["float32", "float64"])
def test_teacher_forced_frame(jax_run, solve_dtype):
    """One steady frame from the same JAX snapshot, stepped by both
    packages with 10 LM iterations at `solve_dtype`: states, the dragged +
    marginalized priors, the pose-graph packet and the keyframe points
    exported with it agree within TF_TOL."""
    cfg, world, _, _, _, snap, tic, qic = jax_run
    tol = TF_TOL[solve_dtype]
    if solve_dtype == "float32":
        ref, ref_packet, ref_kfp = snap["after"], snap["packet"], snap["kfp"]
    else:  # the JAX estimator's own f64 step from the same snapshot
        jest = JEstimator(_with_solve_dtype(cfg, solve_dtype), JDims(B=10, Vo=4, F=256, N=2048))
        jax_load_estimator(jest, snap["path"])
        _feed(jest, world, SNAP_FRAME + 1, tic, qic)
        jest.collect_marg()
        ref = _snapshot_state(jest)
        ref_packet = [np.asarray(a) for a in jest.pose_graph_packets[-1]]
        ref_kfp = jest.keyframe_points[-1]
    est = TEstimator(_with_solve_dtype(_port_config(), solve_dtype),
                     TDims(B=10, Vo=4, F=256, N=2048), device="cpu")
    load_estimator(est, snap["path"])
    _feed(est, world, SNAP_FRAME + 1, tic, qic)
    est.collect_marg()
    np.testing.assert_allclose(est.Ps, ref["P"], atol=tol["P"])
    np.testing.assert_allclose(est.Vs, ref["V"], atol=tol["V"])
    np.testing.assert_allclose(est.Qs, ref["Q"], atol=tol["Q"])
    np.testing.assert_allclose(est.Bas, ref["Ba"], atol=tol["Ba"])
    np.testing.assert_allclose(est.Bgs, ref["Bg"], atol=tol["Bg"])
    for a, b in zip(_prior_leaves(est.priors), ref["priors"]):
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b)
        elif a.ndim >= 2 and a.shape[-1] == a.shape[-2]:  # sqrt-info blocks
            ia, ib = np.swapaxes(a, -1, -2) @ a, np.swapaxes(b, -1, -2) @ b
            scale = np.abs(ib).max() + 1e-300
            np.testing.assert_allclose(ia / scale, ib / scale, atol=tol["info"])
        else:
            np.testing.assert_allclose(a, b, atol=tol["prior"])
    pkt = est.pose_graph_packets[-1]
    np.testing.assert_allclose(np.asarray(pkt.rel_dt), ref_packet[0], atol=tol["prior"])
    # the keyframe points exported with that packet: the pose graph's inputs
    kfp = est.keyframe_points[-1]
    assert len(kfp.ids) >= 20
    np.testing.assert_array_equal(kfp.ids, ref_kfp.ids)
    assert float(kfp.ts) == float(ref_kfp.ts)
    np.testing.assert_allclose(kfp.points_w, ref_kfp.points_w, atol=tol["points_w"])
    np.testing.assert_allclose(kfp.pts_norm, ref_kfp.pts_norm, atol=tol["pts_norm"])
    est.close()


def test_free_running(jax_run):
    """Both packages over the whole sequence: the same keyframe decisions,
    positions within 5 mm of JAX, and the test_e2e_noiseless bounds."""
    cfg, world, jest, jflags, jtraj, _, tic, qic = jax_run
    est = TEstimator(_port_config(), TDims(B=10, Vo=4, F=256, N=2048), device="cpu")
    est._gt_init = _gt_hook(world)
    flags, traj = _run(est, world, tic, qic)
    est.close()
    assert flags == jflags
    assert [k for *_, k in traj] == [k for *_, k in jtraj]
    gap = max(np.linalg.norm(p - q) for (_, p, _), (_, q, _) in zip(traj, jtraj))
    assert gap <= 5e-3, gap
    # tests/test_estimator_e2e.py:96-111 on the port alone
    assert len(traj) >= 10
    emax, emean = ate(traj, world)
    assert emax < 0.05, (emax, emean)
    assert len(est.pose_graph_packets) >= 5
    assert np.isfinite(est.last_kld.get("forward", np.nan))
    assert np.isfinite(est.last_kld.get("backward", np.nan))
    assert est.failure_count == 0


def test_triangulate_matches_reference(jax_run):
    """The f64 DLT (SVD) and the steady path's device DLT (4x4 Gram eigh)
    against the JAX _triangulate_batch on the final window of the JAX run,
    for every track with >= 2 observations: both take the same relative
    transform as the reference, so depths agree to f64 rounding of the
    nullspace (rtol 1e-6)."""
    from isvins_tpu.estimator.feature_manager import _triangulate_batch as jax_tri
    from isvins_tpu_torch.estimator.estimator import device_triangulate
    from isvins_tpu_torch.estimator.feature_manager import _triangulate_batch
    from isvins_tpu_torch.solver import WindowState

    _, _, jest, *_ = jax_run
    fm = jest.f_manager
    args = (fm.obs, fm.has_obs, fm.start, jest.Ps, jest.Qs, jest.tic, jest.qic)
    ref = np.asarray(jax_tri(*map(jnp.asarray, args)))
    rows = fm.active() & (fm.has_obs.sum(axis=1) >= 2)
    assert rows.sum() >= 20
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt)
    obs, has, start = t(fm.obs), t(fm.has_obs, torch.bool), t(fm.start, torch.int64)
    svd = _triangulate_batch(obs, has, start, t(jest.Ps), t(jest.Qs), t(jest.tic), t(jest.qic))
    st = WindowState(P=t(jest.Ps), Q=t(jest.Qs), V=None, Ba=None, Bg=None,
                     tic=t(jest.tic), qic=t(jest.qic), dep=None)
    eig = device_triangulate(st, obs, has, start)
    np.testing.assert_allclose(svd.numpy()[rows], ref[rows], rtol=1e-6)
    np.testing.assert_allclose(eig.numpy()[rows], ref[rows], rtol=1e-6)


def test_port_imports_no_jax():
    """Every isvins_tpu_torch module (the pose graph's, the multi-sequence
    path's, the tracker's, the SfM initialization's and the benches' among
    them), imported in a fresh interpreter, leaves jax (and the JAX package)
    out of sys.modules."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import isvins_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'isvins_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'isvins_tpu')]\n"
        "new = {'isvins_tpu_torch.posegraph.builder', 'isvins_tpu_torch.posegraph.keyframe_db',\n"
        "       'isvins_tpu_torch.posegraph.optimize', 'isvins_tpu_torch.posegraph.brief',\n"
        "       'isvins_tpu_torch.ops.hamming', 'isvins_tpu_torch.initial.pnp',\n"
        "       'isvins_tpu_torch.frontend.camera', 'isvins_tpu_torch.frontend.image_ops',\n"
        "       'isvins_tpu_torch.ops.chol_batched', 'isvins_tpu_torch.ops.schur',\n"
        "       'isvins_tpu_torch.parallel.multi_seq', 'isvins_tpu_torch.parallel.sharded',\n"
        "       'isvins_tpu_torch.frontend.lk', 'isvins_tpu_torch.frontend.tracker',\n"
        "       'isvins_tpu_torch.initial.five_point', 'isvins_tpu_torch.initial.ex_rotation',\n"
        "       'isvins_tpu_torch.bench', 'isvins_tpu_torch.retrieval_bench',\n"
        "       'isvins_tpu_torch.realism_bench', 'isvins_tpu_torch.scaling_bench',\n"
        "       'isvins_tpu_torch.multichip', 'isvins_tpu_torch.utils.timing'}\n"
        "assert len(mods) >= 57 and new <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("dt, tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_min_eigvec_sym4_against_eigh(dt, tol):
    """The nullspace of device_triangulate without torch.linalg.eigh (which
    reads its error flags on the host on CUDA): min_eigvec_sym4's cyclic
    Jacobi against eigh's eigenvector of the smallest eigenvalue, up to
    sign, on 4x4 PSD matrices with eigenvalues 0..3 times a scale of 1e-3
    to 1e3 (gaps of a third of the norm: f64 1e-10, f32 1e-4), on random
    DLT Grams (f64 1e-9 relative to the gap), and finite on a zero matrix
    (a track with no observation)."""
    from isvins_tpu_torch.estimator.estimator import min_eigvec_sym4

    rng = np.random.default_rng(0)
    Qm, _ = np.linalg.qr(rng.normal(size=(200, 4, 4)))
    lam = np.array([0.0, 1.0, 2.0, 3.0]) * 10.0 ** rng.uniform(-3, 3, size=(200, 1))
    G = np.einsum("nij,nj,nkj->nik", Qm, lam, Qm)
    v = min_eigvec_sym4(torch.as_tensor(G, dtype=dt)).double().numpy()
    ref = Qm[..., 0]
    err = np.minimum(np.abs(v - ref).max(-1), np.abs(v + ref).max(-1))
    assert err.max() < tol, err.max()
    if dt == torch.float64:
        A = rng.normal(size=(500, 6, 4))
        G = A.transpose(0, 2, 1) @ A
        w, V = np.linalg.eigh(G)
        v = min_eigvec_sym4(torch.as_tensor(G)).numpy()
        err = np.minimum(np.abs(v - V[..., 0]).max(-1), np.abs(v + V[..., 0]).max(-1))
        assert (err * (w[:, 1] - w[:, 0]) / w[:, 3]).max() < 1e-9
    z = min_eigvec_sym4(torch.zeros((3, 4, 4), dtype=dt))
    assert bool(torch.isfinite(z).all())


def test_e2e_noisy():
    """tests/test_estimator_e2e.py::test_e2e_noisy on the port: run_sequence's
    noisy world (0.5 px projection noise, IMU noise with consistently
    weighted factors, seed 5, 26 frames, ground-truth init), with the
    reference's bounds: 4-DoF-aligned max error under 0.12 m, unaligned
    under 0.5 m, no failure reset."""
    from isvins_tpu_torch.config import NoiseConfig
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.utils.synthetic import make_world, project

    seed = 5
    cfg = _port_config().replace(noise=NoiseConfig(acc_n=0.01, gyr_n=0.001, acc_w=1e-4,
                                                   gyr_w=1e-5))
    world = make_world(n_frames=N_FRAMES, n_landmarks=240, seed=seed, noise_acc=0.02,
                       noise_gyr=0.002)
    est = TEstimator(cfg, TDims(B=10, Vo=4, F=256, N=2048), device="cpu")
    est._gt_init = _gt_hook(world)
    rng = np.random.default_rng(seed + 100)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(cfg.ric_np))
    traj = []
    for k in range(N_FRAMES):
        if k > 0:
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                world.imu_gyrs[k - 1][s])
        pts, _, vis = project(world, k, tic, qic, px_noise=0.5 / 460.0, rng=rng)
        est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
        if est.solver_flag == 2:
            traj.append((world.frame_times[k], est.latest_pose()[1].copy(), k))
    est.close()
    assert len(traj) >= 10
    emax, emean = ate(traj, world, align=True)
    assert emax < 0.12, (emax, emean)
    emax_raw, _ = ate(traj, world)
    assert emax_raw < 0.5, emax_raw
    assert est.failure_count == 0

"""The port's SfM self-initialization (isvins_tpu_torch.initial.five_point
and ex_rotation, estimator.vi_init, initialization.initial_structure
without a hook, and the estimator's online extrinsic calibration) against
the JAX package on the CPU, on the same seeded numpy inputs, each with its
tolerance stated; and the port's mirrors of the reference's
self-initialization and extrinsic-calibration tests."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.config import WindowConfig, euroc_config
from isvins_tpu.estimator import vi_init as jvi
from isvins_tpu.estimator.estimator import Estimator as JEstimator
from isvins_tpu.geom import hostmath as hm
from isvins_tpu.initial import ex_rotation as jex
from isvins_tpu.initial import five_point as jfp
from isvins_tpu.solver import WindowDims as JDims
from isvins_tpu.utils.synthetic import make_world, project
from isvins_tpu_torch.config import WindowConfig as TWindowConfig
from isvins_tpu_torch.config import euroc_config as t_euroc_config
from isvins_tpu_torch.estimator import vi_init as tvi
from isvins_tpu_torch.estimator.estimator import Estimator as TEstimator
from isvins_tpu_torch.initial import ex_rotation as tex
from isvins_tpu_torch.initial import five_point as tfp
from isvins_tpu_torch.solver import WindowDims as TDims

from test_estimator_e2e import ate

RIC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
TIC = (0.02, -0.01, 0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: when several test processes share one
    machine, torch's intra-op thread pools only contend with each other
    (this file's drives ran 10-20x slower beside three other workers than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_view(seed, n=120, outlier_share=0.25, noise=0.0):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], axis=1)
    R = hm.quat_to_mat_np(hm.so3_exp_quat_np(np.array([0.03, -0.12, 0.05])))
    t = np.array([0.3, -0.05, 0.1])
    p1 = X[:, :2] / X[:, 2:3]
    Xc2 = X @ R.T + t
    p2 = Xc2[:, :2] / Xc2[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    is_out = rng.random(n) < outlier_share
    p2 = p2 + is_out[:, None] * rng.normal(scale=0.05, size=(n, 2))
    return p1, p2, is_out, R


@pytest.mark.parametrize("seed,noise", [(5, 0.0), (9, 0.3 / 460.0)])
def test_ransac_core_matches_reference(seed, noise):
    """_ransac_core in f64 (the tracker's host path): the same inlier
    mask, count and cheirality votes, R and t within 1e-9, with a quarter of
    the rows masked out."""
    p1, p2, _, _ = _two_view(seed, noise=noise)
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(len(p1)) < 0.75
    samples = np.stack([rng.choice(np.where(valid)[0], 8, replace=False) for _ in range(128)])
    thresh_sq = (1.0 / 460.0) ** 2
    jR, jt, jinl, jn, jv = jfp._ransac_core(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                            jnp.asarray(samples), thresh_sq)
    tR, tt, tinl, tn, tv = tfp._ransac_core(torch.as_tensor(p1), torch.as_tensor(p2),
                                            torch.as_tensor(valid), torch.as_tensor(samples),
                                            thresh_sq)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) and int(tv) == int(jv) and int(tn) > 15
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed,noise", [(5, 0.0), (9, 0.3 / 460.0), (11, 1.0 / 460.0)])
def test_solve_relative_pose_matches_reference(seed, noise):
    """solve_relative_pose (f64, the same numpy-drawn samples): the same
    acceptance and inlier mask, R and T within 1e-9, and, without pixel
    noise, R within 5e-3 of the true rotation (outliers that land inside the
    threshold enter the refit)."""
    p1, p2, _, R_true = _two_view(seed, noise=noise)
    thresh = 2.0 / 460.0
    j = jfp.solve_relative_pose(p1, p2, thresh=thresh)
    t = tfp.solve_relative_pose(p1, p2, thresh=thresh)
    assert t[0] is j[0] is True
    np.testing.assert_array_equal(t[3], np.asarray(j[3]))
    np.testing.assert_allclose(t[1], np.asarray(j[1]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t[2], np.asarray(j[2]), rtol=0, atol=1e-9)
    if noise == 0.0:
        np.testing.assert_allclose(t[1], R_true.T, atol=5e-3)  # pose of cam2 in cam1
    # too few correspondences: refused in both
    few = (p1[:14], p2[:14])
    assert tfp.solve_relative_pose(*few)[0] is jfp.solve_relative_pose(*few)[0] is False


@pytest.mark.parametrize("seed,noise", [(5, 0.0), (9, 0.5 / 460.0)])
def test_solve_translation_with_rotation_matches_reference(seed, noise):
    """solve_translation_with_rotation (f64): the same inliers, R and T
    within 1e-9, given the true rotation."""
    p1, p2, _, R_true = _two_view(seed, noise=noise, outlier_share=0.1)
    j = jfp.solve_translation_with_rotation(p1, p2, R_true.T, thresh=2.0 / 460.0)
    t = tfp.solve_translation_with_rotation(p1, p2, R_true.T, thresh=2.0 / 460.0)
    assert t[0] is j[0] is True
    np.testing.assert_array_equal(t[3], np.asarray(j[3]))
    np.testing.assert_allclose(t[1], np.asarray(j[1]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t[2], np.asarray(j[2]), rtol=0, atol=1e-9)


def test_ex_rotation_matches_reference():
    """test_ex_rotation.test_ex_rotation_recovers_known_extrinsic, the same
    pushes into both calibrators: acceptance at the same push, ric within
    1e-9 of the reference's from the second push on and within 2e-2 of the
    truth. After the first push the stacked 4 x 4 system has a
    two-dimensional nullspace (its two smallest singular values are 0), so
    the vector either package takes from it is arbitrary; the next push
    makes it one-dimensional."""
    rng = np.random.default_rng(0)
    R_ic = hm.quat_to_mat_np(hm.so3_exp_quat_np(np.array([0.3, -1.2, 0.5])))
    jc, tc = jex.ExtrinsicRotationCalibrator(vo_size=8), tex.ExtrinsicRotationCalibrator(vo_size=8)
    fired = []
    result = None
    for k in range(14):
        R_imu = hm.quat_to_mat_np(hm.so3_exp_quat_np(rng.normal(size=3) * 0.3))
        q_imu = hm.mat_to_quat_np(R_imu)
        R_c = R_ic.T @ R_imu @ R_ic
        X = rng.normal(size=(60, 3)) * np.array([2.0, 1.5, 0.5]) + np.array([0, 0, 6.0])
        t = rng.normal(size=3) * 0.1
        x1 = X / X[:, 2:3]
        X2 = (R_c.T @ (X - t).T).T
        x2 = X2 / X2[:, 2:3]
        a, b = jc.push(x1[:, :2], x2[:, :2], q_imu), tc.push(x1[:, :2], x2[:, :2], q_imu)
        assert (a is None) == (b is None), k
        if k == 0:
            assert max(jc.last_S[2:].max(), tc.last_S[2:].max()) < 1e-12
        else:
            np.testing.assert_allclose(tc.ric, jc.ric, rtol=0, atol=1e-9)
        if b is not None:
            fired.append(k)
            result = b
    assert fired and fired[0] == 7
    assert np.abs(result - R_ic).max() < 2e-2


def _configs(estimate_extrinsic=0, ric=RIC):
    kw = dict(tic=TIC, ric=ric, estimate_extrinsic=estimate_extrinsic)
    j = euroc_config().replace(window=WindowConfig(vo_size=4, all_size=10, max_features=256,
                                                   max_imu_per_frame=64), **kw)
    t = t_euroc_config().replace(window=TWindowConfig(vo_size=4, all_size=10, max_features=256,
                                                      max_imu_per_frame=64), **kw)
    return j, t


class _Stop(Exception):
    pass


def _drive(est, world, n_frames, px_noise, on_frame=None, q_true=None):
    """test_estimator_e2e.run_sequence's feed: IMU, then the frame's
    projections with seeded pixel noise (rng seed 100)."""
    rng = np.random.default_rng(100)
    tic = np.asarray(TIC)
    qic = hm.mat_to_quat_np(np.array(RIC)) if q_true is None else q_true
    traj, infos = [], []
    for k in range(n_frames):
        if k > 0:
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                world.imu_gyrs[k - 1][s])
        pts, _, vis = project(world, k, tic, qic, px_noise=px_noise, rng=rng)
        infos.append(est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k]))
        if est.solver_flag == 2:
            traj.append((world.frame_times[k], est.latest_pose()[1].copy(), k))
        if on_frame is not None:
            on_frame(infos[-1])
    return traj, infos


def test_self_init_matches_reference():
    """test_e2e_self_init's world (26 frames, 700 landmarks, 0.3/460 pixel
    noise; B = 10, F = 256, N = 2048): both estimators take the same packets
    to frame B - 1, where the initialization runs. find_seed_pair gives the
    same frame and relative pose (1e-9); global_sfm the same poses (1e-6 m,
    rad) and inverse depths (1e-6 relative); run_visual_inertial_init the
    same Ps, Vs, Qs (1e-6) and Bgs (1e-9)."""
    jc, tc = _configs()
    world = make_world(n_frames=26, n_landmarks=700, seed=0)

    def recorder(vi, rec):
        def hook(e):
            rec["seed"] = vi.find_seed_pair(e)
            rec["sfm"] = vi.global_sfm(e, *rec["seed"])
            rec["ok"] = vi.run_visual_inertial_init(e)
            rec["state"] = [a.copy() for a in (e.Ps, e.Vs, e.Qs, e.Bgs)]
            raise _Stop
        return hook

    recs = []
    for est, vi in ((JEstimator(jc, JDims(B=10, Vo=4, F=256, N=2048)), jvi),
                    (TEstimator(tc, TDims(B=10, Vo=4, F=256, N=2048), device="cpu"), tvi)):
        rec = {}
        est._gt_init = recorder(vi, rec)
        with pytest.raises(_Stop):
            _drive(est, world, 26, 0.3 / 460.0)
        recs.append(rec)
    j, t = recs
    assert t["seed"][0] == j["seed"][0] is not None
    for a, b in zip(j["seed"][1:], t["seed"][1:]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-9)
    assert t["sfm"][0] is j["sfm"][0] is True
    np.testing.assert_allclose(t["sfm"][1], np.asarray(j["sfm"][1]), rtol=0, atol=1e-6)  # q
    np.testing.assert_allclose(t["sfm"][2], np.asarray(j["sfm"][2]), rtol=0, atol=1e-6)  # p
    jd, td = np.asarray(j["sfm"][3]), t["sfm"][3]
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    assert (jd > 0).sum() > 50
    assert t["ok"] is j["ok"] is True
    for a, b, tol in zip(j["state"], t["state"], (1e-6, 1e-6, 1e-6, 1e-9)):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_e2e_self_init():
    """test_estimator_e2e.test_e2e_self_init on the port (CPU): the full
    pipeline with the SfM + VI-alignment initialization, no ground-truth
    hook: >= 8 poses, yaw-aligned largest error < 0.25 m, no failure."""
    _, tc = _configs()
    world = make_world(n_frames=26, n_landmarks=700, seed=0)
    est = TEstimator(tc, TDims(B=10, Vo=4, F=256, N=2048), device="cpu")
    assert getattr(est, "_gt_init", None) is None
    try:
        traj, _ = _drive(est, world, 26, 0.3 / 460.0)
    finally:
        est.close()
    assert len(traj) >= 8, "self-initialization failed"
    emax, emean = ate(traj, world, align=True)
    assert emax < 0.25, (emax, emean)
    assert est.failure_count == 0


def _rot_angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def test_wired_extrinsic_calibration():
    """test_ex_rotation.test_wired_extrinsic_calibration on the port:
    estimate_extrinsic == 2 runs the hand-eye calibrator per frame, defers
    initialization until it is confident, installs the calibrated ric
    (within 3 deg when it fires) and drops to refinement mode 1; the self-initialized
    estimator then solves >= 5 frames, ends within 1.5 deg and never fails.
    Observations use the true extrinsic, the config a ~10 deg wrong guess."""
    R_true = np.array(RIC)
    dR = hm.quat_to_mat_np(hm.so3_exp_quat_np(np.array([0.10, -0.12, 0.08])))
    _, tc = _configs(estimate_extrinsic=2,
                     ric=tuple(tuple(float(v) for v in row) for row in (dR @ R_true)))
    assert _rot_angle_deg(R_true, np.asarray(tc.ric_np)) > 8.0
    world = make_world(n_frames=48, n_landmarks=900, seed=3, traj_w=0.8, wobble=(0.5, 0.45))
    est = TEstimator(tc, TDims(B=10, Vo=4, F=256, N=2048), device="cpu")
    err_at_fire = []

    def on_frame(info):
        if info.get("extrinsic_calibrated"):
            err_at_fire.append(_rot_angle_deg(hm.quat_to_mat_np(est.qic), R_true))

    try:
        _, infos = _drive(est, world, 48, 0.0, on_frame=on_frame,
                          q_true=hm.mat_to_quat_np(R_true))
    finally:
        est.close()
    assert len(err_at_fire) == 1, "calibration never became confident (or fired twice)"
    assert err_at_fire[0] < 3.0  # the hand-eye output itself is close to the truth
    assert est.estimate_extrinsic == 1
    assert sum(bool(i.get("solved")) for i in infos) >= 5
    assert _rot_angle_deg(hm.quat_to_mat_np(est.qic), R_true) < 1.5
    assert est.failure_count == 0

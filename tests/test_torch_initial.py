"""The port's numpy-side init pieces against the JAX package on the same
inputs: the synthetic world (make_world, project), the gyroscope-bias
solve and the linear alignment. Both sides are f64 numpy apart from the
quaternion helpers, so they agree to f64 rounding (atol 1e-9)."""

import numpy as np
import jax.numpy as jnp
import pytest

import isvins_tpu  # noqa: F401
from isvins_tpu.factors import ImuNoise as JImuNoise
from isvins_tpu.factors import integrate_segment as jax_integrate
from isvins_tpu.geom import quat_to_mat
from isvins_tpu.initial import alignment as jal
from isvins_tpu.utils import synthetic as jsyn
from isvins_tpu_torch.initial import alignment as tal
from isvins_tpu_torch.utils import synthetic as tsyn

WORLD = dict(n_frames=12, n_landmarks=200, seed=3, bg=(0.004, -0.006, 0.003))


def test_make_world_and_project_match():
    """make_world is the JAX package's numpy generator: every field equal;
    project gives the same points, depths and visibility (with pixel noise
    drawn from the same numpy generator)."""
    jw, tw = jsyn.make_world(**WORLD), tsyn.make_world(**WORLD)
    for name in ("P", "Q", "V", "landmarks", "imu_dts", "imu_accs", "imu_gyrs",
                 "frame_times"):
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name), err_msg=name)
    tic, qic = np.array([0.02, -0.01, 0.01]), np.array([0.5, -0.5, 0.5, -0.5])
    for k in (0, 5, 11):
        ref = jsyn.project(jw, k, tic, qic, px_noise=1e-3, rng=np.random.default_rng(k))
        out = tsyn.project(tw, k, tic, qic, px_noise=1e-3, rng=np.random.default_rng(k))
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def _alignment_inputs():
    """Preintegrations of every segment at zero bias (the world carries a
    gyro bias) and camera-frame rotations/positions from ground truth."""
    w = jsyn.make_world(**WORLD)
    noise = JImuNoise(0.08, 0.004, 0.00004, 2.0e-6)
    B = WORLD["n_frames"]
    pres = []
    for k in range(B - 1):
        pre = jax_integrate(jnp.asarray(w.imu_dts[k]), jnp.asarray(w.imu_accs[k]),
                            jnp.asarray(w.imu_gyrs[k]), jnp.asarray(w.imu_acc0[k]),
                            jnp.asarray(w.imu_gyr0[k]), jnp.zeros(3), jnp.zeros(3), noise)
        pres.append(type(pre)(*(np.asarray(a) for a in pre)))
    R = np.asarray(quat_to_mat(jnp.asarray(w.Q)))
    tic = np.array([0.02, -0.01, 0.01])
    T_cams = w.P + np.einsum("bij,j->bi", R, tic)
    return R, T_cams, pres, tic


@pytest.mark.parametrize("trim", [True, False])
def test_solve_gyroscope_bias_matches(trim):
    R, _, pres, _ = _alignment_inputs()
    ref = jal.solve_gyroscope_bias(R, pres, trim=trim)
    out = tal.solve_gyroscope_bias(R, pres, trim=trim)
    np.testing.assert_allclose(out, ref, atol=1e-9)
    # the world's gyro bias is what the solve recovers (noiseless IMU)
    np.testing.assert_allclose(out, WORLD["bg"], atol=5e-4)


def test_linear_alignment_matches():
    R, T_cams, pres, tic = _alignment_inputs()
    ok_j, g_j, x_j = jal.linear_alignment(R, T_cams, pres, tic, 9.81007)
    ok_t, g_t, x_t = tal.linear_alignment(R, T_cams, pres, tic, 9.81007)
    assert ok_t == ok_j
    np.testing.assert_allclose(g_t, g_j, atol=1e-9)
    np.testing.assert_allclose(x_t, x_j, atol=1e-9)

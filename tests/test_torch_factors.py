"""isvins_tpu_torch.factors against isvins_tpu.factors on seeded numpy
inputs: preintegration (partially filled segments), the IMU residual and
Jacobians, sqrt-info, projection and every prior family."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu import factors as jf
from isvins_tpu.factors import priors as jpriors
from isvins_tpu.factors.preintegration import sqrt_info_from_cov as j_sqrt
from isvins_tpu_torch import factors as tf
from isvins_tpu_torch.factors import priors as tpriors

from test_torch_geom import _quats

T = lambda a: torch.as_tensor(np.array(a))
J = lambda a: jnp.asarray(np.asarray(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _imu_buffers(rng, S=6, C=24):
    """S segments of C slots, segment s holding 20 - 4s valid samples (a
    zero-length segment included), plus biases off the zero point."""
    dts = np.zeros((S, C))
    for s in range(S):
        dts[s, : max(0, 20 - 4 * s)] = 0.005 * rng.uniform(0.8, 1.2)
    accs = rng.normal(size=(S, C, 3)) * 0.5 + np.array([0, 0, 9.81])
    gyrs = rng.normal(size=(S, C, 3)) * 0.3
    a0 = rng.normal(size=(S, 3)) * 0.5 + np.array([0, 0, 9.81])
    g0 = rng.normal(size=(S, 3)) * 0.3
    ba = rng.normal(size=(S, 3)) * 0.05
    bg = rng.normal(size=(S, 3)) * 0.005
    return dts, accs, gyrs, a0, g0, ba, bg


NOISE = (0.08, 0.004, 1e-3, 1e-4)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_integrate_segment_partial(rng, dt):
    """Batched port (rotation chain + cumulative sums + F/P recursions) vs
    the JAX lax.scan, per segment. f64: the sums run in another order
    (cumsum vs scan), ~1e-15 relative. f32: the same reordering at f32
    rounding, accumulated over 20 steps; cov spans 1e-12..1e-4, so it is
    held relative to its own scale."""
    bufs = [b.astype(dt) for b in _imu_buffers(rng)]
    jn = jf.ImuNoise(*(np.asarray(x, dt) for x in NOISE))
    pre_t = tf.integrate_segment(*(T(b) for b in bufs), tf.ImuNoise(*NOISE))
    pre_j = jax.vmap(lambda *a: jf.integrate_segment(*a, jn))(*(J(b) for b in bufs))
    tol = dict(rtol=1e-10, atol=1e-12) if dt == np.float64 else dict(rtol=2e-4, atol=2e-6)
    for name in ("delta_p", "delta_q", "delta_v", "jac", "sum_dt", "ba", "bg"):
        _close(getattr(pre_t, name), getattr(pre_j, name), err_msg=name, **tol)
    cov_t, cov_j = pre_t.cov.numpy(), np.asarray(pre_j.cov)
    scale = np.abs(cov_j).max(axis=(1, 2), keepdims=True) + 1e-30
    np.testing.assert_allclose(cov_t / scale, cov_j / scale, atol=tol["rtol"])
    # the zero-length segment is the identity
    np.testing.assert_array_equal(pre_t.delta_q[-1].numpy(), [1, 0, 0, 0])


def _imu_args(rng, n=8):
    bufs = _imu_buffers(rng, S=n)
    pre = jax.vmap(lambda *a: jf.integrate_segment(
        *a, jf.ImuNoise(*(np.asarray(x) for x in NOISE))))(*(J(b) for b in bufs))
    st = lambda: rng.normal(size=(n, 3))
    args = [st(), _quats(rng, n)[:n], st(), st() * 0.05, st() * 0.005,
            st(), _quats(rng, n)[:n], st(), st() * 0.05, st() * 0.005]
    return pre, args


def test_imu_residual_jacobians(rng):
    pre_j, args = _imu_args(rng)
    G = np.array([0.0, 0.0, 9.81])
    out_j = jax.vmap(jf.imu_residual_jacobians, in_axes=(0, None) + (0,) * 10)(
        pre_j, J(G), *(J(a) for a in args))
    pre_t = tf.Preintegration(*(T(a) for a in pre_j))
    out_t = tf.imu_residual_jacobians(pre_t, T(G), *(T(a) for a in args))
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=1e-10, atol=1e-10)


def test_sqrt_info_from_cov(rng):
    pre_j, _ = _imu_args(rng)
    cov = np.asarray(pre_j.cov)
    for jit in (0.0, 1e-12):
        _close(tf.sqrt_info_from_cov(T(cov), rel_jitter=jit),
               j_sqrt(J(cov), rel_jitter=jit), rtol=1e-8, atol=1e-6)


def _proj_args(rng, n=64):
    pts = lambda: np.concatenate([rng.normal(size=(n, 2)) * 0.3, np.ones((n, 1))], 1)
    qic = np.array([0.99, 0.05, -0.08, 0.03])
    return [pts(), pts(), rng.normal(size=(n, 3)), _quats(rng, n)[:n],
            rng.normal(size=(n, 3)), _quats(rng, n)[:n], np.array([0.02, -0.01, 0.015]),
            qic / np.linalg.norm(qic), np.abs(rng.normal(size=n)) + 0.2]


def test_projection_residual_jacobians(rng):
    args = _proj_args(rng)
    ax = (0,) * 6 + (None, None, 0)
    out_j = jax.vmap(jf.projection_residual_jacobians, in_axes=ax)(*(J(a) for a in args))
    out_t = tf.projection_residual_jacobians(*(T(a) for a in args))
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=1e-9, atol=1e-9)
    _close(tf.projection_residual(*(T(a) for a in args)),
           jax.vmap(jf.projection_residual, in_axes=ax)(*(J(a) for a in args)),
           rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("family", ["relpose", "se3_prior", "linear9", "rollpitch", "yaw"])
def test_prior_families(rng, family):
    n = 16
    q = lambda: _quats(rng, n)[:n]
    v = lambda k=3: rng.normal(size=(n, k))
    if family == "relpose":
        args, fn = [v(), q(), v(), q(), v(), q()], "relpose_residual_jacobians"
        res = "relpose_residual"
    elif family == "se3_prior":
        args, fn, res = [v(), q(), v(), q()], "se3_prior_residual_jacobians", "se3_prior_residual"
    elif family == "linear9":
        args, fn, res = [v(9), v(), v(), v()], "linear9_residual_jacobians", None
    elif family == "rollpitch":
        args, fn, res = [q(), q()], "rollpitch_residual_jacobians", "rollpitch_residual"
    else:
        args, fn, res = [q(), q()], "yaw_residual_jacobians", None
    out_j = jax.vmap(getattr(jpriors, fn))(*(J(a) for a in args))
    out_t = getattr(tpriors, fn)(*(T(a) for a in args))
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=1e-10, atol=1e-11)
    if res:
        _close(getattr(tpriors, res)(*(T(a) for a in args)),
               jax.vmap(getattr(jpriors, res))(*(J(a) for a in args)), rtol=1e-10, atol=1e-11)


def test_prior_drags(rng):
    """The host-path *_np drags are the reference's own numpy twins."""
    q = lambda: _quats(rng, 1)[0]
    v = lambda: rng.normal(size=3)
    a = [v(), q(), v(), q(), v(), q(), v(), q(), v(), q()]
    for x, y in zip(tpriors.relpose_update_np(*a), jpriors.relpose_update_np(*a)):
        np.testing.assert_allclose(x, y, rtol=1e-14, atol=1e-14)
    a = [v(), q(), v(), q(), v(), q()]
    for x, y in zip(tpriors.se3_prior_update_np(*a), jpriors.se3_prior_update_np(*a)):
        np.testing.assert_allclose(x, y, rtol=1e-14, atol=1e-14)
    a = [q(), q(), q()]
    np.testing.assert_allclose(tpriors.rollpitch_update_np(*a),
                               jpriors.rollpitch_update_np(*a), rtol=1e-14, atol=1e-14)

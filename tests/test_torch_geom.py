"""isvins_tpu_torch.geom against isvins_tpu.geom: the same seeded numpy
inputs through both, in f64 and f32, including the small-angle branches."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu import geom as jg
from isvins_tpu_torch import geom as tg

# f64: both packages evaluate the same closed forms; only the last-bit
# rounding of libm vs XLA transcendental calls differs. f32: one f32
# rounding per op in different fusion orders (~1e-7 relative per op, a few
# tens of ops per function).
TOL = {np.float64: dict(rtol=1e-11, atol=1e-12), np.float32: dict(rtol=2e-5, atol=3e-6)}
DTYPES = [np.float64, np.float32]


def _vecs(rng, dt, n=64):
    """Tangent vectors: unit-scale, small-angle (below the 1e-8 switch on
    |phi|^2) and an exact zero; in f64 also magnitudes just above the
    switch. In f32 those are left out: there the exact branch's
    (1 - cos t)/t^2 and (t - sin t)/t^3 cancel to a few significant bits in
    BOTH packages, and the two garbage values are not comparable."""
    parts = [rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 1e-5, np.zeros((1, 3))]
    if dt == np.float64:
        parts.append(rng.normal(size=(n, 3)) * 3e-4)
    return np.concatenate(parts)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    near_id = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 3)) * 1e-5], 1)
    near_id /= np.linalg.norm(near_id, axis=1, keepdims=True)
    return np.concatenate([q, near_id, -near_id[:4]])


def _cmp(out_t, out_j, dt):
    if isinstance(out_t, tuple):
        for a, b in zip(out_t, out_j):
            _cmp(a, b, dt)
        return
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL[dt])


def _run(name, dt, *args):
    jt = [jnp.asarray(a.astype(dt)) for a in args]
    tt = [torch.as_tensor(a.astype(dt)) for a in args]
    _cmp(getattr(tg, name)(*tt), getattr(jg, name)(*jt), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["so3_exp_quat", "so3_exp_mat", "right_jacobian_so3",
                                  "right_jacobian_inv_so3", "left_jacobian_so3",
                                  "left_jacobian_inv_so3", "skew", "se3_exp_v"])
def test_tangent_maps(rng, name, dt):
    phi = _vecs(rng, dt)
    if name == "se3_exp_v":
        xi = np.concatenate([rng.normal(size=phi.shape), phi], 1)
        _run("se3_exp", dt, xi)
    else:
        _run(name, dt, phi)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_mat", "quat_log", "quat_conj",
                                  "mat_to_quat", "so3_log_mat", "quat_mul", "quat_rotate"])
def test_quaternion_ops(rng, name, dt):
    q = _quats(rng)
    if name in ("mat_to_quat", "so3_log_mat"):
        _run(name, dt, np.asarray(jg.quat_to_mat(jnp.asarray(q))))
    elif name == "quat_mul":
        _run(name, dt, q, _quats(rng)[::-1].copy())
    elif name == "quat_rotate":
        _run(name, dt, q, rng.normal(size=(q.shape[0], 3)))
    elif name == "quat_normalize":
        _run(name, dt, q * rng.uniform(0.5, 2.0, size=(q.shape[0], 1)))
    else:
        _run(name, dt, q)


@pytest.mark.parametrize("dt", DTYPES)
def test_euler_and_gravity(rng, dt):
    ypr = rng.uniform(-170, 170, size=(32, 3)) * np.array([1.0, 0.5, 1.0])
    _run("ypr_to_mat", dt, ypr)
    _run("mat_to_ypr", dt, np.asarray(jg.ypr_to_mat(jnp.asarray(ypr))))
    g = rng.normal(size=(16, 3)) + np.array([0.0, 0.0, 9.8])
    for k in range(g.shape[0]):  # the JAX g2R takes one vector
        _run("g2R", dt, g[k])
    _run("unskew", dt, rng.normal(size=(16, 3, 3)))


@pytest.mark.parametrize("dt", DTYPES)
def test_se3(rng, dt):
    p1, p2 = rng.normal(size=(32, 3)), rng.normal(size=(32, 3))
    q1, q2 = _quats(rng, 16)[:32], _quats(rng, 16)[:32]
    for name in ("se3_compose", "se3_relative"):
        _run(name, dt, p1, q1, p2, q2)
    _run("se3_inverse", dt, p1, q1)
    _run("se3_apply", dt, p1, q1, p2)
    _run("se3_adjoint", dt, p1, q1)
    _run("se3_log", dt, p1, q1)

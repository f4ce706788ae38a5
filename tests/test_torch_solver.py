"""isvins_tpu_torch.solver against isvins_tpu.solver on make_batch_problem
problems and on the synthetic-world problem of tests/test_solver.py, in f64
and f32, including the estimate_extrinsic branch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu import solver as js
from isvins_tpu.parallel import make_batch_problem as j_make_batch_problem
from isvins_tpu_torch import solver as ts
from isvins_tpu_torch.parallel.sharded import make_batch_problem
from isvins_tpu_torch.utils.convert import from_numpy_tree, to_numpy_tree

from test_solver import anchored_priors, build_problem, perturb


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _first(tree):
    """Leading-batch-axis squeeze of a JAX tree."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)[0]), tree)


def _port(tree, dtype=None):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree), "cpu", dtype)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_make_batch_problem_matches(dt):
    """Array for array at the same seed: the random draws are identical;
    the preintegration (scan vs the port's batched recursion) and the
    f32 casts round differently, within the integration tolerances of
    test_torch_factors.py."""
    dims = ts.WindowDims(B=6, Vo=3, F=32, N=64)
    jp = j_make_batch_problem(2, js.WindowDims(*dims), dtype=jnp.dtype(dt), seed=3)
    tp = make_batch_problem(2, dims, torch.float64 if dt == np.float64 else torch.float32, seed=3,
                            device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), _leaves(tuple(tp))
    assert len(jl) == len(tl)
    tol = dict(rtol=1e-9, atol=1e-12) if dt == np.float64 else dict(rtol=2e-4, atol=2e-6)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert a.dtype == b.numpy().dtype or a.dtype.kind == b.numpy().dtype.kind
        if a.dtype.kind == "f" and a.ndim >= 2 and a.shape[-1] == 15:
            scale = np.abs(a).max(axis=(-1, -2), keepdims=True) + 1e-30  # cov/sqrt blocks
            np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=tol["rtol"] * 10)
        else:
            np.testing.assert_allclose(b.numpy(), a, **tol)


def _batch_args(dims, dt, seed=0):
    jp = j_make_batch_problem(1, js.WindowDims(*dims), dtype=jnp.dtype(dt), seed=seed)
    j_args = [_first(x) for x in jp[:4]] + [jp[4], jp[5]]
    t_args = [_port(x) for x in j_args]
    return j_args, t_args


def test_build_normal_equations_f64():
    dims = ts.WindowDims(B=8, Vo=4, F=64, N=256)
    (j_args, t_args) = _batch_args(dims, np.float64)
    ne_j = js.build_normal_equations(*j_args, js.WindowDims(*dims))
    ne_t = ts.build_normal_equations(*t_args, dims)
    for a, b, name in zip(ne_t, ne_j, ("H", "b", "h", "W", "b_l", "cost")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_solve_window_batch_problem(dt):
    """f64: 10 iterations, the same iterates to 1e-9. f32 at the shapes of
    test_pallas_ops.py:50-65 (B 6, F 32, N 64, 3 iterations): final cost
    rtol 1e-5, as that test holds its two JAX paths. The f32 STATE bound is
    1e-5 plus twice the reference's own f32 round-off on this problem
    (|JAX f32 - JAX f64| per field, measured up to 1.1e-4 on V): the port
    sums the projection blocks in another order (index_add_ vs one-hot
    matmuls) and factors with another Cholesky, and on this H ~ 4e11-scaled
    system each f32 LM step carries eps * cond of any such difference. The
    f64 case shows the math itself agrees."""
    if dt == np.float64:
        dims, iters = ts.WindowDims(B=10, Vo=4, F=64, N=256), 10
    else:
        dims, iters = ts.WindowDims(B=6, Vo=3, F=32, N=64), 3
    j_args, t_args = _batch_args(dims, dt)
    st_j, c_j = js.solve_window(*j_args, js.WindowDims(*dims), iters=iters)
    st_t, c_t = ts.solve_window(*t_args, dims, iters=iters)
    if dt == np.float64:
        np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-9)
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
        return
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)
    j64, _ = _batch_args(dims, np.float64)
    st_64, _ = js.solve_window(*j64, js.WindowDims(*dims), iters=iters)
    for name, a, b, c in zip(st_t._fields, st_t, st_j, st_64):
        own = np.abs(np.asarray(b, np.float64) - np.asarray(c)).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 + 2 * own,
                                   err_msg=name)


@pytest.mark.parametrize("estimate_extrinsic", [False, True])
def test_solve_window_synthetic_world(estimate_extrinsic):
    """The perturbed synthetic-world problem of tests/test_solver.py, f64,
    with anchored priors; with estimate_extrinsic the reference-faithful
    projection Jacobians and the extrinsic block of H take part."""
    cfg, world, gt, imu_f, proj_f, dims, nf = build_problem(B=8, F=96, N=768, seed=1)
    pr = jax.tree_util.tree_map(jnp.asarray, anchored_priors(gt, dims))
    st0 = perturb(gt, np.random.default_rng(5))
    if estimate_extrinsic:
        st0 = st0._replace(tic=st0.tic + 0.005)
    G, psi = jnp.asarray(world.gravity), jnp.asarray(cfg.noise.pixel_sqrt_info)
    args_j = (st0, imu_f, proj_f, pr, G, psi)
    args_t = [_port(a) for a in args_j]
    dj, dt_ = js.WindowDims(*dims), ts.WindowDims(*dims)
    ne_j = js.build_normal_equations(*args_j, dj, estimate_extrinsic)
    ne_t = ts.build_normal_equations(*args_t, dt_, estimate_extrinsic)
    for a, b in zip(ne_t, ne_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
    st_j, c_j = js.solve_window(*args_j, dj, iters=8, estimate_extrinsic=estimate_extrinsic)
    st_t, c_t = ts.solve_window(*args_t, dt_, iters=8, estimate_extrinsic=estimate_extrinsic)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-8)
    for a, b in zip(to_numpy_tree(st_t), st_j):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(st_t.P.numpy(), np.asarray(gt.P), atol=5e-3)


def test_window_cost_and_retract():
    dims = ts.WindowDims(B=6, Vo=3, F=32, N=64)
    j_args, t_args = _batch_args(dims, np.float64, seed=2)
    np.testing.assert_allclose(float(ts.window_cost(*t_args, dims)),
                               float(js.window_cost(*j_args, js.WindowDims(*dims))), rtol=1e-12)
    rng = np.random.default_rng(0)
    dx, dl = rng.normal(size=dims.D) * 0.01, rng.normal(size=dims.F) * 0.01
    a = js.retract_state(j_args[0], jnp.asarray(dx), jnp.asarray(dl), js.WindowDims(*dims))
    b = ts.retract_state(t_args[0], torch.as_tensor(dx), torch.as_tensor(dl), dims)
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12, atol=1e-14)


def test_relpose_slot0_is_inert():
    """jax.nn.one_hot(-1) is a zero row: the k = 0 relative-pose slot must
    not reach frame B-1 in the port (an index of -1 would wrap)."""
    dims = ts.WindowDims(B=6, Vo=3, F=32, N=64)
    _, t_args = _batch_args(dims, np.float64)
    pr = t_args[3]
    pr = pr._replace(rel_valid=torch.ones_like(pr.rel_valid),
                     rel_sqrt=torch.eye(6, dtype=torch.float64).expand(3, 6, 6).clone())
    rows, _ = ts.window._eval_priors(t_args[0], pr, dims)
    J = rows[2][1].reshape(dims.Vo, 6, -1)
    B = dims.B
    assert float(J[0, :, 6 * (B - 1): 6 * B].abs().max()) == 0.0
    assert float(J[0, :, 0:6].abs().max()) > 0.0  # its j side (frame 0) is there


def _row(prob, k):
    """Sequence k of a port batch problem, as solve_window's arguments."""
    from isvins_tpu_torch.utils.convert import tree_map

    return [tree_map(lambda a: a[k].contiguous(), t) for t in prob[:4]] + list(prob[4:])


# (dtype, seed, sequence) of make_batch_problem at B 6, F 32, N 64 whose
# solve converges well inside 60 LM iterations (f64: 24; f32: 37, the one
# f32 sequence of seeds 0-3 that does)
CONVERGING = [(torch.float64, 4, 1), (torch.float32, 0, 3)]


@pytest.mark.parametrize("dt, seed, k", CONVERGING)
def test_iterations_after_convergence_keep_every_bit(dt, seed, k):
    """The LM loop runs all `iters` iterations with no host read (the
    reference exits its while_loop early): a converged solve is frozen by
    its masks, so solve_window(iters=60) gives the same bits as
    solve_window(iters=n), n the iterations it took, and info["iterations"]
    is n, a 0-d tensor on the solve's device, in both."""
    dims = ts.WindowDims(B=6, Vo=3, F=32, N=64)
    args = _row(make_batch_problem(4, dims, dt, seed=seed, device="cpu"), k)
    info = {}
    st, cost = ts.solve_window(*args, dims, iters=60, info=info)
    n = info["iterations"]
    assert isinstance(n, torch.Tensor) and n.dim() == 0 and n.device.type == "cpu"
    assert 0 < int(n) < 60
    info_n = {}
    st_n, cost_n = ts.solve_window(*args, dims, iters=int(n), info=info_n)
    assert int(info_n["iterations"]) == int(n)
    for name, a, b in zip(st._fields + ("cost",), (*st, cost), (*st_n, cost_n)):
        assert torch.equal(a, b), name


def test_batched_iterations_after_convergence_keep_every_bit():
    """Two sequences that converge at different iterations (24 and 35 of
    60, f64): the batched solve run for 60 iterations gives the same bits
    as run for the most either took; sequence_iterations holds each one's
    count, the same as its single solve's, and iterations their maximum."""
    dims = ts.WindowDims(B=6, Vo=3, F=32, N=64)
    prob = make_batch_problem(2, dims, torch.float64, seed=4, device="cpu")
    info = {}
    st, cost = ts.solve_window_batched(*prob, dims, iters=60, info=info)
    its = info["sequence_iterations"].tolist()
    assert len(set(its)) == 2 and max(its) < 60, its
    assert int(info["iterations"]) == max(its)
    for k in range(2):
        solo = {}
        ts.solve_window(*_row(prob, k), dims, iters=60, info=solo)
        assert int(solo["iterations"]) == its[k]
    st_n, cost_n = ts.solve_window_batched(*prob, dims, iters=max(its))
    for name, a, b in zip(st._fields + ("cost",), (*st, cost), (*st_n, cost_n)):
        assert torch.equal(a, b), name


def test_solve_window_wide_window_matches_reference():
    """all_size 21 (D = 321, past the shared-memory route of the card's
    Cholesky, ROADMAP C12) through the port's plain solve against the JAX
    package's, f64 at a narrow F: the same iterates to 1e-9, as at B = 10."""
    dims, iters = ts.WindowDims(B=21, Vo=8, F=32, N=128), 6
    j_args, t_args = _batch_args(dims, np.float64)
    st_j, c_j = js.solve_window(*j_args, js.WindowDims(*dims), iters=iters)
    st_t, c_t = ts.solve_window(*t_args, dims, iters=iters)
    assert dims.D == 321
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-9)
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)

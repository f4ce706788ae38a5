"""The blocked Cholesky routine that K4 and K5 share (csrc/chol.cuh), held on
the CPU through its decomposition. The kernel runs only on the card; its
layout is Python (ops/chol_batched.chol_plan), so a torch emulation that
follows the plan step by step (identity padding to Dp, per panel the
diagonal tile factored column by column and inverted, the panel multiplied
by that inverse, the lower trailing tiles updated; then forward and backward
substitution by tile rows with the stored inverses) is held here against
the plain versions and the Pallas kernels in interpret mode, with the
reference's tolerances (tests/test_pallas_ops.py:157-162, 176-184)."""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu_torch import ops
from isvins_tpu_torch.ops import chol_batched
from isvins_tpu_torch.ops._lib import SMEM_LIMIT
from isvins_tpu_torch.ops.chol_batched import chol_plan

T = torch.as_tensor


def emulate(H, b, plan):
    """x = H^-1 b (f32) as the kernel computes it in the layout of `plan`,
    and the column of the first pivot that is not > 0 (None if there is
    none; x is then all NaN). Returns (x, bad column, tiles visited)."""
    D, nb, Dp = H.shape[0], plan.nb, plan.Dp
    nt = Dp // nb
    A = torch.eye(Dp, dtype=torch.float32)
    A[:D, :D] = H
    tiles = {I * (I + 1) // 2 + J: A[I * nb:(I + 1) * nb, J * nb:(J + 1) * nb].clone()
             for I in range(nt) for J in range(I + 1)}
    t = lambda I, J: I * (I + 1) // 2 + J
    nan = torch.full((D,), float("nan"))
    for p in range(nt):
        L = tiles[t(p, p)]
        for j in range(nb):  # one warp, in registers
            d = L[j, j]
            if not d > 0:
                return nan, p * nb + j, len(tiles)
            L[j, j] = torch.sqrt(d)
            L[j + 1:, j] = L[j + 1:, j] / L[j, j]
            L[j + 1:, j + 1:] -= torch.outer(L[j + 1:, j], L[j + 1:, j])
        L = torch.tril(L)
        tiles[t(p, p)] = torch.linalg.solve_triangular(L, torch.eye(nb), upper=False)
        for i in range(p + 1, nt):  # the panel: L_ip = A_ip Linv^T
            tiles[t(i, p)] = tiles[t(i, p)] @ tiles[t(p, p)].T
        for i in range(p + 1, nt):  # lower trailing tiles only
            for j in range(p + 1, i + 1):
                tiles[t(i, j)] = tiles[t(i, j)] - tiles[t(i, p)] @ tiles[t(j, p)].T
    v = torch.zeros(Dp)
    v[:D] = b
    blk = lambda p: slice(p * nb, (p + 1) * nb)
    for p in range(nt):
        v[blk(p)] = tiles[t(p, p)] @ v[blk(p)]
        for i in range(p + 1, nt):
            v[blk(i)] -= tiles[t(i, p)] @ v[blk(p)]
    for p in reversed(range(nt)):
        v[blk(p)] = tiles[t(p, p)].T @ v[blk(p)]
        for i in range(p):
            v[blk(i)] -= tiles[t(p, i)].T @ v[blk(p)]
    assert bool((v[D:] == 0).all())  # identity padding keeps padded x at 0
    return v[:D], None, len(tiles)


def _spd(D, NB=2, seed=0):
    """NB SPD systems built as tests/test_pallas_ops.py:135-148 builds H."""
    rng = np.random.default_rng(seed + D)
    A = rng.normal(size=(NB, D, D + 60))
    H = A @ A.transpose(0, 2, 1) + 200 * np.eye(D)
    return H.astype(np.float32), rng.normal(size=(NB, D)).astype(np.float32)


@lru_cache(maxsize=None)
def _pallas_x(D):
    """chol_solve_batched_pallas in interpret mode, once per D."""
    from isvins_tpu.ops.linstep_pallas import chol_solve_batched_pallas

    H, b = _spd(D)
    return np.asarray(chol_solve_batched_pallas(jnp.asarray(H), jnp.asarray(b)))


# every D the repo configures: B = 4, 6, 8, 9, 10 (tests) and 18 (the EuRoC
# window, bench.py), D = 15 B + 6
CONFIGURED_D = [15 * B + 6 for B in (4, 6, 8, 9, 10, 18)]


@pytest.mark.parametrize("D", CONFIGURED_D)
def test_chol_plan_fits_every_configured_window(D):
    """The layout of every configured window fits one block's shared memory:
    Dp the first multiple of 16 at or above D, T (T + 1) / 2 tiles of 16 x 16
    floats, two Dp-vectors and 64 floats."""
    plan = chol_plan(D)
    assert plan.nb == chol_batched.CHOL_NB == 16
    assert plan.Dp % plan.nb == 0 and 0 <= plan.Dp - D < plan.nb
    nt = plan.Dp // plan.nb
    assert plan.tiles == nt * (nt + 1) // 2
    assert plan.smem_bytes == (plan.tiles * plan.nb ** 2 + 2 * plan.Dp + 64) * 4
    assert plan.smem_bytes <= SMEM_LIMIT
    assert chol_batched.checked_plan(D, "test") == plan


def test_chol_plan_at_the_product_window_and_the_limit():
    """D = 276 takes 18 x 18 tiles of 16 in 177,664 B of shared memory, and
    320 is the largest D whose tiles fit there (the shared route). From 321
    on the tiles live in a device-memory scratch of tiles x 256 floats per
    problem and shared memory holds the two vectors and 64 floats alone
    (the global route): 321, 366 and 486 are all_size 21, 24 and 32. The route raises only where even its vectors would not
    fit shared memory, naming the sizes."""
    assert chol_plan(276) == (16, 288, 171, 177664, 0) and chol_plan(276).route == "shared"
    assert chol_plan(320) == (16, 320, 210, 217856, 0) and chol_plan(320).route == "shared"
    assert chol_batched.chol_max_dim() == 320
    for D in (321, 366, 486):
        plan = chol_plan(D)
        nt = plan.Dp // plan.nb
        assert plan.route == "global" and plan.tiles == nt * (nt + 1) // 2
        assert plan.scratch_floats == plan.tiles * plan.nb ** 2
        assert plan.smem_bytes == (2 * plan.Dp + 64) * 4 <= SMEM_LIMIT
        assert chol_batched.checked_plan(D, "chol_solve_batched") == plan
    assert chol_plan(486).scratch_floats * 4 == 507904  # 0.5 MB a problem, L2-resident
    with pytest.raises(ValueError, match="shared memory for its vectors"):
        chol_batched.checked_plan(29025, "chol_solve_batched")


@pytest.mark.parametrize("D", [16, 17, 66, 141, 276, 320, 321, 366])
def test_blocked_emulation_vs_plain_and_pallas(D):
    """The emulation of the blocked routine against K5's plain version and
    chol_solve_batched_pallas (interpret): 2e-3 of the largest entry, rtol
    2e-3; it visits exactly the plan's tiles. D: one tile, one row more, the
    windows of B = 4, 9 (not a multiple of 16) and 18, the largest D of the
    shared route, and all_size 21 and 24 on the global route (the same
    routine, its tiles in device memory)."""
    H, b = _spd(D)
    plan = chol_plan(D)
    ref = ops.chol_solve_batched_ref(T(H), T(b)).numpy()
    out = []
    for n in range(len(H)):
        x, bad, visited = emulate(T(H[n]), T(b[n]), plan)
        assert bad is None and visited == plan.tiles
        out.append(x.numpy())
    out = np.stack(out)
    for r in (ref, _pallas_x(D)):
        np.testing.assert_allclose(out, r, atol=2e-3 * np.abs(r).max(), rtol=2e-3)


def _linstep_inputs(rng, B, F):
    """SPD construction of tests/test_pallas_ops.py:130-150."""
    n_pose, D = 6 * B, 15 * B + 6
    Dr = n_pose + 6
    A = rng.normal(size=(D, D + 60))
    H = A @ A.T + 200 * np.eye(D)
    W = rng.normal(size=(F, Dr)).astype(np.float32)
    h = (np.abs(rng.normal(size=F)) * 5 + 0.5).astype(np.float32)
    C = (W / h[:, None]).T @ W
    ex0 = D - 6
    H[:n_pose, :n_pose] += C[:n_pose, :n_pose]
    H[:n_pose, ex0:] += C[:n_pose, n_pose:]
    H[ex0:, :n_pose] += C[n_pose:, :n_pose]
    H[ex0:, ex0:] += C[n_pose:, n_pose:]
    return [H.astype(np.float32), rng.normal(size=D).astype(np.float32), W, h,
            rng.normal(size=F).astype(np.float32)], n_pose, D


def _k4_chain(H, b, W, h, b_l, lam, n_pose, plan):
    """K4's kernel as it runs: C, c_b at h_safe (K3), H_dd written into the
    tiles with the reduced-index insert, damping and jitter, the blocked
    routine, then dl."""
    D, Dr = H.shape[0], W.shape[1]
    ex0 = D - (Dr - n_pose)
    h_d = h * (1.0 + lam)
    h_safe = torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d))
    C, c_b = ops.schur_corr_ref(W, h_safe, b_l)
    red = torch.cat([torch.arange(n_pose), torch.arange(ex0, D)])
    H_dd, b_s = H.clone(), b.clone()
    H_dd[red[:, None], red[None, :]] -= C
    b_s[red] -= c_b
    d = torch.diagonal(H_dd)
    d += lam * torch.clamp(torch.diagonal(H), min=1e-8)
    d += 1e-12 * d.sum() / D
    dx, bad, _ = emulate(H_dd, b_s, plan)
    return dx, (b_l - W @ dx[red]) / h_safe, bad


@pytest.mark.parametrize("B,F", [(4, 50), (9, 200), (18, 1000)])
def test_blocked_linstep_vs_plain_and_pallas(B, F):
    """The K4 step through the emulated routine at D = 66, 141 and 276
    against linstep_ref and linstep_pallas (interpret): 2e-3 of the largest
    entry of dx and of dl, rtol 2e-3."""
    from isvins_tpu.ops.linstep_pallas import linstep_pallas

    rng = np.random.default_rng(B)
    args, n_pose, D = _linstep_inputs(rng, B, F)
    lam = np.float32(1e-3)
    dx, dl, bad = _k4_chain(*(T(a) for a in args), torch.tensor(lam), n_pose, chol_plan(D))
    assert bad is None
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(lam, jnp.float32)]
    for dxr, dlr in (ops.linstep_ref(*(T(a) for a in args), torch.tensor(lam), n_pose, D),
                     linstep_pallas(*jargs, n_pose)):
        dxr, dlr = np.asarray(dxr), np.asarray(dlr)
        np.testing.assert_allclose(dx.numpy(), dxr, atol=2e-3 * np.abs(dxr).max(), rtol=2e-3)
        np.testing.assert_allclose(dl.numpy(), dlr, atol=2e-3 * np.abs(dlr).max(), rtol=2e-3)


@pytest.mark.parametrize("col", [0, 100, 275])
def test_blocked_pivot_failure_is_a_nan_row(col):
    """A system whose pivot at column `col` is negative (the first column,
    one inside panel 6, the last) fails in the emulation at exactly that
    column: its row is NaN, as in the plain version, and the other problem
    of the batch gives the same x as without the bad one."""
    D = 276
    H, b = _spd(D, seed=7)
    good = [emulate(T(H[n]), T(b[n]), chol_plan(D))[0] for n in range(2)]
    H[1, col, col] = -1.0
    x0, bad0, _ = emulate(T(H[0]), T(b[0]), chol_plan(D))
    x1, bad1, _ = emulate(T(H[1]), T(b[1]), chol_plan(D))
    assert bad0 is None and torch.equal(x0, good[0])
    assert bad1 == col and bool(torch.isnan(x1).all())
    ref = ops.chol_solve_batched_ref(T(H), T(b))
    assert bool(torch.isnan(ref[1]).all()) and not bool(torch.isnan(ref[0]).any())
    # K4: the same column of H_dd made negative fails there; dx and dl are
    # NaN, as in linstep_ref
    args, n_pose, _ = _linstep_inputs(np.random.default_rng(0), 18, 50)
    args[0][col, col] = -1e6
    t = [T(a) for a in args] + [torch.tensor(1e-3)]
    dx, dl, bad = _k4_chain(*t, n_pose, chol_plan(D))
    assert bad == col and bool(torch.isnan(dx).all()) and bool(torch.isnan(dl).all())
    assert bool(torch.isnan(ops.linstep_ref(*t, n_pose, D)[0]).all())

"""The plain versions of kernels K1-K4 (isvins_tpu_torch.ops) against the
JAX Pallas functions run in interpret mode on the CPU and against the JAX
references, at the shapes and tolerances of tests/test_pallas_ops.py. The CUDA kernels
themselves are held against these plain versions on the card in
tests/test_torch_gpu.py. The decomposition of the Schur product kernels K3
and K7 (ops/schur.schur_plan: tiles, splits over F, copy width) is Python,
so it is held here: a blocked emulation that follows the plan against the
plain versions and the Pallas kernels."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu_torch import ops
from isvins_tpu_torch.solver.proj_fast import eval_proj_rows

T = lambda a: torch.as_tensor(np.array(a))


def _proj_inputs(rng, N=300, B=6):
    """tests/test_pallas_ops.py:90-109."""
    f32 = np.float32
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    P = rng.normal(size=(B, 3)) * 2.0
    idx_i = rng.integers(0, B, N)
    idx_j = rng.integers(0, B, N)
    pts_i = np.concatenate([rng.normal(size=(N, 2)) * 0.3, np.ones((N, 1))], 1)
    pts_j = np.concatenate([rng.normal(size=(N, 2)) * 0.3, np.ones((N, 1))], 1)
    qic = np.array([0.99, 0.05, -0.08, 0.03])
    qic /= np.linalg.norm(qic)
    return [pts_i.astype(f32), pts_j.astype(f32), P[idx_i].astype(f32), q[idx_i].astype(f32),
            P[idx_j].astype(f32), q[idx_j].astype(f32), np.array([0.02, -0.01, 0.015], f32),
            qic.astype(f32), (np.abs(rng.normal(size=N)) * 4.0 + 0.5).astype(f32),
            rng.random(N) > 0.15]


def test_proj_rows_plain_vs_pallas(rng):
    """K1 plain version vs proj_rows_pallas (interpret) and the JAX
    eval_proj_rows; rtol 3e-4, atol 1e-4 (test_pallas_ops.py:112-115)."""
    from isvins_tpu.ops.proj_pallas import proj_rows_pallas
    from isvins_tpu.solver.proj_fast import eval_proj_rows as j_eval

    args = _proj_inputs(rng)
    args[8][:5] = 0.0  # zero depths on valid rows: the sanitize path
    out = eval_proj_rows(*(T(a) for a in args))
    for ref in (proj_rows_pallas(*(jnp.asarray(a) for a in args)),
                j_eval(*(jnp.asarray(a) for a in args))):
        for o, r, name in zip(out, ref, ("r", "J_pi", "J_pj", "J_dep")):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=3e-4, atol=1e-4,
                                       err_msg=name)
    assert all(bool(torch.isfinite(o).all()) for o in out)


def _imu_inputs(seed=0, B=10):
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims

    state, imu, *_ = make_batch_problem(1, WindowDims(B, 4, 64, 256), torch.float32, seed=seed,
                                        device="cpu")
    rng = np.random.default_rng(seed)
    st = [getattr(state, k)[0] for k in ("P", "Q", "V", "Ba", "Bg")]
    st[3] = st[3] + T(rng.normal(size=(B, 3)).astype(np.float32) * 0.02)
    st[4] = st[4] + T(rng.normal(size=(B, 3)).astype(np.float32) * 0.002)
    pre = imu.pre
    return [a.contiguous() for a in (
        *(a[:-1] for a in st), *(a[1:] for a in st), pre.delta_p[0], pre.delta_q[0],
        pre.delta_v[0], pre.sum_dt[0], pre.ba[0], pre.bg[0], pre.jac[0],
        torch.tensor([0.0, 0.0, 9.81]))]


def test_imu_rows_plain_vs_pallas():
    """K2 plain version vs imu_rows_pallas (interpret) and the JAX
    `_imu_rows_ref`; atol 2e-6 * max, rtol 1e-5 (test_pallas_ops.py:209-214).
    Biases sit off the linearization point so the bias-correction blocks
    (incl. the small-angle exp/Jr branches) are exercised."""
    from isvins_tpu.ops.imu_pallas import _imu_rows_ref, imu_rows_pallas

    args = _imu_inputs()
    r, Jc = ops.imu_rows_ref(*args)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for rr, JJ in (imu_rows_pallas(*jargs), _imu_rows_ref(*jargs)):
        rr, JJ = np.asarray(rr), np.asarray(JJ)
        np.testing.assert_allclose(r.numpy(), rr, atol=2e-6 * np.abs(rr).max(), rtol=1e-5)
        np.testing.assert_allclose(Jc.numpy(), JJ, atol=2e-6 * np.abs(JJ).max(), rtol=1e-5)


def test_schur_corr_plain_vs_pallas(rng):
    """K3 plain version; rtol 2e-5, atol 2e-3 (test_pallas_ops.py:46-47)."""
    from isvins_tpu.ops.schur_pallas import schur_corr_pallas, schur_corr_ref

    F, Dr = 256, 66
    W = rng.normal(size=(F, Dr)).astype(np.float32)
    h = np.abs(rng.normal(size=F)).astype(np.float32) + 0.1
    bl = rng.normal(size=F).astype(np.float32)
    C, cb = ops.schur_corr_ref(T(W), T(h), T(bl))
    for Cr, cbr in (schur_corr_pallas(W, h, bl), schur_corr_ref(W, h, bl)):
        np.testing.assert_allclose(C.numpy(), np.asarray(Cr), rtol=2e-5, atol=2e-3)
        np.testing.assert_allclose(cb.numpy(), np.asarray(cbr), rtol=2e-5, atol=2e-3)


def _linstep_inputs(rng, B=18, F=1000):
    """SPD construction of tests/test_pallas_ops.py:130-150 (D=276)."""
    n_pose, D = 6 * B, 15 * B + 6
    Dr = n_pose + 6
    A = rng.normal(size=(D, D + 60))
    H0 = A @ A.T + 200 * np.eye(D)
    W = rng.normal(size=(F, Dr)).astype(np.float32)
    h = (np.abs(rng.normal(size=F)) * 5 + 0.5).astype(np.float32)
    C = (W / h[:, None]).T @ W
    ex0 = D - 6
    H = H0.copy()
    H[:n_pose, :n_pose] += C[:n_pose, :n_pose]
    H[:n_pose, ex0:] += C[:n_pose, n_pose:]
    H[ex0:, :n_pose] += C[n_pose:, :n_pose]
    H[ex0:, ex0:] += C[n_pose:, n_pose:]
    return [H.astype(np.float32), rng.normal(size=D).astype(np.float32), W, h,
            rng.normal(size=F).astype(np.float32)], n_pose, D


def test_linstep_plain_vs_pallas(rng):
    """K4 plain version at D=276, F=1000 vs linstep_pallas (interpret) and
    the JAX linstep_ref; 2e-3 * max|dx|, 2e-3 * max|dl|, rtol 2e-3
    (test_pallas_ops.py:157-162)."""
    from isvins_tpu.ops.linstep_pallas import linstep_pallas, linstep_ref

    args, n_pose, D = _linstep_inputs(rng)
    lam = np.float32(1e-3)
    dx, dl = ops.linstep_ref(*(T(a) for a in args), torch.tensor(lam), n_pose, D)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(lam, jnp.float32)]
    for dxr, dlr in (linstep_pallas(*jargs, n_pose), linstep_ref(*jargs, n_pose, D)):
        dxr, dlr = np.asarray(dxr), np.asarray(dlr)
        np.testing.assert_allclose(dx.numpy(), dxr, atol=2e-3 * np.abs(dxr).max(), rtol=2e-3)
        np.testing.assert_allclose(dl.numpy(), dlr, atol=2e-3 * np.abs(dlr).max(), rtol=2e-3)


def test_linstep_not_spd_gives_nan(rng):
    """A non-SPD damped system yields NaN (jnp.linalg.cholesky semantics),
    so the LM accept test rejects the step."""
    args, n_pose, D = _linstep_inputs(rng, B=4, F=50)
    args[0] = -np.abs(args[0])
    dx, dl = ops.linstep_ref(*(T(a) for a in args), torch.tensor(1e-3), n_pose, D)
    assert bool(torch.isnan(dx).all()) and bool(torch.isnan(dl).all())


def test_wrappers_take_plain_version_on_cpu(rng):
    """On CPU tensors every wrapper returns its plain version and launches
    nothing."""
    ops.reset_launch_counts()
    p = [T(a) for a in _proj_inputs(rng, N=40)]
    for a, b in zip(ops.proj_rows(*p), eval_proj_rows(*p)):
        assert torch.equal(a, b)
    i = _imu_inputs(B=6)
    for a, b in zip(ops.imu_rows(*i), ops.imu_rows_ref(*i)):
        assert torch.equal(a, b)
    args, n_pose, D = _linstep_inputs(rng, B=4, F=50)
    t = [T(a) for a in args] + [torch.tensor(1e-2)]
    for a, b in zip(ops.linstep(*t, n_pose), ops.linstep_ref(*t, n_pose, D)):
        assert torch.equal(a, b)
    for a, b in zip(ops.schur_corr(*t[2:5]), ops.schur_corr_ref(*t[2:5])):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


# (F, n, extra column): the product shapes of K3 and K7, the small windows of
# the tests, shapes below a tile, a chunk and the split count, an odd n
SCHUR_PLAN_CASES = [(1000, 114, True), (1000, 276, False), (256, 66, True), (50, 30, True),
                    (3, 7, True), (1, 1, False), (37, 276, False)]


def _follow_plan(plan, W, r, b_l):
    """The Schur tile routine's decomposition (csrc/schur_tile.cuh) in torch
    on the CPU: tiles on or below the diagonal, each the rank-ordered sum of
    its splits' partial products with the second operand scaled by r = 1/h,
    mirrored by the epilogue; the extra column from tiles of its own.
    Returns (C, c_b or None, how often each entry of C and c_b was written)."""
    F, n = W.shape
    T = plan.tile
    C, c_b = torch.full((n, n), float("nan")), torch.full((n,), float("nan"))
    hits, hits_b = torch.zeros((n, n), dtype=torch.int64), torch.zeros(n, dtype=torch.int64)
    assert plan.grid == plan.n_tiles * plan.splits
    for t in range(plan.n_tiles):
        ti, tj = plan.tile_at(t)
        a = slice(ti * T, min((ti + 1) * T, n))
        acc = None
        for rank in range(plan.splits):
            lo, hi = plan.rows(rank, F)
            X = b_l[lo:hi, None] if tj is None else W[lo:hi, tj * T:min((tj + 1) * T, n)]
            part = W[lo:hi, a].T @ (X * r[lo:hi, None])
            acc = part if acc is None else acc + part
        if tj is None:
            c_b[a] = acc[:, 0]
            hits_b[a] += 1
            continue
        rows = torch.arange(a.start, a.stop)[:, None]
        cols = torch.arange(tj * T, tj * T + acc.shape[1])[None, :]
        keep = cols <= rows  # the epilogue writes (a, b) for b <= a and mirrors it
        ia, ib = (rows + 0 * cols)[keep], (cols + 0 * rows)[keep]
        C[ia, ib] = acc[keep]
        hits[ia, ib] += 1
        off = ia != ib
        C[ib[off], ia[off]] = acc[keep][off]
        hits[ib[off], ia[off]] += 1
    return C, (c_b if plan.n_tiles > plan.n_row_tiles * (plan.n_row_tiles + 1) // 2 else None), \
        hits, hits_b


@pytest.mark.parametrize("F,n,extra", SCHUR_PLAN_CASES)
def test_schur_plan_covers_every_entry_once(F, n, extra):
    """Every entry of the n x n product, and of the extra column where there
    is one, is written exactly once; every row of F belongs to exactly one
    split; the launch is what the kernel can run."""
    from isvins_tpu_torch.ops.schur import MAX_SPLITS, schur_plan

    plan = schur_plan(F, n, extra)
    assert plan.tile in (32, 64) and plan.n_row_tiles == -(-n // plan.tile)
    assert 1 <= plan.splits <= MAX_SPLITS and plan.splits & (plan.splits - 1) == 0
    assert plan.splits <= F  # no split without rows
    assert plan.copy_bytes in (4, 8, 16) and (n * 4) % plan.copy_bytes == 0
    spans = [plan.rows(r, F) for r in range(plan.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == F
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:] + [(F, F)]))
    W = torch.ones((F, n))
    _, c_b, hits, hits_b = _follow_plan(plan, W, torch.ones(F), torch.ones(F))
    assert bool((hits == 1).all())
    assert (c_b is not None) == extra and bool((hits_b == (1 if extra else 0)).all())


@pytest.mark.parametrize("n,align,width", [(114, 16, 8), (276, 16, 16), (7, 16, 4), (276, 8, 8),
                                           (276, 4, 4), (114, 4, 4)])
def test_schur_plan_copy_width(n, align, width):
    """A copy is as wide as the rows of W (n * 4 bytes apart) and W's own
    alignment allow: 456-byte rows at n = 114 take 8 bytes, n = 276 takes 16,
    an odd n 4; a W that starts off a 16-byte boundary takes less."""
    from isvins_tpu_torch.ops.schur import _alignment, schur_plan

    assert schur_plan(1000, n, True, align).copy_bytes == width
    buf = torch.zeros(64)
    base = _alignment(buf)
    assert base == 16 and _alignment(buf[1:]) == 4 and _alignment(buf[2:]) == 8


@pytest.mark.parametrize("F,n,extra", SCHUR_PLAN_CASES)
def test_schur_plan_emulation_vs_plain_and_pallas(F, n, extra):
    """The blocked emulation that follows the plan (lower tiles mirrored,
    splits summed in rank order, r = 1/h multiplied in) against
    schur_corr_ref / schur_reduce_ref and the JAX schur_corr_pallas /
    schur_reduce_pallas (interpret mode), with one empty landmark under the
    guard and with lam given; rtol 2e-5, atol 2e-3 (test_pallas_ops.py:46-47,
    68-81). The emulated C is exactly symmetric."""
    from isvins_tpu.ops.schur_pallas import schur_corr_pallas, schur_reduce_pallas
    from isvins_tpu_torch.ops.schur import schur_plan

    rng = np.random.default_rng(100 * F + n)
    W = rng.normal(size=(F, n)).astype(np.float32)
    h = (np.abs(rng.normal(size=F)) + 0.1).astype(np.float32)
    h[F // 2] = 0.0  # an empty landmark
    bl = rng.normal(size=F).astype(np.float32)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H, b = A + A.T, rng.normal(size=n).astype(np.float32)
    lam = np.float32(1e-3)
    # K3 as K4 launches it: h damped by lam, then guarded (schur_tile.cuh)
    h_d = h * (np.float32(1.0) + lam)
    h_safe = np.where(h_d > 1e-12, h_d, np.float32(1.0)).astype(np.float32)
    plan = schur_plan(F, n, extra)
    C, c_b, _, _ = _follow_plan(plan, T(W), 1.0 / T(h_safe), T(bl))
    assert torch.equal(C, C.T)
    close = lambda x, y: np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                                    rtol=2e-5, atol=2e-3)
    for Cr, cbr in (ops.schur_corr_ref(T(W), T(h_safe), T(bl)),
                    schur_corr_pallas(W, h_safe, bl)):
        close(C, Cr)
        if extra:
            close(c_b, cbr)
    # K7: the guard without lam; the epilogue subtracts from H and b
    g = np.where(h > 1e-12, h, np.float32(1.0)).astype(np.float32)
    C7, cb7, _, _ = _follow_plan(plan, T(W), 1.0 / T(g), T(bl))
    for Hr, br in (ops.schur_reduce_ref(T(H), T(b), T(W), T(h), T(bl)),
                   schur_reduce_pallas(*(jnp.asarray(a) for a in (H, b, W, h, bl)))):
        close(T(H) - C7, Hr)
        if extra:
            close(T(b) - cb7, br)

"""The CUDA kernels K1-K7 of isvins_tpu_torch on the card, held
against their plain PyTorch versions on the same card inputs at the product
shapes.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Each test decides inside itself whether a card is present and skips with a
reason when there is none (deciding at import time would let xdist workers
collect different tests)."""

import numpy as np
import pytest
import torch

from isvins_tpu_torch import ops
from isvins_tpu_torch.utils import perf

D = 276  # 15 B + 6 at the product window B = 18

# (kernel, plain version, rtol, atol(ref)): the tolerances of the reference's
# own kernel tests (tests/test_pallas_ops.py)
CASES = {
    "proj_rows": (ops.proj_rows, ops.proj_rows_ref, 3e-4, lambda r: 1e-4),
    "imu_rows": (ops.imu_rows, ops.imu_rows_ref, 1e-5, lambda r: 2e-6 * float(r.abs().max())),
    "schur_corr": (ops.schur_corr, ops.schur_corr_ref, 2e-5, lambda r: 2e-3),
    "linstep": (ops.linstep, lambda *a: ops.linstep_ref(*a, D), 2e-3,
                lambda r: 2e-3 * float(r.abs().max())),
    "schur_reduce": (ops.schur_reduce, ops.schur_reduce_ref, 2e-5, lambda r: 2e-3),
}


def _k6_inputs(dev, K):
    """The first K keyframes of the seeded retrieval problem (planted
    duplicates of the query at keyframes 3 and 17), R = 64, thresh = 40."""
    from isvins_tpu_torch.utils.synthetic import make_retrieval_db

    qd, qv, dbd, dbv = make_retrieval_db(max(K, 18))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t(qd.view(np.int32)), t(qv), t(dbd[:K].view(np.int32)), t(dbv[:K]), 40


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py)")
    from isvins_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name):
    """One launch of the kernel, counted once, equal to its plain version
    within the reference's tolerance."""
    dev = _card()
    import chip_smoke

    inp = chip_smoke.kernel_inputs(dev)[name]
    kern, plain, rtol, atol = CASES[name]
    before = ops.KERNELS[name].launches
    out = kern(*inp)
    torch.cuda.synchronize()
    assert ops.KERNELS[name].launches == before + 1
    for o, r in zip(out, plain(*inp)):
        torch.testing.assert_close(o, r, rtol=rtol, atol=atol(r))


@pytest.mark.gpu
def test_wrappers_raise_on_bad_cuda_input():
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    dev = _card()
    x = torch.zeros((8, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):  # f64
        ops.proj_rows(x, x, x, x[:, :3], x, x, x[0], x[0], x[:, 0], x[:, 0] > 0)
    W = torch.zeros((4, 50), dtype=torch.float32, device=dev).T  # not contiguous
    h = torch.ones(50, dtype=torch.float32, device=dev)
    before = ops.schur_corr.launches
    with pytest.raises(ValueError):
        ops.schur_corr(W, h, h)
    with pytest.raises(ValueError):  # wrong shape
        ops.schur_corr(W.contiguous(), h[:10], h)
    assert ops.schur_corr.launches == before


# (F, n): the product shapes of K3 and K7, the small windows' widths, shapes
# below a tile, a chunk of rows and the split count, an odd n (4-byte copies)
SCHUR_SHAPES = [(1000, 114), (1000, 276), (256, 66), (50, 30), (3, 7), (1, 1), (37, 276)]


@pytest.mark.gpu
@pytest.mark.parametrize("F,n", SCHUR_SHAPES)
def test_schur_kernels_shapes_repeat_and_symmetry_on_card(F, n):
    """K3 (as called alone and, with lam, as K4 launches it) and K7 against
    their plain versions (rtol 2e-5, atol 2e-3) with one empty landmark where
    the guard applies; two runs give the same bits; C and, for a symmetric
    H, H_s equal their transposes exactly; a W that starts off a 16-byte
    boundary (narrower copies) gives the same bits."""
    dev = _card()
    from isvins_tpu_torch.ops import schur

    rng = np.random.default_rng(1000 * F + n)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    W, b_l = f32(rng.normal(size=(F, n))), f32(rng.normal(size=F))
    h = f32(np.abs(rng.normal(size=F)) + 0.1)
    h0 = h.clone()
    h0[F // 2] = 0.0
    A = rng.normal(size=(n, n))
    H, b = f32(A + A.T), f32(rng.normal(size=n))
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    h_d = h0 * (1.0 + lam)
    shifted = torch.empty(F * n + 1, dtype=torch.float32, device=dev)[1:].view(F, n)
    shifted.copy_(W)
    assert schur._alignment(shifted) == 4
    runs = [
        (lambda w=W: ops.schur_corr(w, h, b_l), ops.schur_corr_ref(W, h, b_l)),
        (lambda w=W: schur._launch(w, h0, b_l, lam),
         ops.schur_corr_ref(W, torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d)), b_l)),
        (lambda w=W: ops.schur_reduce(H, b, w, h0, b_l), ops.schur_reduce_ref(H, b, W, h0, b_l)),
    ]
    for run, ref in runs:
        before = ops.schur_corr.launches + ops.schur_reduce.launches
        out, again, off = run(), run(), run(shifted)
        torch.cuda.synchronize()
        assert ops.schur_corr.launches + ops.schur_reduce.launches == before + 3
        for o, r, o2, o3 in zip(out, ref, again, off):
            torch.testing.assert_close(o, r, rtol=2e-5, atol=2e-3)
            assert torch.equal(o, o2) and torch.equal(o, o3)
        assert torch.equal(out[0], out[0].T)


@pytest.mark.gpu
@pytest.mark.parametrize("B,F", [(4, 50), (9, 200), (18, 1000)])
def test_linstep_step_on_card(B, F):
    """The K4 step (K3 with lam, then the blocked factorization) at D = 66,
    141 (not a multiple of the tile) and the product window's 276: within
    2e-3 of the largest entry, rtol 2e-3 (tests/test_pallas_ops.py:157-162),
    SPD inputs built as there (chip_smoke.small_linstep_inputs); two runs
    give the same bits; a pivot that is not > 0 at the first column, inside
    the sixth panel or at the last makes dx and dl all NaN."""
    dev = _card()
    import chip_smoke

    args = chip_smoke.small_linstep_inputs(dev, B, F)
    D = 15 * B + 6
    before = ops.linstep.launches, ops.schur_corr.launches
    out = ops.linstep(*args)
    torch.cuda.synchronize()
    assert (ops.linstep.launches, ops.schur_corr.launches) == (before[0] + 1, before[1] + 1)
    for o, r in zip(out, ops.linstep_ref(*args, D)):
        torch.testing.assert_close(o, r, rtol=2e-3, atol=2e-3 * float(r.abs().max()))
    assert all(torch.equal(o, o2) for o, o2 in zip(out, ops.linstep(*args)))
    for col in (0, min(100, D - 1), D - 1):
        Hb = args[0].clone()
        Hb[col, col] = -1e6
        dx, dl = ops.linstep(Hb, *args[1:])
        torch.cuda.synchronize()
        assert bool(torch.isnan(dx).all()) and bool(torch.isnan(dl).all()), col


@pytest.mark.gpu
def test_solve_window_on_card_runs_through_kernels():
    """An f32 window solve on the card launches K1/K2 once per evaluation
    and K3/K4 once per LM iteration, all 10 of them (those after
    convergence too: the loop reads nothing on the host), and reaches the
    cost of the plain solve on the CPU within 1e-3 relative (different
    summation orders in an f32 LM that is not converged after 10
    iterations)."""
    dev = _card()
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window

    dims = WindowDims(10, 4, 128, 512)

    def args(device):
        prob = make_batch_problem(1, dims, torch.float32, device=device)
        squeeze = lambda t: (type(t)(*(squeeze(x) for x in t)) if isinstance(t, tuple)
                             else t[0].contiguous())
        return [squeeze(x) for x in prob[:4]] + list(prob[4:])

    ops.reset_launch_counts()
    info = {}
    st, cost = solve_window(*args(dev), dims, iters=10, info=info)
    torch.cuda.synchronize()
    it = 10
    assert 0 < int(info["iterations"]) <= it and info["iterations"].device == dev
    assert ops.launch_counts() == {"proj_rows": it + 1, "imu_rows": it + 1,
                                   "schur_corr": it, "linstep": it, "chol_solve_batched": 0,
                                   "retrieval_scores": 0, "schur_reduce": 0}
    assert all(bool(torch.isfinite(a).all()) for a in st)
    _, cost_cpu = solve_window(*args("cpu"), dims, iters=10)
    assert abs(float(cost) - float(cost_cpu)) <= 1e-3 * float(cost_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 2, 23, 64, 129, 256, 4096])
def test_retrieval_scores_exact_on_card(K):
    """K6 at R = 64, thresh = 40, at the pose-graph path's first and largest
    database (K = 1, 23), two keyframes, 64 and 129, the slice's capacity
    and the default one: one launch, counted once, exactly equal to its
    plain version (integer work on the int8 tensor cores up to one IEEE
    division); and exact on every case of make_retrieval_cases (thresholds
    0, 33, 40, 109, 257 and 600, invalid database rows and keyframes, every
    query row invalid)."""
    dev = _card()
    from isvins_tpu_torch.utils.synthetic import make_retrieval_cases

    args = _k6_inputs(dev, K)
    before = ops.retrieval_scores.launches
    out = ops.retrieval_scores(*args)
    torch.cuda.synchronize()
    assert ops.retrieval_scores.launches == before + 1
    ref = ops.retrieval_scores_ref(*args)
    assert out.dtype == torch.float32 and out.shape == (K,)
    assert torch.equal(out, ref)
    if K >= 18:
        assert float(ref[3]) > 0.9 and float(ref[9]) == 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    for name, (qd, qv, dbd, dbv), thresh in make_retrieval_cases(K):
        a = (t(qd.view(np.int32)), t(qv), t(dbd.view(np.int32)), t(dbv), thresh)
        assert torch.equal(ops.retrieval_scores(*a), ops.retrieval_scores_ref(*a)), (name, thresh)


@pytest.mark.gpu
def test_retrieval_scores_raises_on_bad_cuda_input():
    """Descriptor words must be int32 (uint32 and int64 raise), masks bool,
    the database contiguous with R = 64 descriptors per keyframe; nothing
    falls back to the plain version."""
    dev = _card()
    qd, qv, dbd, dbv, thresh = _k6_inputs(dev, 32)
    before = ops.retrieval_scores.launches
    with pytest.raises(TypeError):
        ops.retrieval_scores(qd.view(torch.uint32), qv, dbd, dbv, thresh)
    with pytest.raises(TypeError):
        ops.retrieval_scores(qd, qv, dbd.to(torch.int64), dbv, thresh)
    with pytest.raises(TypeError):
        ops.retrieval_scores(qd, qv.to(torch.uint8), dbd, dbv, thresh)
    with pytest.raises(ValueError):  # a strided view of a wider database
        wide = torch.zeros((32, 64, 16), dtype=torch.int32, device=dev)
        ops.retrieval_scores(qd, qv, wide[:, :, :8], dbv, thresh)
    with pytest.raises(ValueError):
        ops.retrieval_scores(qd, qv, dbd.transpose(0, 1), dbv.T, thresh)
    with pytest.raises(ValueError):  # R = 32: the kernel's block is 64 descriptors
        ops.retrieval_scores(qd[:32], qv[:32], dbd[:, :32].contiguous(),
                             dbv[:, :32].contiguous(), thresh)
    assert ops.retrieval_scores.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("NB", [1, 4, 8, 16, 32])
def test_chol_solve_batched_on_card(NB):
    """K5 at D = 276: one launch for the whole batch, counted once, equal to
    its plain version within the batched step's bound of the reference
    (tests/test_pallas_ops.py:176-184: 2e-3 of the largest entry, rtol
    2e-3); two runs give the same bits; a system whose pivot is not > 0 at
    column 0, 100 or D - 1 gives a NaN row and leaves the others' bits."""
    dev = _card()
    import chip_smoke

    H, b = chip_smoke.chol_inputs(dev, NB)
    before = ops.chol_solve_batched.launches
    x = ops.chol_solve_batched(H, b)
    torch.cuda.synchronize()
    assert ops.chol_solve_batched.launches == before + 1
    ref = ops.chol_solve_batched_ref(H, b)
    assert x.shape == (NB, D)
    torch.testing.assert_close(x, ref, rtol=2e-3, atol=2e-3 * float(ref.abs().max()))
    assert torch.equal(ops.chol_solve_batched(H, b), x)
    for col in (0, 100, D - 1):
        Hb = H.clone()
        Hb[NB - 1, col, col] = -1.0
        bad = ops.chol_solve_batched(Hb, b)
        torch.cuda.synchronize()
        assert bool(torch.isnan(bad[NB - 1]).all()), col
        assert torch.equal(bad[: NB - 1], x[: NB - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [66, 141])
def test_chol_solve_batched_small_windows_on_card(D):
    """K5 at the small windows' widths (B = 4 and 9; 141 is not a multiple
    of the tile), four systems, against its plain version (2e-3 of the
    largest entry, rtol 2e-3), bit for bit on a second run."""
    dev = _card()
    import chip_smoke

    H, b = chip_smoke.chol_inputs(dev, 4, D=D)
    x = ops.chol_solve_batched(H, b)
    ref = ops.chol_solve_batched_ref(H, b)
    torch.testing.assert_close(x, ref, rtol=2e-3, atol=2e-3 * float(ref.abs().max()))
    assert torch.equal(ops.chol_solve_batched(H, b), x)


@pytest.mark.gpu
def test_chol_plan_matches_the_kernels_geometry():
    """ops.chol_plan and the C++ chol_plan of csrc/chol.cuh give the same
    (nb, Dp, tiles, smem_bytes, scratch_floats) for the widths the repo
    runs, the last of the shared route (320) and the global route's
    all_size 21, 24 and 32 (321, 366, 486)."""
    dev = _card()
    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.ops.chol_batched import chol_max_dim, chol_plan

    for D in (1, 66, 141, 276, 320, chol_max_dim() + 1, 321, 366, 486):
        out = torch.zeros(5, dtype=torch.int32)
        _lib.launch("isv_chol_plan", D, out, device=dev)
        assert tuple(out.tolist()) == tuple(chol_plan(D)), D
    routes = [chol_plan(D).route for D in (276, 320, 321, 366, 486)]
    assert routes == ["shared"] * 2 + ["global"] * 3


@pytest.mark.gpu
def test_chol_and_schur_reduce_raise_on_bad_cuda_input():
    """K5 and K7 take f32, contiguous tensors of matching shapes on one
    device; anything else raises and nothing is launched."""
    dev = _card()
    import chip_smoke

    H, b = chip_smoke.chol_inputs(dev, 2)
    before = ops.chol_solve_batched.launches, ops.schur_reduce.launches
    with pytest.raises(TypeError):
        ops.chol_solve_batched(H.double(), b.double())
    with pytest.raises(ValueError):  # not contiguous
        ops.chol_solve_batched(H.transpose(1, 2), b)
    with pytest.raises(ValueError):  # one problem without its batch axis
        ops.chol_solve_batched(H[0], b[0])
    with pytest.raises(ValueError):  # wrong right-hand side
        ops.chol_solve_batched(H, b[:, :-1].contiguous())
    with pytest.raises(ValueError):  # b on another device
        ops.chol_solve_batched(H, b.cpu())
    # past the global route too: the vectors would not fit shared memory
    with pytest.raises(ValueError, match="shared memory for its vectors"):
        ops.chol_solve_batched(torch.empty((1, 29025, 29025), device=dev),
                               torch.ones((1, 29025), device=dev))
    Hr, br, W, h, bl = chip_smoke.kernel_inputs(dev)["schur_reduce"]
    with pytest.raises(TypeError):
        ops.schur_reduce(Hr.double(), br, W, h, bl)
    with pytest.raises(ValueError):
        ops.schur_reduce(Hr, br, W.T, h, bl)
    with pytest.raises(ValueError):
        ops.schur_reduce(Hr, br, W, h[:10], bl)
    with pytest.raises(ValueError):
        ops.schur_reduce(Hr[:-1], br, W, h, bl)
    assert (ops.chol_solve_batched.launches, ops.schur_reduce.launches) == before


@pytest.mark.gpu
def test_solve_window_batched_on_card_runs_through_kernels():
    """An f32 batched solve on the card launches K1 and K2 once per
    evaluation and K5 once per LM iteration, all 10 of them, never K3 or K4,
    and in f64 its rows are the single solves (cost 1e-9 relative)."""
    dev = _card()
    from isvins_tpu_torch.parallel import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window, solve_window_batched
    from isvins_tpu_torch.utils.convert import tree_map

    dims = WindowDims(10, 4, 128, 512)
    prob = make_batch_problem(3, dims, torch.float32, device=dev)
    ops.reset_launch_counts()
    info = {}
    st, cost = solve_window_batched(*prob, dims, iters=10, info=info)
    torch.cuda.synchronize()
    it = 10  # every iteration runs
    assert info["sequence_iterations"].shape == (3,)
    assert ops.launch_counts() == {"proj_rows": it + 1, "imu_rows": it + 1, "schur_corr": 0,
                                   "linstep": 0, "chol_solve_batched": it,
                                   "retrieval_scores": 0, "schur_reduce": 0}
    assert all(bool(torch.isfinite(a).all()) for a in st) and tuple(cost.shape) == (3,)
    p64 = make_batch_problem(3, dims, torch.float64, device=dev)
    _, c64 = solve_window_batched(*p64, dims, iters=10)
    for k in range(3):
        row = [tree_map(lambda a: a[k].contiguous(), t) for t in p64[:4]]
        _, c = solve_window(*row, *p64[4:], dims, iters=10)
        assert abs(float(c64[k]) - float(c)) <= 1e-9 * float(c)


# K1 at (rows N, sequences S) and K2 at n factors: one row, the edges of a
# 32-row block, sequences that straddle blocks, the product window, the
# rows of 16 sequences; odd n (a block holds two factors)
ROWS_CASES = ([("proj_rows", N, S) for N, S in ((1, 1), (31, 1), (33, 3), (3072, 1),
                                                 (3072 * 16, 16))]
              + [("imu_rows", n, 1) for n in (1, 2, 17, 68, 272)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,S", ROWS_CASES)
def test_rows_kernels_ragged_sizes_on_card(name, n, S):
    """K1 and K2 at the ragged sizes (chip_smoke.proj_case: several
    sequences with their own tic/qic, masked rows with depth 0, points at
    the +-1e-6 z clamp; chip_smoke.imu_case: a masked factor, per-sequence
    gravity from 68 factors on): one launch, counted once, within the
    reference's tolerance of the plain version, finite, and the same bits
    on a second launch."""
    dev = _card()
    import chip_smoke

    if name == "proj_rows":
        args, plain = chip_smoke.proj_case(dev, n, S), ops.proj_rows_ref
    else:
        args, plain = chip_smoke.imu_case(dev, n), ops.imu_rows_ref
    kern, _, rtol, atol = CASES[name]
    before = ops.KERNELS[name].launches
    out = kern(*args)
    torch.cuda.synchronize()
    assert ops.KERNELS[name].launches == before + 1
    for o, r in zip(out, plain(*args)):
        torch.testing.assert_close(o, r, rtol=rtol, atol=atol(r))
        assert bool(torch.isfinite(o).all())
    assert all(torch.equal(o, o2) for o, o2 in zip(out, kern(*args)))


@pytest.mark.gpu
@pytest.mark.parametrize("NB", [0, 16])
def test_solves_repeat_bit_for_bit_on_card(NB):
    """Two runs of the same f32 solve of the product window (10 LM
    iterations; NB = 0: solve_window, else solve_window_batched of NB
    windows) give the same bits in every state leaf and the cost: the
    normal equations' segment sums add in a fixed order."""
    dev = _card()
    from isvins_tpu_torch.parallel import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window, solve_window_batched
    from isvins_tpu_torch.utils.convert import tree_map

    dims = WindowDims(18, 8, 1000, 3072)
    prob = make_batch_problem(max(NB, 1), dims, torch.float32, device=dev)
    if NB:
        run = lambda: solve_window_batched(*prob, dims, iters=10)
    else:
        args = [tree_map(lambda a: a[0].contiguous(), t) for t in prob[:4]] + list(prob[4:])
        run = lambda: solve_window(*args, dims, iters=10)
    (st, cost), (st2, cost2) = run(), run()
    assert all(torch.equal(a, b) for a, b in zip((*st, cost), (*st2, cost2)))


@pytest.mark.gpu
def test_segment_sum_on_card_without_host_read():
    """normal_plans and segment_sum on the card read nothing back to the
    host (a sync raises under the debug mode), equal index_add_ to rounding,
    and give the bits of the same sums on the CPU (each slot's rows added
    in row order on both)."""
    dev = _card()
    from isvins_tpu_torch.solver.window import (ProjFactors, WindowDims, normal_plans,
                                                segment_sum)

    rng = np.random.default_rng(5)
    dims = WindowDims(18, 8, 1000, 3072)
    idx_i = rng.integers(0, 18, (2, 3072))
    idx_j = (idx_i + rng.integers(1, 18, (2, 3072))) % 18
    fidx = rng.integers(0, 1000, (2, 3072))
    src = rng.normal(size=(2 * 2 * 3072, 36)).astype(np.float32)

    def sums(device):
        t = lambda a: torch.as_tensor(a, device=device)
        proj = ProjFactors(t(idx_i), t(idx_j), t(fidx), None, None, None)
        rows = t(src)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if device != "cpu" else "default")
        try:
            out = segment_sum(normal_plans(proj, dims).frames, rows)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out.cpu()

    card, cpu = sums(dev), sums("cpu")
    assert torch.equal(card, cpu)
    keys = np.concatenate([(np.arange(2)[:, None] * 18 + idx_i).ravel(),
                           (np.arange(2)[:, None] * 18 + idx_j).ravel()])
    ref = torch.zeros((36, 36)).index_add_(0, torch.as_tensor(keys), torch.as_tensor(src))
    torch.testing.assert_close(card, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [21, 24, 32])
def test_linstep_and_chol_wide_windows_on_card(B):
    """K4 and K5 past the shared-memory route: D = 321, 366 and 486
    (all_size 21, 24 and 32), the tiles in a device-memory scratch. Each is
    launched once, counted once, and equal to its plain version within 2e-3
    of the largest entry, rtol 2e-3 (tests/test_pallas_ops.py:157-162 and
    176-184); a second run gives the same bits; a pivot that is not > 0 at
    the last column gives a NaN row in K5 and leaves the others' bits."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.ops.chol_batched import chol_plan

    D = 15 * B + 6
    assert chol_plan(D).route == "global"
    args = chip_smoke.small_linstep_inputs(dev, B, 1000)
    H, b = chip_smoke.chol_inputs(dev, 4, D=D)
    before = ops.linstep.launches, ops.chol_solve_batched.launches
    out = ops.linstep(*args)
    x = ops.chol_solve_batched(H, b)
    torch.cuda.synchronize()
    assert (ops.linstep.launches, ops.chol_solve_batched.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for o, r in zip(out, ops.linstep_ref(*args, D)):
        torch.testing.assert_close(o, r, rtol=2e-3, atol=2e-3 * float(r.abs().max()))
    ref = ops.chol_solve_batched_ref(H, b)
    torch.testing.assert_close(x, ref, rtol=2e-3, atol=2e-3 * float(ref.abs().max()))
    assert all(torch.equal(o, o2) for o, o2 in zip(out, ops.linstep(*args)))
    assert torch.equal(ops.chol_solve_batched(H, b), x)
    Hb = H.clone()
    Hb[3, D - 1, D - 1] = -1.0
    bad = ops.chol_solve_batched(Hb, b)
    torch.cuda.synchronize()
    assert bool(torch.isnan(bad[3]).all()) and torch.equal(bad[:3], x[:3])


@pytest.mark.gpu
def test_dispatch_steady_reads_nothing_on_the_host():
    """An estimator on the card (the window of test_torch_parallel's
    pipelined drive) driven to its steady state; then dispatch_steady of its
    window under torch.cuda.set_sync_debug_mode("error"), where any host
    read of the device raises (chip_smoke._dispatch_without_host_reads).
    The collected solve took between 1 and the iterations it ran."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.config import WindowConfig, euroc_config
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.solver import WindowDims
    from isvins_tpu_torch.utils.synthetic import make_world, project

    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    cfg = euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01), ric=tuple(map(tuple, R_bc)))
    world = make_world(n_frames=14, n_landmarks=240, seed=0)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(R_bc)
    est = Estimator(cfg, WindowDims(B=10, Vo=4, F=256, N=2048), device=dev)

    def gt_init(e):
        e.set_ground_truth_init(world.P, world.Q, world.V)
        e.f_manager.depth[:] = -1.0

    est._gt_init = gt_init
    try:
        for k in range(14):
            if k > 0:
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                    world.imu_gyrs[k - 1][s])
            pts, _, vis = project(world, k, tic, qic)
            est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
        assert est.solver_flag == NON_LINEAR and est.steady_solves > 0
        rec = chip_smoke._dispatch_without_host_reads(est, dev)
    finally:
        est.close()
    assert 0 < rec["dispatch_iterations"] <= cfg.solver.max_iterations
    assert rec["solve_stream_ms"] > 0


@pytest.mark.gpu
def test_converged_f32_solve_keeps_its_bits_on_card():
    """C8 on the card: an f32 solve runs all `iters` LM iterations, and those
    after convergence keep every bit. Of make_batch_problem's windows (B 6,
    F 32, N 64, seeds 0-3), every one whose single solve (K1-K4) converges
    inside 60 iterations gives the same state and cost for iters = 60 as
    for iters = n, the n it took (info["iterations"] in both); the same for
    the batched solve (K1, K2, K5) of each seed's windows that converge
    there, with sequence_iterations. At least one window of each kind
    converges."""
    dev = _card()
    from isvins_tpu_torch.parallel import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window, solve_window_batched
    from isvins_tpu_torch.utils.convert import tree_map

    dims, iters = WindowDims(B=6, Vo=3, F=32, N=64), 60
    same = lambda x, y: all(torch.equal(a, b) for a, b in zip((*x[0], x[1]), (*y[0], y[1])))
    sub = lambda prob, ks: [tree_map(lambda a: a[ks].contiguous(), t) for t in prob[:4]]
    single = batched = 0
    for seed in range(4):
        prob = make_batch_problem(4, dims, torch.float32, seed=seed, device=dev)
        for k in range(4):
            args = [tree_map(lambda a: a[k].contiguous(), t) for t in prob[:4]] + list(prob[4:])
            info, info_n = {}, {}
            out = solve_window(*args, dims, iters=iters, info=info)
            n = int(info["iterations"])
            if n < iters:
                single += 1
                assert same(out, solve_window(*args, dims, iters=n, info=info_n)), (seed, k)
                assert int(info_n["iterations"]) == n
        info = {}
        solve_window_batched(*prob, dims, iters=iters, info=info)
        ks = [k for k, n in enumerate(info["sequence_iterations"].tolist()) if n < iters]
        if ks:
            batched += len(ks)
            info, info_n = {}, {}
            out = solve_window_batched(*sub(prob, ks), *prob[4:], dims, iters=iters, info=info)
            n = int(info["iterations"])
            assert n < iters
            out_n = solve_window_batched(*sub(prob, ks), *prob[4:], dims, iters=n, info=info_n)
            assert same(out, out_n), (seed, ks)
            assert torch.equal(info_n["sequence_iterations"], info["sequence_iterations"])
    assert single > 0 and batched > 0, (single, batched)


@pytest.mark.gpu
def test_shi_tomasi_reads_nothing_on_the_host():
    """shi_tomasi_response (its Sobel taps made with device_const) on a
    CUDA image under torch.cuda.set_sync_debug_mode("error") raises nothing,
    and equals the CPU's response within 1e-4 of its largest entry."""
    dev = _card()
    from isvins_tpu_torch.frontend.image_ops import shi_tomasi_response

    img = torch.as_tensor(np.random.default_rng(0).uniform(0, 255, (480, 752)).astype(np.float32))
    ref = shi_tomasi_response(img)
    img_d = img.to(dev)
    shi_tomasi_response(img_d)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = shi_tomasi_response(img_d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


def _room_frames(n, W=320, H=240):
    """n frames of the port's RoomRenderer on a 320x240 f = 200 camera (the
    nuisance-free room of tests/test_adversarial.py's world), uint8."""
    from isvins_tpu_torch.config import CameraConfig
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

    cam = CameraConfig(width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    world = make_world(n_frames=n, frame_hz=10.0, imu_hz=200.0, n_landmarks=10, seed=3)
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    r = RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(R_bc))
    return cam, world, [np.clip(r.render(k)[0], 0, 255).astype(np.uint8) for k in range(n)]


def _tracker_cfg(fused_ransac=True):
    from isvins_tpu_torch.config import TrackerConfig

    return TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4, lk_win=21,
                         equalize=True, border=4, fused_ransac=fused_ransac)


@pytest.mark.gpu
def test_tracker_dispatch_reads_nothing_on_the_host():
    """FeatureTracker.dispatch of a steady frame, with the fused epipolar
    RANSAC on, under torch.cuda.set_sync_debug_mode("error"): the upload,
    the whole device step and the start of the download are enqueued
    without a host read; collect then returns the packet. Two steady
    frames: the second reuses the first's pinned staging buffers."""
    dev = _card()
    from isvins_tpu_torch.frontend import FeatureTracker

    cam, world, frames = _room_frames(5)
    tr = FeatureTracker(cam, _tracker_cfg(None), device=dev)
    assert tr.fused_ransac
    for k in range(3):
        tr.read_image(frames[k], world.frame_times[k])
    assert int(tr.valid.sum()) >= 15
    staged = {k: b.data_ptr() for k, b in tr._staging.items()}
    assert sorted(staged) == ["img", "packed", "samples", "slots"]
    perf.enable(True)  # the stream's timing events are recorded while perf is on
    try:
        for k in (3, 4):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = tr.dispatch(frames[k], world.frame_times[k])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out = tr.collect(pending)
            assert pending.stream_ms() > 0 and (out["track_cnt"] > 1).sum() >= 15
    finally:
        perf.enable(False)
        perf.reset()
    assert {k: b.data_ptr() for k, b in tr._staging.items()} == staged


@pytest.mark.gpu
def test_card_tracker_matches_cpu_tracker():
    """The tracker on the card against the same port on the CPU (both with
    the fused RANSAC) over 6 rendered 320x240 frames: ids equal in at least
    95 % of the packets' slots and a median position gap of matched ids of
    at most 0.05 px (chip_smoke.py's bounds for the pixels phase)."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.frontend import FeatureTracker

    cam, world, frames = _room_frames(6)
    card = FeatureTracker(cam, _tracker_cfg(), device=dev)
    cpu = FeatureTracker(cam, _tracker_cfg(), device="cpu")
    a = [card.read_image(f, t) for f, t in zip(frames, world.frame_times)]
    b = [cpu.read_image(f, t) for f, t in zip(frames, world.frame_times)]
    equal, gap_median, _ = chip_smoke._slot_agreement(a, b)
    assert equal >= 0.95 and gap_median <= 0.05, (equal, gap_median)
    assert sum(len(p["ids"]) for p in a) > 150


@pytest.mark.gpu
def test_self_init_on_card():
    """tests/test_estimator_e2e.py::test_e2e_self_init's drive on the card
    (26 frames, 700 landmarks, 0.3/460 pixel noise; B = 10, F = 256, N =
    2048), with no ground-truth hook: the estimator self-initializes and
    meets the reference test's bound, >= 8 poses, a yaw-aligned largest
    error < 0.25 m and no failure."""
    dev = _card()
    from isvins_tpu_torch.config import WindowConfig, euroc_config
    from isvins_tpu_torch.estimator.estimator import Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.solver import WindowDims
    from isvins_tpu_torch.utils.synthetic import make_world, project

    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    cfg = euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01), ric=tuple(map(tuple, R_bc)))
    world = make_world(n_frames=26, n_landmarks=700, seed=0)
    est = Estimator(cfg, WindowDims(B=10, Vo=4, F=256, N=2048), device=dev)
    rng = np.random.default_rng(100)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(R_bc)
    X, Y = [], []
    try:
        for k in range(26):
            if k > 0:
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                    world.imu_gyrs[k - 1][s])
            pts, _, vis = project(world, k, tic, qic, px_noise=0.3 / 460.0, rng=rng)
            est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
            if est.solver_flag == 2:
                X.append(est.latest_pose()[1].copy())
                Y.append(world.P[k])
    finally:
        est.close()
    assert len(X) >= 8, "self-initialization failed"
    # test_estimator_e2e.ate(align=True): yaw + translation least squares
    X, Y = np.array(X), np.array(Y)
    Xc, Yc = X - X.mean(0), Y - Y.mean(0)
    th = np.arctan2(np.sum(Xc[:, 0] * Yc[:, 1] - Xc[:, 1] * Yc[:, 0]),
                    np.sum(Xc[:, 0] * Yc[:, 0] + Xc[:, 1] * Yc[:, 1]))
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    emax = np.linalg.norm((R @ Xc.T).T + Y.mean(0) - Y, axis=1).max()
    assert emax < 0.25, emax
    assert est.failure_count == 0


def _system_drive(dev, pg_thread):
    """tests/test_torch_system.py's 16-frame 320x240 drive with the pose
    graph on, a 2.5 s gap before the last frame, through System on `dev`."""
    from isvins_tpu_torch.config import (CameraConfig, NoiseConfig, PoseGraphConfig,
                                         TrackerConfig, WindowConfig, euroc_config)
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.solver import WindowDims
    from isvins_tpu_torch.system import System
    from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cam = CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4, lk_win=21,
                              equalize=False, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=200.0),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.15, skip_recent=100,
                                  max_keyframes=64, max_kp_per_kf=128),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    n = 16
    world = make_world(n_frames=n, frame_hz=10.0, imu_hz=200.0, n_landmarks=500, seed=3)
    r = RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(np.array(R_bc)))
    sys_ = System(cfg, WindowDims(B=10, Vo=4, F=256, N=2048), pipeline=True,
                  pg_thread=pg_thread, device=dev)
    try:
        for k in range(n):
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            sys_.pub_image(world.frame_times[k] + (2.5 if k == n - 1 else 0.0), r.render(k)[0])
        sys_.flush()
    finally:
        sys_.close()
    return sys_


@pytest.mark.gpu
def test_system_pg_thread_matches_inline_on_card():
    """System on the card with the pose graph on its worker thread (a CUDA
    stream of its own) against the inline builder: the same keyframes, the
    same sequence break, the same loop_tum() and vio_tum() text (the card's
    f32 solve and keyframe step repeat bit for bit, so the thread changes
    only where the work runs)."""
    dev = _card()
    a, b = _system_drive(dev, False), _system_drive(dev, True)
    n = a.pgbuilder.db.n
    assert n == b.pgbuilder.db.n > 0 and len(a.vio_trajectory) > 0
    assert a.pgbuilder.sequence == b.pgbuilder.sequence == 2
    np.testing.assert_array_equal(a.pgbuilder.db.ts[:n], b.pgbuilder.db.ts[:n])
    assert a.loop_tum() == b.loop_tum()
    assert a.vio_tum() == b.vio_tum()


@pytest.mark.gpu
def test_e2e_async_matches_sync_on_card():
    """bench.py's e2e configuration on the card, cut to its first 40 frames
    (init near frame 19, about 20 steady frames): System(pipeline=True,
    pg_thread=True) with solve_async=True against solve_async=False on the
    same frames. The async solve runs on its own stream beside the
    tracker's and the pose-graph worker's; it is the same solve on the same
    inputs, so the pose timestamps are equal and the poses within 1e-9
    (tests/test_pipeline_mode.py's bound), with the same keyframes and
    loops."""
    from isvins_tpu_torch import bench
    from isvins_tpu_torch.system import System

    dev = _card()
    cfg, dims = bench.e2e_config()
    world, renderer = bench.e2e_world()
    frames = [renderer.render(k)[0] for k in range(40)]
    runs = []
    for solve_async in (True, False):
        sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True,
                      solve_async=solve_async, device=dev)
        try:
            runs.append((bench.drive_e2e(sys_, world, frames), sys_))
        finally:
            sys_.close()
    (a, sa), (b, sb) = runs
    ta, tb = a["trajectory"], b["trajectory"]
    assert [x[0] for x in ta] == [x[0] for x in tb] and len(ta) >= 15
    for (_, Pa, Qa), (_, Pb, Qb) in zip(ta, tb):
        np.testing.assert_allclose(Pa, Pb, rtol=0, atol=1e-9)
        np.testing.assert_allclose(Qa, Qb, rtol=0, atol=1e-9)
    n = sa.pgbuilder.db.n
    assert n == sb.pgbuilder.db.n > 0 and sa.pgbuilder.n_loops == sb.pgbuilder.n_loops
    np.testing.assert_array_equal(sa.pgbuilder.db.ts[:n], sb.pgbuilder.db.ts[:n])
    assert a["e2e_frames_processed"] == b["e2e_frames_processed"] == 40


@pytest.mark.gpu
def test_png_round_trip_feeds_the_card_tracker(tmp_path):
    """A rendered 752x480 frame through the port's PNG codec (the card's
    machine has no PIL): the decoded pixels equal the frame's, for the Up
    rows the encoder writes and for a file with all five row filters, and
    the decoded f32 image gives the card's tracker the same packet as the
    uint8 frame."""
    dev = _card()
    import struct
    import zlib

    from isvins_tpu_torch.config import TrackerConfig
    from isvins_tpu_torch.data import png
    from isvins_tpu_torch.frontend import FeatureTracker

    cam, world, frames = _room_frames(2, W=752, H=480)
    path = str(tmp_path / "f.png")
    png.write_png(path, frames[1])
    img = png.read_png(path)
    np.testing.assert_array_equal(img, frames[1])
    # Sub rows and Paeth rows, filtered here by the spec's forward filters
    x = frames[1].astype(np.int64)
    left = np.concatenate([np.zeros((480, 1), np.int64), x[:, :-1]], axis=1)
    up = np.concatenate([np.zeros((1, 752), np.int64), x[:-1]], axis=0)
    ul = np.concatenate([np.zeros((1, 752), np.int64), left[:-1]], axis=0)
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    types = np.arange(480) % 5
    pred = np.select([types[:, None] == t for t in (1, 2, 3, 4)],
                     [left, up, (left + up) // 2, paeth], 0)
    raw = np.concatenate([types[:, None], (x - pred) % 256], axis=1).astype(np.uint8)
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d)))
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 752, 480, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(data), frames[1])
    cfg = TrackerConfig(max_cnt=150, min_dist=25, freq=100, lk_levels=4, lk_win=21,
                        equalize=True, border=4)
    outs = []
    for second in (frames[1], img.astype(np.float32)):
        tr = FeatureTracker(cam, cfg, device=dev)
        tr.read_image(frames[0], world.frame_times[0])
        outs.append(tr.read_image(second, world.frame_times[1]))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dd_solve_on_card_matches_cpu_f64(dtype):
    """dd_pose_graph_solve on the card listed 4 times (one batched program)
    against the same solve in f64 on ["cpu"] * 4, on scaling_bench's problem
    at K = 64 (3 iterations, with covariance): in f64 at the reference
    tests' tolerances, in f32 within chip_smoke's f32 bounds (256 ulps of
    the largest coordinate, of 1.0 for quaternions; covariance 5 %)."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.parallel import dd_pose_graph_solve

    prob = chip_smoke.posegraph_problem(64, 64, 4)
    ref = dd_pose_graph_solve(["cpu"] * 4, *prob, iters=3, with_cov=True)
    args = prob if dtype == "float64" else chip_smoke._f32(prob)
    out = dd_pose_graph_solve([dev] * 4, *args, iters=3, with_cov=True)
    assert all(o.device == dev and o.dtype == getattr(torch, dtype) for o in out)
    bounds = (chip_smoke.F64_BOUNDS if dtype == "float64"
              else chip_smoke._f32_bounds(float(np.abs(ref[0].numpy()).max())))
    chip_smoke._pg_check(f"dd [card] * 4 {dtype} vs CPU f64", out, ref, bounds, {})


@pytest.mark.gpu
def test_router_dd_dispatch_reads_nothing_on_the_host():
    """optimize_pose_graph's multi-device branch on the card listed 4 times,
    dispatched with async_dispatch=True under
    torch.cuda.set_sync_debug_mode("error") (any host read raises), then
    finalized: it lands, closes the loop of the drifted circle (< 0.25 m,
    tests/test_distributed.py's bound) and agrees with the f64 router on
    ["cpu"] * 4 within the f32 bounds."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.posegraph import KeyframeDB, optimize_pose_graph

    n = 64
    make = lambda d: chip_smoke.drifted_circle_db(lambda: KeyframeDB(n, 8, 8, device=d), n, 4)
    (cpu_db, t_gt), card_db = make("cpu"), make(dev)[0]
    optimize_pose_graph(cpu_db, 0, n - 1, dist_min_poses=2, devices=["cpu"] * 4)
    optimize_pose_graph(make(dev)[0], 0, n - 1, dist_min_poses=2, devices=[dev] * 4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = optimize_pose_graph(card_db, 0, n - 1, dist_min_poses=2, devices=[dev] * 4,
                                      async_dispatch=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pending.finalize()
    assert pending.landed
    assert np.linalg.norm(card_db.opt_t[:n] - t_gt, axis=1).max() < 0.25
    out = lambda db: (db.opt_t[:n], db.opt_q[:n], db.cov[:n])
    chip_smoke._pg_check("router [card] * 4 vs CPU f64", out(card_db), out(cpu_db),
                         chip_smoke._f32_bounds(float(np.abs(cpu_db.opt_t[:n]).max())), {})


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dd", "distributed"])
def test_pose_graph_across_devices_repeats_bit_for_bit_on_card(solver):
    """Two runs of the same f32 solve on the card listed 4 times give the
    same bits: the shards' partial sums are taken in mesh order, with no
    atomics."""
    dev = _card()
    import chip_smoke
    from isvins_tpu_torch.parallel import dd_pose_graph_solve, distributed_pose_graph_solve

    fn = dd_pose_graph_solve if solver == "dd" else distributed_pose_graph_solve
    args = chip_smoke._f32(chip_smoke.posegraph_problem(64, 64, 4))
    a = fn([dev] * 4, *args, iters=3, with_cov=True)
    b = fn([dev] * 4, *args, iters=3, with_cov=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)



@pytest.mark.gpu
def test_realism_bench_main_on_card_at_a_cut():
    """python -m isvins_tpu_torch.realism_bench at EuRoC's 752x480 cut to 40
    frames (init near frame 18, about 20 steady frames), synchronous, on
    the card: one JSON line with realism_bench.py's fields, the backend the
    card's name, finite frame and tracker times with the tracker inside
    the frame, poses solved and keyframes made."""
    import json

    from isvins_tpu_torch import realism_bench

    _card()
    out = realism_bench.main(40)
    assert list(out) == list(realism_bench.FIELDS)
    assert out["backend"] == f"cuda ({torch.cuda.get_device_name()})"
    assert out["solved_poses"] >= 15 and out["keyframes"] >= 5
    for k in ("tracker_ms_per_frame_median", "pipeline_ms_per_frame_median",
              "pipeline_ms_per_frame_p90", "pipeline_fps", "tracking_fps", "ate_se3_m_vio"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["tracker_ms_per_frame_median"] < out["pipeline_ms_per_frame_median"]
    json.dumps(out)


@pytest.mark.gpu
def test_dryrun_multichip_on_one_card():
    """__graft_entry__.py's dry run on the card alone (a mesh of one): the
    product window's solve, the dense solve, one coordinated estimator."""
    from isvins_tpu_torch import multichip

    dev = _card()
    out = multichip.dryrun_multichip(1, devices=[dev])
    assert out["mesh"] == [str(dev)] and out["dd"] is None and out["n_solved"] == 1
    assert out["window"][0].P.device == dev and out["dense"][0].device == dev


def _two_cards():
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards; this machine has {torch.cuda.device_count()}")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.gpu
def test_dryrun_multichip_on_two_distinct_cards():
    """The dry run on two distinct cards (mesh ["cuda:0", "cuda:1"]): the
    windows cut across both cards and gathered on the first, dd with its
    interface summed on the first card, the coordinator's batch cut in two,
    one solve per card. Against the same dry run on the first card listed
    twice, whose chunks have the same sizes: the windows and the
    estimators' positions equal bit for bit (the same programs on the same
    inputs); the f32 pose-graph solves, whose shards run as one batched
    program on one card and one by one on two, each within max(256 f32 ulps
    of the largest coordinate, 4x the one-card solve's error) of the f64
    solve of the same inputs (chip_smoke's f32 bounds), covariance 5 %."""
    import chip_smoke
    from isvins_tpu_torch import multichip
    from isvins_tpu_torch.parallel import dd_pose_graph_solve, distributed_pose_graph_solve

    cards = _two_cards()
    two = multichip.dryrun_multichip(2, devices=cards)
    one = multichip.dryrun_multichip(2, devices=[cards[0]] * 2)
    assert two["distinct_devices"] == 2 and one["distinct_devices"] == 1
    for a, b in zip((*two["window"][0], two["window"][1]), (*one["window"][0], one["window"][1])):
        assert a.device == cards[0] and torch.equal(a, b)
    for a, b in zip(two["sequences"], one["sequences"]):
        assert np.array_equal(a["Ps"], b["Ps"]) and a["packets"] == b["packets"] == 1
    pg = tuple(x.astype(np.float64) if x.dtype == np.float32 else x
               for x in multichip.pose_graph_inputs())
    ref = dd_pose_graph_solve([cards[0]] * 2, *pg, iters=2, with_cov=True)
    base = chip_smoke._pg_errors(one["dd"], ref)
    chip_smoke._pg_check("dd on two cards vs f64", two["dd"], ref,
                         chip_smoke._f32_bounds(base["t_max"], base), {})
    Ks = 16
    small = tuple(x[:Ks] for x in pg[:14])
    small = small[:4] + (np.minimum(small[4], Ks - 2), np.minimum(small[5], Ks - 1)) + small[6:]
    dense = distributed_pose_graph_solve([cards[0]] * 2, *small, iters=2)
    err = lambda out: float((out[0].double().cpu() - dense[0].cpu()).abs().max())
    t_max = float(dense[0].abs().max())
    assert err(two["dense"]) <= max(256 * float(np.spacing(np.float32(t_max))),
                                    chip_smoke.F32_MARGIN * err(one["dense"]))


@pytest.mark.gpu
def test_scaling_sweeps_on_two_distinct_cards():
    """scaling_bench's sweeps on two distinct cards at a cut: dd at K = 256
    over nd = 2, 4, 8 (the two cards in turn) against the dense solve in f64
    at the reference tests' tolerances; 4 product windows over nd = 1, 2, 4
    equal bit for bit to the same sweep on the first card alone (the same
    chunks, the same programs); the interface sum measured (not null) in
    chip_phases."""
    import chip_smoke
    from isvins_tpu_torch import scaling_bench

    cards = _two_cards()
    sols = {}
    rec = scaling_bench.bench_posegraph_dd(256, devices=cards, reps=1, solutions=sols)
    assert [r["distinct_devices"] for r in rec["measured_virtual_mesh"].values()] == [1, 2, 2, 2]
    for nd in scaling_bench.DD_NDS:
        chip_smoke._pg_check(f"dd{nd} on two cards vs dense", sols[nd], sols[1],
                             chip_smoke.F64_BOUNDS, {})
    two, one = {}, {}
    scaling_bench.bench_window_dp(devices=cards, nb=4, reps=1, results=two)
    scaling_bench.bench_window_dp(devices=cards[:1], nb=4, reps=1, results=one)
    for nd in (1, 2, 4):
        for a, b in zip((*two[nd][0], two[nd][1]), (*one[nd][0], one[nd][1])):
            assert torch.equal(a, b), nd
    ph = scaling_bench.chip_phases(256, devices=cards)
    assert all(r["interface_sum_ms"] > 0 for r in ph["per_device_ms"].values())

def test_resolve_device_without_a_card_raises():
    """`None` means the card: without one it raises, and so does every entry
    point that resolves its device from None; the CPU is used only when the
    caller says so."""
    from isvins_tpu_torch.device import resolve_device
    from isvins_tpu_torch.parallel import make_batch_problem, make_mesh
    from isvins_tpu_torch.solver import WindowDims

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for call in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: make_mesh(None),
                 lambda: make_batch_problem(1, WindowDims(6, 3, 32, 64))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    prob = make_batch_problem(1, WindowDims(6, 3, 32, 64), device="cpu")
    assert prob[0].P.device.type == "cpu"


def test_entry_points_default_to_the_card_and_take_cpu(tmp_path):
    """No entry point of the port defaults to the CPU: `device` is None (the
    card) or a required argument; with device="cpu" each runs here."""
    import inspect

    import numpy as np

    from isvins_tpu_torch.estimator.estimator import Estimator
    from isvins_tpu_torch.estimator.feature_manager import FeatureManager
    from isvins_tpu_torch.initial.pnp import pnp_ransac_gn
    from isvins_tpu_torch.parallel import MultiSequenceSolver, make_batch_problem
    from isvins_tpu_torch.posegraph.keyframe_db import KeyframeDB
    from isvins_tpu_torch.utils.checkpoint import load_pose_graph

    from isvins_tpu_torch.frontend import FeatureTracker
    from isvins_tpu_torch.posegraph import PoseGraphBuilder
    from isvins_tpu_torch.system import System

    from isvins_tpu_torch.bench import bench_e2e, bench_solve
    from isvins_tpu_torch.multichip import dryrun_multichip, entry
    from isvins_tpu_torch.parallel import cycle_mesh
    from isvins_tpu_torch.realism_bench import bench_realism, main as realism_main
    from isvins_tpu_torch.retrieval_bench import build_db
    from isvins_tpu_torch.scaling_bench import (bench_posegraph_dd, bench_window_dp,
                                                chip_phases, run as scaling_run)

    for fn in (make_batch_problem, load_pose_graph, pnp_ransac_gn, Estimator.__init__,
               FeatureTracker.__init__, PoseGraphBuilder.__init__, System.__init__,
               bench_solve, bench_e2e, build_db, bench_realism, realism_main, entry):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    for fn in (MultiSequenceSolver.__init__, cycle_mesh, bench_posegraph_dd, bench_window_dp,
               chip_phases, scaling_run, dryrun_multichip):
        assert inspect.signature(fn).parameters["devices"].default is None, fn
    for cls in (FeatureManager, KeyframeDB):
        assert inspect.signature(cls.__init__).parameters["device"].default is inspect.Parameter.empty
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 3)) + [0, 0, 5]
    assert not pnp_ransac_gn(X, X[:, :2] / X[:, 2:], [1.0, 0, 0, 0], np.zeros(3), device="cpu")[0]
    assert [d.type for d in MultiSequenceSolver(["cpu"]).devices] == ["cpu"]

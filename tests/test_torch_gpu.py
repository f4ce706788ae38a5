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
    and K3/K4 once per LM iteration, and reaches the cost of the plain
    solve on the CPU within 1e-3 relative (different summation orders in
    an f32 LM that is not converged after 10 iterations)."""
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
    it = info["iterations"]
    assert ops.launch_counts() == {"proj_rows": it + 1, "imu_rows": it + 1,
                                   "schur_corr": it, "linstep": it, "chol_solve_batched": 0,
                                   "retrieval_scores": 0, "schur_reduce": 0}
    assert all(bool(torch.isfinite(a).all()) for a in st)
    _, cost_cpu = solve_window(*args("cpu"), dims, iters=10)
    assert abs(float(cost) - float(cost_cpu)) <= 1e-3 * float(cost_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 23, 256, 4096])
def test_retrieval_scores_exact_on_card(K):
    """K6 at R = 64, thresh = 40, at the pose-graph path's first and largest
    database (K = 1, 23), the slice's capacity and the default one: one
    launch, counted once, exactly equal to its plain version (integer work
    up to one IEEE division)."""
    dev = _card()
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
    (nb, Dp, tiles, smem_bytes) for the widths the repo runs and the limit."""
    dev = _card()
    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.ops.chol_batched import chol_max_dim, chol_plan

    for D in (1, 66, 141, 276, chol_max_dim(), chol_max_dim() + 1):
        out = torch.zeros(4, dtype=torch.int32)
        _lib.launch("isv_chol_plan", D, out, device=dev)
        assert tuple(out.tolist()) == tuple(chol_plan(D)), D


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
    for n in (321, 400):  # the tiles would not fit shared memory (D <= 320)
        with pytest.raises(ValueError, match="D <= 320"):
            ops.chol_solve_batched(torch.eye(n, device=dev)[None].contiguous(),
                                   torch.ones((1, n), device=dev))
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
    evaluation and K5 once per LM iteration, never K3 or K4, and in f64 its
    rows are the single solves (cost 1e-9 relative)."""
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
    it = info["iterations"]
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

    for fn in (make_batch_problem, load_pose_graph, pnp_ransac_gn, Estimator.__init__):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    assert inspect.signature(MultiSequenceSolver.__init__).parameters["devices"].default is None
    for cls in (FeatureManager, KeyframeDB):
        assert inspect.signature(cls.__init__).parameters["device"].default is inspect.Parameter.empty
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 3)) + [0, 0, 5]
    assert not pnp_ransac_gn(X, X[:, :2] / X[:, 2:], [1.0, 0, 0, 0], np.zeros(3), device="cpu")[0]
    assert [d.type for d in MultiSequenceSolver(["cpu"]).devices] == ["cpu"]

"""The port's multi-sequence path against the JAX package, on the CPU, with
seeded numpy inputs through both:
(a) K5's and K7's plain versions against the Pallas kernels in interpret
    mode, and linstep_batched against `_linstep_batched` and
    vmap(linstep_ref), at the product width D = 276;
(b) solve_window_batched against the reference's sharded_batch_solve, its
    freeze of converged sequences, a poisoned sequence beside healthy ones,
    and the two-device split;
(c) MultiSequenceSolver against solo estimators of both packages, and the
    solve_async pipeline against the synchronous estimator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu import solver as js
from isvins_tpu.parallel import make_batch_problem as j_make_batch_problem
from isvins_tpu.parallel import make_mesh as j_make_mesh
from isvins_tpu.parallel import sharded_batch_solve as j_sharded_batch_solve
from isvins_tpu_torch import ops
from isvins_tpu_torch import solver as ts
from isvins_tpu_torch.parallel import (MultiSequenceSolver, make_batch_problem, make_mesh,
                                       sharded_batch_solve)
from isvins_tpu_torch.utils.convert import from_numpy_tree, tree_map

T = torch.as_tensor
DIMS = ts.WindowDims(B=6, Vo=3, F=32, N=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: when several test processes share one
    machine, torch's intra-op thread pools only contend with each other
    (this file ran 6x slower beside five other workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a) the kernels
def _linstep_problem(rng):
    """tests/test_pallas_ops.py:130-150: an SPD H at the product width that
    holds the landmark information, so its Schur complement stays SPD."""
    B, F = 18, 1000
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
    b = rng.normal(size=D).astype(np.float32)
    bl = rng.normal(size=F).astype(np.float32)
    # NB = 2: the same problem twice, told apart by lam
    args = [np.stack([a, a]) for a in (H.astype(np.float32), b, W, h, bl)]
    return args, np.asarray([1e-4, 1e-1], np.float32), n_pose, D


def test_chol_solve_batched_ref_matches_pallas():
    """K5's plain version against chol_solve_batched_pallas (interpret mode)
    on two damped systems at D = 276: 2e-3 of the largest entry, rtol 2e-3
    (the bound tests/test_pallas_ops.py:176-184 gives the batched step)."""
    from isvins_tpu.ops.linstep_pallas import chol_solve_batched_pallas

    (H, b, *_), lam, _, D = _linstep_problem(np.random.default_rng(0))
    H_dd, k = H.copy(), np.arange(D)
    H_dd[:, k, k] *= 1.0 + lam[:, None]  # the LM damping of the diagonal
    ref = np.asarray(chol_solve_batched_pallas(jnp.asarray(H_dd), jnp.asarray(b)))
    out = ops.chol_solve_batched_ref(T(H_dd), T(b)).numpy()
    assert out.shape == (2, D)
    np.testing.assert_allclose(out, ref, atol=2e-3 * np.abs(ref).max(), rtol=2e-3)
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = ops.chol_solve_batched.launches
    np.testing.assert_array_equal(ops.chol_solve_batched(T(H_dd), T(b)).numpy(), out)
    assert ops.chol_solve_batched.launches == before


def test_chol_solve_batched_ref_not_spd_is_nan_row():
    """A matrix that is not SPD gives a NaN row and leaves the other rows
    as they are (the LM accept test then rejects that sequence's step)."""
    (H, b, *_), _, _, D = _linstep_problem(np.random.default_rng(1))
    good = ops.chol_solve_batched_ref(T(H), T(b)).numpy()
    H[1, 40, 40] = -1.0
    out = ops.chol_solve_batched_ref(T(H), T(b)).numpy()
    assert np.isnan(out[1]).all()
    np.testing.assert_array_equal(out[0], good[0])


def test_linstep_batched_matches_reference():
    """linstep_batched (CPU: K5's plain version inside) against the
    reference's `_linstep_batched` (Pallas factorization in interpret mode)
    and against vmap(linstep_ref), two different lam: 2e-3 of the largest
    entry, rtol 2e-3, as tests/test_pallas_ops.py:176-184."""
    from isvins_tpu.ops.linstep_pallas import _linstep_batched, linstep_ref

    args, lam, n_pose, D = _linstep_problem(np.random.default_rng(2))
    j_args = [jnp.asarray(a) for a in args]
    dx, dl = ops.linstep_batched(*(T(a) for a in args), T(lam), n_pose)
    bdx, bdl = _linstep_batched(*j_args, jnp.asarray(lam), n_pose)
    rdx, rdl = jax.vmap(lambda *a: linstep_ref(*a, n_pose, D))(*j_args, jnp.asarray(lam))
    assert float(np.abs(np.asarray(rdx[0]) - np.asarray(rdx[1])).max()) > 0  # lam matters
    for ref_dx, ref_dl in ((bdx, bdl), (rdx, rdl)):
        ref_dx, ref_dl = np.asarray(ref_dx), np.asarray(ref_dl)
        np.testing.assert_allclose(dx.numpy(), ref_dx, atol=2e-3 * np.abs(ref_dx).max(),
                                   rtol=2e-3)
        np.testing.assert_allclose(dl.numpy(), ref_dl, atol=2e-3 * np.abs(ref_dl).max(),
                                   rtol=2e-3)
    # each row is the single-problem plain step at its own lam
    for n in range(2):
        sdx, sdl = ops.linstep_ref(*(T(a[n]) for a in args), T(lam[n]), n_pose, D)
        np.testing.assert_allclose(dx[n].numpy(), sdx.numpy(), rtol=2e-3,
                                   atol=2e-3 * float(sdx.abs().max()))
        np.testing.assert_allclose(dl[n].numpy(), sdl.numpy(), rtol=2e-3,
                                   atol=2e-3 * float(sdl.abs().max()))


def test_schur_reduce_ref_matches_pallas():
    """K7's plain version against schur_reduce_pallas (interpret mode) at
    D = 276, F = 1000 with one empty landmark: rtol 2e-5, atol 2e-3, the
    bound of tests/test_pallas_ops.py:68-81."""
    from isvins_tpu.ops.schur_pallas import schur_reduce_pallas

    rng = np.random.default_rng(3)
    D, F = 276, 1000
    A = rng.normal(size=(D, D))
    H = (A + A.T).astype(np.float32)
    W = rng.normal(size=(F, D)).astype(np.float32)
    h = np.abs(rng.normal(size=F)).astype(np.float32) + 0.1
    h[7] = 0.0  # empty landmark
    b = rng.normal(size=D).astype(np.float32)
    bl = rng.normal(size=F).astype(np.float32)
    Hs_ref, bs_ref = schur_reduce_pallas(*(jnp.asarray(a) for a in (H, b, W, h, bl)))
    before = ops.schur_reduce.launches
    Hs, bs = ops.schur_reduce(*(T(a) for a in (H, b, W, h, bl)))  # CPU: the plain version
    assert ops.schur_reduce.launches == before
    np.testing.assert_allclose(Hs.numpy(), np.asarray(Hs_ref), rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(bs.numpy(), np.asarray(bs_ref), rtol=2e-5, atol=2e-3)


# ------------------------------------------------------ (b) the batched solve
def _port(tree, dtype=None):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree), "cpu", dtype)


def _row(tree, k):
    return tree_map(lambda a: a[k], tree)


def _solo(prob, k, dims, **kw):
    """Sequence k of a batch problem through solve_window."""
    st, im, pr, pri, G, psi = prob
    return ts.solve_window(_row(st, k), _row(im, k), _row(pr, k), _row(pri, k), G, psi, dims, **kw)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_solve_window_batched_matches_reference(dt):
    """Three sequences through the reference's sharded_batch_solve on a
    one-device mesh and through the port's. f64, 10 iterations: the same
    iterates to 1e-9. f32, 3 iterations: cost rtol 1e-5 and the state within
    1e-5 plus twice the reference's own f32 round-off per field, the bound
    and the reasons of test_torch_solver.test_solve_window_batch_problem."""
    iters = 10 if dt == np.float64 else 3
    jd = js.WindowDims(*DIMS)
    jp = j_make_batch_problem(3, jd, dtype=jnp.dtype(dt), seed=4)
    j_step, j_shard = j_sharded_batch_solve(j_make_mesh(1), jd, iters=iters)
    st_j, c_j = j_step(*j_shard(jp[:4]), jp[4], jp[5])
    step, shard = sharded_batch_solve(["cpu"], DIMS, iters=iters)
    st_t, c_t = step(*shard(tuple(_port(x) for x in jp[:4])), _port(jp[4]), _port(jp[5]))
    assert tuple(c_t.shape) == (3,) and tuple(st_t.P.shape) == (3, DIMS.B, 3)
    if dt == np.float64:
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-9)
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
        return
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    j64 = j_make_batch_problem(3, jd, dtype=jnp.float64, seed=4)
    st_64, _ = j_step(*j_shard(j64[:4]), j64[4], j64[5])
    for name, a, b, c in zip(st_t._fields, st_t, st_j, st_64):
        own = np.abs(np.asarray(b, np.float64) - np.asarray(c)).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 + 2 * own, err_msg=name)


def test_batched_freezes_converged_sequences():
    """A batch whose sequences converge at different iterations (here one of
    three stops at iteration 28 of 32) equals the same problems solved alone
    (f64, 1e-9): a converged sequence keeps its state, cost and lam while
    the others iterate on."""
    prob = make_batch_problem(3, DIMS, torch.float64, seed=5, device="cpu")
    its, alone = [], []
    for k in range(3):
        info = {}
        alone.append(_solo(prob, k, DIMS, iters=32, info=info))
        its.append(info["iterations"])
    assert len(set(its)) >= 2, its  # they do stop at different iterations
    info = {}
    st, cost = ts.solve_window_batched(*prob, DIMS, iters=32, info=info)
    assert info["iterations"] == max(its)
    for k, (st_k, c_k) in enumerate(alone):
        np.testing.assert_allclose(float(cost[k]), float(c_k), rtol=1e-9)
        for a, b in zip(st, st_k):
            np.testing.assert_allclose(a[k].numpy(), b.numpy(), atol=1e-9)


@pytest.mark.parametrize("poison", ["nan", "not_spd"])
def test_batched_poisoned_sequence_leaves_others(poison):
    """One sequence whose cost is NaN from the start, or whose linear system
    is not SPD (every step NaN, so every trial rejected), beside two healthy
    ones: the healthy sequences end where they end without it (f64, 1e-12),
    and the poisoned one keeps its initial state."""
    prob = list(make_batch_problem(3, DIMS, torch.float64, seed=6, device="cpu"))
    clean_st, clean_c = ts.solve_window_batched(*prob, DIMS, iters=6)
    if poison == "nan":
        pts, valid = prob[2].pts_j.clone(), prob[2].valid.clone()
        pts[1, 0, 0] = float("nan")
        valid[1, 0] = True
        prob[2] = prob[2]._replace(pts_j=pts, valid=valid)
        st, cost = ts.solve_window_batched(*prob, DIMS, iters=6)
        assert bool(torch.isnan(cost[1]))
    else:
        import importlib

        mod = importlib.import_module("isvins_tpu_torch.ops.linstep")
        real = mod.chol_solve_batched_ref

        def broken(H, b):  # sequence 1's system loses a pivot
            H = H.clone()
            H[1, 3, 3] = -1.0
            return real(H, b)

        mod.chol_solve_batched_ref = broken
        try:
            st, cost = ts.solve_window_batched(*prob, DIMS, iters=6)
        finally:
            mod.chol_solve_batched_ref = real
        c0 = ts.solve_window_batched(*prob, DIMS, iters=0)[1]
        np.testing.assert_allclose(float(cost[1]), float(c0[1]), rtol=1e-12)
    for a, a0 in zip(st, prob[0]):
        np.testing.assert_array_equal(a[1].numpy(), a0[1].numpy())
    for k in (0, 2):
        np.testing.assert_allclose(float(cost[k]), float(clean_c[k]), rtol=1e-12)
        for a, b in zip(st, clean_st):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-12)


def test_sharded_batch_solve_two_devices():
    """The leading axis cut into two contiguous chunks, one per device
    (here twice the CPU), no communication, results concatenated: equal to
    the one-device solve (f64, 1e-9: the same code on the same rows; in f32
    a product's rounding depends on the batch size it ran at)."""
    assert [d.type for d in make_mesh(["cpu", "cpu"])] == ["cpu", "cpu"]
    prob = make_batch_problem(3, DIMS, torch.float64, seed=7, device="cpu")
    one, _ = sharded_batch_solve(["cpu"], DIMS, iters=3)
    two, shard = sharded_batch_solve(["cpu", "cpu"], DIMS, iters=3)
    st1, c1 = one(*prob)
    shards = shard(prob[:4])
    assert len(shards) == 2 and shards[0][0].P.shape[0] + shards[1][0].P.shape[0] == 3
    for st2, c2 in (two(*prob), two(*zip(*shards), *prob[4:])):
        assert tuple(c2.shape) == (3,)
        np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=1e-9)
        for a, b in zip(st2, st1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)


# ------------------------------------------------ (c) estimators, coordinated
B_, VO_, F_, N_ = 10, 4, 64, 256
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def _build_estimator(pkg, seed, **kw):
    """tests/test_distributed.py:296-317 for either package: an estimator in
    the steady state on a seeded world, one frame's solve ahead of it."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    cfgm, em, synth = mod("config"), mod("estimator.estimator"), mod("utils.synthetic")
    hostmath, sol = mod("geom.hostmath"), mod("solver")
    cfg = cfgm.euroc_config().replace(
        window=cfgm.WindowConfig(vo_size=VO_, all_size=B_, max_features=F_, max_imu_per_frame=64),
        tic=(0.0, 0.0, 0.0), ric=tuple(map(tuple, R_BC)))
    qic = hostmath.mat_to_quat_np(R_BC)
    world = synth.make_world(n_frames=B_, n_landmarks=120, seed=seed)
    est = em.Estimator(cfg, sol.WindowDims(B=B_, Vo=VO_, F=F_, N=N_), solve_async=True, **kw)
    est.Ps[:] = world.P
    est.Qs[:] = world.Q
    est.Vs[:] = world.V
    est.Headers[:] = world.frame_times
    est.imu_dt[1:] = world.imu_dts
    est.imu_acc[1:] = world.imu_accs
    est.imu_gyr[1:] = world.imu_gyrs
    est.imu_acc0[1:] = world.imu_acc0
    est.imu_gyr0[1:] = world.imu_gyr0
    est.imu_cnt[1:] = (world.imu_dts > 0).sum(axis=1)
    for k in range(B_):
        pts, _, vis = synth.project(world, k, np.zeros(3), qic)
        est.f_manager.add_features(k, np.where(vis)[0], pts[vis])
    est.frame_count = B_ - 1
    est.solver_flag = em.NON_LINEAR
    est.marginalization_flag = em.MARGIN_OLD
    est.priors = sol.PriorState.empty(VO_)
    return est


def _port_estimator(seed):
    return _build_estimator("isvins_tpu_torch", seed, device="cpu")


def test_multi_sequence_solver_equivalent():
    """The mirror of tests/test_distributed.py:274-339 on the port: two
    estimators batched through the coordinator against the same two
    dispatching alone, one pose-graph packet each. In f64 the batched rows
    ARE the solo solves (1e-12). In f32 they differ by summation order (bmm
    against mm), so the bound is the reference's 1e-5 plus each solve's own
    f32 round-off (its f32 against its f64 result, measured here: ~5e-5 on
    these windows, the batched-solo gap 1.5e-5). Both equal the JAX
    estimators' Ps within 1e-4, the f32 position bound of
    test_torch_estimator.TF_TOL."""
    from isvins_tpu_torch.estimator.estimator import steady_solve, to_device

    seeds = (200, 201)
    solo, own, pend = [], [], []
    for s in seeds:
        e = _port_estimator(s)
        e.dispatch_odometry()
        args = e._solve_pending["args"]
        run = lambda a, dt: tree_map(lambda o: o.numpy().astype(np.float64), steady_solve(
            *to_device(a, torch.device("cpu"), dt), e.dims, e.cfg.solver.max_iterations, False,
            e.noise, float(e.cfg.solver.max_depth))[0])
        st32, st64 = run(args, torch.float32), run(args, torch.float64)
        own.append(max(float(np.abs(a - b).max()) for a, b in zip(st32, st64)))
        pend.append((args, st64, run))
        e.collect_solve()
        e.close()
        solo.append(e.Ps.copy())
    stacked = tree_map(lambda *leaves: np.stack(leaves), *(a for a, _, _ in pend))
    both64 = pend[0][2](stacked, torch.float64)
    for k, (_, st64, _) in enumerate(pend):
        for a, b in zip(both64, st64):
            np.testing.assert_allclose(a[k], b, atol=1e-12)

    ests = [_port_estimator(s) for s in seeds]
    for e in ests:
        e._defer_dispatch = True
        e.dispatch_odometry()
        assert e._solve_pending["handle"] is None
    assert MultiSequenceSolver(["cpu"]).step(ests) == 2
    for e, ref, o in zip(ests, solo, own):
        e.close()
        assert e._solve_pending is None and len(e.ready_poses) == 1
        np.testing.assert_allclose(e.Ps, ref, atol=1e-5 + o)
        assert len(e.pose_graph_packets) == 1
    for s, e in zip(seeds, ests):
        j = _build_estimator("isvins_tpu", s)
        j.dispatch_odometry()
        j.collect_solve()
        j.collect_marg()
        np.testing.assert_allclose(e.Ps, j.Ps, atol=1e-4)


def test_multi_sequence_solver_collects_own_dispatches_and_rejects_mixes():
    """An estimator that already dispatched its own solve is still collected
    by step() when another one deferred (the reference left it pending); two
    chunks on two devices give the one-device result; estimators whose
    solves differ in structure raise."""
    own, deferred = _port_estimator(200), _port_estimator(201)
    deferred._defer_dispatch = True
    own.dispatch_odometry()
    deferred.dispatch_odometry()
    assert own._solve_pending["handle"] is not None
    assert MultiSequenceSolver(["cpu"]).step([own, deferred]) == 1
    for e in (own, deferred):
        assert e._solve_pending is None and len(e.ready_poses) == 1
        e.close()
    # a deferred dispatch that no coordinator picks up runs at collect_solve
    alone = _port_estimator(201)
    alone._defer_dispatch = True
    alone.dispatch_odometry()
    alone.collect_solve()
    alone.close()
    np.testing.assert_allclose(alone.Ps, deferred.Ps, atol=5e-5)  # f32 summation order

    pair = [_port_estimator(s) for s in (200, 201)]
    for e in pair:
        e._defer_dispatch = True
        e.dispatch_odometry()
    assert MultiSequenceSolver(["cpu", "cpu"]).step(pair) == 2
    np.testing.assert_allclose(pair[0].Ps, own.Ps, atol=5e-5)
    np.testing.assert_allclose(pair[1].Ps, deferred.Ps, atol=5e-5)

    mixed = [_port_estimator(s) for s in (200, 201)]
    mixed[1].estimate_extrinsic = 1
    for e in mixed:
        e._defer_dispatch = True
        e.dispatch_odometry()
    with pytest.raises(ValueError, match="mixed"):
        MultiSequenceSolver(["cpu"]).step(mixed)
    for e in pair + mixed:
        e.close()


def test_solve_async_equivalent_to_sync():
    """One estimator drive (the world and window of test_torch_estimator, cut
    to 18 frames: init at frame 9, then 8 steady frames) with solve_async=True, collect_solve() before each frame's IMU
    feed, against the synchronous drive: the same poses (1e-9, the bound of
    tests/test_pipeline_mode.py:73-97; the same code on the same inputs),
    each delivered one frame later."""
    from isvins_tpu_torch.config import WindowConfig, euroc_config
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.utils.synthetic import make_world, project

    cfg = euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01), ric=tuple(map(tuple, R_BC)))
    n_frames = 18
    world = make_world(n_frames=n_frames, n_landmarks=240, seed=0)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(R_BC)

    def drive(solve_async):
        est = Estimator(cfg, ts.WindowDims(B=10, Vo=4, F=256, N=2048), device="cpu",
                        solve_async=solve_async)

        def gt_init(e):
            e.set_ground_truth_init(world.P, world.Q, world.V)
            e.f_manager.depth[:] = -1.0

        est._gt_init = gt_init
        delivered = []  # poses out after each frame
        for k in range(n_frames):
            est.collect_solve()
            if k > 0:
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                    world.imu_gyrs[k - 1][s])
            pts, _, vis = project(world, k, tic, qic)
            info = est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
            if solve_async and est.solver_flag == NON_LINEAR and "init" not in info:
                assert info["solved"] and est._solve_pending is not None
            delivered.append(len(est.ready_poses))
        est.collect_solve()
        est.close()
        assert est.failure_count == 0
        return est.ready_poses, delivered

    sync, n_sync = drive(False)
    pipe, n_pipe = drive(True)
    assert len(sync) == len(pipe) >= 8
    for (ta, Pa, Qa), (tb, Pb, Qb) in zip(sync, pipe):
        assert ta == tb
        np.testing.assert_allclose(Pa, Pb, atol=1e-9)
        np.testing.assert_allclose(Qa, Qb, atol=1e-9)
    # the init frame publishes at once in both modes; every steady frame's
    # pose is out one frame later
    first = next(k for k, n in enumerate(n_sync) if n)
    assert n_pipe[first] == n_sync[first] == 1
    assert n_pipe[first + 1:] == n_sync[first:-1]

"""The port's pose graph across devices (isvins_tpu_torch.parallel.{distributed,
dd_solver} and the multi-device branch of posegraph.optimize_pose_graph)
against the JAX package on the CPU: the same seeded numpy inputs through
the reference on its 8 virtual devices (tests/conftest.py) and through the
port on ["cpu"] * nd, in f64, at the tolerances of the reference's own tests
(tests/test_distributed.py:245-262: poses atol 1e-10, covariance rtol 1e-6
atol 2e-8, cost rtol 1e-12; the router's :47-67: 1e-6)."""

import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.parallel import make_mesh as j_mesh
from isvins_tpu.parallel.dd_solver import dd_partition as j_dd_partition
from isvins_tpu.parallel.dd_solver import dd_pose_graph_solve as j_dd_solve
from isvins_tpu.parallel.distributed import distributed_pose_graph_solve as j_dist_solve
from isvins_tpu_torch.parallel import dd_pose_graph_solve, distributed_pose_graph_solve
from isvins_tpu_torch.parallel.dd_solver import dd_partition

from test_distributed import _dd_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's thread pools only contend with the other test
    processes (as tests/test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, K=32, E=32):
    """tests/test_distributed.py's _dd_problem as numpy (writable copies)."""
    return [np.array(a) for a in _dd_problem(np.random.default_rng(seed), K=K, E=E)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_solves_agree(out, ref, cost_atol=0.0):
    """(t, q[, cov], cost) at the reference tests' tolerances."""
    out, ref = [_np(x) for x in out], [_np(x) for x in ref]
    np.testing.assert_allclose(out[0], ref[0], atol=1e-10)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-10)
    if len(out) == 4:
        # eps lands on gauge-fixed slots differently in dd and dense
        # (identity vs 1/(1+eps)): atol 2e-8, as the reference's test
        np.testing.assert_allclose(out[2], ref[2], rtol=1e-6, atol=2e-8)
    np.testing.assert_allclose(float(out[-1]), float(ref[-1]), rtol=1e-12, atol=cost_atol)


def _cut_graph():
    """K = 32 with chain-family edges that cross a segment cut away from a
    separator (5 -> 12, 13 -> 27), loops that touch separators (8 -> 20,
    3 -> 16 at nd = 4), loops within a segment, a loop to a promoted pose
    and masked rows of each family."""
    e_i, e_j, e_valid, rp_i, rp_valid, loop_i, loop_j, loop_valid = (
        _problem(5)[k] for k in (4, 5, 9, 10, 13, 14, 15, 19))
    e_i[[29, 31]], e_j[[29, 31]], e_valid[[29, 31]] = [5, 13], [12, 27], True
    e_valid[3] = False
    loop_i[:8] = [8, 3, 2, 25, 1, 12, 17, 4]
    loop_j[:8] = [20, 16, 30, 30, 27, 27, 9, 6]
    loop_valid[6] = False
    rp_valid[[7, 16]] = False
    return e_i, e_j, e_valid, rp_i, rp_valid, loop_i, loop_j, loop_valid


@pytest.mark.parametrize("graph", ["dd_problem", "cut_graph"])
@pytest.mark.parametrize("nd", [2, 4, 8])
def test_dd_partition_equals_reference(nd, graph):
    """The host routing, array for array: interface, NB (raised to a
    multiple of nd), promotions, capacities and augmented placements."""
    if graph == "dd_problem":
        p = _problem(7)
        args = [p[k] for k in (4, 5, 9, 10, 13, 14, 15, 19)]
    else:
        args = _cut_graph()
    ours, ref = dd_partition(nd, 32, *args), j_dd_partition(nd, 32, *args)
    assert ours.keys() == ref.keys()
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("nd", [1, 4])
def test_distributed_solve_matches_reference(nd, with_cov):
    """The edge-sharded dense solve on ["cpu"] * nd against the reference's
    shard_map solve on nd virtual devices (the sharded covariance too)."""
    p = _problem(7)
    out = distributed_pose_graph_solve(["cpu"] * nd, *p, iters=5, with_cov=with_cov)
    ref = j_dist_solve(j_mesh(nd), *p, iters=5, with_cov=with_cov)
    assert len(out) == len(ref) == (4 if with_cov else 3)
    _assert_solves_agree(out, ref)


@pytest.mark.parametrize("nd", [2, 4, 8])
def test_dd_solve_matches_reference_and_dense(nd):
    """The nested-dissection solve against the reference's at the same mesh
    size, and against the port's own dense solve (the exactness claim:
    dd factors the dense path's H + eps I)."""
    p = _problem(7)
    out = dd_pose_graph_solve(["cpu"] * nd, *p, iters=5, with_cov=True)
    _assert_solves_agree(out, j_dd_solve(j_mesh(nd), *p, iters=5, with_cov=True))
    _assert_solves_agree(out, distributed_pose_graph_solve(["cpu"], *p, iters=5, with_cov=True))
    assert out[2].shape == (32, 6, 6) and all(o.dtype == torch.float64 for o in out)


def test_dd_solve_no_loops_no_cov():
    """Loop-free graphs (the interface is the chain separators alone) and
    the covariance-free path (tests/test_distributed.py:253-262)."""
    p = _problem(3)[:14]
    out = dd_pose_graph_solve(["cpu"] * 4, *p, iters=4)
    ref = j_dd_solve(j_mesh(4), *p, iters=4)
    assert len(out) == 3
    # the loop-free graph converges to a zero residual: the cost is held as
    # the reference's test holds it, to 1e-18
    _assert_solves_agree(out, ref, cost_atol=1e-18)
    dense = distributed_pose_graph_solve(["cpu"], *p, iters=4)
    np.testing.assert_allclose(out[0].numpy(), dense[0].numpy(), atol=1e-10)
    np.testing.assert_allclose(float(out[2]), float(dense[2]), rtol=1e-9, atol=1e-18)


@pytest.mark.parametrize("case", ["dd_K30_nd4", "dd_nd1", "dist_cov_K30_nd4", "dist_E30_nd4"])
def test_bad_meshes_raise(case):
    """dd needs nd >= 2 and K % nd == 0; the edge-sharded solve needs every
    family divisible by nd, and K too with covariance."""
    p30 = _problem(1, K=30, E=30)
    p32 = _problem(1, K=32, E=30)
    call = {
        "dd_K30_nd4": lambda: dd_pose_graph_solve(["cpu"] * 4, *p30, iters=2),
        "dd_nd1": lambda: dd_pose_graph_solve(["cpu"], *_problem(1), iters=2),
        "dist_cov_K30_nd4": lambda: distributed_pose_graph_solve(
            ["cpu"] * 4, *p30[:4], *_problem(1)[4:], iters=2, with_cov=True),
        "dist_E30_nd4": lambda: distributed_pose_graph_solve(["cpu"] * 4, *p32, iters=2),
    }[case]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("solver", ["dd", "distributed"])
def test_masked_nonfinite_values_do_not_leak(solver):
    """ROADMAP C5: non-finite values in a masked loop row, a masked chain
    edge and an inactive pose (every edge to it masked, as the router masks
    them) leave the answer exactly as the same inputs with those values
    zeroed: poses of the active segment, every covariance block, the cost.
    Port against port: the reference lets a masked NaN through `* m`."""
    p = _problem(7)
    t, q, active = p[0], p[1], p[2]
    active[31] = False
    p[9][30] = False                         # chain edge 30 -> 31
    p[13][31] = False                        # roll-pitch edge on 31
    p[19][p[15] == 31] = False               # loops into 31
    p[19][0] = False                         # a masked loop row

    def with_values(v):
        a = [x.copy() for x in p]
        a[0][31], a[1][31] = v, v                # the inactive pose
        a[6][31], a[8][31] = v, v                # the masked chain edge's dt and sqrt-info
        a[16][0], a[17][0], a[18][0] = v, v, v   # the masked loop's dt, dq, weight
        return a

    run = {"dd": lambda a: dd_pose_graph_solve(["cpu"] * 4, *a, iters=4, with_cov=True),
           "distributed": lambda a: distributed_pose_graph_solve(["cpu"] * 4, *a, iters=4,
                                                                 with_cov=True)}[solver]
    bad, clean = run(with_values(np.nan)), run(with_values(0.0))
    bad_inf = run(with_values(np.inf))
    for out in (bad, bad_inf):
        for x, y in zip(out[:2], clean[:2]):
            assert torch.equal(x[:31], y[:31])
        assert torch.equal(out[2], clean[2]) and torch.equal(out[3], clean[3])
        assert bool(torch.isfinite(out[2]).all()) and bool(torch.isfinite(out[3]))


@pytest.mark.parametrize("solver", ["dd", "distributed"])
def test_runs_repeat_and_groupings_agree_bit_for_bit(solver):
    """Two runs give the same bits, and so does the same mesh split into two
    device groups ("cpu" and "cpu:0" are distinct torch devices): the
    partial sums are taken shard by shard in mesh order, whatever runs
    them."""
    p = _problem(7)
    fn = dd_pose_graph_solve if solver == "dd" else distributed_pose_graph_solve
    one = fn(["cpu"] * 4, *p, iters=5, with_cov=True)
    again = fn(["cpu"] * 4, *p, iters=5, with_cov=True)
    grouped = fn(["cpu", "cpu:0", "cpu", "cpu:0"], *p, iters=5, with_cov=True)
    for a, b, c in zip(one, again, grouped):
        assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------------------------------ router
def _dbs(n=40, seq0=False):
    """tests/test_distributed.py:16-44's drifted circle (n keyframes, one
    loop) in a JAX and a port KeyframeDB, the first half as a loaded map
    (seq == 0) when asked."""
    import chip_smoke
    from isvins_tpu.posegraph import KeyframeDB as JDB
    from isvins_tpu_torch.posegraph import KeyframeDB

    jdb, t_gt = chip_smoke.drifted_circle_db(lambda: JDB(64, 8, 8), n, 1)
    db, _ = chip_smoke.drifted_circle_db(lambda: KeyframeDB(64, 8, 8, device="cpu"), n, 1)
    if seq0:
        jdb.seq[: n // 2] = 0
        db.seq[: n // 2] = 0
    return jdb, db, t_gt


@pytest.fixture
def dd_calls(monkeypatch):
    """The mesh of every dd solve the router dispatches."""
    from isvins_tpu_torch.posegraph import optimize

    calls, real = [], optimize.dd_pose_graph_solve

    def spy(devices, *a, **kw):
        calls.append(list(devices))
        return real(devices, *a, **kw)

    monkeypatch.setattr(optimize, "dd_pose_graph_solve", spy)
    return calls


@pytest.mark.parametrize("seq0", [False, True])
def test_router_dd_branch_matches_reference(seq0, dd_calls):
    """optimize_pose_graph(dist_min_poses=2) on ["cpu"] * 8 takes the dd
    branch at nd = 8, as the reference's router on 8 virtual devices does,
    and writes the same poses, covariances, drift and cost (the reference
    test's 1e-6); again with the first half as a loaded map."""
    from isvins_tpu.posegraph import optimize_pose_graph as j_opt
    from isvins_tpu_torch.posegraph import optimize_pose_graph

    n = 40
    jdb, db, t_gt = _dbs(n, seq0)
    r, t, cost = optimize_pose_graph(db, 0, n - 1, iters=8, dist_min_poses=2,
                                     devices=["cpu"] * 8)
    jr, jt, jcost = j_opt(jdb, 0, n - 1, iters=8, dist_min_poses=2)
    assert [len(c) for c in dd_calls] == [8]
    for f in ("opt_t", "opt_q", "cov", "edge_dt", "edge_dq"):
        np.testing.assert_allclose(getattr(db, f)[:n], getattr(jdb, f)[:n], atol=1e-6, err_msg=f)
    np.testing.assert_allclose(r, jr, atol=1e-6)
    np.testing.assert_allclose(t, jt, atol=1e-6)
    np.testing.assert_allclose(cost, jcost, rtol=1e-6, atol=1e-9)
    if seq0:  # the loaded map's poses stay where they were
        np.testing.assert_array_equal(db.opt_t[: n // 2], db.vio_t[: n // 2])
    else:  # the loop closed (the reference test's bound)
        assert np.linalg.norm(db.opt_t[:n] - t_gt, axis=1).max() < 0.25


@pytest.mark.parametrize("n_devices,nd", [(8, 8), (6, 4), (3, 2)])
def test_router_mesh_size_and_async_form(n_devices, nd, dd_calls):
    """nd = the largest power of two <= len(devices) (the L and K // 4 caps
    do not bind at K = L = 64); the async form finalizes to what the dense
    route gives on one device, within the reference test's 1e-6."""
    from isvins_tpu_torch.posegraph import optimize_pose_graph

    n = 40
    _, db, _ = _dbs(n)
    pending = optimize_pose_graph(db, 0, n - 1, iters=8, dist_min_poses=2,
                                  devices=["cpu"] * n_devices, async_dispatch=True)
    np.testing.assert_array_equal(db.opt_t[:n], db.vio_t[:n])  # nothing landed yet
    _, t, cost = pending.finalize()
    assert pending.landed and [len(c) for c in dd_calls] == [nd]
    _, dense, _ = _dbs(n)
    _, t_d, cost_d = optimize_pose_graph(dense, 0, n - 1, iters=8, dist_min_poses=2,
                                         devices=["cpu"])
    assert len(dd_calls) == 1  # one device: the dense route
    np.testing.assert_allclose(db.opt_t[:n], dense.opt_t[:n], atol=1e-6)
    np.testing.assert_allclose(db.cov[:n], dense.cov[:n], atol=1e-6)
    np.testing.assert_allclose(t, t_d, atol=1e-6)
    np.testing.assert_allclose(cost, cost_d, rtol=1e-6, atol=1e-9)


def test_router_stays_dense_below_the_threshold(dd_calls):
    """A segment shorter than dist_min_poses takes the dense route whatever
    the device list; on the CPU the default list is [db.device]."""
    from isvins_tpu_torch.posegraph import optimize_pose_graph

    _, db, _ = _dbs(40)
    optimize_pose_graph(db, 0, 39, iters=2, dist_min_poses=41, devices=["cpu"] * 8)
    optimize_pose_graph(db, 0, 39, iters=2, dist_min_poses=2)
    assert dd_calls == []

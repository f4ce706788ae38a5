"""The port's multi-device sweeps and dry run (isvins_tpu_torch.scaling_bench
and isvins_tpu_torch.multichip) against the JAX package's (scaling_bench.py,
__graft_entry__.py) on the CPU: the port on lists of CPU devices ("cpu" and
"cpu:0" are distinct torch devices, so the distinct-device branches run),
the reference on the conftest's 8 virtual devices.

- posegraph_problem draw for draw;
- bench_posegraph_dd at K = 64: the dense and the dd solves at nd = 2, 4, 8
  in f64 at the reference tests' tolerances (tests/test_distributed.py:
  245-250), and the rows' keys;
- bench_window_dp at a cut (NB = 4 windows of B=6/Vo=3/F=32/N=64): every
  nd's rows within the reference's own batched f32 tolerance
  (test_torch_parallel.test_solve_window_batched_matches_reference);
- chip_phases' shapes and keys at K = 64, the interface sum measured on
  distinct devices only;
- dryrun_multichip(2) against the JAX dryrun_multichip(2)'s pieces, taken
  from its own calls;
- window_batch_probe.py at its CPU cut: the sharded rows equal the chunks
  bit for bit, and every section prints.

The card runs are chip_smoke.py's `scaling` phase and tests/test_torch_gpu.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
import scaling_bench as jax_scaling
from isvins_tpu import solver as js
from isvins_tpu.parallel import make_batch_problem as j_make_batch_problem
from isvins_tpu.parallel import make_mesh as j_mesh
from isvins_tpu.parallel import sharded_batch_solve as j_sharded_batch_solve
from isvins_tpu.parallel.dd_solver import dd_partition as j_dd_partition
from isvins_tpu_torch import multichip, scaling_bench
from isvins_tpu_torch.parallel import cycle_mesh, dd_pose_graph_solve
from isvins_tpu_torch.solver import WindowDims

from test_torch_pgdist import _assert_solves_agree

ROOT = Path(__file__).resolve().parents[1]
CPUS = ["cpu", "cpu:0"]  # two distinct torch devices
CUT_DIMS = WindowDims(B=6, Vo=3, F=32, N=64)
CUT_NB = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _source_keys(func: str, block_start: str):
    """The string keys of the dict literal that opens at `block_start` inside
    scaling_bench.py's function `func`, in order."""
    src = (ROOT / "scaling_bench.py").read_text()
    body = src[src.index(f"def {func}("):]
    body = body[body.index(block_start):]
    return re.findall(r'"(\w+)":', body[: body.index("}")])


def test_cycle_mesh_lists_devices_in_turn():
    """nd entries over the devices given, each in turn; a device listed more
    than once where there are fewer than nd."""
    mesh = cycle_mesh(5, CPUS)
    assert [str(d) for d in mesh] == ["cpu", "cpu:0", "cpu", "cpu:0", "cpu"]
    assert len(set(mesh)) == 2 and len(set(cycle_mesh(3, ["cpu"]))) == 1


@pytest.mark.parametrize("K", [64, 256])
def test_posegraph_problem_equals_scaling_bench(K):
    """scaling_bench._posegraph_problem's 20 arrays, bit for bit and type for
    type, from the same seed."""
    ref = jax_scaling._posegraph_problem(K, K, max(16, K // 16), np.random.default_rng(0))
    out = scaling_bench.posegraph_problem(K, K, max(16, K // 16))
    assert len(out) == len(ref) == 20
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def dd_runs():
    sols = {}
    rec = scaling_bench.bench_posegraph_dd(64, devices=CPUS, reps=1, solutions=sols)
    return rec, sols


def test_bench_posegraph_dd_matches_reference(dd_runs):
    """At K = 64 (64 chain edges, 16 loops, 3 iterations, with covariance,
    f64): the dense solve and dd at nd = 2, 4, 8 on the two CPU devices
    listed in turn equal the reference's distributed and dd solves on 1, 2,
    4, 8 virtual devices at its tests' tolerances."""
    from isvins_tpu.parallel.dd_solver import dd_pose_graph_solve as j_dd
    from isvins_tpu.parallel.distributed import distributed_pose_graph_solve as j_dense

    _, sols = dd_runs
    args = jax_scaling._posegraph_problem(64, 64, 16, np.random.default_rng(0))
    _assert_solves_agree(sols[1], j_dense(j_mesh(1), *args, iters=3, with_cov=True))
    for nd in scaling_bench.DD_NDS:
        _assert_solves_agree(sols[nd], j_dd(j_mesh(nd), *args, iters=3, with_cov=True))


def test_bench_posegraph_dd_rows(dd_runs):
    """scaling_bench.py's row keys (read from its source) plus
    `distinct_devices`; the top level's keys too; finite times."""
    rec, _ = dd_runs
    top = set(_source_keys("bench_posegraph_dd", "return {"))
    row_dd = set(_source_keys("bench_posegraph_dd", 'rows[str(nd)] = {'))
    assert top <= set(rec) and rec["K"] == 64 and rec["loops"] == 16
    rows = rec["measured_virtual_mesh"]
    assert list(rows) == ["1", "2", "4", "8"]
    assert set(rows["1"]) == {"ms", "solver", "distinct_devices"}
    for nd in ("2", "4", "8"):
        assert set(rows[nd]) == row_dd | {"efficiency_fixed_alg_vs_2dev", "distinct_devices"}
        assert rows[nd]["distinct_devices"] == 2 and rows[nd]["solver"] == "dd"
        assert np.isfinite(rows[nd]["ms"]) and rows[nd]["ms"] > 0
    assert rows["2"]["efficiency_fixed_alg_vs_2dev"] == pytest.approx(1.0)


def test_bench_window_dp_matches_reference():
    """NB = 4 windows of B=6/Vo=3/F=32/N=64, 5 iterations, f32, over nd = 1,
    2, 4 (the two CPU devices in turn): the rows of every nd against the
    reference's sharded_batch_solve on one virtual device (whose rows the
    sharded solves on more devices repeat) within the bound of
    test_torch_parallel.test_solve_window_batched_matches_reference: every
    state leaf within 1e-5 plus twice the reference's own f32 round-off (its
    f32 against its f64 solve), and the cost within rtol 1e-5 plus twice the
    reference's own f32 round-off of the cost (that test's rtol 1e-5 alone
    was set at 3 iterations; the cost's own round-off grows with the two
    more run here). On the CPU a batch of one sequence rounds otherwise
    than a batch of four, so the rows of different nd are not held to each
    other bit for bit here; on the card they differ too, and the scaling
    phase of chip_smoke.py holds each nd's rows to the nd = 1 rows within 3x
    the single f32 solves' own gap to f64."""
    res = {}
    rec = scaling_bench.bench_window_dp(devices=CPUS, nb=CUT_NB, dims=CUT_DIMS, reps=1,
                                        results=res)
    keys = set(_source_keys("bench_window_dp", "return {"))
    assert keys <= set(rec) and rec["devices"] == [1, 2, 4] and rec["distinct_devices"] == [1, 2, 2]
    assert rec["batch"] == CUT_NB and len(rec["measured_ms_virtual_mesh"]) == 3
    jd = js.WindowDims(*CUT_DIMS)
    step, shard = j_sharded_batch_solve(j_mesh(1), jd, iters=scaling_bench.WINDOW_ITERS)
    jp = j_make_batch_problem(CUT_NB, jd, dtype=jnp.float32)
    j64 = j_make_batch_problem(CUT_NB, jd, dtype=jnp.float64)
    st_j, c_j = step(*shard(jp[:4]), jp[4], jp[5])
    st_64, c_64 = step(*shard(j64[:4]), j64[4], j64[5])
    c_j, c_64 = np.asarray(c_j, np.float64), np.asarray(c_64)
    for nd, (st, c) in res.items():
        assert np.all(np.abs(c.numpy() - c_j) <= 1e-5 * np.abs(c_j) + 2 * np.abs(c_j - c_64)), nd
        for name, a, b, r in zip(st._fields, st, st_j, st_64):
            own = np.abs(np.asarray(b, np.float64) - np.asarray(r)).max()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 + 2 * own,
                                       err_msg=f"nd={nd} {name}")


def test_chip_phases_shapes_at_a_cut():
    """chip_phases at K = 64 on the CPU (host clock): dd_partition's Ki and
    NB as the reference's for every nd, scaling_bench.py's keys less the
    analytic ICI term, positive finite times; the interface sum measured on
    the two distinct CPU devices and null on one device listed nd times."""
    out = scaling_bench.chip_phases(64, devices=CPUS)
    one = scaling_bench.chip_phases(64, devices=["cpu"])
    assert set(_source_keys("chip_phases", 'out = {"backend"')) <= set(out)
    assert set(out["dense_1dev_ms"]) == {"gn_iter", "cov", "total_model"}
    K, L = 64, 16
    rng = np.random.default_rng(0)
    li, lj = rng.integers(0, K // 2, L), rng.integers(K // 2, K - 1, L)
    e_i = np.minimum(np.arange(K), K - 2)
    for nd in scaling_bench.DD_NDS:
        part = j_dd_partition(nd, K, e_i, e_i + 1, np.ones(K, bool), np.arange(K),
                              np.ones(K, bool), li, lj, np.ones(L, bool))
        row = out["per_device_ms"][str(nd)]
        assert (row["Ki"], row["NB"]) == (part["Ki"], part["NB"])
        assert "ici_per_iter_us" not in row and row["distinct_devices"] == 2
        assert all(np.isfinite(row[k]) and row[k] > 0
                   for k in ("gn_iter", "cov", "interface_sum_ms", "total_model"))
        assert row["interface_bytes"] == (36 * part["NB"] ** 2 + 6 * part["NB"]) * 4
        assert one["per_device_ms"][str(nd)]["interface_sum_ms"] is None
        assert out["eff_model_vs_dense"][str(nd)] > 0


def test_window_batch_probe_at_a_cut(capsys):
    """window_batch_probe.py --device cpu --cut (4 windows of B=6/Vo=3/F=32/
    N=64): one JSON line per section; the sharded solve over the CPU listed
    nd times equals the chunks of 4 / nd solved here bit for bit, the batch
    of all equals itself, and every chunk size took its iterations."""
    import json

    import window_batch_probe

    window_batch_probe.main(["--device", "cpu", "--cut"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [next(iter(o)) for o in out] == ["chunks", "sharded", "growth", "first_assembly",
                                            "first_step", "products"]
    chunks = out[0]["chunks"]
    assert set(chunks) == {"single", "single_contiguous", "4", "2", "1"}
    assert chunks["4"]["largest_gap_vs_batch_of_all"] == 0.0
    assert all(chunks[c]["sequence_iterations"] == [5] * 4 for c in ("4", "2", "1"))
    assert all(r["equal_bit_for_bit"] for r in out[1]["sharded"].values())
    assert set(out[1]["sharded"]) == {"2", "4"}
    assert out[5]["single_rerun_largest_gap"] == 0.0


def _record(monkeypatch, module, name, calls, wrap=None):
    """Replace module.name by a recorder of its results (or of wrap(result))."""
    real = getattr(module, name)

    def rec(*a, **k):
        out = real(*a, **k)
        calls.append(out if wrap is None else wrap(out, calls))
        return calls[-1]

    monkeypatch.setattr(module, name, rec)


def test_dryrun_multichip_matches_reference(monkeypatch):
    """dryrun_multichip(2) on the two CPU devices against the JAX
    dryrun_multichip(2) on two virtual devices, piece by piece, each read off
    the reference's own calls: the two product windows after 2 LM
    iterations (f32: cost rtol 1e-5, positions within 1e-4, the f32 position
    bound of test_torch_estimator.TF_TOL); the dd solve with covariance at
    K = 256, E = 2048 and the dense solve at 16 poses (f32), each within
    256 f32 ulps of the largest coordinate or 4x the reference's own f32
    error against the port's f64 solve of the same inputs, covariance 5 %;
    the two coordinated estimators' positions within 1e-4, one pose-graph
    packet each."""
    import __graft_entry__ as graft
    import isvins_tpu.parallel as jpar
    from isvins_tpu.parallel import dd_solver as jdd
    from isvins_tpu.parallel import distributed as jdist
    from isvins_tpu.parallel.multi_seq import MultiSequenceSolver as JMSS

    out = multichip.dryrun_multichip(2, devices=CPUS)
    assert out["mesh"] == ["cpu", "cpu:0"] and out["distinct_devices"] == 2
    assert out["n_solved"] == 2 and [s["packets"] for s in out["sequences"]] == [1, 1]

    windows, dds, denses, ests = [], [], [], []

    def recording_solve(mesh, dims, iters=10):
        step, shard = real_sbs(mesh, dims, iters=iters)

        def rec_step(*a, **k):
            windows.append(step(*a, **k))
            return windows[-1]

        return rec_step, shard

    real_sbs = jpar.sharded_batch_solve
    monkeypatch.setattr(jpar, "sharded_batch_solve", recording_solve)
    _record(monkeypatch, jdd, "dd_pose_graph_solve", dds)
    _record(monkeypatch, jdist, "distributed_pose_graph_solve", denses)
    real_step = JMSS.step
    monkeypatch.setattr(JMSS, "step", lambda self, e: (ests.extend(e), real_step(self, e))[1])
    graft.dryrun_multichip(2)
    assert len(windows) == len(dds) == len(denses) == 1 and len(ests) == 2

    (st, c), (jst, jc) = out["window"], windows[0]
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(st.P.numpy(), np.asarray(jst.P), atol=1e-4)

    pg = multichip.pose_graph_inputs()
    for a, b in zip(pg, graft_inputs(graft)):
        assert np.array_equal(a, b)
    pg64 = tuple(a.astype(np.float64) if a.dtype == np.float32 else a for a in pg)
    ref64 = dd_pose_graph_solve(CPUS, *pg64, iters=2, with_cov=True)
    _assert_f32_close(out["dd"], dds[0], ref64)
    Ks = 16
    from isvins_tpu_torch.parallel import distributed_pose_graph_solve

    small = tuple(a[:Ks] for a in pg64[:14])
    small = small[:4] + (np.minimum(small[4], Ks - 2), np.minimum(small[5], Ks - 1)) + small[6:]
    dense64 = distributed_pose_graph_solve(CPUS, *small, iters=2)
    _assert_f32_close(out["dense"], denses[0], dense64)

    for s, j in zip(out["sequences"], ests):
        np.testing.assert_allclose(s["Ps"], j.Ps, atol=1e-4)
        assert len(j.pose_graph_packets) == s["packets"] == 1


def graft_inputs(graft):
    """__graft_entry__.py:61-87's pose graph, as the JAX dryrun builds it,
    read back from its source (the 20 arrays in the order of pg_args)."""
    import inspect
    import textwrap

    src = inspect.getsource(graft.dryrun_multichip)
    body = src[src.index("    K, E, L = 256, 2048, 32"): src.index("    if n_devices >= 2:")]
    ns = {"np": np, "jnp": jnp}
    exec(textwrap.dedent(body), ns)
    return [np.asarray(a) for a in ns["pg_args"]]


def _assert_f32_close(out, ref32, ref64):
    """An f32 pose-graph solve of the port against the f64 solve of the same
    inputs, within max(256 ulps of the largest coordinate, 4x the
    reference's f32 solve's own error); covariance blocks within 5 %."""
    errs = lambda x: (np.abs(_np(x[0]).astype(np.float64) - _np(ref64[0])).max(),
                      np.minimum(np.abs(_np(x[1]) - _np(ref64[1])),
                                 np.abs(_np(x[1]) + _np(ref64[1]))).max())
    t_own, q_own = errs(ref32)
    t_err, q_err = errs(out)
    t_max = float(np.abs(_np(ref64[0])).max())
    assert t_err <= max(256 * float(np.spacing(np.float32(t_max))), 4 * t_own), (t_err, t_own)
    assert q_err <= max(256 * float(np.spacing(np.float32(1.0))), 4 * q_own), (q_err, q_own)
    if len(out) == 4:
        c, c64 = _np(out[2]).astype(np.float64), _np(ref64[2])
        rel = (np.linalg.norm(c - c64, axis=(1, 2)) / np.linalg.norm(c64, axis=(1, 2))).max()
        assert rel <= 0.05, rel

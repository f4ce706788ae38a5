"""The plain reference (benchmark/reference) against the port, on the CPU.

- layer by layer on synthetic inputs: the frozen copies of the pose graph's
  dense solve and of PnP give the port's answers in float64, the port's
  float32 pose graph reads within the limits, and the control (bfloat16
  storage, float32) does not;
- the TF32 and bfloat16 emulations round what the hardware rounds;
- a run of the cut cell: every number the steady cell compares (tracker,
  K1, K2, K4, the solve's answer, marginalization) within its limit, and
  the control, the reference put in the program's place in the precision
  below, judged by the same limits, is not correct;
- a run of the cut cell with the timed path broken underneath reads
  `correct` false, once per fault the cell can have: an LM step (K4) that
  leaves the state unchanged, a step that leaves half of the landmarks out
  of its Schur complement, normal equations assembled from half of the
  factors' rows (the segment sums), a solve whose answer is never
  installed, K1
  rows altered on a third of the rows, a third of the published tracks
  moved where the tracker produces them, the tracker's lift through a
  camera model that is off, a marginalization prior altered
  where it is produced; and the pose graph's comparison, given an optimize
  that returns the VIO poses untouched or a covariance that is off, reads
  `correct` false. (One card: no exchange between chips to leave out.)
- a self-calibrating cut (estimate_extrinsic 1: K1's rows come from the
  extrinsic branch's row function, J_ex among them) is correct with K1
  read over those rows, and its control is not; J_ex altered on a third of
  the rows, or an answer whose tic and qic are never installed, reads
  `correct` false;
- an equidistant (fisheye) cut renders through its model, initializes,
  and reads the tracker's lift within its limit."""

import numpy as np
import pytest
import torch

from benchmark import faults
from benchmark.reference import check
from benchmark.reference.precision import Bf16Storage, Tf32Products, bf16_round, tf32_round

from conftest import run_cut


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, 3.14159265, -2.718281828], dtype=torch.float32)
    r = tf32_round(x)
    bits = r.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0**-11)
    a, b = torch.randn(30, 40), torch.randn(40, 20)
    with Tf32Products():
        c = a @ b
    torch.testing.assert_close(c, tf32_round(a) @ tf32_round(b), rtol=0, atol=0)
    assert (c - a @ b).abs().max() > 0


def test_bf16_storage_rounds_every_result():
    x = torch.tensor([1.0, 1.0 + 2.0**-9, 3.14159265], dtype=torch.float32)
    r = bf16_round(x)
    assert torch.all((r.view(torch.int32) & 0xFFFF) == 0)
    a = torch.randn(6, 6)
    with Bf16Storage():
        h = a @ a.T + 6 * torch.eye(6)
        c = torch.linalg.cholesky(h)
        h += 1.0
        v = h[0]
    for t in (h, c, v):
        torch.testing.assert_close(t, bf16_round(t), rtol=0, atol=0)
    assert (c - torch.linalg.cholesky(a @ a.T + 6 * torch.eye(6))).abs().max() > 0


def _graph(n=24, seed=0):
    """A drifted chain of n poses with two loops, as the keyframe database
    holds a segment; the edges measured with noise, so that no pose fits
    every edge and the optimum's cost is not 0."""
    from isvins_tpu_torch.geom.hostmath import quat_mul_np, quat_normalize_np

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi * 1.1, n)
    t = np.stack([3 * np.cos(ang), 3 * np.sin(ang), 0.1 * rng.normal(size=n)], 1)
    q = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], 1)
    t_drift = t + np.cumsum(rng.normal(scale=0.02, size=(n, 3)), 0)
    rel_t, rel_q = [], []
    for k in range(n - 1):
        qi_inv = q[k] * np.array([1, -1, -1, -1])
        R = _mat(qi_inv)
        rel_t.append(R @ (t[k + 1] - t[k]) + rng.normal(scale=0.01, size=3))
        rel_q.append(quat_normalize_np(quat_mul_np(qi_inv, q[k + 1])))
    rel_t.append(np.zeros(3))
    rel_q.append(np.array([1.0, 0, 0, 0]))
    loops = []
    for i, j in ((1, n - 3), (2, n - 2)):
        R = _mat(q[i] * np.array([1, -1, -1, -1]))
        loops.append((i, j, R @ (t[j] - t[i]),
                      quat_normalize_np(quat_mul_np(q[i] * np.array([1, -1, -1, -1]), q[j])), 50.0))
    return {"vio_t": t_drift, "vio_q": q, "edge_dt": np.array(rel_t), "edge_dq": np.array(rel_q),
            "edge_sqrt": np.tile(np.eye(6) * 30.0, (n, 1, 1)), "edge_valid": np.ones(n, bool),
            "rp_q": q.copy(), "rp_sqrt": np.tile(np.eye(2) * 10.0, (n, 1, 1)),
            "rp_valid": np.ones(n, bool), "seq": np.ones(n, np.int64), "loops": loops}


def _mat(q):
    return check._quat_to_mat(np.asarray(q, np.float64))


def _port_optimize(rows, dtype):
    """The port's dense solve on the same segment, built as
    posegraph/optimize.optimize_pose_graph builds it."""
    from isvins_tpu_torch.posegraph.optimize import _optimize_core

    n = len(rows["vio_t"])
    fixed = np.zeros(n, bool)
    fixed[0] = True
    ev = rows["edge_valid"].copy()
    ev[-1] = False
    L = len(rows["loops"])
    li = np.array([l[0] for l in rows["loops"]])
    lj = np.array([l[1] for l in rows["loops"]])
    host = (rows["vio_t"], rows["vio_q"], rows["edge_dt"], rows["edge_dq"], rows["edge_sqrt"], ev,
            rows["rp_q"], rows["rp_sqrt"], rows["rp_valid"], li, lj,
            np.array([l[2] for l in rows["loops"]]), np.array([l[3] for l in rows["loops"]]),
            np.array([l[4] for l in rows["loops"]]), np.ones(L, bool), fixed)
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in host]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    return _optimize_core(*args, iters=10)


class _Captured:
    """What benchmark/capture.Captures holds, with only pose-graph solves."""

    def __init__(self, optimizes):
        self.tracks, self.kernels, self.solves, self.margs, self.loops = {}, {}, [], [], []
        self.lifts = []
        self.optimizes = optimizes


_PG = ("pg_cost_excess", "pg_cov_rel_gap")


def _judge_pg(rows, out, control=False):
    cfg = _cfg()
    counts = {k: 4 for k in ("tracks", "solves", "margs", "loops", "optimizes")}
    cap = _Captured([{"inputs": rows, "iters": 10, "out": out}])
    readings = {k: v for k, v in check.evaluate(cap, None, cfg, counts, 7, "cpu",
                                                 control=control).items() if k in _PG}
    return check.judge(readings, {k: cfg["correct_limits"][k] for k in _PG}), readings


def test_pose_graph_reference_is_the_ports_solve():
    """The copy's solve is the port's in float64; the port's float32 solve
    reads within the pose graph's limits, and the control (bfloat16 storage
    of every float32 result) does not."""
    rows = _graph()
    ref = check.Reference(_cfg(), "cpu")
    r = tuple(x.numpy() for x in ref.optimize(rows, 10))
    p64 = tuple(x.numpy() for x in _port_optimize(rows, torch.float64))
    for a, b in zip(r, p64):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    p32 = tuple(x.double().numpy() for x in _port_optimize(rows, torch.float32))
    (ok, _), readings = _judge_pg(rows, p32)
    assert ok, readings
    (ok, _), low = _judge_pg(rows, None, control=True)
    assert not ok, low
    assert any(low[k].value > 3 * readings[k].value for k in _PG), (low, readings)


@pytest.mark.parametrize("fault, number", [("the_vio_poses_untouched", "pg_cost_excess"),
                                           ("a_covariance_off", "pg_cov_rel_gap")])
def test_a_pose_graph_fault_is_not_correct(fault, number):
    rows = _graph()
    t, q, cov, cost = (x.double().numpy() for x in _port_optimize(rows, torch.float32))
    out = ((rows["vio_t"], rows["vio_q"], cov, cost) if fault == "the_vio_poses_untouched"
           else (t, q, cov * 1.5, cost))
    (ok, checks), _ = _judge_pg(rows, out)
    value, limit = {n: (v, lim) for n, v, lim, _ in checks}[number]
    assert not ok and not value <= limit, checks


def test_pnp_reference_is_the_ports_pnp():
    from isvins_tpu_torch.initial.pnp import pnp_ransac_gn

    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 3)) + [0.0, 0.0, 6.0]
    x = X[:, :2] / X[:, 2:3] + rng.normal(scale=1e-3, size=(60, 2))
    x[:6] += 0.2  # outliers
    q0, t0 = np.array([0.999, 0.02, -0.01, 0.03]), np.array([0.05, -0.02, 0.1])
    q0 = q0 / np.linalg.norm(q0)
    ref = check.Reference(_cfg(), "cpu")
    r = ref.pnp((X, x, q0, t0), {"thresh": 10.0 / 460.0})
    p = pnp_ransac_gn(X, x, q0, t0, thresh=10.0 / 460.0, device="cpu")
    assert check.pnp_gap(r, p) < 1e-12
    low = check.Reference(_cfg(), "cpu", control=True).pnp((X, x, q0, t0), {"thresh": 10.0 / 460.0})
    assert check.pnp_gap(r, low) > 1e-9


def _cfg():
    import json

    from conftest import ROOT

    return json.loads((ROOT / "benchmark" / "configs" / "euroc_mav.json").read_text())


# ------------------------------------------------------- runs of the cut cell

def test_cut_run_is_correct_and_its_control_is_not():
    res = run_cut(seed=2**40 + 1, control=True)
    ctl = res["_control"]
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert set(limits) == set(check.NUMBERS) - set(check.LOOP_NUMBERS)
    for k in limits:
        assert ctl[k]["answers"] > 0, k
        assert ctl[k]["program"] <= limits[k], k
    assert res["_control_correct"] is False, res["_control_checks"]
    assert set(res["_control_checks"]) == set(limits)


def _fails(c):
    """A check's line fails: a reading that is not finite ("inf", "nan") or
    over its limit."""
    return isinstance(c["value"], str) or not c["value"] <= c["limit"]


def _wrap(module: str, name: str, make):
    """A fault: `module.name` replaced, where the port looks it up, by
    make(the original)."""
    def plant(monkeypatch):
        import importlib

        m = importlib.import_module(module)
        orig = getattr(m, name)
        return lambda system: monkeypatch.setattr(m, name, make(orig))
    return plant


def _step_of_zeros(orig):
    def step(H, b, W, h, b_l, lam, n_pose):
        dx, dl = orig(H, b, W, h, b_l, lam, n_pose)
        return torch.zeros_like(dx), torch.zeros_like(dl)
    return step


def _half_the_landmarks(orig):
    def step(H, b, W, h, b_l, lam, n_pose):
        W2 = W.clone()
        W2[1::2] = 0.0
        return orig(H, b, W2, h, b_l, lam, n_pose)
    return step


def _tracks_moved(every: int):
    """Every `every`-th track the forward LK publishes moved 0.25 px."""
    def make(orig):
        def lk(*a, **k):
            p, ok, err = orig(*a, **k)
            if k.get("levels") != 1:
                p = p.clone()
                p[::every] += 0.25
            return p, ok, err
        return lk
    return make


def _k1_rows_off(orig):
    def rows(*a):
        r, *rest = orig(*a)
        r = r.clone()
        r[::3] += 1e-2
        return (r, *rest)
    return rows


def _half_the_rows(orig):
    def half(plan, src):
        src = src.clone()
        src[1::2] = 0.0
        return orig(plan, src)
    return half


def _marg_prior_off(orig):
    def back(*a, **k):
        out = orig(*a, **k)
        return (out[0] + 1e-3,) + tuple(out[1:])
    return back


def _never_installed(monkeypatch):
    def plant(system):
        system.estimator._install_solution = lambda *a, **k: None
    return plant


def _planted(name: str):
    """A fault of benchmark/faults.py (it breaks the System's own objects)."""
    return lambda monkeypatch: faults.FAULTS[name]


def _j_ex_off(orig):
    def rows(*a):
        r, J_pi, J_pj, J_ex, J_dep = orig(*a)
        J_ex = J_ex.clone()
        J_ex[::3] += 1e-2
        return r, J_pi, J_pj, J_ex, J_dep
    return rows


_WINDOW = "isvins_tpu_torch.solver.window"
# each fault: how it is planted, the number that has to fail, the run's seed
FAULTS = {
    "a_step_of_zeros": (_wrap(_WINDOW, "linstep", _step_of_zeros), "k4_step_backward_err",
                        2**33 + 5),
    "half_of_the_landmarks_left_out_of_the_step": (
        _wrap(_WINDOW, "linstep", _half_the_landmarks), "k4_step_backward_err", 2**33 + 5),
    "every_track_moved": (_wrap("isvins_tpu_torch.frontend.tracker", "pyramidal_lk",
                                _tracks_moved(1)), "trk_lk_px", 2**35 + 9),
    "a_third_of_the_tracks_moved": (_wrap("isvins_tpu_torch.frontend.tracker", "pyramidal_lk",
                                          _tracks_moved(3)), "trk_lk_px", 2**39 + 5),
    "k1_rows_altered_on_a_third": (_wrap("isvins_tpu_torch.ops.proj", "proj_rows", _k1_rows_off),
                                   "k1_rows_rel_gap", 2**38 + 7),
    "normal_equations_from_half_the_rows": (_wrap(_WINDOW, "segment_sum", _half_the_rows),
                                            "normal_eq_rel_gap", 2**42 + 13),
    "a_solve_never_installed": (_never_installed, "solve_cost_excess", 2**37 + 11),
    "a_marginalization_prior_altered": (_wrap("isvins_tpu_torch.estimator.estimator",
                                              "marg_backward", _marg_prior_off),
                                        "marg_rel_gap", 2**36 + 3),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    plant, number, seed = FAULTS[fault]
    res = run_cut(seed=seed, fault=plant(monkeypatch))
    assert not res["correct"]
    assert _fails(res["checks"][number]), res["checks"]


def test_the_trackers_lift_off_is_not_correct():
    """The tracker's camera model with fx 0.1 % off, planted after set-up.
    The window's first collect returns a frame the pipeline dispatched in
    set-up, lifted before the fault: the window runs long enough (8 s)
    for the sampled packets to reach the frames after it."""
    res = run_cut(seed=2**41 + 3, seconds=8, fault=faults.FAULTS["lift_fx_off"])
    lift = res["checks"]["trk_lift_px"]
    assert not res["correct"] and lift["answers"] > 0 and _fails(lift), res["checks"]


# ------------------------------------------- cuts with another sensor model

def test_selfcal_cut_is_correct_and_its_control_is_not():
    res = run_cut(seed=2**40 + 1, control=True, config="cut_vio_selfcal")
    assert res["correct"], res["checks"]
    assert res["checks"]["k1_rows_rel_gap"]["answers"] > 0
    assert res["_control_correct"] is False, res["_control_checks"]


EXTRINSIC_FAULTS = {
    "j_ex_altered_on_a_third": (_wrap(_WINDOW, "projection_residual_jacobians", _j_ex_off),
                                "k1_rows_rel_gap", 2**40 + 7),
    "the_extrinsic_never_installed": (_planted("extrinsic_never_installed"), "solve_cost_excess",
                                      2**40 + 9),
}


@pytest.mark.parametrize("fault", sorted(EXTRINSIC_FAULTS))
def test_an_extrinsic_fault_is_not_correct(monkeypatch, fault):
    plant, number, seed = EXTRINSIC_FAULTS[fault]
    res = run_cut(seed=seed, fault=plant(monkeypatch), config="cut_vio_selfcal")
    assert not res["correct"]
    assert _fails(res["checks"][number]), res["checks"]


def test_equidistant_cut_reads_the_lift_within_its_limit():
    res = run_cut(seed=2**43 + 1, config="cut_vio_equidistant")
    lift = res["checks"]["trk_lift_px"]
    assert lift["answers"] > 0 and lift["value"] <= lift["limit"], lift
    assert res["correct"], res["checks"]

"""The deterministic segment sums of the port's normal equations
(solver/window.segment_plan, segment_sum, normal_plans), and the device
guard of the kernel launches (ops/_lib.launch).

index_add_ sums in an order that changes from run to run on the card; the
segment sum must equal it to rounding, add in an order fixed by the plan
(so its bits are too), and keep every sequence of a batched index set to
its own slots. That the solves still match the
JAX package is held by tests/test_torch_solver.py and
tests/test_torch_parallel.py. No jax here."""

import types

import numpy as np
import pytest
import torch

from isvins_tpu_torch.solver import window
from isvins_tpu_torch.solver.window import normal_plans, segment_plan, segment_sum


def _index_add(slots, src, n_slots):
    out = torch.zeros((n_slots,) + src.shape[1:], dtype=src.dtype)
    return out.index_add_(0, slots, src)


def _draw(seed, R, n_slots, k, dtype, masked=0.2):
    """R rows of shape k over n_slots slots, most slots repeated, a few
    empty, a share of rows masked (zero, on slot 0, as a padded factor)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, max(n_slots - 2, 1), R)  # the last two slots stay empty
    src = rng.normal(size=(R,) + k) * 10.0 ** rng.integers(-3, 3, size=(R,) + (1,) * len(k))
    mask = rng.random(R) < masked
    slots[mask] = 0
    src[mask] = 0.0
    return torch.as_tensor(slots), torch.as_tensor(src, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,n_slots,k", [(512, 8, (6, 6)), (3072, 324, (6,)), (3072, 1000, (116,)),
                                         (1, 3, (2,))])
def test_segment_sum_equals_index_add(dtype, R, n_slots, k):
    """Against index_add_ to rounding (relative to the slot's sum of
    magnitudes), empty slots exactly 0."""
    slots, src = _draw(R + n_slots, R, n_slots, k, dtype)
    out = segment_sum(segment_plan(slots, n_slots), src)
    ref = _index_add(slots, src, n_slots)
    mag = _index_add(slots, src.abs(), n_slots)
    eps = torch.finfo(dtype).eps
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= 4 * eps * np.log2(R + 1) * mag).all())
    assert bool((out[-2:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [600, 33])
def test_segment_sum_adds_in_a_fixed_order(dtype, R):
    """Bit for bit: each slot's rows in runs of SEGMENT_RUN in row order,
    each run summed left to right, then the runs left to right. The order
    is a property of the plan, not of the run."""
    chunk = window.SEGMENT_RUN
    slots, src = _draw(7, R, 5, (3,), dtype, masked=0.0)
    plan = segment_plan(slots, 5)
    out = segment_sum(plan, src)
    for s in range(5):
        rows = torch.nonzero(slots == s)[:, 0].tolist()
        acc = torch.zeros(3, dtype=dtype)
        for r0 in range(0, len(rows), chunk):
            run = torch.zeros(3, dtype=dtype)
            for row in rows[r0: r0 + chunk]:
                run = run + src[row]
            acc = acc + run
        assert torch.equal(out[s], acc), s
    assert torch.equal(segment_sum(segment_plan(slots, 5), src), out)
    assert plan.run_ids.shape == (R // chunk + 5,)  # the bound, whatever the data


def _proj(rng, lead, B, F, N):
    """Projection factor indices with leading sequence axes: host != observer
    frames, landmarks repeated, a masked tail on slot 0."""
    idx_i = rng.integers(0, B, lead + (N,))
    idx_j = (idx_i + rng.integers(1, B, lead + (N,))) % B
    fidx = rng.integers(0, F, lead + (N,))
    valid = rng.random(lead + (N,)) > 0.2
    idx_i[~valid], idx_j[~valid], fidx[~valid] = 0, 0, 0
    t = lambda a: torch.as_tensor(a)
    zeros = torch.zeros(lead + (N, 3))
    return window.ProjFactors(t(idx_i), t(idx_j), t(fidx), zeros, zeros, t(valid))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_normal_plans_keep_sequences_apart(lead):
    """A batched plan (slots offset by the sequence) gives each sequence
    exactly the sums of its own single plan, for the frames (host-side rows
    then observer-side rows), the pairs and the landmarks."""
    dims = window.WindowDims(B=6, Vo=3, F=40, N=200)
    rng = np.random.default_rng(11)
    proj = _proj(rng, lead, dims.B, dims.F, dims.N)
    plans = normal_plans(proj, dims)
    S = int(np.prod(lead)) if lead else 1
    k = (4,)
    src_i = torch.as_tensor(rng.normal(size=lead + (dims.N,) + k), dtype=torch.float32)
    src_j = torch.as_tensor(rng.normal(size=lead + (dims.N,) + k), dtype=torch.float32)
    flat = lambda a: a.reshape((S, dims.N) + k)
    frames = segment_sum(plans.frames, torch.cat([src_i.reshape((-1,) + k),
                                                  src_j.reshape((-1,) + k)]))
    pairs = segment_sum(plans.pairs, src_i.reshape((-1,) + k))
    marks = segment_sum(plans.landmarks, src_j.reshape((-1,) + k))
    assert frames.shape == (S * dims.B,) + k and marks.shape == (S * dims.F,) + k
    ii, jj, ff = (a.reshape(S, dims.N) for a in (proj.idx_i, proj.idx_j, proj.fidx))
    for s in range(S):
        one = window.ProjFactors(ii[s], jj[s], ff[s], None, None, None)
        p1 = normal_plans(one, dims)
        si, sj = flat(src_i)[s], flat(src_j)[s]
        assert torch.equal(frames.reshape(S, dims.B, *k)[s],
                           segment_sum(p1.frames, torch.cat([si, sj])))
        assert torch.equal(pairs.reshape(S, dims.B ** 2, *k)[s], segment_sum(p1.pairs, si))
        assert torch.equal(marks.reshape(S, dims.F, *k)[s], segment_sum(p1.landmarks, sj))
        # and index_add_ to rounding
        ref = (_index_add(ii[s], si, dims.B) + _index_add(jj[s], sj, dims.B))
        torch.testing.assert_close(frames.reshape(S, dims.B, *k)[s], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_build_normal_equations_same_bits_with_and_without_plans(lead):
    """The solve's plans (built once in _lm) give the same normal equations
    as plans built inside build_normal_equations, and a second build gives
    the same bits."""
    from isvins_tpu_torch.parallel.sharded import make_batch_problem

    dims = window.WindowDims(B=6, Vo=3, F=32, N=96)
    prob = make_batch_problem(2, dims, torch.float32, seed=4, device="cpu")
    if not lead:
        squeeze = lambda t: (type(t)(*(squeeze(x) for x in t)) if isinstance(t, tuple)
                             else t[0].contiguous())
        prob = [squeeze(x) for x in prob[:4]] + [prob[4], prob[5]]
    else:
        prob = list(prob[:4]) + [prob[4].expand(2, 3), prob[5].expand(2)]
    a = window.build_normal_equations(*prob, dims)
    b = window.build_normal_equations(*prob, dims, plans=normal_plans(prob[2], dims))
    c = window.build_normal_equations(*prob, dims)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_launch_runs_under_the_tensors_device(monkeypatch):
    """ops/_lib.launch makes the tensors' device current around the C call
    (ROADMAP C9): a launch for cuda:1 enters torch.cuda.device(cuda:1) and
    calls the kernel inside it, on that device's stream, whatever device
    the thread had current. torch.cuda and the library are patched: no card
    is needed, and a one-card machine cannot check a real cuda:1 launch."""
    from isvins_tpu_torch.ops import _lib

    events = []

    class FakeGuard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))
            return False

    def current_stream(device=None):
        events.append(("stream", torch.device(device)))
        return types.SimpleNamespace(cuda_stream=1234)

    def kernel(*args):
        events.append(("call", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", FakeGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_lib, "lib", lambda: types.SimpleNamespace(isv_noop=kernel))
    dev = torch.device("cuda:1")
    _lib.launch("isv_noop", 7, device=dev)
    assert events == [("enter", dev), ("stream", dev), ("call", (7, 1234)), ("exit", dev)]
    # a failing kernel still leaves the guard, and raises
    events.clear()
    monkeypatch.setattr(_lib, "lib", lambda: types.SimpleNamespace(isv_noop=lambda *a: 700))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _lib.launch("isv_noop", device=dev)
    assert events[0] == ("enter", dev) and events[-1] == ("exit", dev)

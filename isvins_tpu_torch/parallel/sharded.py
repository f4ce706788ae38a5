"""Sequence-data-parallel window solves (port of
isvins_tpu/parallel/sharded.py): N independent sliding-window problems as a
leading axis of every leaf, solved by ONE batched program per device
(solver.solve_window_batched), and the synthetic problems that feed it.

The reference shards the leading axis over a `jax.sharding.Mesh`; here a
mesh is a list of torch devices. With one device the whole batch is one
program; with several, the leading axis is cut into contiguous chunks, one
per device, with no communication, and the results are concatenated on the
first device."""

from __future__ import annotations

import numpy as np
import torch

from ..factors import ImuNoise, integrate_segment
from ..geom import so3_exp_quat
from ..device import resolve_device
from ..solver import (ImuFactors, PriorState, ProjFactors, WindowDims, WindowState,
                      solve_window_batched)
from ..utils.convert import from_numpy_tree, tree_map


def make_mesh(devices=None):
    """The devices a batch is spread over, as a list of torch devices: None
    is the one CUDA card; an int n is the first n cards; a list of devices
    is taken as given (["cpu", "cpu"] runs two chunks on the CPU)."""
    if devices is None:
        return [resolve_device(None)]
    if isinstance(devices, int):
        return [resolve_device(f"cuda:{k}") for k in range(devices)]
    return [resolve_device(d) for d in devices]


def sharded_batch_solve(devices, dims: WindowDims, iters: int = 10):
    """Returns (step, shard_leading) as the reference does.

    `shard_leading(tree)` moves a tree whose every leaf has the leading
    sequence axis to the device; with several devices it returns a list,
    chunk k of the leading axis (contiguous chunks) on devices[k].
    `step(state, imu, proj, priors, G, psi, info=None)` solves the batch with
    solve_window_batched and returns (state, cost (NB,)); G (3,) and psi ()
    serve every sequence, as in the reference. `info`, when given, receives
    the LM iterations run (the most of any chunk). With several devices the
    four trees are plain (sharded here) or the lists shard_leading made;
    every chunk is solved on its own device, with no communication, and the
    results are concatenated on devices[0]."""
    devices = make_mesh(devices)
    nd = len(devices)

    def shard_leading(tree):
        first = []
        tree_map(lambda a: first.append(a.shape[0]), tree)
        cuts = [round(k * first[0] / nd) for k in range(nd + 1)]
        shards = [tree_map(lambda a, k=k: a[cuts[k]: cuts[k + 1]].to(devices[k]), tree)
                  for k in range(nd)]
        return shards[0] if nd == 1 else shards

    def step(state, imu, proj, priors, G, psi, info=None):
        if nd == 1:
            return solve_window_batched(state, imu, proj, priors, G, psi, dims, iters=iters,
                                        info=info)
        shards = (state, imu, proj, priors)
        if isinstance(state, WindowState):  # plain trees: shard them here
            shards = zip(*shard_leading(shards))
        infos = [{} for _ in devices]
        outs = [solve_window_batched(*sh, G.to(dev), psi.to(dev), dims, iters=iters, info=i)
                for sh, dev, i in zip(zip(*shards), devices, infos)]
        if info is not None:
            info["iterations"] = max(i["iterations"] for i in infos)
        gather = lambda *parts: torch.cat([p.to(devices[0]) for p in parts], dim=0)
        return tree_map(gather, *(o[0] for o in outs)), gather(*(o[1] for o in outs))

    return step, shard_leading


def make_batch_problem(n_seq: int, dims: WindowDims, dtype=torch.float32, seed: int = 0,
                       device=None):
    """Batch of `n_seq` random but well-conditioned window problems with a
    leading sequence axis on every leaf; the same numbers as the JAX
    package's make_batch_problem at the same seed. `device` None is the CUDA
    card. Returns (state, imu, proj, priors, G, psi)."""
    device = resolve_device(device)
    B, F, N, Vo = dims.B, dims.F, dims.N, dims.Vo

    def mk_seq(s):
        rng_s = np.random.default_rng(seed * 1000 + s)
        P_ = np.cumsum(rng_s.normal(size=(B, 3)) * 0.05 + np.array([0.2, 0, 0]), axis=0)
        phi = rng_s.normal(size=(B, 3)) * 0.02
        Q_ = so3_exp_quat(torch.as_tensor(phi)).numpy()
        V_ = np.gradient(P_, 0.1, axis=0)
        dep = rng_s.uniform(0.1, 0.5, size=F)
        idx_i = rng_s.integers(0, B - 1, size=N)
        gap = rng_s.integers(1, 4, size=N)
        idx_j = np.minimum(idx_i + gap, B - 1)
        fidx = rng_s.integers(0, F, size=N)
        pts_i = np.concatenate([rng_s.normal(size=(N, 2)) * 0.2, np.ones((N, 1))], axis=1)
        pts_j = pts_i + rng_s.normal(size=(N, 3)) * np.array([0.01, 0.01, 0.0])
        C = 24
        dts = np.zeros((B - 1, C))
        dts[:, :20] = 0.005
        accs = rng_s.normal(size=(B - 1, C, 3)) * 0.05 + np.array([0, 0, 9.81])
        gyrs = rng_s.normal(size=(B - 1, C, 3)) * 0.01
        return P_, Q_, V_, dep, idx_i, idx_j, fidx, pts_i, pts_j, dts, accs, gyrs

    cols = [mk_seq(s) for s in range(n_seq)]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    stack = lambda i: np.stack([c[i] for c in cols]).astype(np_dt)
    idx = lambda i: np.stack([c[i] for c in cols]).astype(np.int32)
    P_, Q_, V_, dep = stack(0), stack(1), stack(2), stack(3)
    pts_i, pts_j = stack(7), stack(8)
    dts, accs, gyrs = (torch.as_tensor(stack(i), device=device) for i in (9, 10, 11))

    noise = ImuNoise(0.1, 0.01, 1e-3, 1e-4)
    zeros3 = torch.zeros(dts.shape[:2] + (3,), dtype=dtype, device=device)
    pre = integrate_segment(dts, accs, gyrs, accs[..., 0, :], gyrs[..., 0, :],
                            zeros3, zeros3, noise)
    imu = ImuFactors.create(pre, torch.ones(dts.shape[:2], dtype=torch.bool, device=device))

    z = lambda *s: np.zeros((n_seq,) + s, np_dt)
    state = WindowState(P=P_, Q=Q_, V=V_, Ba=z(B, 3), Bg=z(B, 3), tic=z(3),
                        qic=np.tile(np.array([1.0, 0, 0, 0], np_dt), (n_seq, 1)), dep=dep)
    proj = ProjFactors(idx_i=idx(4), idx_j=idx(5), fidx=idx(6), pts_i=pts_i, pts_j=pts_j,
                       valid=np.ones((n_seq, N), bool))
    e = PriorState.empty(Vo, np_dt)
    rep = lambda a: np.stack([np.asarray(a)] * n_seq)
    priors = PriorState(*(rep(a) if not isinstance(a, tuple) else type(a)(*(rep(x) for x in a))
                          for a in e))
    priors = priors._replace(
        se3_t=P_[:, 0], se3_q=Q_[:, 0],
        se3_sqrt=np.tile(np.eye(6, dtype=np_dt)[None] * 100.0, (n_seq, 1, 1)),
        se3_valid=np.ones(n_seq, bool),
        vb=np.concatenate([V_[:, Vo - 1], np.zeros((n_seq, 6), np_dt)], axis=1),
        vb_sqrt=np.tile(np.eye(9, dtype=np_dt)[None] * 10.0, (n_seq, 1, 1)),
        vb_valid=np.ones(n_seq, bool),
    )
    G = torch.tensor([0.0, 0.0, 9.81], dtype=dtype, device=device)
    psi = torch.tensor(460.0, dtype=dtype, device=device)
    state, proj, priors = from_numpy_tree((state, proj, priors), device)
    return state, imu, proj, priors, G, psi

"""Synthetic window problems (port of isvins_tpu/parallel/sharded.py
`make_batch_problem`; the sharded batch solve is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from ..factors import ImuNoise, integrate_segment
from ..geom import so3_exp_quat
from ..solver import ImuFactors, PriorState, ProjFactors, WindowDims, WindowState
from ..utils.convert import from_numpy_tree


def make_batch_problem(n_seq: int, dims: WindowDims, dtype=torch.float32, seed: int = 0,
                       device="cpu"):
    """Batch of `n_seq` random but well-conditioned window problems with a
    leading sequence axis on every leaf; the same numbers as the JAX
    package's make_batch_problem at the same seed. Returns (state, imu,
    proj, priors, G, psi)."""
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

"""Edge-sharded pose-graph Gauss-Newton over a list of devices (port of
isvins_tpu/parallel/distributed.py).

The graph's edge families (relative-pose edges, roll-pitch edges,
Huber-weighted loop edges) are cut into nd contiguous chunks, one per entry
of the device list, as the reference's `shard_map` cuts a leading axis. Each
chunk assembles its partial normal equations; the dense (6K, 6K) system is
their sum in mesh order (the reference's `psum`), solved once by dense
Cholesky on the first device. With `with_cov=True` the per-pose 6x6 blocks
of H^-1 are returned too: each chunk solves its own 6K/nd block-columns of
the inverse against identity columns and keeps its diagonal blocks, which
are concatenated in mesh order (the reference's `all_gather`).

One process drives the whole mesh. A device listed several times runs its
chunks as one batched program (a leading shard axis on every tensor);
distinct devices each run their own group. The sums are taken chunk by chunk
in mesh order either way, never by atomics, so two runs give the same bits.
The helpers here (`_normal_equations`, the groups, the uploads) are shared
with the nested-dissection solve in dd_solver.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..factors.preintegration import cholesky_nan
from ..factors.priors import relpose_residual_jacobians, rollpitch_residual_jacobians
from ..geom import quat_mul, quat_normalize, so3_exp_quat
from .sharded import make_mesh

_EPS = 1e-8  # the damping both solves add to H (distributed.py:212)


def _huber_weight(r_norm_sq, delta):
    """sqrt of the IRLS weight for Huber loss rho(s) with s = ||r||^2."""
    r = torch.sqrt(torch.clamp(r_norm_sq, min=1e-18))
    return torch.sqrt(torch.where(r <= delta, torch.ones_like(r), delta / r))


def _masked(valid, x):
    """x on valid rows, exactly 0 elsewhere: a non-finite payload or pose on a
    masked row would survive `* 0` (ROADMAP C5)."""
    v = valid.reshape(valid.shape + (1,) * (x.dim() - valid.dim()))
    return torch.where(v, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _cho_solve(B, L):
    """X with L Lᵀ X = B, by two triangular solves (cuBLAS). A batched
    torch.cholesky_solve on a card goes through MAGMA, which holds the host
    until the card has finished its queued work."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), Y, upper=True)


def _expand(Jb, idx, C):
    """(G, n, r, 6) Jacobian blocks placed at pose columns idx (G, n) of C
    poses by one-hot expansion -> (G, n * r, 6C)."""
    oh = F.one_hot(idx, C).to(Jb.dtype)
    G, n, r = Jb.shape[:3]
    return torch.einsum("gnrk,gnc->gnrck", Jb, oh).reshape(G, n * r, 6 * C)


def _normal_equations(tt, qq, s, C, delta, anneal=None):
    """The shards' partial normal equations H (G, 6C, 6C), b (G, 6C) and
    costs (G,). `s` holds each family's rows with a leading shard axis G:
    poses are gathered from (tt, qq) by global index (`e_gi`, `e_gj`, `r_gi`,
    `l_gi`, `l_gj`) and their Jacobian blocks placed among C poses at `e_ai`,
    `e_aj`, `r_ai`, `l_ai`, `l_aj`. Loop edges carry sqrt(w) I with a
    Huber(delta) IRLS weight; `anneal` in (0, 1] raises each loop's delta to
    max(delta, anneal ||r_w||), the graduated non-convexity of
    posegraph/optimize.py. `s["augmask"]` (G, 6C), where given, zeroes
    columns."""
    e_gi, e_gj, r_gi, l_gi, l_gj = s["e_gi"], s["e_gj"], s["r_gi"], s["l_gi"], s["l_gj"]
    r, Ji, Jj = relpose_residual_jacobians(s["e_dt"], s["e_dq"], tt[e_gi], qq[e_gi],
                                           tt[e_gj], qq[e_gj])
    S, ok = s["e_sqrt"], s["e_ok"]
    rE, JiE, JjE = (_masked(ok, S @ x) for x in (r[..., None], Ji, Jj))

    r, J = rollpitch_residual_jacobians(s["r_q"], qq[r_gi])
    S, ok = s["r_sqrt"], s["r_ok"]
    rR, JR = _masked(ok, S @ r[..., None]), _masked(ok, S @ J)

    r, Ji, Jj = relpose_residual_jacobians(s["l_dt"], s["l_dq"], tt[l_gi], qq[l_gi],
                                           tt[l_gj], qq[l_gj])
    w = torch.sqrt(torch.clamp(s["l_w"], min=0.0))
    rsq = torch.sum((w[..., None] * r) ** 2, dim=-1)
    d = delta
    if anneal is not None:
        d = torch.clamp(anneal * torch.sqrt(rsq + 1e-18), min=delta)
    m = (_huber_weight(rsq, d) * w)[..., None]
    ok = s["l_ok"]
    rL, JiL, JjL = _masked(ok, r * m), _masked(ok, Ji * m[..., None]), _masked(ok, Jj * m[..., None])

    J = torch.cat([_expand(JiE, s["e_ai"], C) + _expand(JjE, s["e_aj"], C),
                   _expand(JR, s["r_ai"], C),
                   _expand(JiL, s["l_ai"], C) + _expand(JjL, s["l_aj"], C)], dim=1)
    res = torch.cat([rE.flatten(1), rR.flatten(1), rL.flatten(1)], dim=1)
    if "augmask" in s:
        J = J * s["augmask"][:, None, :]
    Jt = J.transpose(1, 2)
    return Jt @ J, -(Jt @ res[..., None])[..., 0], 0.5 * torch.sum(res * res, dim=1)


def _groups(devices):
    """The mesh's shards grouped by device, in mesh order: [(device, [k, ...])]."""
    out = {}
    for k, d in enumerate(devices):
        out.setdefault(d, []).append(k)
    return list(out.items())


def _mesh_order(groups, parts):
    """Per-group results with a leading shard axis -> one tensor per shard, in
    mesh order, on the first group's device."""
    home = groups[0][0]
    out = [None] * sum(len(ks) for _, ks in groups)
    for (_, ks), p in zip(groups, parts):
        p = p.to(home)
        for g, k in enumerate(ks):
            out[k] = p[g]
    return out


def _mesh_sum(shards):
    """The shards' partials summed one by one in mesh order (the `psum`)."""
    acc = shards[0]
    for p in shards[1:]:
        acc = acc + p
    return acc


def _host(a):
    """A caller's array as host numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _upload(a, dev, fdtype):
    """A copy of host numpy on `dev` (floats as `fdtype`, indices as int64),
    by a non-blocking copy, which stages pageable memory at once and never
    waits on the device."""
    a = np.asarray(a)
    kind = {"f": fdtype, "i": np.int64, "u": np.int64}.get(a.dtype.kind, a.dtype)
    return torch.from_numpy(np.array(a, dtype=kind, order="C")).to(dev, non_blocking=True)


def _np_dtype(t):
    """The solve's dtype: that of the seed translations t (f32 or f64)."""
    dt = _host(t).dtype
    if dt not in (np.float32, np.float64):
        raise TypeError(f"t must be float32 or float64, not {dt}")
    return dt


def _no_loops(nd, dtype):
    """nd masked loop rows (distributed.py:147-154)."""
    return (np.zeros(nd, np.int32), np.zeros(nd, np.int32), np.zeros((nd, 3), dtype),
            np.tile(np.array([1.0, 0, 0, 0], dtype), (nd, 1)), np.zeros(nd, dtype),
            np.zeros(nd, bool))


def _retract(tt, qq, d):
    """Poses moved by the step d (K, 6) = [dt | dtheta]."""
    return tt + d[:, :3], quat_normalize(quat_mul(qq, so3_exp_quat(d[:, 3:])))


def distributed_pose_graph_solve(devices, t, q, active, fixed,
                                 e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
                                 rp_i, rp_q, rp_sqrt, rp_valid,
                                 loop_i=None, loop_j=None, loop_dt=None, loop_dq=None,
                                 loop_w=None, loop_valid=None,
                                 iters: int = 10, with_cov: bool = False,
                                 huber_delta: float = 0.1):
    """Gauss-Newton with edge-sharded assembly over `devices` (a list of
    torch devices, as parallel.make_mesh returns, or what it takes).

    t (K,3), q (K,4), active, fixed (K,) are replicated; the edge (E,),
    roll-pitch (Krp,) and loop (L,) families are cut into len(devices)
    contiguous chunks, so E, Krp and L must divide by it (pad with invalid
    rows); with_cov=True also needs K to. Arrays are host numpy (tensors
    are copied back first); the solve's dtype is t's. Returns torch tensors
    on devices[0]: (t_opt, q_opt, cost), or (t_opt, q_opt, cov_blocks
    (K,6,6), cost) with covariance."""
    devices = make_mesh(devices)
    nd = len(devices)
    fdt = _np_dtype(t)
    K = _host(t).shape[0]
    if with_cov and K % nd != 0:
        raise ValueError(
            f"with_cov=True requires K ({K}) divisible by mesh size ({nd}); "
            "pad poses (active=False) to a multiple of the mesh size")
    if loop_i is None:
        loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid = _no_loops(nd, fdt)
    fam = {"e_gi": e_i, "e_gj": e_j, "e_dt": e_dt, "e_dq": e_dq, "e_sqrt": e_sqrt,
           "e_ok": e_valid, "r_gi": rp_i, "r_q": rp_q, "r_sqrt": rp_sqrt, "r_ok": rp_valid,
           "l_gi": loop_i, "l_gj": loop_j, "l_dt": loop_dt, "l_dq": loop_dq, "l_w": loop_w,
           "l_ok": loop_valid}
    fam = {k: _host(v) for k, v in fam.items()}
    for k in ("e_ok", "r_ok", "l_ok"):
        if fam[k].shape[0] % nd:
            raise ValueError(f"{k[0]} family has {fam[k].shape[0]} rows, not divisible by the "
                             f"mesh size {nd}; pad with invalid rows")
    chunked = {k: v.reshape((nd, v.shape[0] // nd) + v.shape[1:]) for k, v in fam.items()}
    groups = _groups(devices)
    home = devices[0]
    shards = []
    for dev, ks in groups:
        s = {k: _upload(v[ks], dev, fdt) for k, v in chunked.items()}
        s.update(e_ai=s["e_gi"], e_aj=s["e_gj"], r_ai=s["r_gi"], l_ai=s["l_gi"], l_aj=s["l_gj"])
        shards.append(s)
    tt, qq = _upload(_host(t), home, fdt), _upload(_host(q), home, fdt)
    colmask = _upload(np.repeat(~_host(fixed).astype(bool) & _host(active).astype(bool), 6)
                      .astype(fdt), home, fdt)
    D = 6 * K
    eye = torch.eye(D, dtype=tt.dtype, device=home)

    def build(tt, qq, anneal=None):
        poses = [(tt.to(dev), qq.to(dev)) for dev, _ in groups]
        parts = [_normal_equations(pt, pq, s, K, huber_delta, anneal)
                 for (pt, pq), s in zip(poses, shards)]
        H, b, c = (_mesh_sum(_mesh_order(groups, [p[i] for p in parts])) for i in range(3))
        H = H * colmask[:, None] * colmask[None, :] + torch.diag(1.0 - colmask)
        return H, b * colmask, c

    for i in range(iters):
        H, b, _ = build(tt, qq, float(np.exp(-1.2 * i)))
        dx = _cho_solve(b[:, None], cholesky_nan(H + _EPS * eye))[:, 0]
        tt, qq = _retract(tt, qq, dx.reshape(K, 6))
    H, _, cost = build(tt, qq)
    if not with_cov:
        return tt, qq, cost
    # each shard solves only its own D/nd block-columns of H^-1 and keeps
    # its diagonal blocks (distributed.py:223-250)
    Lh = cholesky_nan(H + _EPS * eye)
    Kl = K // nd
    parts = []
    for dev, ks in groups:
        cols = (np.asarray(ks)[:, None] * (6 * Kl) + np.arange(6 * Kl)).reshape(-1)
        inv = _cho_solve(eye.to(dev)[:, _upload(cols, dev, fdt)], Lh.to(dev))
        P = len(cols) // 6  # poses whose columns this group solved
        blocks = inv.reshape(K, 6, P, 6)[_upload(cols[::6] // 6, dev, fdt), :,
                                         torch.arange(P, device=dev), :]
        parts.append(blocks.reshape(len(ks), Kl, 6, 6))
    return tt, qq, torch.cat(_mesh_order(groups, parts)), cost

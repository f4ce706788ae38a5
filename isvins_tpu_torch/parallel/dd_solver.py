"""Nested-dissection (domain-decomposition) pose-graph solve over a list of
devices (port of isvins_tpu/parallel/dd_solver.py).

An exact two-level direct method that keeps the O(D^3) work local to each
shard:
  - the pose chain is split into nd contiguous segments of Ki = K/nd poses;
  - one separator pose per segment cut, plus the later endpoint of every
    edge that crosses segments, form a small replicated INTERFACE of NB
    slots (6 NB unknowns);
  - every edge is routed on the host (numpy) to the shard that owns its
    interior endpoint, so the interior Hessian A is block-diagonal across
    shards by construction;
  - each shard factors its (6Ki)^2 interior block and forms its Schur
    contribution C_d - B_d^T A_d^-1 B_d; only the (6NB)^2 interface system is
    summed over the shards (in mesh order) and solved replicated;
  - per-pose covariance comes from the same factorization: interior blocks
    are diag(A^-1) + diag(W S^-1 W^T) with W = A^-1 B, interface blocks the
    diagonal blocks of S^-1.

The damping eps goes on the A and C diagonals before the Schur complement,
so the method factors the dense path's H + eps I exactly: dd and dense agree
to roundoff.

Each shard's work is written once, on tensors with a leading shard axis. The
shards listed on one device run as one batched program (one batched JᵀJ,
`cholesky_ex` and triangular solves on (G, 6Ki, 6Ki)); distinct devices each
run their group. The routing is host numpy before dispatch; after it the
solve reads nothing on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..factors.preintegration import cholesky_nan
from .distributed import (_EPS, _cho_solve, _groups, _host, _mesh_order, _mesh_sum, _no_loops,
                          _normal_equations, _np_dtype, _retract, _upload)
from .sharded import make_mesh


def _pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _route(nd: int, Ki: int, owner_of, idxs, cap: int):
    """Distribute edge indices across devices by owner; returns (nd, cap)
    int32 slot arrays into the global edge list plus a validity mask
    (padding rows point at edge 0, masked out)."""
    buckets = [[] for _ in range(nd)]
    for k in idxs:
        buckets[owner_of(k)].append(k)
    slot = np.zeros((nd, cap), np.int32)
    valid = np.zeros((nd, cap), bool)
    for d in range(nd):
        b = buckets[d]
        if len(b) > cap:
            # cap comes from route_family's independent owner pass; a
            # mismatch would silently drop edges from the solve
            raise AssertionError(
                f"dd _route capacity mismatch: device {d} got {len(b)} edges > cap={cap}")
        slot[d, : len(b)] = b
        valid[d, : len(b)] = True
    return slot, valid


def dd_partition(nd: int, K: int, e_i, e_j, e_valid, rp_i, rp_valid,
                 loop_i, loop_j, loop_valid):
    """Host partitioner. Device d owns poses [d*Ki, (d+1)*Ki); the interface
    is the segment-cut separators plus one promoted endpoint per
    cross-segment edge. Returns the routing arrays of the solve, with
    capacities pow2-bucketed as the reference's (the same arrays)."""
    Ki = K // nd
    seg = lambda p: min(int(p) // Ki, nd - 1)

    e_i = np.asarray(e_i); e_j = np.asarray(e_j)
    e_valid = np.asarray(e_valid)
    rp_i = np.asarray(rp_i); rp_valid = np.asarray(rp_valid)
    loop_i = np.asarray(loop_i); loop_j = np.asarray(loop_j)
    loop_valid = np.asarray(loop_valid)

    interface = [d * Ki for d in range(1, nd)]
    iface_set = set(interface)
    # promote the later endpoint of every cross-segment edge, loop edges and
    # sequential-family edges alike, unless an endpoint already is
    # interface, which un-crosses it: every edge then has an interior or
    # interface placement for both endpoints, whatever the caller's topology
    for fam_i, fam_j, fam_valid in ((loop_i, loop_j, loop_valid), (e_i, e_j, e_valid)):
        for k in np.nonzero(np.asarray(fam_valid))[0]:
            i, j = int(fam_i[k]), int(fam_j[k])
            if i in iface_set or j in iface_set:
                continue
            if seg(i) != seg(j):
                p = max(i, j)
                iface_set.add(p)
                interface.append(p)
    NB = _pow2(len(interface))
    # the covariance shards S^-1 block-columns as NB // nd per device: NB
    # must divide evenly
    if NB % nd != 0:
        NB = ((NB + nd - 1) // nd) * nd
    bnd_glob = np.zeros(NB, np.int32)
    bnd_glob[: len(interface)] = np.asarray(interface, np.int32)
    bnd_valid = np.zeros(NB, bool)
    bnd_valid[: len(interface)] = True
    is_iface = np.zeros(K, bool)
    is_iface[bnd_glob[bnd_valid]] = True
    slot_of = {p: s for s, p in enumerate(bnd_glob[bnd_valid])}

    def owner(i, j=None):
        if not is_iface[i]:
            return seg(i)
        if j is not None and not is_iface[j]:
            return seg(j)
        return 0

    def aug(p, d):
        """Augmented local index of pose p on device d."""
        return Ki + slot_of[p] if is_iface[p] else int(p) - d * Ki

    def route_family(idx_valid, ends):
        counts = np.zeros(nd, np.int64)
        for k in idx_valid:
            counts[owner(*ends(k))] += 1
        return _pow2(int(counts.max()) if len(idx_valid) else 1)

    ev = np.nonzero(e_valid)[0]
    cap_e = route_family(ev, lambda k: (e_i[k], e_j[k]))
    e_slot, e_ok = _route(nd, Ki, lambda k: owner(e_i[k], e_j[k]), ev, cap_e)

    rv = np.nonzero(rp_valid)[0]
    cap_r = route_family(rv, lambda k: (rp_i[k],))
    r_slot, r_ok = _route(nd, Ki, lambda k: owner(rp_i[k]), rv, cap_r)

    lv = np.nonzero(loop_valid)[0]
    cap_l = route_family(lv, lambda k: (loop_i[k], loop_j[k]))
    l_slot, l_ok = _route(nd, Ki, lambda k: owner(loop_i[k], loop_j[k]), lv, cap_l)

    def aug_of(slot, ok, src):
        out = np.zeros_like(slot)
        for d in range(nd):
            for c in range(slot.shape[1]):
                if ok[d, c]:
                    out[d, c] = aug(int(src[slot[d, c]]), d)
        return out

    return dict(
        Ki=Ki, NB=NB,
        bnd_glob=bnd_glob, bnd_valid=bnd_valid, is_iface=is_iface,
        e_slot=e_slot, e_ok=e_ok,
        e_ai=aug_of(e_slot, e_ok, e_i), e_aj=aug_of(e_slot, e_ok, e_j),
        r_slot=r_slot, r_ok=r_ok, r_ai=aug_of(r_slot, r_ok, rp_i),
        l_slot=l_slot, l_ok=l_ok,
        l_ai=aug_of(l_slot, l_ok, loop_i), l_aj=aug_of(l_slot, l_ok, loop_j),
    )


def dd_pose_graph_solve(devices, t, q, active, fixed,
                        e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
                        rp_i, rp_q, rp_sqrt, rp_valid,
                        loop_i=None, loop_j=None, loop_dt=None, loop_dq=None,
                        loop_w=None, loop_valid=None,
                        iters: int = 10, with_cov: bool = False, huber_delta: float = 0.1):
    """Domain-decomposition Gauss-Newton over `devices` (nd >= 2 entries,
    K % nd == 0); the signature and returns of
    parallel.distributed_pose_graph_solve. Arrays are host numpy (tensors
    are copied back first); the solve's dtype is t's; results are on
    devices[0]."""
    devices = make_mesh(devices)
    nd = len(devices)
    t = _host(t)
    K = t.shape[0]
    if nd < 2 or K % nd != 0:
        raise ValueError(f"dd solver needs nd>=2 and K%nd==0 (K={K}, nd={nd})")
    fdt = _np_dtype(t)
    if loop_i is None:
        loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid = _no_loops(nd, fdt)
    e_i, e_j, e_valid, rp_i, rp_valid, loop_i, loop_j, loop_valid = map(
        _host, (e_i, e_j, e_valid, rp_i, rp_valid, loop_i, loop_j, loop_valid))
    part = dd_partition(nd, K, e_i, e_j, e_valid, rp_i, rp_valid, loop_i, loop_j, loop_valid)
    NB, Ki = part["NB"], part["Ki"]
    nI = 6 * Ki

    # the routed payloads gathered by slot on the host: the device never
    # sees the global edge layout (dd_solver.py:223-246)
    g = lambda a, slot: _host(a)[slot]
    es, rs, ls = part["e_slot"], part["r_slot"], part["l_slot"]
    payload = {
        "e_gi": g(e_i, es), "e_gj": g(e_j, es), "e_dt": g(e_dt, es), "e_dq": g(e_dq, es),
        "e_sqrt": g(e_sqrt, es), "e_ok": part["e_ok"], "e_ai": part["e_ai"],
        "e_aj": part["e_aj"],
        "r_gi": g(rp_i, rs), "r_q": g(rp_q, rs), "r_sqrt": g(rp_sqrt, rs), "r_ok": part["r_ok"],
        "r_ai": part["r_ai"],
        "l_gi": g(loop_i, ls), "l_gj": g(loop_j, ls), "l_dt": g(loop_dt, ls),
        "l_dq": g(loop_dq, ls), "l_w": g(loop_w, ls), "l_ok": part["l_ok"],
        "l_ai": part["l_ai"], "l_aj": part["l_aj"],
    }
    # the masks of the alive (active, not fixed) unknowns, per shard
    alive = _host(active).astype(bool) & ~_host(fixed).astype(bool)
    poses = np.arange(nd)[:, None] * Ki + np.arange(Ki)
    int_alive6 = np.repeat(alive[poses] & ~part["is_iface"][poses], 6, axis=1).astype(fdt)
    bnd_alive6 = np.repeat(part["bnd_valid"] & alive[part["bnd_glob"]], 6).astype(fdt)
    payload["augmask"] = np.concatenate([int_alive6, np.tile(bnd_alive6, (nd, 1))], axis=1)
    payload["a_diag"] = _EPS * int_alive6 + (1.0 - int_alive6)  # eps alive, 1 dead
    payload["int_alive6"] = int_alive6

    groups = _groups(devices)
    home = devices[0]
    shards = [{k: _upload(v[ks], dev, fdt) for k, v in payload.items()} for dev, ks in groups]
    tt, qq = _upload(t, home, fdt), _upload(_host(q), home, fdt)
    c_diag = _upload((_EPS / nd) * bnd_alive6, home, fdt)
    s_diag = _upload(1.0 - bnd_alive6, home, fdt)
    oh = np.zeros((NB, K), fdt)
    oh[np.arange(NB), part["bnd_glob"]] = part["bnd_valid"]
    bnd_oh = _upload(oh, home, fdt)                                     # (NB, K)
    is_iface = _upload(part["is_iface"], home, fdt)                     # bool

    def schur(tt, qq, anneal):
        """One assembly and the exact Schur factorization of H + eps I on
        every shard: (LA, W, y) per group; S, g and the cost summed in mesh
        order on devices[0]."""
        per = []
        for (dev, _), s in zip(groups, shards):
            H, b, cost = _normal_equations(tt.to(dev), qq.to(dev), s, Ki + NB, huber_delta,
                                           anneal)
            A = H[:, :nI, :nI] + torch.diag_embed(s["a_diag"])
            B = H[:, :nI, nI:]
            Cd = H[:, nI:, nI:] + torch.diag(c_diag.to(dev))
            LA = cholesky_nan(A)
            W = _cho_solve(B, LA)                      # A^-1 B
            y = _cho_solve(b[:, :nI, None], LA)[..., 0]  # A^-1 bI
            Bt = B.transpose(1, 2)
            per.append((LA, W, y, Cd - Bt @ W, b[:, nI:] - (Bt @ y[..., None])[..., 0], cost))
        S, gB, cost = (_mesh_sum(_mesh_order(groups, [p[i] for p in per])) for i in (3, 4, 5))
        return [p[:3] for p in per], S + torch.diag(s_diag), gB, cost

    def step(tt, qq, anneal):
        fac, S, gB, _ = schur(tt, qq, anneal)
        xB = _cho_solve(gB[:, None], cholesky_nan(S))[:, 0]     # (6NB,)
        parts = []
        for (dev, ks), s, (_, W, y) in zip(groups, shards, fac):
            xI = y - (W @ xB.to(dev)[:, None])[..., 0]                   # (G, 6Ki)
            parts.append((xI * s["int_alive6"]).reshape(len(ks), Ki, 6))
        dxg = torch.cat(_mesh_order(groups, parts))                      # (K, 6)
        dxg = dxg + torch.einsum("bk,bd->kd", bnd_oh, xB.reshape(NB, 6))
        return _retract(tt, qq, dxg)

    for i in range(iters):
        tt, qq = step(tt, qq, float(np.exp(-1.2 * i)))

    if not with_cov:
        costs = [_normal_equations(tt.to(dev), qq.to(dev), s, Ki + NB, huber_delta)[2]
                 for (dev, _), s in zip(groups, shards)]
        return tt, qq, _mesh_sum(_mesh_order(groups, costs))

    fac, S, _, cost = schur(tt, qq, None)
    LS = cholesky_nan(S)
    NBl = NB // nd
    cov_int, cov_bnd = [], []
    for (dev, ks), (LA, W, _) in zip(groups, fac):
        G, Ls = len(ks), LS.to(dev)
        eye = torch.eye(nI, dtype=LA.dtype, device=dev).expand(G, nI, nI)
        diagA = _cho_solve(eye, LA).reshape(G, Ki, 6, Ki, 6).diagonal(
            dim1=1, dim2=3).permute(0, 3, 1, 2)                          # (G, Ki, 6, 6)
        # U = S^-1 W^T for every shard of the group in one solve
        Wt = W.transpose(1, 2).permute(1, 0, 2).reshape(6 * NB, G * nI)
        U = _cho_solve(Wt, Ls).reshape(6 * NB, G, Ki, 6).permute(1, 2, 0, 3)
        corr = W.reshape(G, Ki, 6, 6 * NB) @ U                          # (G, Ki, 6, 6)
        cov_int.append(diagA + corr)
        # interface poses: diagonal blocks of S^-1, NB / nd slots per shard
        cols = (np.asarray(ks)[:, None] * (6 * NBl) + np.arange(6 * NBl)).reshape(-1)
        Sc = _cho_solve(torch.eye(6 * NB, dtype=LA.dtype, device=dev)
                                  [:, _upload(cols, dev, fdt)], Ls)
        P = G * NBl
        blocks = Sc.reshape(NB, 6, P, 6)[_upload(cols[::6] // 6, dev, fdt), :,
                                         torch.arange(P, device=dev), :]
        cov_bnd.append(blocks.reshape(G, NBl, 6, 6))
    covg = torch.cat(_mesh_order(groups, cov_int))                       # (K, 6, 6)
    diagS = torch.cat(_mesh_order(groups, cov_bnd))                      # (NB, 6, 6)
    cov_iface = torch.einsum("bk,bij->kij", bnd_oh, diagS)
    covg = torch.where(is_iface[:, None, None], cov_iface, covg)
    return tt, qq, covg, cost

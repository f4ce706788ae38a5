#!/usr/bin/env python3
"""Where a batch of 2 windows parts from a batch of 16: the 16 product
windows of isvins_tpu_torch.scaling_bench's window sweep (make_batch_problem,
seed 0, B=18/Vo=8/F=1000/N=3072, f32, 5 LM iterations) solved with
solver.solve_window_batched in chunks of 16, 8, 4, 2 and 1 windows on one
device, one chunk after another, against the 16 single solves (solve_window)
and the f64 batched solve. Prints one JSON line each for:

  - `chunks`: per chunk size, and for the single solves on the rows as
    they lie (`single`; the square-root informations are transposed views)
    and on contiguous copies (`single_contiguous`, as chip_smoke.py's
    scaling phase makes them), each window's relative cost gap to f64 and
    the largest, the median over the windows of each one's largest |dP| to
    f64, the gaps to the batch of 16 and to the single solves (largest over
    every leaf, relative cost), the windows equal bit for bit to the batch of
    16, and the LM iterations each window took;
  - `sharded`: sharded_batch_solve over the device listed nd = 2, 4, 8
    times against the chunks of 16 / nd solved here (equal bits or not);
  - `growth`: chunks of 2 against the batch of 16 after 1, 2, ... 5
    iterations (largest gap over every leaf, windows that differ);
  - `first_assembly`: build_normal_equations at the initial states, for
    each chunk of 2 against its rows of the batch of 16: per output (H, b,
    h, W, b_l, cost) the largest gap and the count of elements that differ,
    and the cost's parts (the IMU, projection and prior cost vectors)
    before and after their row sum;
  - `first_step`: the linear step (ops.linstep_batched) on the batch of
    16's first normal equations, as one batch and as chunks of 2 of the
    same inputs: the Schur product C = Wᵀ(W/h), its right-hand side, K5's
    solve of the same damped systems, the step itself, and the trial state
    (solver.window.retract_state) from the same step;
  - `products`: on the same inputs as one batch and as chunks of 2, the
    IMU factors' whitening S·r (a batched matrix-vector product, the shape
    of solver.window._eval_imu's) against S·J (matrix-matrix), on seeded
    residuals and Jacobians and the problem's square-root informations;
  - `single_rerun`: the 16 single solves run again at the end of the
    process against their first run.

    python3 window_batch_probe.py [--device cpu] [--cut]

`--cut` takes WindowDims(6, 3, 32, 64) and 4 windows (for the CPU). Runs
on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json


def _gap(a, b):
    """Largest |a - b| and the count of elements that differ."""
    d = (a.double() - b.double()).abs()
    return float(d.max()), int((a != b).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--cut", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from isvins_tpu_torch.bench import PRODUCT_DIMS
    from isvins_tpu_torch.device import resolve_device
    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.ops.chol_batched import chol_solve_batched
    from isvins_tpu_torch.ops.linstep import linstep_batched
    from isvins_tpu_torch.parallel import cycle_mesh, make_batch_problem, sharded_batch_solve
    from isvins_tpu_torch.scaling_bench import WINDOW_ITERS
    from isvins_tpu_torch.solver import WindowDims, solve_window, solve_window_batched
    from isvins_tpu_torch.solver.window import (_eval_imu, _eval_priors, _eval_proj,
                                                build_normal_equations, normal_plans,
                                                retract_state)
    from isvins_tpu_torch.utils.convert import tree_map

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _lib.lib()
    dims, nb = (WindowDims(6, 3, 32, 64), 4) if args.cut else (PRODUCT_DIMS, 16)
    iters = WINDOW_ITERS
    prob = make_batch_problem(nb, dims, torch.float32, device=dev)
    trees, G, psi = prob[:4], prob[4], prob[5]
    rows = lambda k0, k1, ts=trees: [tree_map(lambda a: a[k0:k1], t) for t in ts]
    cat = lambda parts: type(parts[0])(*(torch.cat(leaf) for leaf in zip(*parts)))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def chunked(c, n_iter=iters):
        sts, costs, taken = [], [], []
        for k in range(0, nb, c):
            info = {}
            st, cost = solve_window_batched(*rows(k, k + c), G, psi, dims, iters=n_iter,
                                            info=info)
            sts.append(st), costs.append(cost), taken.append(info["sequence_iterations"])
        sync()
        return cat(sts), torch.cat(costs), torch.cat(taken)

    def largest(st, cost, ref_st, ref_cost):
        return max(float((a.double() - b.double()).abs().max())
                   for a, b in zip((*st, cost), (*ref_st, ref_cost)))

    f64 = lambda t: tree_map(lambda a: a.double() if a.is_floating_point() else a, t)
    st64, c64 = solve_window_batched(*f64(trees), G.double(), psi.double(), dims, iters=iters)
    solo = [solve_window(*[tree_map(lambda a: a[k], t) for t in trees], G, psi, dims,
                         iters=iters) for k in range(nb)]
    solo_st = type(st64)(*(torch.stack(leaf) for leaf in zip(*(st for st, _ in solo))))
    solo_c = torch.stack([c for _, c in solo])

    def contig():
        out = [solve_window(*[tree_map(lambda a: a[k].contiguous(), t) for t in trees], G, psi,
                            dims, iters=iters) for k in range(nb)]
        return (type(st64)(*(torch.stack(leaf) for leaf in zip(*(st for st, _ in out)))),
                torch.stack([c for _, c in out]))

    def vs_f64(st, cost):
        rel = ((cost.double() - c64).abs() / c64).tolist()
        dP = (st.P.double() - st64.P).abs().reshape(nb, -1).amax(dim=1)
        return rel, float(dP.median())

    res = {}
    for name, st, cost in (("single", solo_st, solo_c), ("single_contiguous", *contig())):
        rel, mid = vs_f64(st, cost)
        res[name] = {"rel_cost_gap_vs_f64": rel, "rel_cost_gap_vs_f64_max": max(rel),
                     "median_dP_vs_f64_m": mid}
    by_c, sizes = {}, [nb // 2 ** i for i in range(nb.bit_length()) if nb // 2 ** i >= 1]
    for c in sizes:
        st, cost, taken = chunked(c)
        by_c[c] = (st, cost)
        rel, mid = vs_f64(st, cost)
        st16, c16 = by_c[nb]
        same = [all(bool(torch.equal(a[k], b[k])) for a, b in zip((*st, cost), (*st16, c16)))
                for k in range(nb)]
        res[str(c)] = {
            "rel_cost_gap_vs_f64": rel, "rel_cost_gap_vs_f64_max": max(rel),
            "median_dP_vs_f64_m": mid, "largest_gap_vs_batch_of_all": largest(st, cost, st16, c16),
            "rel_cost_gap_vs_batch_of_all": float(((cost.double() - c16.double()).abs()
                                                   / c64).max()),
            "largest_gap_vs_single": largest(st, cost, solo_st, solo_c),
            "rel_cost_gap_vs_single": float(((cost.double() - solo_c.double()).abs()
                                             / c64).max()),
            "windows_equal_to_batch_of_all": sum(same), "sequence_iterations": taken.tolist()}
    print(json.dumps({"chunks": res, "windows": nb, "iters": iters, "device": str(dev)}),
          flush=True)

    sharded = {}
    for nd in (2, 4, 8):
        if nb % nd:
            continue
        step, shard = sharded_batch_solve(cycle_mesh(nd, [dev]), dims, iters=iters)
        st, cost = step(*zip(*shard(tuple(trees))), G, psi)
        sync()
        ref = by_c[nb // nd]
        sharded[str(nd)] = {"chunk": nb // nd, "equal_bit_for_bit": largest(st, cost, *ref) == 0.0,
                            "largest_gap": largest(st, cost, *ref)}
    print(json.dumps({"sharded": sharded}), flush=True)

    growth = {}
    for n_iter in range(1, iters + 1):
        a, b = chunked(2, n_iter)[:2], chunked(nb, n_iter)[:2]
        diff = [k for k in range(nb)
                if not all(bool(torch.equal(x[k], y[k])) for x, y in zip((*a[0], a[1]),
                                                                          (*b[0], b[1])))]
        growth[str(n_iter)] = {"largest_gap": largest(*a, *b), "windows_differ": diff}
    print(json.dumps({"growth": growth}), flush=True)

    names = ("H", "b", "h", "W", "b_l", "cost")
    full = build_normal_equations(*trees, G, psi, dims, False, normal_plans(trees[2], dims))
    asm = {n: [0.0, 0] for n in names}
    parts = {n: [0.0, 0] for n in ("cv_imu", "cv_proj", "cv_prior", "row_sum")}

    def cost_parts(ts):
        st, imu, proj, priors = ts
        return (_eval_imu(st, imu, G, dims)[2], _eval_proj(st, proj, psi, dims)[5],
                _eval_priors(st, priors, dims)[1])

    parts_full = cost_parts(trees)
    for k in range(0, nb, 2):
        sub = rows(k, k + 2)
        out = build_normal_equations(*sub, G, psi, dims, False, normal_plans(sub[2], dims))
        for n, a, b in zip(names, out, full):
            g, m = _gap(a, b[k:k + 2])
            asm[n] = [max(asm[n][0], g), asm[n][1] + m]
        mine = cost_parts(sub)
        for n, a, b in zip(("cv_imu", "cv_proj", "cv_prior"), mine, parts_full):
            g, m = _gap(a, b[k:k + 2])
            parts[n] = [max(parts[n][0], g), parts[n][1] + m]
        # the row sum alone, on the same inputs: the batch of all's rows k, k + 1
        same_in = torch.cat([p[k:k + 2] for p in parts_full], dim=-1)
        whole = torch.sum(torch.cat(parts_full, dim=-1), dim=-1)[k:k + 2]
        g, m = _gap(torch.sum(same_in, dim=-1), whole)
        parts["row_sum"] = [max(parts["row_sum"][0], g), parts["row_sum"][1] + m]
    print(json.dumps({"first_assembly": {"outputs": asm, "cost_parts": parts,
                                         "row_sum_length": int(same_in.shape[-1])}}), flush=True)

    H, b, h, W, b_l, _ = full
    lam = torch.full((nb,), 1e-4, dtype=H.dtype, device=dev)
    h_safe = torch.where(h * (1 + lam[:, None]) > 1e-12, h * (1 + lam[:, None]),
                         torch.ones_like(h))
    C_all = W.transpose(1, 2) @ (W / h_safe[..., None])
    cb_all = (W.transpose(1, 2) @ (b_l / h_safe)[..., None])[..., 0]
    Hd = H + 1e-2 * torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2).clamp(min=1e-8))
    x_all = chol_solve_batched(Hd.contiguous(), b.contiguous())
    dx_all, dl_all = linstep_batched(H, b, W, h, b_l, lam, 6 * dims.B)
    trial_all = retract_state(trees[0], dx_all, dl_all, dims)
    step = {n: [0.0, 0] for n in ("C", "c_b", "chol_solve_batched", "dx", "dl", "trial_state")}
    for k in range(0, nb, 2):
        s = slice(k, k + 2)
        C = W[s].transpose(1, 2) @ (W[s] / h_safe[s][..., None])
        cb = (W[s].transpose(1, 2) @ (b_l[s] / h_safe[s])[..., None])[..., 0]
        x = chol_solve_batched(Hd[s].contiguous(), b[s].contiguous())
        dx, dl = linstep_batched(H[s], b[s], W[s], h[s], b_l[s], lam[s], 6 * dims.B)
        trial = retract_state(rows(k, k + 2)[0], dx_all[s], dl_all[s], dims)
        g = max(_gap(a, ref[s])[0] for a, ref in zip(trial, trial_all))
        m = sum(_gap(a, ref[s])[1] for a, ref in zip(trial, trial_all))
        step["trial_state"] = [max(step["trial_state"][0], g), step["trial_state"][1] + m]
        for n, a, ref in (("C", C, C_all[s]), ("c_b", cb, cb_all[s]),
                          ("chol_solve_batched", x, x_all[s]), ("dx", dx, dx_all[s]),
                          ("dl", dl, dl_all[s])):
            g, m = _gap(a, ref)
            step[n] = [max(step[n][0], g), step[n][1] + m]
    sync()
    print(json.dumps({"first_step": step, "C_shape": list(C_all.shape)}), flush=True)

    S = trees[1].sqrt
    gen = torch.Generator().manual_seed(0)
    r = torch.randn(S.shape[:-1], generator=gen).to(dev)
    J = torch.randn(S.shape[:-1] + (30,), generator=gen).to(dev)
    Sr_all, SJ_all = S @ r[..., None], S @ J
    prods = {n: [0.0, 0] for n in ("S_r", "S_J")}
    for k in range(0, nb, 2):
        s = slice(k, k + 2)
        for n, a, ref in (("S_r", S[s] @ r[s][..., None], Sr_all[s]),
                          ("S_J", S[s] @ J[s], SJ_all[s])):
            g, m = _gap(a, ref)
            prods[n] = [max(prods[n][0], g), prods[n][1] + m]
    again = [solve_window(*[tree_map(lambda a: a[k], t) for t in trees], G, psi, dims,
                          iters=iters) for k in range(nb)]
    sync()
    rerun = max(largest(a_st, a_c, b_st, b_c) for (a_st, a_c), (b_st, b_c) in zip(again, solo))
    print(json.dumps({"products": prods, "S_shape": list(S.shape),
                      "single_rerun_largest_gap": rerun}), flush=True)


if __name__ == "__main__":
    main()

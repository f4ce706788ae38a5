"""The multi-device dry run (port of __graft_entry__.py).

- `entry()` -> (fn, example_args): one full sliding-window LM solve at the
  product window (18 frames, 1000 landmarks, 3072 projection factors, 10
  iterations, f32), the engine's hot path.
- `dryrun_multichip(n_devices, devices=None)`: the multi-device paths at
  product shapes over a mesh of n_devices entries: (1) n sequence-data-
  parallel window solves at B=18/F=1000/N=3072, one per device; (2) the
  nested-dissection pose-graph solve with per-pose covariance at K = 256
  poses, E = 2048 edge slots and 32 loops (n >= 2), and the dense
  edge-sharded solve on a 16-pose graph; (3) n Estimators in the steady
  state stepped by one MultiSequenceSolver over the mesh, each installing
  its solve and marginalizing once. Asserts what __graft_entry__.py:34-168
  asserts, and returns what it computed.

`devices=None` is every CUDA card torch sees, listed in turn when there are
fewer than n_devices (parallel.cycle_mesh); a list of devices (["cpu",
"cpu:0"]) runs it anywhere.

    python -m isvins_tpu_torch.multichip [n_devices] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .bench import PRODUCT_DIMS
from .solver import WindowDims


def entry(device=None):
    """(fn, args): fn(state, imu, proj, priors, G, psi) -> (P, cost) of
    solve_window at PRODUCT_DIMS, 10 iterations, on make_batch_problem's
    first window (f32) on `device` (None: the card)."""
    import torch

    from .parallel import make_batch_problem
    from .solver import solve_window
    from .utils.convert import tree_map

    dims = PRODUCT_DIMS
    prob = make_batch_problem(1, dims, torch.float32, device=device)

    def fn(state, imu, proj, priors, G, psi):
        st, cost = solve_window(state, imu, proj, priors, G, psi, dims, iters=10)
        return st.P, cost

    return fn, tuple(tree_map(lambda a: a[0], t) for t in prob[:4]) + tuple(prob[4:])


def pose_graph_inputs(K: int = 256, E: int = 2048, L: int = 32, seed: int = 0):
    """__graft_entry__.py:61-87's graph as f32 numpy: a random-walk chain of
    K poses, E edge slots of which the first K - 1 are valid (k -> k + 1,
    sqrt-information 10 I), a roll-pitch edge per pose (4 I), L loops of
    weight 100 from the first half to the second, pose 0 fixed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    ident = lambda n: np.tile(np.array([1.0, 0, 0, 0], f), (n, 1))
    t = np.cumsum(rng.normal(size=(K, 3)) * 0.1, axis=0).astype(f)
    e_i = (np.arange(E) % (K - 1)).astype(np.int32)
    e_dt = (rng.normal(size=(E, 3)) * 0.1).astype(f)
    loop_i = rng.integers(0, K // 2, L).astype(np.int32)
    loop_j = rng.integers(K // 2, K - 1, L).astype(np.int32)
    loop_dt = (rng.normal(size=(L, 3)) * 0.05).astype(f)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (t, ident(K), np.ones(K, bool), fixed,
            e_i, e_i + 1, e_dt, ident(E), np.tile(np.eye(6, dtype=f)[None] * 10.0, (E, 1, 1)),
            np.arange(E) < K - 1,
            np.arange(K, dtype=np.int32), ident(K), np.tile(np.eye(2, dtype=f)[None] * 4.0, (K, 1, 1)),
            np.ones(K, bool),
            loop_i, loop_j, loop_dt, ident(L), np.ones(L, f) * 100.0, np.ones(L, bool))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """__graft_entry__.py:34-112 over parallel.cycle_mesh(n_devices,
    devices). Returns {"mesh", "distinct_devices", "window": (state, cost),
    "dd": (t, q, cov, cost) or None, "dense": (t, q, cost), "n_solved",
    "sequences": [{"Ps", "last_cost", "packets"}, ...]}; an assertion that
    fails raises."""
    import torch

    from .parallel import (cycle_mesh, dd_pose_graph_solve, distributed_pose_graph_solve,
                           make_batch_problem, sharded_batch_solve)

    mesh = cycle_mesh(n_devices, devices)

    # 1) sequence-data-parallel window solves at the product shapes, one
    # stream per device
    dims = PRODUCT_DIMS
    step, shard = sharded_batch_solve(mesh, dims, iters=2)
    prob = make_batch_problem(n_devices, dims, torch.float32, device=mesh[0])
    shards = shard(prob[:4])
    trees = shards if n_devices == 1 else tuple(zip(*shards))
    window = step(*trees, prob[4], prob[5])
    assert tuple(window[0].P.shape) == (n_devices, dims.B, 3)
    assert bool(torch.isfinite(window[1]).all())

    # 2) the pose graph across the mesh: dd with covariance at K = 256,
    # E = 2048, 32 loops; the dense edge-sharded solve on a 16-pose graph
    pg = pose_graph_inputs()
    K = len(pg[0])
    dd = None
    if n_devices >= 2:
        dd = dd_pose_graph_solve(mesh, *pg, iters=2, with_cov=True)
        assert tuple(dd[0].shape) == (K, 3) and tuple(dd[2].shape) == (K, 6, 6)
    Ks = 16
    (t, q, active, fixed, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
     rp_i, rp_q, rp_sqrt, rp_valid) = pg[:14]
    dense = distributed_pose_graph_solve(
        mesh, t[:Ks], q[:Ks], active[:Ks], fixed[:Ks],
        np.minimum(e_i[:Ks], Ks - 2), np.minimum(e_j[:Ks], Ks - 1),
        e_dt[:Ks], e_dq[:Ks], e_sqrt[:Ks], e_valid[:Ks],
        rp_i[:Ks], rp_q[:Ks], rp_sqrt[:Ks], rp_valid[:Ks], iters=2)

    # 3) n estimators in the steady state, their window solves batched by
    # one coordinator over the mesh
    n_solved, sequences = _dryrun_multi_sequence_system(mesh, n_devices)
    return {"mesh": [str(d) for d in mesh], "distinct_devices": len(set(mesh)),
            "window": window, "dd": dd, "dense": dense, "n_solved": n_solved,
            "sequences": sequences}


def steady_estimator(cfg, dims, seed: int, device):
    """__graft_entry__.py:133-158: an Estimator (solve_async, the dispatch
    deferred to a coordinator) placed straight in the steady state on
    make_world(n_frames=B, n_landmarks=120, seed), one frame's solve ahead."""
    from .estimator.estimator import MARGIN_OLD, NON_LINEAR, Estimator
    from .geom.hostmath import mat_to_quat_np
    from .solver import PriorState
    from .utils.synthetic import make_world, project

    qic = mat_to_quat_np(np.asarray(cfg.ric_np))
    world = make_world(n_frames=dims.B, n_landmarks=120, seed=seed)
    est = Estimator(cfg, dims, device=device, solve_async=True)
    est._defer_dispatch = True
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
    for k in range(dims.B):
        pts, _, vis = project(world, k, np.zeros(3), qic)
        est.f_manager.add_features(k, np.where(vis)[0], pts[vis])
    est.frame_count = dims.B - 1
    est.solver_flag = NON_LINEAR
    est.marginalization_flag = MARGIN_OLD
    est.priors = PriorState.empty(dims.Vo)
    return est


def _dryrun_multi_sequence_system(mesh, n_devices: int):
    """__graft_entry__.py:115-168: B = 10, Vo = 4, F = 64, N = 256, seeds
    100 + s; one MultiSequenceSolver step over the mesh solves all n, each
    installs its result and marginalizes once (one pose-graph packet)."""
    from .config import WindowConfig, euroc_config
    from .parallel import MultiSequenceSolver

    B, Vo, F, N = 10, 4, 64, 256
    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        window=WindowConfig(vo_size=Vo, all_size=B, max_features=F, max_imu_per_frame=64),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    ests = [steady_estimator(cfg, WindowDims(B=B, Vo=Vo, F=F, N=N), 100 + s, mesh[0])
            for s in range(n_devices)]
    try:
        for est in ests:
            est.dispatch_odometry()
        n_solved = MultiSequenceSolver(mesh).step(ests)
        assert n_solved == n_devices, n_solved
        out = []
        for est in ests:
            est.collect_marg()
            assert np.isfinite(est.Ps).all() and np.isfinite(est.last_cost)
            assert len(est.pose_graph_packets) == 1  # the MARGIN_OLD marginalization ran
            out.append({"Ps": est.Ps.copy(), "last_cost": float(est.last_cost),
                        "packets": len(est.pose_graph_packets)})
    finally:
        for est in ests:
            est.close()
    return n_solved, out


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=None,
                    help="mesh entries (default: every CUDA card)")
    ap.add_argument("--device", default=None, help="one torch device for every mesh entry")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device]
    fn, ex = entry(device=args.device)
    P, cost = fn(*ex)
    print("entry ok:", tuple(P.shape), float(cost))
    n = args.n_devices or (torch.cuda.device_count() if devices is None else 1)
    out = dryrun_multichip(n, devices)
    print(f"dryrun ok: mesh {out['mesh']} ({out['distinct_devices']} distinct)")


if __name__ == "__main__":
    main()

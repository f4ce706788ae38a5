"""What the timed path produces, copied where it is produced, for the
comparison that decides `correct` (benchmark/reference/check.py).

While the window runs, thin wrappers around calls of the port copy their
host inputs and outputs as plain NumPy trees (no object of the port is
kept, so the reference reads nothing of the program but numbers):

- the steady solve: the host tree that `estimator.to_device` uploads
  (window state, raw IMU segments, triangulation inputs, projection
  factors, priors, gravity, pixel information), the solved state that
  `Estimator._install_solution` then receives with its anchor (frame 0's
  pose before the solve), and the state the estimator holds once it
  returns (its P, Q, V, Ba, Bg and the extrinsic tic, qic);
- the steady solve's kernels K1 (proj_rows, or on the extrinsic branch
  of a configuration that estimates the extrinsic its row function
  `projection_residual_jacobians`, with the solve's projection-factor
  mask), K2 (imu_rows) and K4 (linstep), and the normal equations that
  K1 and K2 feed (`build_normal_equations`: their rows summed per frame
  pair and landmark): in every few solves one call of each, its tensor
  arguments and outputs copied on the device as it returns (moved to the
  host after the window);
- the marginalization job: `Estimator._marg_compute`'s arguments (its
  snapshot) and its result, on the marginalization worker thread;
- loop verification: `pnp_ransac_gn`'s arguments and result, as the
  pose-graph builder calls it;
- the pose-graph solve: the keyframe database's rows that
  `optimize_pose_graph` reads, at its call, and the PendingOptimize it
  returns (its host outputs are read after the flush);
- the tracker: after each frame's calls the harness copies the tracker's
  host track state (`Drive.step`); and in every few frames the packet
  that `FeatureTracker.collect` returns (ids, pixels, normalized points:
  the undistortion through the camera model).

Each wrapper copies only while `armed` (the measured window), and never
reads the device.

These are the names of the port that the comparison needs, and that a
change to the port has to keep (or a benchmark change has to move first):
`estimator.to_device` called with steady_solve's host argument tree (its
fourth leaf the ProjFactors, with `valid`),
`Estimator._install_solution` and the state it sets (`Ps`, `Qs`, `Vs`,
`Bas`, `Bgs`, `tic`, `qic`), `Estimator._marg_compute`, the pose-graph
builder module's `pnp_ransac_gn` and `optimize_pose_graph`, the tracker's
`pts`, `ids`, `valid` and `track_cnt`, its `collect` and the packet's
`ids`, `pts_px` and `pts_norm`, and the solver module's
`_proj_ops.proj_rows`, `projection_residual_jacobians`, `imu_rows`,
`build_normal_equations` and `linstep`, called from Python at every LM
evaluation. A steady solve replayed as a CUDA graph makes no such call in
the window: K1's, K2's, the normal equations' and K4's numbers then have
no answer and `correct` reads false.

While installed, `_proj_ops` holds K1's wrapper at `proj_rows` and reads
every other name through to ops.proj, so a function added there is
called through the alias as it is. Two rules a new kernel keeps:
- benchmark/trace.py counts K1-K4 on the device by substring of the
  kernel's symbol (COUNTED: `proj_rows_kernel`, `imu_rows_kernel`,
  `schur_corr_kernel`, `linstep_chol_kernel`). A new kernel whose symbol
  contains one of these (K1's kernel templated on an extrinsic flag, say)
  is counted as that kernel: no profiler session then matches
  ops.launch_counts() (the last is kept, with `consistent` False), and the
  kernel's roofline takes in the new kernel's time. A new kernel takes a
  symbol of its own.
- The extrinsic branch's rows are copied at the solver module's name
  `projection_residual_jacobians`, called with its 9 positional arguments
  (pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i) and returning its 5
  outputs (r, J_pi, J_pj, J_ex, J_dep) in that order and in its shapes. A
  kernel of those rows is bound to that name, or the capture moves first."""

from __future__ import annotations

import threading

import numpy as np


# the steady solve's calls copied, with the calls a solve makes of each: LM
# iterations + 1 evaluations of K1, K2 and the normal equations they feed,
# one K4 step an iteration
KERNEL_CALLS = {"proj_rows": 11, "imu_rows": 11, "normal_equations": 11, "linstep": 10}
# K1's rows on the extrinsic branch: a solve calls either proj_rows or
# this, as often, so its copy takes proj_rows' pick (and the draws from
# the seed stay those of a configuration without the branch)
PROJ_ROWS_EX = "proj_rows_ex"

# the arguments of the normal equations' build that are copied: the LM
# state, the IMU factors, the projection factors, the priors, gravity and
# the pixel information (the dims, the extrinsic flag and the segment-sum
# plans are the configuration's or worked out again)
NORMAL_ARGS = 6


def freeze(tree):
    """A NumPy copy of a tree of NamedTuples, tuples and arrays:
    NamedTuples become ("ClassName", fields...) tuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(freeze(v) for v in tree)
    if isinstance(tree, (tuple, list)):
        return tuple(freeze(v) for v in tree)
    if isinstance(tree, (int, float, bool, str)) or tree is None:
        return tree
    return np.array(tree)


class Captures:
    def __init__(self, system, seed: int = 0, kernel_stride: int = 8, kernel_cap: int = 10,
                 solve_cap: int = 1 << 30, lift_cap: int = 0):
        self.system = system
        self.armed = False
        self.lock = threading.Lock()
        self.solves, self.margs, self.loops, self.optimizes = [], [], [], []
        self.kernels = {name: [] for name in (*KERNEL_CALLS, PROJ_ROWS_EX)}
        self.tracks = {}  # frame index -> the tracker's state after that frame's collect
        self.lifts = []  # the tracker's packets (ids, pts_px, pts_norm)
        self._solve_in = None
        self._proj_valid = None
        self._undo = []
        # the kernel calls copied: in every kernel_stride-th steady solve of
        # the window (the first drawn from the seed), one call of each
        # kernel at an LM iteration drawn from the seed
        self._rng = np.random.default_rng(seed)
        self._stride, self._kcap, self._scap = kernel_stride, kernel_cap, solve_cap
        self._n_solves = 0
        self._next_pick = int(self._rng.integers(0, kernel_stride))
        self._pick, self._calls = {}, {}
        # the tracker's packets copied: every kernel_stride-th of the
        # window, the first drawn from the seed (a generator of its own, so
        # that the kernels' picks stay as they were), at most lift_cap
        self._lcap, self._n_packets = lift_cap, 0
        self._next_packet = int(np.random.default_rng([seed, 1]).integers(0, kernel_stride))

    # ------------------------------------------------------------ install
    def install(self):
        from isvins_tpu_torch.estimator import estimator as est_mod
        from isvins_tpu_torch.posegraph import builder as pg_mod

        est = self.system.estimator
        to_device, install = est_mod.to_device, est._install_solution
        marg = est._marg_compute

        def to_device_copy(tree, device, dtype=None):
            if self.armed and dtype is not None:
                if len(self.solves) < self._scap:
                    self._solve_in = freeze(tree)
                self._pick, self._calls = {}, {}
                if self._n_solves == self._next_pick:
                    self._next_pick += self._stride
                    self._pick = {name: int(self._rng.integers(0, n))
                                  for name, n in KERNEL_CALLS.items()}
                    self._proj_valid = np.array(tree[3].valid)
                self._n_solves += 1
            return to_device(tree, device, dtype)

        def install_copy(new_state, cost, P0_old, Q0_old):
            out = install(new_state, cost, P0_old, Q0_old)
            if self._solve_in is not None:
                self.solves.append({"inputs": self._solve_in, "state": freeze(new_state),
                                    "anchor": freeze((P0_old, Q0_old)),
                                    "installed": freeze((est.Ps, est.Qs, est.Vs, est.Bas,
                                                         est.Bgs, est.tic, est.qic))})
                self._solve_in = None
            return out

        def marg_copy(*args, **kw):
            out = marg(*args, **kw)
            if self.armed:
                with self.lock:
                    self.margs.append({"inputs": freeze(args), "out": freeze(out)})
            return out

        from isvins_tpu_torch.ops import proj as proj_mod
        from isvins_tpu_torch.solver import window as win_mod

        # the solver calls K1 as ops.proj.proj_rows through its module alias
        # `_proj_ops`, and K2 and K4 by the names it imported; the wrappers
        # go where the solver looks, so each kernel module keeps its own
        # function (which counts its launches on itself). Every other name
        # of the alias reads through to ops.proj.
        proj_alias = win_mod._proj_ops
        win_mod._proj_ops = _Forward(proj_mod, proj_rows=self._kernel_copy("proj_rows",
                                                                           proj_mod.proj_rows))
        self._undo.append(lambda: setattr(win_mod, "_proj_ops", proj_alias))
        for name, key in (("imu_rows", "imu_rows"), ("linstep", "linstep"),
                          ("build_normal_equations", "normal_equations"),
                          ("projection_residual_jacobians", PROJ_ROWS_EX)):
            orig = getattr(win_mod, name)
            setattr(win_mod, name, self._kernel_copy(key, orig))
            self._undo.append(lambda name=name, orig=orig: setattr(win_mod, name, orig))

        trk = self.system.tracker
        collect = trk.collect

        def collect_copy(*args, **kw):
            out = collect(*args, **kw)
            if self.armed and len(self.lifts) < self._lcap:
                if self._n_packets == self._next_packet:
                    self._next_packet += self._stride
                    self.lifts.append({k: np.array(out[k]) for k in ("ids", "pts_px", "pts_norm")})
                self._n_packets += 1
            return out

        trk.collect = collect_copy
        self._undo.append(lambda: trk.__dict__.pop("collect", None))

        est_mod.to_device = to_device_copy
        est._install_solution = install_copy
        est._marg_compute = marg_copy
        self._undo += [lambda: setattr(est_mod, "to_device", to_device),
                       lambda: est.__dict__.pop("_install_solution", None),
                       lambda: est.__dict__.pop("_marg_compute", None)]

        if self.system.pgbuilder is not None:
            pnp, opt = pg_mod.pnp_ransac_gn, pg_mod.optimize_pose_graph

            def pnp_copy(pts3d, pts2d, q0, t0, **kw):
                out = pnp(pts3d, pts2d, q0, t0, **kw)
                if self.armed:
                    with self.lock:
                        self.loops.append({"inputs": freeze((pts3d, pts2d, q0, t0)),
                                           "kw": {k: v for k, v in kw.items() if k != "device"},
                                           "out": freeze(out)})
                return out

            def opt_copy(db, first_idx, cur_idx, **kw):
                rows = _segment(db, first_idx, cur_idx, kw) if self.armed else None
                out = opt(db, first_idx, cur_idx, **kw)
                if rows is not None:
                    with self.lock:
                        self.optimizes.append({"inputs": rows, "pending": out,
                                               "iters": kw.get("iters", 10)})
                return out

            pg_mod.pnp_ransac_gn = pnp_copy
            pg_mod.optimize_pose_graph = opt_copy
            self._undo += [lambda: setattr(pg_mod, "pnp_ransac_gn", pnp),
                           lambda: setattr(pg_mod, "optimize_pose_graph", opt)]

    def _kernel_copy(self, name, orig):
        """The wrapper of `orig`, copying (on the device, without a host
        read) its tensor arguments and outputs at the picked call."""
        nargs = NORMAL_ARGS if name == "normal_equations" else None
        ex = name == PROJ_ROWS_EX
        drawn = "proj_rows" if ex else name

        def call(*args):
            out = orig(*args)
            pick = self._pick.get(drawn)
            if pick is not None and self.armed and len(self.kernels[name]) < self._kcap:
                i = self._calls.get(drawn, 0)
                self._calls[drawn] = i + 1
                if i == pick:
                    c = {"args": _tree(args[:nargs], _clone), "out": _tree(tuple(out), _clone)}
                    if ex:  # the row function takes no mask: the solve's projection factors'
                        c["valid"] = self._proj_valid
                    self.kernels[name].append(c)
            return out
        return call

    def uninstall(self):
        for f in reversed(self._undo):
            f()
        self._undo = []

    def track_state(self, k: int):
        """Copy the tracker's host state: after the harness's calls for
        frame k + 1 it holds frame k's tracks (the pipeline collects a frame
        in the next frame's pub_image)."""
        trk = self.system.tracker
        self.tracks[k] = {"pts": trk.pts.copy(), "ids": trk.ids.copy(),
                          "valid": trk.valid.copy(), "track_cnt": trk.track_cnt.copy()}

    def finish(self):
        """After the flush: the copied kernel calls moved to the host, and
        each pose-graph solve's host outputs (t, q, cov, cost), read from
        its PendingOptimize."""
        for calls in self.kernels.values():
            for c in calls:
                c["args"] = freeze(_tree(c["args"], _host))
                c["out"] = freeze(_tree(c["out"], _host))
        for o in self.optimizes:
            pend = o.pop("pending")
            outs = getattr(pend, "_outputs", None)
            o["out"] = None if outs is None else tuple(np.array(x.numpy()) for x in outs)


class _Forward:
    """A module as a caller sees it through an alias while some of its
    functions are wrapped: the wrapped names as given, every other name
    read from the module at each access."""

    def __init__(self, module, **wrapped):
        self.__dict__.update(wrapped)
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)


def _tree(tree, leaf):
    """`leaf` applied to every tensor of a tree of NamedTuples and tuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return leaf(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree(v, leaf) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_tree(v, leaf) for v in tree)
    return tree


def _clone(t):
    return t.detach().clone()


def _host(t):
    return t.cpu().numpy()


def _segment(db, first_idx: int, cur_idx: int, kw: dict):
    """The rows of the keyframe database that the dense pose-graph solve of
    [first_idx..cur_idx] reads (posegraph/optimize.py:optimize_pose_graph),
    copied as it reads them; the clamp to max_active poses as there."""
    n = cur_idx - first_idx + 1
    max_active = kw.get("max_active", 4096)
    if n > max_active:
        first_idx = cur_idx - max_active + 1
    sl = slice(first_idx, cur_idx + 1)
    loops = [(int(db.loop_idx[k]) - first_idx, k - first_idx, np.array(db.loop_dt[k]),
              np.array(db.loop_dq[k]), float(db.loop_weight[k]))
             for k in range(first_idx, cur_idx + 1) if db.loop_idx[k] >= first_idx]
    return {"vio_t": np.array(db.vio_t[sl]), "vio_q": np.array(db.vio_q[sl]),
            "edge_dt": np.array(db.edge_dt[sl]), "edge_dq": np.array(db.edge_dq[sl]),
            "edge_sqrt": np.array(db.edge_sqrt[sl]), "edge_valid": np.array(db.edge_valid[sl]),
            "rp_q": np.array(db.rp_q[sl]), "rp_sqrt": np.array(db.rp_sqrt[sl]),
            "rp_valid": np.array(db.rp_valid[sl]), "seq": np.array(db.seq[sl]),
            "loops": loops}

"""The port's checkpoints (isvins_tpu_torch.utils.checkpoint) on the CPU.

Mirrors of tests/test_checkpoint.py's three cases on the port; each
package loading the other's files (the npz keys are the contract); and the
two faults of the reference the port does not copy: a save taken while an
async solve is pending equals one taken after it is collected (C3), and a
pose-graph save leaves the live database's bag-of-words state as it was,
while a System with its pose graph on a worker, saved after
wait_pg_ready(), writes the same file as the inline one (C4)."""

import os

import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu_torch.config import WindowConfig, euroc_config
from isvins_tpu_torch.estimator.estimator import Estimator
from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
from isvins_tpu_torch.posegraph.keyframe_db import KeyframeDB
from isvins_tpu_torch.solver import WindowDims
from isvins_tpu_torch.utils.checkpoint import (_DB_FIELDS, load_estimator, load_pose_graph,
                                               save_estimator, save_pose_graph)
from isvins_tpu_torch.utils.synthetic import make_world, project

DIMS = WindowDims(B=10, Vo=4, F=256, N=2048)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_db(rng, n, K=32, D=16, P=8):
    db = KeyframeDB(K, D, P, device="cpu")
    for k in range(n):
        db.add(ts=float(k), vio_t=rng.normal(size=3), vio_q=np.array([1.0, 0, 0, 0]),
               kp_desc=rng.integers(0, 2**32, size=(D, 8), dtype=np.uint32),
               kp_valid=np.ones(D, bool))
    return db


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------- reference mirrors

def test_pose_graph_roundtrip(rng, tmp_path):
    db = _random_db(rng, 5)
    db.loop_idx[4] = 0
    db.loop_weight[4] = 12.5
    path = str(tmp_path / "pg.npz")
    save_pose_graph(db, path)
    db2 = load_pose_graph(path, device="cpu")
    assert db2.n == 5
    np.testing.assert_array_equal(db2.kp_desc[:5], db.kp_desc[:5])
    np.testing.assert_allclose(db2.vio_t[:5], db.vio_t[:5])
    assert db2.loop_idx[4] == 0 and db2.loop_weight[4] == 12.5
    # retrieval still works on the restored db
    assert all(c in (0, 1, 2, 3) for c in db2.query(4, skip_recent=1))


def test_pre_bow_snapshot_freezes_vocab_from_loaded_map(rng, tmp_path):
    """A database restored from a snapshot without vocabulary state rebuilds
    the vocabulary from ALL loaded keyframes on the next add."""
    db = _random_db(rng, 55, K=64, D=32, P=16)
    path = str(tmp_path / "pg.npz")
    save_pose_graph(db, path)
    z = _npz(path)
    for k in ("vocab", "vocab_frozen", "df", "tf"):
        z.pop(k)  # a snapshot written before the bag of words
    np.savez(path, **z)
    db2 = load_pose_graph(path, device="cpu")
    assert not db2.vocab_frozen
    db2.add(ts=55.0, kp_desc=rng.integers(0, 2**32, size=(32, 8), dtype=np.uint32),
            kp_valid=np.ones(32, bool))
    assert db2.vocab_frozen
    stored = set(map(tuple, db2.kp_desc[:56][db2.kp_valid[:56]].tolist()))
    in_pool = sum(tuple(w) in stored for w in db2.vocab.tolist())
    assert in_pool == min(db2.W, len(stored))
    db2.flush_bow()
    assert (db2.tf[:56].sum(axis=1) > 0).all()


def _resume_setup():
    cfg = euroc_config().replace(
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=(0.02, -0.01, 0.01), ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)))
    world = make_world(n_frames=24, n_landmarks=240, seed=0)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(cfg.ric_np))

    def make(**kw):
        est = Estimator(cfg, DIMS, device="cpu", **kw)
        est._gt_init = lambda e: (e.set_ground_truth_init(world.P, world.Q, world.V),
                                  e.f_manager.depth.fill(-1.0))
        return est

    def feed(e, k):
        if k > 0:
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                e.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                              world.imu_gyrs[k - 1][s])
        pts, _, vis = project(world, k, tic, qic)
        e.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])

    return cfg, world, make, feed


def test_estimator_resume_continues_trajectory(tmp_path):
    cfg, world, make, feed = _resume_setup()
    est = make()
    for k in range(16):
        feed(est, k)
    assert est.solver_flag == 2
    path = str(tmp_path / "est.npz")
    save_estimator(est, path)
    est2 = load_estimator(make(), path)
    np.testing.assert_allclose(est2.Ps, est.Ps)
    assert est2.solver_flag == 2
    for k in range(16, 24):
        feed(est, k)
        feed(est2, k)
    np.testing.assert_allclose(est2.Ps, est.Ps, atol=1e-9)
    assert np.linalg.norm(est2.Ps[-1] - world.P[23]) < 0.1
    est.close()
    est2.close()


# ------------------------------------------------------------ both packages

def test_pose_graph_files_load_in_both_packages(rng, tmp_path):
    """The port's snapshot loads in the JAX package, whose own save of that
    database loads back in the port: every field, the bag-of-words state
    included, unchanged both ways."""
    from isvins_tpu.utils import checkpoint as jck

    db = _random_db(rng, 49, K=64, D=32, P=16)  # the vocabulary froze on the last add
    assert db.vocab_frozen
    db.loop_idx[40], db.loop_weight[40] = 3, 7.5
    ours, theirs, back = (str(tmp_path / f) for f in ("ours.npz", "theirs.npz", "back.npz"))
    save_pose_graph(db, ours)
    jdb = jck.load_pose_graph(ours)
    assert jdb.n == db.n
    jck.save_pose_graph(jdb, theirs)
    _assert_same_npz(_npz(ours), _npz(theirs))
    db2 = load_pose_graph(theirs, device="cpu")
    save_pose_graph(db2, back)
    _assert_same_npz(_npz(ours), _npz(back))
    for f in _DB_FIELDS:
        np.testing.assert_array_equal(getattr(db2, f)[: db.n], getattr(db, f)[: db.n])


def test_estimator_files_load_in_both_packages(tmp_path):
    """The port's estimator snapshot loads into a JAX Estimator, whose save
    of it loads back into the port: the same npz, key for key."""
    from isvins_tpu.config import WindowConfig as JWindowConfig
    from isvins_tpu.config import euroc_config as jeuroc_config
    from isvins_tpu.estimator.estimator import Estimator as JEstimator
    from isvins_tpu.solver import WindowDims as JDims
    from isvins_tpu.utils import checkpoint as jck

    cfg, world, make, feed = _resume_setup()
    est = make()
    for k in range(14):
        feed(est, k)
    assert est.solver_flag == 2 and est.priors is not None
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    save_estimator(est, ours)
    jcfg = jeuroc_config().replace(
        window=JWindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        tic=cfg.tic, ric=cfg.ric)
    jest = jck.load_estimator(JEstimator(jcfg, JDims(B=10, Vo=4, F=256, N=2048)), ours)
    jck.save_estimator(jest, theirs)
    a, b = _npz(ours), _npz(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype), err_msg=k)
    est2 = load_estimator(make(), theirs)
    np.testing.assert_array_equal(est2.Ps, est.Ps)
    np.testing.assert_array_equal(est2.f_manager.depth, est.f_manager.depth)
    est.close()


# ------------------------------------------------------------------- C3, C4

def test_save_collects_a_pending_solve(tmp_path):
    """C3: with solve_async=True a frame's solve is pending after
    process_image; a save then collects it before the marginalization, so
    the file equals a save taken after collecting by hand, and holds the
    solved window (not the pre-solve one)."""
    _, _, make, feed = _resume_setup()
    est, ref = make(solve_async=True), make(solve_async=True)
    for k in range(15):
        for e in (est, ref):
            e.collect_solve()
            feed(e, k)
    assert est._solve_pending is not None and est.solver_flag == 2
    before = est.Ps.copy()
    pending, collected = str(tmp_path / "pending.npz"), str(tmp_path / "collected.npz")
    save_estimator(est, pending)
    assert est._solve_pending is None and est._marg_future is None
    ref.collect_solve()
    ref.collect_marg()
    save_estimator(ref, collected)
    _assert_same_npz(_npz(pending), _npz(collected))
    assert not np.array_equal(_npz(pending)["Ps"], before)
    est.close()
    ref.close()


def test_save_leaves_the_database_as_it_was(rng, tmp_path):
    """C4: a save with a bag-of-words backlog pending writes the backfilled
    tf and df, but the live database keeps its tf, df and backlog."""
    import copy

    db = _random_db(rng, 49, K=64, D=32, P=16)  # frozen on the last add: the backlog is full
    assert db.vocab_frozen and len(db._bow_backlog) == 49
    tf, df, backlog = db.tf.copy(), db.df.copy(), list(db._bow_backlog)
    path = str(tmp_path / "pg.npz")
    save_pose_graph(db, path)
    np.testing.assert_array_equal(db.tf, tf)
    np.testing.assert_array_equal(db.df, df)
    assert db._bow_backlog == backlog
    flushed = copy.deepcopy(db)
    flushed.flush_bow()
    z = _npz(path)
    np.testing.assert_array_equal(z["tf"], flushed.tf[: db.n])
    np.testing.assert_array_equal(z["df"], flushed.df)
    assert (z["tf"].sum(axis=1) > 0).all()


def test_threaded_save_equals_inline_save(tmp_path):
    """C4: a System with its pose graph on the worker thread, saved after
    wait_pg_ready(), writes the same pose-graph file as the inline System
    on the same drive."""
    from isvins_tpu_torch.utils.synthetic import RoomRenderer
    from test_torch_system import N_FRAMES, R_BC, _config, _drive, _system

    world = make_world(n_frames=N_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=500, seed=3)
    renderer = RoomRenderer(world, _config("torch", True).camera, np.zeros(3),
                            mat_to_quat_np(np.array(R_BC)))
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    paths = []
    for pg_thread in (False, True):
        sys_ = _system("torch", True, pg_thread=pg_thread)
        _drive(sys_, world, frames)
        sys_.wait_pg_ready()
        paths.append(str(tmp_path / f"pg_{pg_thread}.npz"))
        save_pose_graph(sys_.pgbuilder.db, paths[-1])
        assert sys_.pgbuilder.db.n > 0
        sys_.close()
    _assert_same_npz(_npz(paths[0]), _npz(paths[1]))
    assert os.path.getsize(paths[0]) > 0

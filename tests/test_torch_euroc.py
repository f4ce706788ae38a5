"""The port's EuRoC path on the CPU: the fixture writer
(utils/euroc_fixture), the loader with its native parser and PNG codec
(data/), the driver (run_euroc) and the covariance dump
(utils/visualization).

Mirrors of tests/test_euroc_rehearsal.py's three cases and of
tests/test_posegraph.py's covariance-dump case on the port, and the port
held to the JAX package: the fixture's CSVs byte-equal to the JAX writer's
and its PNGs decoding to the same pixels, and the PNG codec against PIL in
both directions."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from isvins_tpu_torch.config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                                     WindowConfig, euroc_config)
from isvins_tpu_torch.data import png
from isvins_tpu_torch.geom import hostmath as hm
from isvins_tpu_torch.solver import WindowDims
from isvins_tpu_torch.utils.euroc_fixture import write_euroc_fixture
from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

N_FRAMES = 36


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    """test_euroc_rehearsal.fixture_tree on the port: a 36-frame 320x240
    world (seed 6) written as a EuRoC tree by the port's writer."""
    H, W, f = 240, 320, 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                              lk_win=21, equalize=False, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=64, max_kp_per_kf=128),
        tic=(0.0, 0.0, 0.0), ric=R_bc,
    )
    world = make_world(n_frames=N_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=400, seed=6)
    renderer = RoomRenderer(world, cam, np.zeros(3), hm.mat_to_quat_np(np.array(R_bc)))
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    root = tmp_path_factory.mktemp("euroc_fix")
    mav0 = write_euroc_fixture(str(root), world, frames)
    return mav0, cfg, world, frames


def test_fixture_tree_is_euroc_format(fixture_tree):
    mav0 = fixture_tree[0]
    with open(os.path.join(mav0, "imu0", "data.csv")) as f:
        head = f.readline()
        row = f.readline().split(",")
    assert head.startswith("#timestamp [ns],w_RS_S_x")
    assert len(row) == 7 and int(row[0]) > 10 ** 18  # epoch-scale ns stamps
    with open(os.path.join(mav0, "cam0", "data.csv")) as f:
        f.readline()
        ts, name = f.readline().strip().split(",")
    assert name == f"{ts}.png"
    assert os.path.exists(os.path.join(mav0, "cam0", "data", name))
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")) as f:
        f.readline()
        assert len(f.readline().split(",")) == 17


def test_fixture_equals_jax_writer(fixture_tree, tmp_path):
    """The JAX package's writer (PIL for the PNGs) on the same world and
    frames: every CSV byte-equal, every PNG decoding to the same pixels (the
    float frames truncated to uint8 alike)."""
    from isvins_tpu.utils.euroc_fixture import write_euroc_fixture as jax_write

    mav0, _, world, frames = fixture_tree
    jmav0 = jax_write(str(tmp_path), world, frames)
    for rel in ("imu0/data.csv", "cam0/data.csv", "state_groundtruth_estimate0/data.csv"):
        with open(os.path.join(mav0, rel), "rb") as a, open(os.path.join(jmav0, rel), "rb") as b:
            assert a.read() == b.read(), rel
    names = sorted(os.listdir(os.path.join(mav0, "cam0", "data")))
    assert names == sorted(os.listdir(os.path.join(jmav0, "cam0", "data")))
    assert len(names) == N_FRAMES
    for name in names:
        ours = png.read_png(os.path.join(mav0, "cam0", "data", name))
        theirs = np.asarray(Image.open(os.path.join(jmav0, "cam0", "data", name)))
        np.testing.assert_array_equal(ours, theirs)


def test_loader_roundtrips_through_native_parser(fixture_tree):
    """The loader reproduces the world's IMU stream (ns -> s through the
    native parser) in time order and decodes the PNGs to the rendered
    pixels; the same tree through the JAX package's loader gives the same
    samples, images and ground truth."""
    from isvins_tpu.data import EurocDataset as JDataset
    from isvins_tpu_torch import native
    from isvins_tpu_torch.data import EurocDataset

    mav0, _, _, frames = fixture_tree
    ds = EurocDataset(mav0)
    assert ds.csv_parser == ("native" if native.available() else "numpy")
    assert len(ds.images) == N_FRAMES
    assert len(ds.imu) > 600  # 3.5 s at 200 Hz
    last = -np.inf
    kinds = set()
    for kind, m in ds.stream():
        assert m.t >= last - 1e-9
        last = m.t
        kinds.add(kind)
    assert kinds == {"imu", "image"}
    img = ds.images[0].load()
    assert img.shape == (240, 320) and img.dtype == np.float32
    np.testing.assert_array_equal(img, np.clip(frames[0], 0, 255).astype(np.uint8))
    assert ds.ground_truth is not None and len(ds.ground_truth["t"]) == N_FRAMES

    jds = JDataset(mav0)
    assert [s.t for s in ds.imu] == [s.t for s in jds.imu]
    np.testing.assert_array_equal(np.stack([s.acc for s in ds.imu]),
                                  np.stack([s.acc for s in jds.imu]))
    np.testing.assert_array_equal(np.stack([s.gyr for s in ds.imu]),
                                  np.stack([s.gyr for s in jds.imu]))
    assert [s.t for s in ds.images] == [s.t for s in jds.images]
    np.testing.assert_array_equal(ds.images[-1].load(), jds.images[-1].load())
    for k in ("t", "p", "q", "v"):
        np.testing.assert_array_equal(ds.ground_truth[k], jds.ground_truth[k])


def test_run_euroc_end_to_end(fixture_tree, tmp_path):
    """The port's driver replays the tree on the CPU: TUM outputs written,
    ATE against the fixture's ground truth sane, the covariance dump one
    line per keyframe."""
    from isvins_tpu_torch import run_euroc

    mav0, cfg = fixture_tree[:2]
    out = str(tmp_path / "out")
    res = run_euroc.main([mav0, "--out-dir", out, "--device", "cpu"], cfg=cfg,
                         dims=WindowDims(B=10, Vo=4, F=256, N=2048))
    assert res["n_frames"] == N_FRAMES
    assert res["n_vio_poses"] >= 15, res
    assert os.path.exists(res["pose_output"])
    assert os.path.exists(res["loop_pose_output"])
    with open(res["pose_output"]) as f:
        first = f.readline().split()
    assert len(first) == 8  # t x y z qx qy qz qw
    assert float(first[0]) > 10 ** 9  # epoch-scale seconds preserved
    assert res["ate_rmse"] is not None and res["ate_rmse"] < 0.5, res
    with open(os.path.join(out, "loop_cov_output.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == res["n_keyframes"] >= 1
    assert all(len(line.split()) == 4 + 36 for line in lines)


# ------------------------------------------------------------------ PNG codec

def _pil_png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def _filtered_png(img: np.ndarray, types) -> bytes:
    """A PNG of `img` with row r filtered by types[r], by the PNG spec's
    forward filters pixel by pixel (section 9.2)."""
    H, W = img.shape
    x = img.astype(np.int64)
    rows = []
    for r in range(H):
        out = [types[r]]
        for c in range(W):
            a = x[r, c - 1] if c else 0
            b = x[r - 1, c] if r else 0
            cc = x[r - 1, c - 1] if r and c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            pred = [0, a, b, (a + b) // 2, paeth][types[r]]
            out.append((x[r, c] - pred) % 256)
        rows.append(bytes(out))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (37, 53), (240, 320)])
def test_png_codec_against_pil(shape):
    """PIL's files (adaptive row filters) decode to PIL's pixels, and the
    port's files decode in PIL to the port's pixels: exact, both ways."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256).astype(np.uint8)
    for img in (noise, ramp):
        np.testing.assert_array_equal(png.decode_png(_pil_png(img)), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png.encode_png(img)))), img)


def test_png_decodes_every_row_filter():
    """Rows filtered with None, Sub, Up, Average and Paeth in one file (the
    anti-diagonal wavefront path), and a file of None/Sub/Up rows only (the
    row path): both equal the image and PIL's decode of the same bytes."""
    img = np.random.default_rng(5).integers(0, 256, (23, 17), dtype=np.uint8)
    for types in ([r % 5 for r in range(23)], [r % 3 for r in range(23)]):
        data = _filtered_png(img, types)
        np.testing.assert_array_equal(png.decode_png(data), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


def test_png_refuses_other_kinds():
    """Colour, 16-bit and interlaced files, and a corrupted chunk, raise."""
    rgb = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8), mode="RGB").save(rgb, format="PNG")
    deep = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(deep, format="PNG")
    data = png.encode_png(np.zeros((4, 4), np.uint8))
    ihdr = data[16:29]
    interlaced = data[:8] + _chunk(b"IHDR", ihdr[:12] + b"\x01") + data[33:]
    corrupt = data[:-20] + bytes([data[-20] ^ 1]) + data[-19:]
    for bad in (rgb.getvalue(), deep.getvalue(), interlaced, corrupt, b"GIF89a"):
        with pytest.raises(ValueError):
            png.decode_png(bad)


# ----------------------------------------------------------- covariance dump

def test_covariance_grows_then_shrinks_with_loop():
    """tests/test_posegraph.py:121 on the port: the per-keyframe covariance
    grows away from the gauge pose along an open chain and shrinks at the
    far end once a loop ties it back; the text dump surfaces the blocks."""
    from isvins_tpu_torch.posegraph import KeyframeDB, optimize_pose_graph
    from isvins_tpu_torch.utils.visualization import covariance_tum

    from test_posegraph import _circle_kfs

    n = 30
    t_gt, q_gt = _circle_kfs(n)

    def rel(i, j):
        Ri = hm.quat_to_mat_np(q_gt[i])
        return Ri.T @ (t_gt[j] - t_gt[i]), hm.mat_to_quat_np(Ri.T @ hm.quat_to_mat_np(q_gt[j]))

    def build_db(with_loop):
        db = KeyframeDB(32, 8, 8, device="cpu")
        for k in range(n):
            db.add(ts=float(k), vio_t=t_gt[k], vio_q=q_gt[k], opt_t=t_gt[k], opt_q=q_gt[k])
        for k in range(n - 1):
            db.edge_dt[k], db.edge_dq[k] = rel(k, k + 1)
            db.edge_sqrt[k] = np.eye(6) * 30.0
            db.edge_valid[k] = True
        if with_loop:
            k = n - 1
            db.loop_idx[k] = 0
            db.loop_dt[k], db.loop_dq[k] = rel(0, k)
            db.loop_weight[k] = 900.0
        optimize_pose_graph(db, 0, n - 1, iters=10)
        return db

    db_open = build_db(with_loop=False)
    tr_open = [np.trace(db_open.cov[k]) for k in range(n)]
    assert tr_open[n // 2] > tr_open[2] > 0
    assert tr_open[n - 1] > tr_open[n // 2]
    db_loop = build_db(with_loop=True)
    assert np.trace(db_loop.cov[n - 1]) < 0.5 * tr_open[n - 1], (
        np.trace(db_loop.cov[n - 1]), tr_open[n - 1])
    dump = covariance_tum(db_loop.ts[:n], db_loop.opt_t[:n], db_loop.cov[:n])
    rows = [line.split() for line in dump.splitlines()]
    assert len(rows) == n and all(len(r) == 4 + 36 for r in rows)
    np.testing.assert_allclose(np.array(rows[-1][4:], float).reshape(6, 6),
                               db_loop.cov[n - 1], rtol=1e-8)

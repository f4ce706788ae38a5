"""The port's feature tracker (isvins_tpu_torch.frontend: image pyramid,
CLAHE, min-distance mask, pyramidal LK, the fused epipolar RANSAC and
FeatureTracker) against the JAX package on the CPU, on the same seeded
numpy inputs, each with its tolerance stated; the port's own mirrors of the
reference's tracker tests; and the image renderers' numpy copies."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.config import CameraConfig, TrackerConfig
from isvins_tpu.frontend import FeatureTracker as JTracker
from isvins_tpu.frontend import image_ops as jops
from isvins_tpu.frontend.lk import pyramidal_lk as jax_lk
from isvins_tpu.initial.five_point import epipolar_inliers as jax_epipolar_inliers
from isvins_tpu.geom import hostmath as hm
from isvins_tpu.utils import synthetic as jsyn
from isvins_tpu_torch.config import CameraConfig as TCameraConfig
from isvins_tpu_torch.config import TrackerConfig as TTrackerConfig
from isvins_tpu_torch.frontend import FeatureTracker
from isvins_tpu_torch.frontend import image_ops as tops
from isvins_tpu_torch.frontend.lk import pyramidal_lk
from isvins_tpu_torch.initial.five_point import epipolar_inliers
from isvins_tpu_torch.utils import perf
from isvins_tpu_torch.utils import synthetic as tsyn
from isvins_tpu_torch.utils.convert import tracker_state

from test_frontend import _texture

CPU = "cpu"
R_BC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
CAM_320 = dict(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0)
f32 = lambda a: torch.as_tensor(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: when several test processes share one
    machine, torch's intra-op thread pools only contend with each other
    (this file's drives ran 10-20x slower beside three other workers than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(H, W, seed):
    return _texture(H, W, seed).astype(np.float32)


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_pyramid_matches_reference(levels):
    """pyr_down / build_pyramid in f32: rtol 1e-6, atol 1e-4 (0-255 scale;
    the same taps in the same order, only XLA's fusion rounds apart)."""
    img = _image(97, 130, 2) * 3.0
    ref = jops.build_pyramid(jnp.asarray(img), levels)
    out = tops.build_pyramid(f32(img), levels)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tops.pyr_down(f32(img)).numpy(),
                               np.asarray(jops.pyr_down(jnp.asarray(img))), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("radius", [1, 16, 25])
def test_min_dist_mask_exact(radius):
    """The bounding-window mask equals the reference's (N, H, W) one bit for
    bit, with points on pixel centres, between them, on and beyond the
    border, invalid ones and a non-finite invalid one."""
    rng = np.random.default_rng(radius)
    H, W = 120, 200
    pts = np.concatenate([rng.uniform([-30, -30], [W + 30, H + 30], size=(12, 2)),
                          rng.integers(0, [W, H], size=(4, 2)).astype(float),
                          [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 0.5, 3.25], [np.nan, 5.0]]])
    pts = pts.astype(np.float32)
    valid = rng.random(len(pts)) < 0.7
    valid[-1] = False
    ref = np.asarray(jops.min_dist_mask(H, W, jnp.asarray(pts), jnp.asarray(valid), radius))
    out = tops.min_dist_mask(H, W, f32(pts), torch.as_tensor(valid), radius).numpy()
    assert out.any() and not out.all()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,lo,hi", [((96, 128), 100, 140), ((480, 752), 0, 255)])
def test_clahe_matches_reference(shape, lo, hi):
    """CLAHE within 1e-3 on the 0-255 scale (integer histograms; the f32
    clip, CDF and interpolation in the reference's order), on a
    low-contrast image and on a full-range EuRoC-sized one; and the
    reference's sanity check (contrast stretched)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(lo, hi, size=shape).astype(np.float32)
    img[:5, :7] = 255.0  # a clipped corner
    ref = np.asarray(jops.clahe(jnp.asarray(img)))
    out = tops.clahe(f32(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert np.isfinite(out).all()
    if hi - lo < 100:
        assert out.std() > img.std() * 1.2


def _shifted_pair(H, W, shift, seed=1):
    from scipy.ndimage import map_coordinates

    img0 = _texture(H, W, seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img1 = map_coordinates(img0, [y - shift[1], x - shift[0]], order=1)
    return img0.astype(np.float32), img1.astype(np.float32)


def _sinusoid_pair(H, W, shift, seed=1):
    """_texture's random sum of sinusoids sampled on the pixel grid and on
    the grid shifted by `shift` (px): the second image is the first moved,
    with true content up to its border (no fill)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img0, img1 = np.zeros((H, W)), np.zeros((H, W))
    for _ in range(24):
        fx, fy = rng.uniform(0.01, 0.15, 2)
        ph = rng.uniform(0, 2 * np.pi)
        a = rng.uniform(5, 25)
        img0 += a * np.sin(fx * x + fy * y + ph)
        img1 += a * np.sin(fx * (x - shift[0]) + fy * (y - shift[1]) + ph)
    lo = img0.min()
    return (img0 - lo).astype(np.float32), (img1 - lo).astype(np.float32)


def test_lk_matches_reference_with_border_features():
    """pyramidal_lk forward (3 levels) and the tracker's single-level
    backward pass with guess0: identical ok masks and positions within 1e-3
    px where ok, with features inside the image, within the padding of the
    border, and invalid ones. The second image is the first moved with true
    content at its border (a zero-filled border leaves a feature there
    without a solution, whose iterates wander wherever rounding takes them,
    in either package)."""
    H, W = 120, 160
    img0, img1 = _sinusoid_pair(H, W, (3.3, -2.4))
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform([20, 20], [W - 20, H - 20], size=(30, 2)),
                          rng.uniform([0, 0], [13, H], size=(6, 2)),
                          rng.uniform([W - 13, 0], [W, H], size=(6, 2)),
                          rng.uniform([0, 0], [W, 13], size=(6, 2)),
                          rng.uniform([0, H - 13], [W, H], size=(6, 2))]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    j = [np.asarray(a) for a in jax_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                                       jnp.asarray(valid))]
    t = [a.numpy() for a in pyramidal_lk(f32(img0), f32(img1), f32(pts), torch.as_tensor(valid))]
    np.testing.assert_array_equal(t[1], j[1])
    assert j[1].sum() > 40 and j[1][30:].sum() > 15 and (~j[1]).sum() > 5
    np.testing.assert_allclose(t[0][j[1]], j[0][j[1]], rtol=0, atol=1e-3)
    # the backward pass of the flow-back gate: levels=1, iters=8, guess0
    jb = [np.asarray(a) for a in jax_lk(jnp.asarray(img1), jnp.asarray(img0), jnp.asarray(j[0]),
                                        jnp.asarray(j[1]), levels=1, iters=8,
                                        guess0=jnp.asarray(pts))]
    tb = [a.numpy() for a in pyramidal_lk(f32(img1), f32(img0), f32(j[0]),
                                          torch.as_tensor(j[1].copy()), levels=1, iters=8,
                                          guess0=f32(pts))]
    np.testing.assert_array_equal(tb[1], jb[1])
    np.testing.assert_allclose(tb[0][jb[1]], jb[0][jb[1]], rtol=0, atol=1e-3)


@pytest.mark.parametrize("levels", [1, 3])
def test_lk_clamps_windows_as_the_reference(levels):
    """Features more than 2 px outside the image, whose windows start
    outside the padded image: jax.lax.dynamic_slice counts a negative start
    from the far end and clamps the start so that the window stays inside
    the image, and the port places the window the same way. One LK
    iteration from the same start gives the same position (1e-3 px) and
    residual (1e-3). Further iterations are not compared: with the window
    held by the clamp, the step jumps where the position crosses an integer
    (the fractional offset wraps while the window stays), so the iterates of
    such a feature follow the rounding of either package."""
    H, W = 120, 160
    img0, img1 = _sinusoid_pair(H, W, (3.3, -2.4))
    pts = np.array([[-4.0, 50.0], [-19.5, 40.25], [W + 6.0, 60.0], [W + 30.0, -30.0],
                    [70.0, -15.0], [90.5, H + 8.75], [-40.0, H + 40.0]], np.float32)
    valid = np.ones(len(pts), bool)
    j = [np.asarray(a) for a in jax_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                                       jnp.asarray(valid), levels=levels, iters=1)]
    t = [a.numpy() for a in pyramidal_lk(f32(img0), f32(img1), f32(pts), torch.as_tensor(valid),
                                         levels=levels, iters=1)]
    assert np.isfinite(t[0]).all() and np.isfinite(t[2]).all()
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t[1], j[1])


def test_lk_recovers_shift():
    """test_frontend.test_lk_recovers_shift on the port."""
    H, W = 120, 160
    shift = np.array([3.3, -2.4])
    img0, img1 = _shifted_pair(H, W, shift)
    pts = np.random.default_rng(0).uniform([20, 20], [W - 20, H - 20], size=(30, 2))
    p1, ok, _ = pyramidal_lk(f32(img0), f32(img1), f32(pts), torch.ones(30, dtype=torch.bool))
    ok = ok.numpy()
    assert ok.sum() > 20
    np.testing.assert_allclose((p1.numpy() - pts)[ok], np.tile(shift, (int(ok.sum()), 1)),
                               atol=0.2)


def test_shi_tomasi_finds_corners():
    """test_frontend.test_shi_tomasi_finds_corners on the port."""
    H, W = 96, 128
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    centers = [(30, 40), (70, 90), (50, 20)]
    img = sum(120.0 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * 2.5**2)) for cy, cx in centers)
    pts, _, _ = tops.nms_topk(tops.shi_tomasi_response(f32(img)), 3, 8)
    pts = pts.numpy()
    for cy, cx in centers:
        assert np.sqrt((pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2).min() < 4.0


def _two_view(seed=5, n=120, outlier_share=0.25):
    """test_frontend.test_epipolar_inliers_fused's geometry."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], axis=1)
    R = hm.quat_to_mat_np(hm.so3_exp_quat_np(np.array([0.03, -0.12, 0.05])))
    t = np.array([0.3, -0.05, 0.1])
    p1 = X[:, :2] / X[:, 2:3]
    Xc2 = X @ R.T + t
    p2 = Xc2[:, :2] / Xc2[:, 2:3]
    is_out = rng.random(n) < outlier_share
    p2 = p2 + is_out[:, None] * rng.normal(scale=0.05, size=(n, 2))
    samples = np.stack([rng.choice(n, size=8, replace=False) for _ in range(128)])
    return p1, p2, is_out, samples


def test_epipolar_inliers_matches_reference():
    """The fused (f32) classification on test_epipolar_inliers_fused's
    geometry: the same inlier mask and count as the reference's eigh route
    (here QR nullspaces and inverse iteration), keeping the true
    correspondences and rejecting the contaminated ones; and with a third
    of the rows masked out."""
    p1, p2, is_out, samples = _two_view()
    thresh_sq = (2.0 / 460.0) ** 2
    for valid in (np.ones(len(p1), bool), np.arange(len(p1)) % 3 != 0):
        ji, jn = jax_epipolar_inliers(jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32),
                                      jnp.asarray(valid), jnp.asarray(samples.astype(np.int32)),
                                      thresh_sq)
        ti, tn = epipolar_inliers(f32(p1), f32(p2), torch.as_tensor(valid),
                                  torch.as_tensor(samples), thresh_sq)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tn) == int(jn)
        inl = ti.numpy()
        assert inl[~is_out & valid].mean() > 0.9
        assert 1.0 - inl[is_out & valid].mean() > 0.85


def test_epipolar_inliers_survive_a_nonfinite_masked_row():
    """ROADMAP C5: a diverged (NaN) track outside `valid` must not poison
    the refit through its zero weight (NaN * 0 is NaN); the classification
    of the valid rows is the one without it."""
    p1, p2, _, samples = _two_view()
    thresh_sq = (2.0 / 460.0) ** 2
    valid = np.ones(len(p1), bool)
    valid[7] = False
    clean, n_clean = epipolar_inliers(f32(p1), f32(p2), torch.as_tensor(valid),
                                      torch.as_tensor(samples), thresh_sq)
    p2n = p2.copy()
    p2n[7] = np.nan
    samples = samples[~(samples == 7).any(axis=1)]  # keep every hypothesis finite
    out, n_out = epipolar_inliers(f32(p1), f32(p2n), torch.as_tensor(valid),
                                  torch.as_tensor(samples), thresh_sq)
    assert int(n_out) > 60
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


def _blob_world(n_frames=8):
    """test_frontend.test_tracker_follows_rendered_world's world and
    Gaussian-blob renderer (320x240, f = 200)."""
    W, H = CAM_320["width"], CAM_320["height"]
    world = jsyn.make_world(n_frames=n_frames, frame_hz=25.0, n_landmarks=400, seed=3)
    qic = hm.mat_to_quat_np(np.array(R_BC))
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]])
    base = _texture(H, W, 9) * 0.04
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)

    def render(k):
        pts, _, vis = jsyn.project(world, k, np.zeros(3), qic)
        px = (K @ pts.T).T[:, :2]
        inb = vis & (px[:, 0] > 5) & (px[:, 0] < W - 5) & (px[:, 1] > 5) & (px[:, 1] < H - 5)
        img = base.copy()
        for p in px[inb]:
            img += 120.0 * np.exp(-((x - p[0]) ** 2 + (y - p[1]) ** 2) / (2 * 3.0**2))
        return np.clip(img, 0, 255), px, inb

    return world, render


@pytest.fixture(scope="module")
def blob_frames():
    world, render = _blob_world()
    return world, [render(k) for k in range(8)]


def _packet_match(a, b, where):
    """Tracker packets: identical ids and track counts; pts_px within 1e-3
    px, pts_norm within 1e-5, vel within 1e-3 (normalized units per
    second)."""
    np.testing.assert_array_equal(b["ids"], a["ids"], err_msg=where)
    np.testing.assert_array_equal(b["track_cnt"], a["track_cnt"], err_msg=where)
    np.testing.assert_allclose(b["pts_px"], a["pts_px"], rtol=0, atol=1e-3, err_msg=where)
    np.testing.assert_allclose(b["pts_norm"], a["pts_norm"], rtol=0, atol=1e-5, err_msg=where)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=1e-3, err_msg=where)


@pytest.mark.parametrize("fused", [True, False])
def test_read_image_matches_reference(blob_frames, fused):
    """FeatureTracker.read_image, port (CPU) against JAX on 6 uint8 frames
    of the reference test's 320x240 world, with CLAHE, the flow-back gate,
    and the fused (device-step) or host (f64) epipolar RANSAC set
    explicitly in both packages. Tracks leave the view and are refilled,
    so partly observed tracks are in every packet."""
    tk = dict(max_cnt=60, min_dist=16, lk_levels=3, lk_win=21, equalize=True, border=4,
              fused_ransac=fused)
    jt = JTracker(CameraConfig(**CAM_320), TrackerConfig(**tk))
    tt = FeatureTracker(TCameraConfig(**CAM_320), TTrackerConfig(**tk), device=CPU)
    assert tt.fused_ransac is fused
    _, frames = blob_frames
    new_ids = 0
    for k in range(6):
        img = frames[k][0].astype(np.uint8)
        a, b = jt.read_image(img, 0.04 * k), tt.read_image(img, 0.04 * k)
        _packet_match(a, b, f"frame {k}")
        new_ids += int((a["track_cnt"] == 1).sum()) if k else 0
    assert new_ids > 0 and tt.next_id == jt.next_id and tt._ransac_seed == jt._ransac_seed


def test_load_state_continues_the_reference(blob_frames):
    """A port tracker given the JAX tracker's host state mid-sequence
    (utils.convert.tracker_state, FeatureTracker.load_state) goes on as the
    JAX tracker does."""
    tk = dict(max_cnt=60, min_dist=16, lk_levels=3, lk_win=21, equalize=False, border=4,
              fused_ransac=True)
    jt = JTracker(CameraConfig(**CAM_320), TrackerConfig(**tk))
    tt = FeatureTracker(TCameraConfig(**CAM_320), TTrackerConfig(**tk), device=CPU)
    _, frames = blob_frames
    for k in range(3):
        jt.read_image(frames[k][0], 0.04 * k)
    tt.load_state(tracker_state(jt))
    for k in range(3, 6):
        _packet_match(jt.read_image(frames[k][0], 0.04 * k), tt.read_image(frames[k][0], 0.04 * k),
                      f"frame {k}")


def test_tracker_follows_rendered_world(blob_frames):
    """test_frontend.test_tracker_follows_rendered_world on the port: IDs
    persist and tracked features sit within 1.5 px of a true projection."""
    tracker = FeatureTracker(TCameraConfig(**CAM_320),
                             TTrackerConfig(max_cnt=60, min_dist=16, lk_levels=3, lk_win=21,
                                            equalize=False, border=4), device=CPU)
    _, frames = blob_frames
    id_hits = total = 0
    prev = None
    for k in range(6):
        img, px, inb = frames[k]
        out = tracker.read_image(img, k * 0.04)
        if k >= 2:
            d = np.sqrt(((out["pts_px"][:, None, :] - px[None, inb, :]) ** 2).sum(-1)).min(axis=1)
            tracked = out["track_cnt"] >= 2
            assert tracked.sum() > 15
            assert (d[tracked] < 1.5).mean() > 0.7
            if prev is not None:
                id_hits += len(np.intersect1d(out["ids"], prev["ids"]))
                total += len(out["ids"])
        prev = out
    assert id_hits > 0.6 * total


def test_tracker_runs_with_fisheye_model():
    """test_cameras.test_tracker_runs_with_fisheye_model on the port: the
    frontend is camera-model agnostic (the KB lift)."""
    H, W = 96, 128
    cfg = TCameraConfig(model="equidistant", width=W, height=H, fx=60.0, fy=60.0, cx=W / 2,
                        cy=H / 2, kb=(0.004, 0.0007, -0.002, 0.0002))
    tr = FeatureTracker(cfg, TTrackerConfig(max_cnt=30, min_dist=8, freq=100, equalize=False,
                                            lk_levels=2, flow_back=False), device=CPU)
    base = np.random.default_rng(3).uniform(0, 60, (H, W)).astype(np.float32)
    for k in range(3):
        out = tr.read_image(np.roll(base, shift=k, axis=1), t=0.1 * k)
    assert out["ids"].size > 0
    assert np.isfinite(out["pts_norm"]).all()


def test_tracker_survives_nuisances():
    """test_adversarial.test_tracker_survives_nuisances on the port: under
    blur + flicker + bursts + occluders enough aged tracks survive."""
    from test_adversarial import NUISANCE

    cam = TCameraConfig(**CAM_320)
    world = tsyn.make_world(n_frames=14, frame_hz=10.0, imu_hz=200.0, n_landmarks=10, seed=3)
    renderer = tsyn.RoomRenderer(world, cam, np.zeros(3), hm.mat_to_quat_np(np.array(R_BC)),
                                 **NUISANCE)
    tracker = FeatureTracker(cam, TTrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                                                 lk_win=21, equalize=True, border=4), device=CPU)
    for k in range(14):
        out = tracker.read_image(renderer.render(k)[0], world.frame_times[k])
    assert int((out["track_cnt"] >= 3).sum()) >= 25


def test_dispatch_collect_contract():
    """One dispatch pending at a time; collect returns read_image's packet."""
    tk = TTrackerConfig(max_cnt=30, min_dist=8, lk_levels=2, equalize=False)
    a = FeatureTracker(TCameraConfig(**CAM_320), tk, device=CPU)
    b = FeatureTracker(TCameraConfig(**CAM_320), tk, device=CPU)
    imgs = [np.roll(_image(240, 320, 6), k, axis=0).astype(np.uint8) for k in range(3)]
    for k, img in enumerate(imgs):
        pend = a.dispatch(img, 0.05 * k)
        with pytest.raises(AssertionError):
            a.dispatch(img, 0.05 * k)
        _packet_match(b.read_image(img, 0.05 * k), a.collect(pend), f"frame {k}")


def test_cpu_tracker_never_captures():
    """The CPU tracker steps eagerly on every frame, a reset and a
    load_state among them: no CUDA graph is captured or replayed, every
    dispatch counts among eager_steps, and with utils.perf on each step sits
    in a trk.step_eager span and none in trk.replay."""
    tk = TTrackerConfig(max_cnt=30, min_dist=8, lk_levels=2, equalize=False)
    tr = FeatureTracker(TCameraConfig(**CAM_320), tk, device=CPU)
    imgs = [np.roll(_image(240, 320, 6), k, axis=0).astype(np.uint8) for k in range(6)]
    perf.reset()
    perf.enable(True)
    try:
        for k, img in enumerate(imgs):
            if k == 2:
                tr.reset()
            if k == 4:
                tr.load_state(tracker_state(tr))
            tr.read_image(img, 0.05 * k)
        names = [s.name for s in perf.spans()]
    finally:
        perf.enable(False)
        perf.reset()
    assert (tr.captures, tr.replays, tr.eager_steps) == (0, 0, len(imgs))
    assert names.count("trk.step_eager") == len(imgs) and "trk.replay" not in names
    assert tr._graph is None and tr._prev_static is None


@pytest.mark.parametrize("name", ["StampRenderer", "PatchRenderer"])
def test_renderers_match_reference(name):
    """The port's numpy copies of the JAX package's renderers give the same
    image, projections and visibility for two frames (exact)."""
    cam_j, cam_t = CameraConfig(**CAM_320), TCameraConfig(**CAM_320)
    qic = hm.mat_to_quat_np(np.array(R_BC))
    jw = jsyn.make_world(n_frames=4, n_landmarks=120, seed=2)
    tw = tsyn.make_world(n_frames=4, n_landmarks=120, seed=2)
    jr = getattr(jsyn, name)(jw, cam_j, np.zeros(3), qic)
    tr = getattr(tsyn, name)(tw, cam_t, np.zeros(3), qic)
    for k in (0, 3):
        for a, b in zip(jr.render(k), tr.render(k)):
            np.testing.assert_array_equal(b, a)
        assert jr.render(k)[2].sum() > 5

"""The port's camera models and image kernels (isvins_tpu_torch.frontend)
against the JAX package on the CPU, on the same numpy inputs: the four
camera models in f64, the image kernels of the pose graph's keyframe step
in f32, each with its tolerance stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.config import CameraConfig
from isvins_tpu.frontend import camera as jcam
from isvins_tpu.frontend import image_ops as jops
from isvins_tpu_torch.config import CameraConfig as TCameraConfig
from isvins_tpu_torch.frontend import camera as tcam
from isvins_tpu_torch.frontend import image_ops as tops

from test_cameras import _fit_ocam, _rays
from test_frontend import _texture

T = lambda a: torch.as_tensor(np.array(a))


def _camera_configs():
    """The calibrations of tests/test_cameras.py, one per model."""
    poly, inv_poly = _fit_ocam()
    return {
        "pinhole": (dict(), 35.0),  # EuRoC calib
        "mei": (dict(model="mei", xi=0.9, fx=600.0, fy=602.0, cx=370.0, cy=240.0,
                     k1=-0.2, k2=0.05, p1=1e-4, p2=-2e-4), 60.0),
        "equidistant": (dict(model="equidistant", fx=285.7, fy=286.0, cx=254.9, cy=256.9,
                             kb=(0.00348, 0.000715, -0.00205, 0.000203)), 80.0),
        "scaramuzza": (dict(model="scaramuzza", fx=160.0, cx=320.0, cy=240.0,
                            ocam_poly=poly, ocam_inv_poly=inv_poly,
                            ocam_cde=(1.0002, -3e-5, 4e-5)), 70.0),
    }


@pytest.mark.parametrize("model", list(_camera_configs()))
def test_camera_matches_reference(model):
    """space_to_plane and lift_projective in f64 on the same points and
    pixels: within 1e-9 px, and 1e-12 + 1e-10 relative on the normalized
    plane (rays near 90 deg off-axis reach |x/z| ~ 1e4), of the JAX models
    (the same operations; only libm's last bits differ), the same class
    from make_camera, and the same focal."""
    kw, max_angle = _camera_configs()[model]
    jc = jcam.make_camera(CameraConfig(**kw))
    tc = tcam.make_camera(TCameraConfig(**kw))
    assert type(tc).__name__ == type(jc).__name__
    pts = _rays(max_angle_deg=max_angle)
    pts[:3] = [[0.0, 0.0, 2.0], [1e-13, 0.0, 1.0], [0.3, -0.2, 1e-12]]  # guards
    uv = tc.space_to_plane(T(pts)).numpy()
    np.testing.assert_allclose(uv, np.asarray(jc.space_to_plane(jnp.asarray(pts))),
                               rtol=0, atol=1e-9)
    ray = tc.lift_projective(T(uv)).numpy()
    np.testing.assert_allclose(ray, np.asarray(jc.lift_projective(jnp.asarray(uv))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(tc.focal), float(jc.focal), rtol=1e-15)
    # (..., 3) batches and the input's dtype are kept
    out = tc.space_to_plane(T(pts).reshape(4, 50, 3).to(torch.float32))
    assert out.shape == (4, 50, 2) and out.dtype == torch.float32


def test_make_camera_rejects_unknown_and_incomplete():
    with pytest.raises(ValueError):
        tcam.make_camera(TCameraConfig(model="nope"))
    with pytest.raises(ValueError):
        tcam.make_camera(TCameraConfig(model="scaramuzza"))


def _image():
    rng = np.random.default_rng(1)
    img = _texture(120, 160, 3) + rng.normal(scale=2.0, size=(120, 160))
    img[40:60, 50:90] = 17.0  # a flat patch: ties at the local-max test
    return img.astype(np.float32)


@pytest.mark.parametrize("fn", ["gaussian_blur", "sobel", "shi_tomasi_response"])
def test_image_kernels_match_reference(fn):
    """f32 on the same image: rtol 1e-5 (the Gaussian taps come from each
    framework's own exp, which may differ in the last bit), atol 1e-5 of
    the output's scale."""
    img = _image()
    args = {"gaussian_blur": (2.0, 4), "sobel": (), "shi_tomasi_response": ()}[fn]
    out = getattr(tops, fn)(T(img), *args)
    ref = getattr(jops, fn)(jnp.asarray(img), *args)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("border, k", [(14, 256), (8, 40)])
def test_nms_topk_same_corners_same_order(border, k):
    """nms_topk on the reference's own Shi-Tomasi response: the same
    corners in the same order (ties go to the lower flat index, as
    jax.lax.top_k breaks them), the same values and validity; a forbid mask
    is honored the same way."""
    resp = np.array(jops.shi_tomasi_response(jnp.asarray(_image())))
    resp[70:80, 100:110] = resp.max()  # a plateau of tied maxima
    forbid = np.zeros_like(resp, bool)
    forbid[:, :20] = True
    for mask in (None, forbid):
        xy, vals, ok = tops.nms_topk(T(resp), k, 10, border=border,
                                     forbid_mask=None if mask is None else T(mask))
        jxy, jvals, jok = jops.nms_topk(jnp.asarray(resp), k, 10, border=border,
                                        forbid_mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.sum() > 5
    assert ok.all() == (k == 40)  # k = 256 runs past the local maxima into -inf


def test_bilinear_sample_matches_reference():
    """Sub-pixel samples, clamped at the border: within 1e-4 (f32)."""
    img = _image()
    xy = np.random.default_rng(2).uniform([-5, -5], [170, 130], size=(500, 2)).astype(np.float32)
    np.testing.assert_allclose(tops.bilinear_sample(T(img), T(xy)).numpy(),
                               np.asarray(jops.bilinear_sample(jnp.asarray(img),
                                                               jnp.asarray(xy))),
                               rtol=1e-6, atol=1e-4)

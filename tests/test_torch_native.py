"""The port's native host runtime (isvins_tpu_torch.native: EuRoC CSV
ingestion and the IMU/image measurement aligner over
native/isvins_native.cpp, built into build/native/) against the Python
semantics it replaces: the three cases of tests/test_native.py on the port,
and the port's CSV parser against the JAX package's on the same file."""

import os
import tempfile

import numpy as np
import pytest

from isvins_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")


def _imu_csv(path, n=500, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(1e18, 2e18, size=n))
    data = rng.normal(size=(n, 6))
    with open(path, "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(n):
            f.write(f"{ts[i]}," + ",".join(f"{v:.9f}" for v in data[i]) + "\n")
    return ts, data


def test_parse_csv_ns():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "imu.csv")
        ts, data = _imu_csv(path)
        out = native.parse_csv_ns(path, 6)
    assert out is not None
    t_s, dd = out
    np.testing.assert_allclose(t_s, ts / 1e9, rtol=1e-12)
    np.testing.assert_allclose(dd, data, atol=1e-9)


def test_parse_csv_ns_equals_jax_package_and_builds_its_own_library():
    """The same file through both packages' native parsers: equal bits. The
    port's library is its own build under build/native/, named by the hash
    of the source, never the JAX package's native/libisvins_native.so."""
    from isvins_tpu import native as jnative

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "imu.csv")
        _imu_csv(path, n=300, seed=3)
        t_s, dd = native.parse_csv_ns(path, 6)
        if jnative.available():
            jt, jd = jnative.parse_csv_ns(path, 6)
            np.testing.assert_array_equal(t_s, jt)
            np.testing.assert_array_equal(dd, jd)
    so = [p for p in native.BUILD_DIR.glob("libisvins_native_*.so")]
    assert so, native.BUILD_DIR
    with pytest.raises(FileNotFoundError):
        native.parse_csv_ns(os.path.join(tempfile.gettempdir(), "no_such_isvins.csv"), 6)


def test_aligner_matches_python_semantics():
    """The native aligner reproduces System._feed_imu's interpolation:
    samples strictly before t_img keep their own dt; one synthetic sample
    is interpolated at exactly t_img."""
    rng = np.random.default_rng(1)
    al = native.NativeAligner()
    t = 0.0
    samples = []
    for _ in range(100):
        t += 0.005
        acc = rng.normal(size=3)
        gyr = rng.normal(size=3)
        samples.append((t, acc, gyr))
        al.push_imu(t, acc, gyr)

    t_img = 0.1037
    assert al.ready(t_img)
    dts, accs, gyrs = al.collect(t_img)
    # the Python semantics: current_time starts at the first image time
    cur = t_img
    exp = []
    last = None
    idx = 0
    for (ts, acc, gyr) in samples:
        if ts >= t_img:
            break
        dt = ts - cur
        if dt > 0:
            exp.append((dt, acc, gyr))
        cur = ts
        last = (acc, gyr)
        idx += 1
    ts2, acc2, gyr2 = samples[idx]
    dt1 = t_img - cur
    dt2 = ts2 - t_img
    w1 = dt2 / (dt1 + dt2)
    w2 = dt1 / (dt1 + dt2)
    exp.append((dt1, w1 * last[0] + w2 * acc2, w1 * last[1] + w2 * gyr2))

    assert len(dts) == len(exp)
    for k, (dt_e, a_e, g_e) in enumerate(exp):
        np.testing.assert_allclose(dts[k], dt_e, atol=1e-12)
        np.testing.assert_allclose(accs[k], a_e, atol=1e-12)
        np.testing.assert_allclose(gyrs[k], g_e, atol=1e-12)

    # the second image continues from current_time = t_img
    t_img2 = 0.2012
    dts2, _, _ = al.collect(t_img2)
    assert abs(dts2.sum() - (t_img2 - t_img)) < 1e-9
    assert (dts2 > 0).all()


def test_aligner_not_ready():
    al = native.NativeAligner()
    al.push_imu(0.01, np.zeros(3), np.zeros(3))
    assert not al.ready(0.05)
    assert al.collect(0.05) is None

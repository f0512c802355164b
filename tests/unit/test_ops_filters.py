"""Tests for median / bad-pixel / flat-field filters and general utilities."""
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st
from scipy.ndimage import median_filter as scipy_median

from camera_linearity.ops import filters
from camera_linearity.utils import general
from camera_linearity.config import CameraConfig


def test_median_filter_matches_scipy(rng):
    x = rng.uniform(0, 1, (17, 23, 3))
    out = filters.median_filter_2d(jnp.asarray(x), 3)
    expect = scipy_median(x, size=(3, 3, 1), mode="reflect")
    np.testing.assert_allclose(np.asarray(out), expect)


def test_median_filter_5x5(rng):
    x = rng.uniform(0, 1, (12, 14))
    out = filters.median_filter_2d(jnp.asarray(x), 5)
    expect = scipy_median(x, size=(5, 5), mode="reflect")
    np.testing.assert_allclose(np.asarray(out), expect)


def test_bad_pixel_filter_semantics(rng):
    x = rng.uniform(0, 1, (16, 16, 3))
    s = rng.uniform(0.01, 0.1, (16, 16, 3))
    dark = np.zeros((16, 16, 3))
    dark[4, 5, 1] = 0.9  # one hot pixel
    val, std = filters.bad_pixel_filter(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(dark), 0.5, 3)
    med = scipy_median(x, size=(3, 3, 1), mode="reflect")
    expect = x.copy()
    expect[4, 5, 1] = med[4, 5, 1]
    np.testing.assert_allclose(np.asarray(val), expect)
    # untouched everywhere else, including std
    assert np.asarray(std)[4, 5, 1] != s[4, 5, 1] or np.isclose(
        scipy_median(s, size=(3, 3, 1), mode="reflect")[4, 5, 1], s[4, 5, 1])
    mask = np.ones_like(x, bool)
    mask[4, 5, 1] = False
    np.testing.assert_allclose(np.asarray(val)[mask], x[mask])


def test_flat_field_correction_oracle(rng):
    cfg_p = 0.05
    x = rng.uniform(0.2, 0.9, (100, 120, 3))
    sx = rng.uniform(0.001, 0.01, x.shape)
    ff = rng.uniform(0.5, 1.0, x.shape)
    sff = rng.uniform(0.001, 0.01, x.shape)
    val, std = filters.flat_field_correction(
        jnp.asarray(x), jnp.asarray(sx), jnp.asarray(ff), jnp.asarray(sff),
        cfg_p)
    # oracle replicating measurand.py:559-604 with integer ROI indices
    import math
    roi_dx = math.floor(100 * cfg_p)
    roi_dy = math.floor(120 * cfg_p)
    start = int((math.floor(1 / cfg_p) - 1) // 2)
    ffm = ff[start * roi_dx:(start + 1) * roi_dx,
             start * roi_dy:(start + 1) * roi_dy].mean(axis=(0, 1))
    ffsm = sff[start * roi_dx:(start + 1) * roi_dx,
               start * roi_dy:(start + 1) * roi_dy].mean(axis=(0, 1))
    u_acq = sx ** 2 / ff ** 2 * ffm ** 2
    u_ff = x ** 2 / ff ** 4 * sff ** 2 * ffm ** 2
    u_ffm = x ** 2 / ff ** 2 * ffsm ** 2
    np.testing.assert_allclose(np.asarray(val), x / ff * ffm, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(std),
                               np.sqrt(u_acq + u_ff + u_ffm), rtol=1e-12)


# ---------------------------------------------------------------------------
# general utilities (reference test_general_functions.py:10-44)
# ---------------------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(1, 5), min_size=1, max_size=4),
       st.lists(st.integers(1, 5), min_size=1, max_size=4))
def test_is_broadcastable_fuzz(s1, s2):
    s1, s2 = tuple(s1), tuple(s2)
    try:
        np.broadcast_shapes(s1, s2)
        expect = True
    except ValueError:
        expect = False
    assert general.is_broadcastable(s1, s2) == expect


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(1, 7),
       st.integers(1, 7))
def test_evenly_spaced_points_shape(rows, cols, sx, sy):
    arr = np.zeros((rows, cols, 2))
    out = general.choose_evenly_spaced_points(arr, sx, sy)
    assert out.shape[:2] == general.predict_output_shape((rows, cols), sx, sy)


def test_map_linearity_limits(rng):
    cfg = CameraConfig()
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    lower, upper = general.map_linearity_limits(5, 5, jnp.asarray(icrf), cfg)
    np.testing.assert_allclose(np.asarray(lower), icrf[5, np.arange(3)])
    np.testing.assert_allclose(np.asarray(upper), icrf[250, np.arange(3)])
    lower, upper = general.map_linearity_limits(None, None, None, cfg)
    np.testing.assert_allclose(np.asarray(lower), [5 / 255] * 3)
    np.testing.assert_allclose(np.asarray(upper), [250 / 255] * 3)


def test_interpolate_data_roundtrip():
    table = np.tile(np.linspace(0, 1, 16)[None, :], (4, 1))
    out = general.interpolate_data(jnp.asarray(table), 16, 32)
    assert out.shape == (4, 32)
    np.testing.assert_allclose(np.asarray(out[:, 0]), 0.0)
    np.testing.assert_allclose(np.asarray(out[:, -1]), 1.0)


def test_config_ini_roundtrip(tmp_path):
    ini = tmp_path / "config.ini"
    ini.write_text("""
[Integer data]
image size x = 640
image size y = 480
channels = 3
bit depth = 8
final datapoints = 256
number of principal components = 5
median filter kernel size = 3
lower linearity limit = 5
upper linearity limit = 250

[Float data]
dark threshold = 0.04
flat field middle zone percentage = 0.05
hot pixel threshold = 0.04

[String data]
channel names = blue,green,red
ICRFs = ICRF_blue.txt,ICRF_green.txt,ICRF_red.txt
""")
    cfg = CameraConfig.from_ini(ini)
    assert cfg.im_size_x == 640
    assert cfg.bits == 256 and cfg.max_dn == 255
    assert cfg.ch_names == ("blue", "green", "red")
    assert cfg.dark_threshold == 0.04
    assert cfg.icrf_files == ("ICRF_blue.txt", "ICRF_green.txt",
                              "ICRF_red.txt")
    assert cfg.ch_chars == ("b", "g", "r")
    # hashable -> usable as jit static arg
    hash(cfg)


def test_stage_to_device_chunked_equals_direct(rng):
    from camera_linearity.utils import general
    arr = rng.uniform(0, 1, (10, 37, 5)).astype(np.float32)
    direct = np.asarray(jnp.asarray(arr))
    chunked = np.asarray(general.stage_to_device(arr, max_bytes=4096))
    np.testing.assert_array_equal(direct, chunked)
    # small arrays take the single-transfer path
    small = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(general.stage_to_device(small)), small)

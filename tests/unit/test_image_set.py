"""Unit tests for ImageSet and the IO helpers.

Mirrors the reference suite's coverage (reference tests/unit/test_image_set.py):
filename-grammar table, exposure matching, dark/flat lookup, scaling and
difference delegation — plus the numerical STD fallback.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig, Measurand
from camera_linearity.models.image_set import ImageSet
from camera_linearity.utils import io


# ---------------------------------------------------------------------------
# filename grammar (reference test_image_set.py:317-327)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,expect", [
    ("5ms BF sample 50x.tif",
     {"exposure": 0.005, "illumination": "BF", "subject": "sample",
      "magnification": "50x"}),
    ("100ms df thing 5x.tif",
     {"exposure": 0.1, "illumination": "df", "subject": "thing",
      "magnification": "5x"}),
    ("sample 20X 2ms BF.tif",
     {"exposure": 0.002, "illumination": "BF", "subject": "sample",
      "magnification": "20X"}),
    ("plain.tif",
     {"exposure": 0.0, "illumination": "", "subject": "plain",
      "magnification": ""}),
])
def test_features_from_file_name(name, expect):
    feats = io.features_from_file_name(Path(name))
    assert feats == expect


def test_std_path_and_listing(tmp_path):
    for n in ["5ms BF s 50x.tif", "5ms BF s 50x STD.tif", "10ms BF s 50x.tif",
              "notes.txt"]:
        (tmp_path / n).write_bytes(b"")
    assert io.std_path_for(tmp_path / "a.tif").name == "a STD.tif"
    paths = io.list_image_paths(tmp_path)
    assert [p.name for p in paths] == ["10ms BF s 50x.tif",
                                      "5ms BF s 50x.tif"]


def test_exposure_match():
    a = ImageSet("5ms BF sample 50x.tif")
    b = ImageSet("10ms BF sample 50x.tif")
    c = ImageSet("10ms DF sample 50x.tif")
    assert a.is_exposure_match(b)
    assert not a.is_exposure_match(c)
    assert not a.is_exposure_match(ImageSet(value=jnp.ones((2, 2, 3))))


def test_path_without_exposure():
    s = ImageSet("/data/5ms BF sample 50x.tif")
    assert s.get_file_path_without_exposure() == \
        Path("/data/sample BF 50x.tif")


# ---------------------------------------------------------------------------
# dark / flat lookup (reference image_set.py:146-198)
# ---------------------------------------------------------------------------

def _dark(exposure_ms: float, value=None):
    s = ImageSet(f"{exposure_ms:g}ms dark.tif")
    if value is not None:
        s.measurand = Measurand(jnp.full((4, 4, 3), float(value)))
    return s


def test_get_dark_field_exact_match():
    darks = [_dark(1, 0.01), _dark(5, 0.05), _dark(10, 0.1)]
    img = ImageSet("5ms BF sample 50x.tif",
                   value=jnp.zeros((4, 4, 3)))
    img.config = CameraConfig(dark_threshold=0.001)
    got = img.get_dark_field(darks)
    assert got is darks[1]


def test_get_dark_field_scales_down_longer_exposure():
    darks = [_dark(1, 0.01), _dark(10, 0.1)]
    img = ImageSet("5ms BF sample 50x.tif", value=jnp.zeros((4, 4, 3)),
                   config=CameraConfig(dark_threshold=0.001))
    got = img.get_dark_field(darks)
    assert got is not None
    assert got.features["exposure"] == pytest.approx(0.005)
    # scaled by 5/10
    np.testing.assert_allclose(np.asarray(got.measurand.val), 0.05)


def test_get_dark_field_below_threshold_returns_none():
    darks = [_dark(1, 0.01)]
    img = ImageSet("5ms BF sample 50x.tif", value=jnp.zeros((4, 4, 3)),
                   config=CameraConfig(dark_threshold=10.0))
    assert img.get_dark_field(darks) is None


def test_get_flat_field_matches_features():
    flats = [ImageSet("flat BF 20x.tif"), ImageSet("flat BF 50x.tif"),
             ImageSet("flat DF 50x.tif")]
    img = ImageSet("5ms BF sample 50x.tif")
    assert img.get_flat_field(flats) is flats[1]
    img2 = ImageSet("5ms DF sample 20x.tif")
    assert img2.get_flat_field(flats) is None


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_scale_to_exposure(rng):
    val = rng.uniform(0, 1, (4, 4, 3))
    s = ImageSet("10ms BF sample 50x.tif", value=jnp.asarray(val))
    scaled = s.scale_to_exposure(0.005)
    np.testing.assert_allclose(np.asarray(scaled.measurand.val), val * 0.5)
    assert scaled.features["exposure"] == 0.005
    assert s.features["exposure"] == 0.01  # source untouched


def test_linearize_delegates(rng):
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    val = rng.uniform(0, 1, (8, 8, 3))
    s = ImageSet("5ms BF sample 50x.tif", value=jnp.asarray(val))
    out = s.linearize(jnp.asarray(icrf))
    idx = np.around(val * 255).astype(int)
    np.testing.assert_allclose(np.asarray(out.measurand.val),
                               icrf[idx, np.arange(3)])
    assert out.features == s.features


def test_compute_difference_ratio():
    short = ImageSet("5ms BF s 50x.tif", value=jnp.full((2, 2, 3), 0.5))
    long_ = ImageSet("10ms BF s 50x.tif", value=jnp.full((2, 2, 3), 1.0))
    abs_s, rel_s = ImageSet.compute_difference(short, long_)
    np.testing.assert_allclose(np.asarray(abs_s.measurand.val), 0.0)
    np.testing.assert_allclose(np.asarray(rel_s.measurand.val), 0.0)


def test_exposure_interpolation_bounds():
    a = ImageSet("5ms BF s 50x.tif", value=jnp.zeros((2, 2, 3)))
    b = ImageSet("10ms BF s 50x.tif", value=jnp.ones((2, 2, 3)))
    mid = ImageSet.exposure_interpolation(a, b, 0.0075)
    np.testing.assert_allclose(np.asarray(mid.measurand.val), 0.5)
    with pytest.raises(ValueError):
        ImageSet.exposure_interpolation(a, b, 0.02)
    with pytest.raises(TypeError):
        ImageSet.exposure_interpolation(a, b, "x")


def test_calculate_numerical_std(rng, tmp_path):
    # STD LUT: per-DN noise levels; linearize() gathers through it.
    std_data = np.sort(rng.uniform(0, 0.1, (256, 3)), axis=0)
    np.savetxt(tmp_path / "std.txt", std_data)
    cfg = CameraConfig(std_file_name="std.txt", data_path=str(tmp_path))
    val = rng.uniform(0, 1, (8, 8, 3))
    s = ImageSet("5ms BF sample 50x.tif", value=jnp.asarray(val), config=cfg)
    out = s.calculate_numerical_std()
    idx = np.around(val * 255).astype(int)
    np.testing.assert_allclose(np.asarray(out), std_data[idx, np.arange(3)])


def test_calculate_numerical_std_missing_file():
    s = ImageSet("5ms BF sample 50x.tif", value=jnp.zeros((2, 2, 3)),
                 config=CameraConfig(std_file_name="nope.txt",
                                     data_path="/nonexistent"))
    assert s.calculate_numerical_std() is None

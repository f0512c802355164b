"""Integration: real file round-trips through save/load.

Mirrors reference tests/integration/test_integration_image_set.py:49-84 —
save then reload and compare within quantization tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models.image_set import ImageSet


@pytest.fixture
def sample(rng, tmp_path):
    val = rng.uniform(0, 1, (32, 48, 3))
    std = rng.uniform(0.001, 0.05, (32, 48, 3))
    s = ImageSet(tmp_path / "5ms BF sample 50x.tif",
                 value=jnp.asarray(val), std=jnp.asarray(std))
    return s, val, std


def test_save_load_8bit_roundtrip(sample, tmp_path):
    s, val, std = sample
    s.save_8bit(tmp_path / s.path.name)
    reloaded = ImageSet(tmp_path / s.path.name)
    reloaded.load_value_image()
    np.testing.assert_allclose(np.asarray(reloaded.measurand.val), val,
                               atol=0.5 / 255)
    reloaded.load_std_image(bit64=True)
    assert reloaded.measurand.std is not None
    np.testing.assert_allclose(np.asarray(reloaded.measurand.std), std,
                               atol=1e-12)


def test_save_load_64bit_roundtrip(sample, tmp_path):
    s, val, std = sample
    out = tmp_path / "out" / s.path.name
    s.save_64bit(out)
    reloaded = ImageSet(out)
    reloaded.load_value_image(bit64=True)
    np.testing.assert_allclose(np.asarray(reloaded.measurand.val), val,
                               atol=1e-12)


def test_save_64bit_separate_channels(sample, tmp_path):
    s, val, std = sample
    out = tmp_path / "ch" / s.path.name
    s.save_64bit(out, separate_channels=True)
    files = sorted(p.name for p in (tmp_path / "ch").glob("*.tif"))
    assert len(files) == 6  # 3 value + 3 std channels
    assert any("blue" in f for f in files)


def test_multiple_from_path_skips_std(sample, tmp_path):
    s, _, _ = sample
    s.save_8bit(tmp_path / s.path.name)
    sets = ImageSet.multiple_from_path(tmp_path)
    assert len(sets) == 1
    assert sets[0].features["exposure"] == pytest.approx(0.005)


def test_calibrate_dark_frames(rng, tmp_path):
    cfg = CameraConfig()
    src = tmp_path / "raw_darks"
    dst = tmp_path / "darks"
    src.mkdir()
    base = rng.uniform(0.1, 0.2, (16, 16, 3))
    for ms, extra in [(1, 0.0), (10, 0.3)]:
        s = ImageSet(src / f"{ms}ms dark.tif",
                     value=jnp.asarray(base + extra))
        s.save_8bit(src / f"{ms}ms dark.tif")
    from camera_linearity.models.image_set import calibrate_dark_frames
    out = calibrate_dark_frames(cfg, in_path=src, out_path=dst)
    assert len(out) == 2
    produced = {p.name for p in dst.glob("*.tif")}
    assert produced == {"1ms dark.tif", "10ms dark.tif"}
    # shortest dark is its own bias -> calibrated to ~0
    bias_out = ImageSet(dst / "1ms dark.tif").load_value_image()
    assert float(jnp.max(bias_out.measurand.val)) <= 1.0 / 255 + 1e-9

"""Physical invariance properties of the HDR merge, plus remaining
IO-driver coverage (calibrate_flats, pooled video processing)."""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig, Measurand
from camera_linearity.ops import hdr
from camera_linearity.models.image_set import ImageSet


@pytest.fixture
def merge_inputs(rng):
    n, h, w, c = 4, 16, 24, 3
    sv = jnp.asarray(rng.uniform(0.05, 0.95, (n, h, w, c)))
    ss = jnp.asarray(rng.uniform(0.001, 0.02, (n, h, w, c)))
    ex = jnp.asarray(0.001 * 2.0 ** np.arange(n))
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    return sv, ss, ex, jnp.asarray(icrf), jnp.asarray(icrf_diff)


def test_merge_scales_inversely_with_exposure(merge_inputs):
    """HDR estimates radiance = linearized/t, so scaling every exposure by
    k scales the output by 1/k."""
    sv, ss, ex, icrf, icrf_diff = merge_inputs
    v1, s1 = hdr.merge_stack(sv, ss, ex, icrf, icrf_diff)
    v2, s2 = hdr.merge_stack(sv, ss, ex * 4.0, icrf, icrf_diff)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1) / 4.0,
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1) / 4.0,
                               rtol=1e-10)


def test_merge_invariant_to_exposure_order(merge_inputs):
    sv, ss, ex, icrf, icrf_diff = merge_inputs
    v1, s1 = hdr.merge_stack(sv, ss, ex, icrf, icrf_diff)
    perm = np.array([2, 0, 3, 1])
    v2, s2 = hdr.merge_stack(sv[perm], ss[perm], ex[perm], icrf, icrf_diff)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-10)


def test_merge_identity_icrf_constant_radiance(rng):
    """A perfectly linear camera observing radiance r at exposures t sees
    x = r*t; with the identity ICRF the merge must return ~r for every
    pixel (weighted average of identical estimates)."""
    n, h, w, c = 3, 8, 8, 3
    r = rng.uniform(5.0, 40.0, (h, w, c))
    ex = np.array([0.004, 0.008, 0.016])
    sv = jnp.asarray(np.clip(r[None] * ex.reshape(-1, 1, 1, 1), 0, 1))
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    v, _ = hdr.merge_stack(sv, None, jnp.asarray(ex), jnp.asarray(icrf),
                           jnp.asarray(icrf_diff))
    # quantization to 8-bit DNs bounds the error: the smallest estimate
    # x = r*t_min ~ 0.02 carries up to (0.5/255)/x ~ 10% relative
    # quantization error per exposure; the weighted average suppresses
    # most of it, 5% is a safe envelope
    np.testing.assert_allclose(np.asarray(v), r, rtol=0.05)


def test_calibrate_flats(rng, tmp_path):
    from camera_linearity.models.image_set import calibrate_flats
    cfg = CameraConfig()
    darks = tmp_path / "darks"
    raw_flats = tmp_path / "raw_flats"
    out = tmp_path / "flats"
    darks.mkdir()
    raw_flats.mkdir()
    bias = rng.uniform(0.05, 0.1, (16, 16, 3))
    ImageSet(darks / "1ms dark.tif",
             value=jnp.asarray(bias)).save_8bit(darks / "1ms dark.tif")
    flat = rng.uniform(0.6, 0.9, (16, 16, 3))
    ImageSet(raw_flats / "flat BF 50x.tif",
             value=jnp.asarray(flat)).save_8bit(
                 raw_flats / "flat BF 50x.tif")
    result = calibrate_flats(cfg, dark_path=darks, flat_path=raw_flats,
                             out_path=out)
    assert len(result) == 1
    produced = ImageSet(out / "flat BF 50x.tif").load_value_image()
    # bias-subtracted within quantization tolerance
    np.testing.assert_allclose(np.asarray(produced.measurand.val),
                               np.clip(flat - bias, 0, 1), atol=2 / 255)


def test_process_directory_pooled(tmp_path, rng):
    import cv2 as cv
    from camera_linearity.models import video
    frames = rng.integers(60, 200, (10, 16, 24, 3), dtype=np.uint8)
    for name in ("a 5ms.avi", "b 5ms.avi"):
        w = cv.VideoWriter(str(tmp_path / name),
                           cv.VideoWriter_fourcc(*"FFV1"), 10, (24, 16))
        for f in frames:
            w.write(f)
        w.release()
    cap = cv.VideoCapture(str(tmp_path / "a 5ms.avi"))
    ok, _ = cap.read()
    cap.release()
    if not ok:
        pytest.skip("no usable codec")
    video.process_directory(tmp_path, separately=False)
    assert (tmp_path / "total_mean.tif").exists()
    assert (tmp_path / "total_std.tif").exists()

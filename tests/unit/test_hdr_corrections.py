"""HDR merge with the full corrections prologue/epilogue:
dark-frame bad-pixel repair ahead of the merge, flat-field after
(BASELINE config 3 family; reference exposure_series.py:399-419).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig, Measurand
from camera_linearity.models.exposure_series import ExposureSeries
from camera_linearity.models.image_set import ImageSet


@pytest.fixture
def corrected_setup(rng):
    cfg = CameraConfig(dark_threshold=0.05, median_filter_kernel_size=3,
                       flat_field_mid_percentage=0.05)
    n, h, w, c = 3, 100, 120, 3
    exposures_ms = [400, 800, 1600]  # above dark_threshold (0.05 s=50ms)
    stack = rng.uniform(0.2, 0.8, (n, h, w, c))
    # hot pixel at a known site in every frame
    stack[:, 10, 11, :] = 1.0
    sets = []
    for i, ms in enumerate(exposures_ms):
        sets.append(ImageSet(f"{ms}ms BF scene 50x.tif",
                             measurand=Measurand(
                                 jnp.asarray(stack[i]),
                                 jnp.asarray(rng.uniform(0.002, 0.01,
                                                         (h, w, c)))),
                             config=cfg))
    # dark frames: exact exposure matches flagging the hot pixel
    darks = []
    for ms in exposures_ms:
        dval = np.zeros((h, w, c))
        dval[10, 11, :] = 0.9  # above dark_threshold
        darks.append(ImageSet(f"{ms}ms dark.tif",
                              measurand=Measurand(jnp.asarray(dval)),
                              config=cfg))
    # flat field matching illumination+magnification, with std
    flat = ImageSet("flat BF 50x.tif",
                    measurand=Measurand(
                        jnp.asarray(rng.uniform(0.7, 1.0, (h, w, c))),
                        jnp.asarray(rng.uniform(0.001, 0.01, (h, w, c)))),
                    config=cfg)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    return cfg, sets, darks, flat, icrf, stack


def test_hdr_with_dark_bad_pixel_repair(corrected_setup):
    cfg, sets, darks, flat, icrf, stack = corrected_setup
    series = ExposureSeries(input_image_sets=sets, config=cfg)
    hdr = series.process_HDR_image(ICRF=jnp.asarray(icrf),
                                   list_of_dark_fields=darks,
                                   apply_flat_field=False)
    val = np.asarray(hdr.measurand.val)
    # the hot pixel must have been median-repaired before merging:
    # without repair its merged value would reflect DN=1.0 at every
    # exposure (>> neighbors); with repair it sits near its neighborhood
    neighborhood = val[8:13, 9:14, 0]
    hot = val[10, 11, 0]
    assert hot <= neighborhood.max() + 1e-6
    assert np.isfinite(val).all()


def test_hdr_with_flat_field_epilogue(corrected_setup):
    cfg, sets, darks, flat, icrf, stack = corrected_setup
    series = ExposureSeries(input_image_sets=sets, config=cfg)
    hdr = series.process_HDR_image(ICRF=jnp.asarray(icrf),
                                   list_of_dark_fields=[],
                                   flat_field=flat,
                                   apply_flat_field=True)
    base = ExposureSeries(
        input_image_sets=[ImageSet(s.path, measurand=s.measurand,
                                   features=s.features, config=cfg)
                          for s in sets],
        config=cfg).process_HDR_image(ICRF=jnp.asarray(icrf),
                                      list_of_dark_fields=[],
                                      apply_flat_field=False)
    # flat-field correction divides by the flat and rescales by its ROI
    # mean: oracle from ops.filters on the uncorrected merge
    from camera_linearity.ops import filters
    expect_val, expect_std = filters.flat_field_correction(
        base.measurand.val, base.measurand.std, flat.measurand.val,
        flat.measurand.std, cfg.flat_field_mid_percentage)
    np.testing.assert_allclose(np.asarray(hdr.measurand.val),
                               np.asarray(expect_val), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(hdr.measurand.std),
                               np.asarray(expect_std), rtol=1e-10)


def test_hdr_flat_field_applies_to_value_only_merge(corrected_setup):
    """A use_std=False merge still flat-fields the value (the reference
    applies the correction unconditionally, exposure_series.py:415-417);
    std stays None."""
    cfg, sets, darks, flat, icrf, stack = corrected_setup
    series = ExposureSeries(input_image_sets=sets, config=cfg)
    hdr = series.process_HDR_image(ICRF=jnp.asarray(icrf),
                                   list_of_dark_fields=[],
                                   use_std=False,
                                   flat_field=flat,
                                   apply_flat_field=True)
    assert hdr.measurand.std is None
    base = ExposureSeries(
        input_image_sets=[ImageSet(s.path, measurand=s.measurand,
                                   features=s.features, config=cfg)
                          for s in sets],
        config=cfg).process_HDR_image(ICRF=jnp.asarray(icrf),
                                      list_of_dark_fields=[],
                                      use_std=False,
                                      apply_flat_field=False)
    from camera_linearity.ops import filters
    expect_val, expect_std = filters.flat_field_correction(
        base.measurand.val, None, flat.measurand.val,
        flat.measurand.std, cfg.flat_field_mid_percentage)
    assert expect_std is None
    np.testing.assert_allclose(np.asarray(hdr.measurand.val),
                               np.asarray(expect_val), rtol=1e-10)


def test_flat_field_correction_without_flat_std(corrected_setup, rng):
    """Missing flat-field uncertainty drops the two flat terms but keeps
    the acquisition term."""
    from camera_linearity.ops import filters
    cfg, _, _, flat, _, _ = corrected_setup
    val = jnp.asarray(rng.uniform(0.2, 0.8, (100, 120, 3)))
    std = jnp.asarray(rng.uniform(0.001, 0.01, (100, 120, 3)))
    out_val, out_std = filters.flat_field_correction(
        val, std, flat.measurand.val, None, cfg.flat_field_mid_percentage)
    ff_means = filters.flat_field_roi_mean(flat.measurand.val,
                                           cfg.flat_field_mid_percentage)
    expect_std = np.sqrt(np.asarray(std) ** 2
                         / np.asarray(flat.measurand.val) ** 2
                         * np.asarray(ff_means) ** 2)
    np.testing.assert_allclose(np.asarray(out_std), expect_std, rtol=1e-6)


def test_measurand_shims(rng):
    m = Measurand(jnp.asarray(rng.uniform(0, 1, (4, 4, 3))),
                  jnp.asarray(rng.uniform(0, 0.1, (4, 4, 3))))
    z = m.zeros_like_measurand()
    assert float(jnp.sum(z.val)) == 0.0 and float(jnp.sum(z.std)) == 0.0
    val_np, std_np = m.to_numpy()
    assert isinstance(val_np, np.ndarray) and isinstance(std_np, np.ndarray)
    m2 = Measurand(jnp.ones((2, 2, 1)))
    assert m2.to_numpy()[1] is None


def test_merge_corrected_fused_matches_sequential(corrected_setup, rng):
    """merge_corrected (ONE jit: bad-pixel -> merge -> flat) equals the
    sequential ops chain (BASELINE config 3)."""
    from camera_linearity.ops import filters, hdr
    cfg, sets, darks, flat, icrf, stack = corrected_setup
    n = len(sets)
    stack_val = jnp.stack([s.measurand.val for s in sets])
    stack_std = jnp.stack([s.measurand.std for s in sets])
    dark_stack = jnp.stack([d.measurand.val for d in darks])
    exposures = jnp.asarray([0.4, 0.8, 1.6])
    icrf_j = jnp.asarray(icrf)
    icrf_d = jnp.asarray(np.gradient(icrf, 2 / 255, axis=0))

    fused_v, fused_s = hdr.merge_corrected(
        stack_val, stack_std, dark_stack, exposures, icrf_j, icrf_d,
        jnp.asarray(cfg.dark_threshold), flat.measurand.val,
        flat.measurand.std,
        mid_percentage=cfg.flat_field_mid_percentage,
        kernel_size=cfg.median_filter_kernel_size)

    vs, ss = [], []
    for i in range(n):
        v, s = filters.bad_pixel_filter(stack_val[i], stack_std[i],
                                        dark_stack[i], cfg.dark_threshold,
                                        cfg.median_filter_kernel_size)
        vs.append(v)
        ss.append(s)
    mv, ms = hdr.merge_stack(jnp.stack(vs), jnp.stack(ss), exposures,
                             icrf_j, icrf_d)
    ev, es = filters.flat_field_correction(
        mv, ms, flat.measurand.val, flat.measurand.std,
        cfg.flat_field_mid_percentage)
    np.testing.assert_allclose(np.asarray(fused_v), np.asarray(ev),
                               rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fused_s), np.asarray(es),
                               rtol=5e-4, atol=1e-6)


def test_merge_corrected_12bit(rng):
    """The fused corrections path on a 12-bit stack (4096-entry tables)."""
    from camera_linearity.ops import hdr
    n, h, w, c = 3, 24, 40, 3
    bits = 4096
    dn = rng.integers(0, bits, (n, h, w, c))
    val = jnp.asarray((dn / (bits - 1)).astype(np.float32))
    std = jnp.asarray(rng.uniform(0.001, 0.01,
                                  (n, h, w, c)).astype(np.float32))
    dark = jnp.zeros_like(val)
    exposures = jnp.asarray([0.4, 0.8, 1.6], jnp.float32)
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_j = jnp.asarray(icrf, jnp.float32)
    icrf_d = jnp.asarray(np.gradient(icrf, 2 / (bits - 1), axis=0),
                         jnp.float32)
    fv, fs = hdr.merge_corrected(val, std, dark, exposures, icrf_j,
                                 icrf_d, jnp.asarray(0.05))
    mv, ms = hdr.merge_stack(val, std, exposures, icrf_j, icrf_d)
    np.testing.assert_allclose(np.asarray(fv), np.asarray(mv),
                               rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fs), np.asarray(ms),
                               rtol=5e-4, atol=1e-6)

"""ExposureSeries pipeline tests (reference tests/unit/test_exposure_series.py
coverage: constructor defaulting, grouping, exposure-sorted matching) plus
end-to-end linearity and HDR pipelines on synthetic in-memory data.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig, Measurand
from camera_linearity.models.exposure_series import (ExposurePair,
                                                         ExposureSeries)
from camera_linearity.models.image_set import ImageSet


def _img(name, val=None, std=None):
    m = None
    if val is not None:
        m = Measurand(jnp.asarray(val),
                      None if std is None else jnp.asarray(std))
    return ImageSet(name, measurand=m)


def test_constructor_defaults():
    s = ExposureSeries()
    assert s.merged_image_set is None
    assert s.input_image_sets == []
    assert s.exposure_pairs is None


def test_from_multiple_image_sets_groups_and_sorts():
    sets = [ImageSet("10ms BF a 50x.tif"), ImageSet("5ms BF a 50x.tif"),
            ImageSet("5ms DF b 50x.tif"), ImageSet("20ms BF a 50x.tif"),
            ImageSet("1ms DF b 50x.tif")]
    series = ExposureSeries.from_multiple_image_sets(sets)
    assert len(series) == 2
    exps = [s.features["exposure"] for s in series[0].input_image_sets]
    assert exps == sorted(exps)
    assert len(series[0].input_image_sets) == 3
    assert len(series[1].input_image_sets) == 2


def test_initialize_exposure_pairs_ratio_filter():
    sets = [ImageSet("1ms BF a 50x.tif"), ImageSet("5ms BF a 50x.tif"),
            ImageSet("100ms BF a 50x.tif")]
    series = ExposureSeries(input_image_sets=sets)
    series.initialize_exposure_pairs()
    ratios = [p.exposure_ratio for p in series.exposure_pairs]
    # (1,5): 0.2 ok; (1,100): 0.01 rejected; (5,100): 0.05 rejected
    assert ratios == [pytest.approx(0.2)]


def test_exposure_pair_stats_roundtrip(rng):
    val_s = rng.uniform(0.1, 0.9, (8, 8, 3))
    val_l = rng.uniform(0.1, 0.9, (8, 8, 3))
    pair = ExposurePair(_img("5ms BF a 50x.tif", val_s),
                        _img("10ms BF a 50x.tif", val_l))
    pair.compute_difference()
    pair.compute_stats(axis=(0, 1))
    assert pair.absolute_difference is None  # memory released
    expect_abs = val_s - 0.5 * val_l
    np.testing.assert_allclose(np.asarray(pair.absolute_stats["mean"]),
                               expect_abs.mean(axis=(0, 1)), rtol=1e-10)


def test_process_linearity_and_collect(rng):
    # perfectly linear images: val proportional to exposure
    base = rng.uniform(0.2, 0.6, (10, 10, 3))
    sets = []
    for ms in (4, 8):
        sets.append(_img(f"{ms}ms BF a 50x.tif", base * (ms / 8)))
    series = ExposureSeries(input_image_sets=sets)
    series.initialize_exposure_pairs()
    series.process_linearity(ICRF=None, linearity_limit=None, use_std=False)
    abs_stats, rel_stats = series.collect_exposure_pair_stats()
    # linear data -> zero difference
    np.testing.assert_allclose(abs_stats["means"], 0.0, atol=1e-12)
    np.testing.assert_allclose(rel_stats["means"], 0.0, atol=1e-12)
    assert abs_stats["means"].shape == (1, 3)
    assert abs_stats["errors"] is None


def test_process_linearity_weighted(rng):
    base = rng.uniform(0.2, 0.6, (10, 10, 3))
    noise = rng.normal(0, 0.01, (10, 10, 3))
    sets = [
        _img("4ms BF a 50x.tif", base * 0.5 + noise,
             rng.uniform(0.01, 0.02, (10, 10, 3))),
        _img("8ms BF a 50x.tif", base, rng.uniform(0.01, 0.02, (10, 10, 3))),
    ]
    series = ExposureSeries(input_image_sets=sets)
    series.initialize_exposure_pairs()
    series.process_linearity(ICRF=None, use_std=True)
    abs_stats, rel_stats = series.collect_exposure_pair_stats()
    assert abs_stats["errors"].shape == (1, 3)
    assert np.all(np.isfinite(rel_stats["means"]))


@pytest.mark.parametrize("use_std", [False, True])
def test_process_linearity_batched_matches_per_pair(rng, use_std):
    """The one-call ``_pair_stats_all`` path equals K per-pair dispatches
   , including NaN-thresholded pixels."""
    from camera_linearity.models.exposure_series import _pair_stats
    base = rng.uniform(0.1, 0.9, (12, 9, 3))
    sets = []
    for ms in (2, 4, 8, 16):
        val = np.clip(base * (ms / 16) + rng.normal(0, 0.02, base.shape),
                      0.001, 1.0)
        std = rng.uniform(0.005, 0.02, base.shape) if use_std else None
        sets.append(_img(f"{ms}ms BF a 50x.tif", val, std))
    series = ExposureSeries(input_image_sets=sets)
    series.initialize_exposure_pairs()
    assert len(series.exposure_pairs) == 6
    # thresholding inside process_linearity NaNs the tails
    series.process_linearity(ICRF=None, linearity_limit=30, use_std=use_std)

    for pair in series.exposure_pairs:
        sm, lm = pair.short_exposure.measurand, pair.long_exposure.measurand
        exp_abs, exp_rel = _pair_stats(
            sm.val, lm.val, sm.std if use_std else None,
            lm.std if use_std else None,
            jnp.asarray(pair.exposure_ratio, dtype=sm.val.dtype), use_std)
        for key in ("mean", "std", "error"):
            got_a, got_r = pair.absolute_stats[key], pair.relative_stats[key]
            if exp_abs[key] is None:
                assert got_a is None and got_r is None
            else:
                np.testing.assert_allclose(np.asarray(got_a),
                                           np.asarray(exp_abs[key]),
                                           rtol=1e-6, atol=1e-9)
                np.testing.assert_allclose(np.asarray(got_r),
                                           np.asarray(exp_rel[key]),
                                           rtol=1e-6, atol=1e-9)


def test_process_linearity_foreign_pairs_fallback(rng):
    """Hand-built pairs referencing sets outside the series still compute
    (per-pair fallback path)."""
    a = _img("4ms BF a 50x.tif", rng.uniform(0.2, 0.4, (6, 6, 3)))
    b = _img("8ms BF a 50x.tif", rng.uniform(0.4, 0.8, (6, 6, 3)))
    outsider = _img("2ms BF a 50x.tif", rng.uniform(0.1, 0.2, (6, 6, 3)))
    series = ExposureSeries(input_image_sets=[a, b])
    series.exposure_pairs = [ExposurePair(outsider, b)]
    series.process_linearity(ICRF=None, use_std=False)
    assert np.all(np.isfinite(
        np.asarray(series.exposure_pairs[0].absolute_stats["mean"])))


def test_process_hdr_image_end_to_end(rng, ftype):
    """Full merge through the pipeline layer vs the oracle from
    test_hdr_merge."""
    from tests.unit.test_hdr_merge import numpy_reference_merge
    cfg = CameraConfig(compat_mode="corrected")
    n, h, w, c = 4, 16, 16, 3
    stack_val = rng.uniform(0.05, 0.95, (n, h, w, c)).astype(ftype)
    stack_std = rng.uniform(0.001, 0.01, (n, h, w, c)).astype(ftype)
    exposures_ms = [2, 4, 8, 16]
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0).astype(ftype)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf.astype(np.float64), 2 / 255,
                            axis=0).astype(ftype)

    sets = [_img(f"{ms}ms BF a 50x.tif", stack_val[i], stack_std[i])
            for i, ms in enumerate(exposures_ms)]
    for s in sets:
        s.config = cfg
    series = ExposureSeries(input_image_sets=sets, config=cfg)
    hdr = series.process_HDR_image(ICRF=jnp.asarray(icrf),
                                   ICRF_diff=jnp.asarray(icrf_diff),
                                   list_of_dark_fields=[],
                                   apply_flat_field=False)
    exposures = np.array(exposures_ms) / 1000
    oval, ostd = numpy_reference_merge(stack_val, stack_std, exposures,
                                       icrf, icrf_diff, mode="corrected")
    np.testing.assert_allclose(np.asarray(hdr.measurand.val), oval,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(hdr.measurand.std), ostd,
                               rtol=1e-10, atol=1e-12)
    assert hdr.is_hdr
    assert series.merged_image_set is hdr


def test_linearize_series(rng):
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    val = rng.uniform(0, 1, (8, 8, 3))
    series = ExposureSeries(input_image_sets=[_img("5ms BF a 50x.tif", val)])
    out = series.linearize(jnp.asarray(icrf), release_memory=True)
    idx = np.around(val * 255).astype(int)
    np.testing.assert_allclose(np.asarray(out.input_image_sets[0].val),
                               icrf[idx, np.arange(3)])
    assert series.input_image_sets[0].measurand is None  # released


def test_extract_series(rng):
    val = rng.uniform(0, 1, (8, 8, 3))
    series = ExposureSeries(input_image_sets=[_img("5ms BF a 50x.tif", val)])
    out = series.extract([1])
    assert out.input_image_sets[0].val.shape == (8, 8, 1)


@pytest.mark.parametrize("bit_depth", [10, 14])
def test_process_hdr_image_arbitrary_bit_depth(rng, bit_depth):
    """A 10/14-bit CameraConfig routes end-to-end: the reference supports
    arbitrary BIT_DEPTH (global_settings.py:36), so a config-sized ICRF
    (2**bit_depth entries, the reference's np.interp expansion) must flow
    through process_HDR_image and agree with the float64 oracle merge on
    the expanded tables."""
    from tests.unit.test_hdr_merge import numpy_reference_merge
    bits = 2 ** bit_depth
    cfg = CameraConfig(compat_mode="corrected", bit_depth=bit_depth)
    assert cfg.bits == bits and cfg.max_dn == bits - 1
    n, h, w, c = 3, 16, 16, 3
    stack_val = rng.uniform(0.05, 0.95, (n, h, w, c))
    stack_std = rng.uniform(0.001, 0.01, (n, h, w, c))
    base = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    base[0], base[-1] = 0.0, 1.0
    diff_base = np.gradient(base, 2 / 255, axis=0)
    x, xb = np.arange(bits) / (bits - 1), np.arange(256) / 255.0
    icrf = np.stack([np.interp(x, xb, base[:, ch]) for ch in range(c)], 1)
    icrf_diff = np.stack(
        [np.interp(x, xb, diff_base[:, ch]) for ch in range(c)], 1)

    sets = [_img(f"{ms}ms BF a 50x.tif", stack_val[i], stack_std[i])
            for i, ms in enumerate([2, 4, 8])]
    for s in sets:
        s.config = cfg
    series = ExposureSeries(input_image_sets=sets, config=cfg)
    hdr = series.process_HDR_image(
        ICRF=jnp.asarray(icrf), ICRF_diff=jnp.asarray(icrf_diff),
        list_of_dark_fields=[], apply_flat_field=False)
    oval, ostd = numpy_reference_merge(
        stack_val, stack_std, np.array([2, 4, 8]) / 1000, icrf, icrf_diff,
        mode="corrected")
    np.testing.assert_allclose(np.asarray(hdr.measurand.val), oval,
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(hdr.measurand.std), ostd,
                               rtol=1e-3, atol=2e-6)

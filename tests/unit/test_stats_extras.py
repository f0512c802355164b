"""Coverage for the remaining stats utilities and observability helpers."""
import logging

import jax.numpy as jnp
import numpy as np

from camera_linearity.ops import stats
from camera_linearity.utils import observability


def test_weighted_avg_and_std_oracle(rng):
    values = rng.uniform(0, 10, 200)
    weights = rng.uniform(0.1, 2.0, 200)
    avg, std = stats.weighted_avg_and_std(jnp.asarray(values),
                                          jnp.asarray(weights))
    expect_avg = np.average(values, weights=weights)
    expect_std = np.sqrt(np.average((values - expect_avg) ** 2,
                                    weights=weights))
    np.testing.assert_allclose(float(avg), expect_avg, rtol=1e-12)
    np.testing.assert_allclose(float(std), expect_std, rtol=1e-12)


def test_weighted_percentile_unweighted_matches_reference(rng):
    """Oracle: the reference's own algorithm (general_functions.py:179-223)
    re-implemented in NumPy."""
    values = rng.uniform(0, 1, 101)
    percentiles = np.array([25.0, 50.0, 75.0])
    got = stats.weighted_percentile(jnp.asarray(values),
                                    jnp.asarray(percentiles))

    w = np.ones(values.size)
    idx = np.argsort(values)
    a_sort = values[idx]
    ecdf = np.cumsum(w[idx])
    p = (percentiles / 100) * (w.sum() - 1)
    idx_low = np.searchsorted(ecdf, p, side="right")
    idx_high = np.minimum(np.searchsorted(ecdf, p + 1, side="right"),
                          ecdf.size - 1)
    wh = p - np.floor(p)
    expect = a_sort[idx_low] * (1 - wh) + a_sort[idx_high] * wh
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-12)


def test_weighted_percentile_default_percentiles(rng):
    values = rng.uniform(0, 1, 64)
    got = stats.weighted_percentile(jnp.asarray(values))
    assert got.shape == (2,)  # default [75, 25]
    assert float(got[0]) >= float(got[1])


def test_observability_logger_and_timed(caplog):
    log = observability.get_logger("clt_test")
    with observability.timed("unit-timing", log) as info:
        _ = jnp.sum(jnp.ones((64, 64)))
    assert info["seconds"] >= 0
    log2 = observability.get_logger("clt_test")
    assert log2 is log  # no duplicate handlers


def test_observability_trace(tmp_path):
    with observability.trace(str(tmp_path / "prof")):
        _ = float(jnp.sum(jnp.ones((32, 32))))
    assert any((tmp_path / "prof").rglob("*"))


def test_kde_chunked_matches_unchunked(rng):
    """The lax.scan-chunked KDE evaluation is exact: same result whether
    the data fits one chunk or streams over many (incl. a ragged tail)."""
    import jax.numpy as jnp
    from camera_linearity.ops.stats import gaussian_kde
    val = rng.uniform(0, 1, 10_007).astype(np.float64)
    x_range = jnp.linspace(0.0, 1.0, 64)
    full = gaussian_kde(jnp.asarray(val), x_range)
    chunked = gaussian_kde(jnp.asarray(val), x_range, chunk=1024)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               rtol=1e-10, atol=1e-12)


def test_kde_megapixel_scale(rng):
    """KDE streams: a megapixel input evaluates without materializing the
    (points, samples) kernel matrix."""
    import jax.numpy as jnp
    from scipy.stats import gaussian_kde as scipy_kde
    from camera_linearity.ops.stats import gaussian_kde
    val = rng.uniform(0, 1, 1 << 20).astype(np.float64)
    x_range = jnp.linspace(0.0, 1.0, 32)
    out = gaussian_kde(jnp.asarray(val), x_range)
    ref = scipy_kde(val, "silverman").evaluate(np.asarray(x_range))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-9)

"""Property-based tests of the Measurand numeric core.

Mirrors the reference's hypothesis suite (reference:
tests/unit/test_measurand.py): broadcastable shape-pair strategies, algebraic
laws for + - * /, LUT-membership of linearize, and a loop-oracle regression
for apply_thresholds — plus direct parity of the uncertainty-propagation
formulas against a hand-written float64 NumPy oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from camera_linearity import Measurand

# ---------------------------------------------------------------------------
# Strategies: broadcastable array pairs (reference test_measurand.py:26-60)
# ---------------------------------------------------------------------------

finite_floats = st.floats(min_value=0.05, max_value=10.0, allow_nan=False,
                          allow_infinity=False, width=64)


@st.composite
def broadcastable_pairs(draw, with_std=st.booleans()):
    ndim = draw(st.integers(min_value=1, max_value=3))
    base_shape = tuple(draw(st.integers(min_value=1, max_value=4))
                       for _ in range(ndim))
    # Second shape: same, or with some axes collapsed to 1, or fewer dims.
    shape2 = list(base_shape)
    for i in range(ndim):
        if draw(st.booleans()):
            shape2[i] = 1
    drop = draw(st.integers(min_value=0, max_value=ndim - 1))
    shape2 = tuple(shape2[drop:])

    def arr(shape):
        n = int(np.prod(shape))
        vals = draw(st.lists(finite_floats, min_size=n, max_size=n))
        return np.asarray(vals, dtype=np.float64).reshape(shape)

    a_val = arr(base_shape)
    b_val = arr(shape2)
    a_std = arr(base_shape) if draw(with_std) else None
    b_std = arr(shape2) if draw(with_std) else None
    return (a_val, a_std), (b_val, b_std)


def _m(pair):
    val, std = pair
    return Measurand(jnp.asarray(val), None if std is None
                     else jnp.asarray(std))


def _assert_close(x, y, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# Algebraic laws (reference test_measurand.py:170-378)
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_add_commutative(pairs):
    a, b = map(_m, pairs)
    r1, r2 = a + b, b + a
    _assert_close(r1.val, r2.val)
    if r1.std is not None:
        _assert_close(r1.std, r2.std)


@settings(max_examples=30, deadline=None)
@given(broadcastable_pairs(), broadcastable_pairs())
def test_add_associative_vals(p1, p2):
    a, b = map(_m, p1)
    c = _m(p2[0])
    try:
        r1 = (a + b) + c
        r2 = a + (b + c)
    except (ValueError, TypeError):
        return  # non-broadcastable triple
    _assert_close(r1.val, r2.val, rtol=1e-10)


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_add_identity(pairs):
    a, _ = map(_m, pairs)
    zero = a.zeros_like()
    r = a + zero
    _assert_close(r.val, a.val)
    if a.std is not None:
        _assert_close(r.std, a.std)


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_sub_anticommutative(pairs):
    a, b = map(_m, pairs)
    r1 = a - b
    r2 = b - a
    _assert_close(r1.val, -np.asarray(r2.val))
    if r1.std is not None:
        _assert_close(r1.std, r2.std)


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_mul_commutative(pairs):
    a, b = map(_m, pairs)
    r1, r2 = a * b, b * a
    _assert_close(r1.val, r2.val)
    if r1.std is not None:
        _assert_close(r1.std, r2.std)


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_mul_unity_and_zero(pairs):
    a, _ = map(_m, pairs)
    one = Measurand(jnp.ones_like(a.val))
    _assert_close((a * one).val, a.val)
    zero = Measurand(jnp.zeros_like(a.val))
    _assert_close((a * zero).val, np.zeros(a.shape))


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_div_inversion(pairs):
    a, b = map(_m, pairs)
    r = (a / b) * b
    _assert_close(r.val, np.broadcast_to(np.asarray(a.val),
                                         np.asarray(r.val).shape),
                  rtol=1e-10)


@settings(max_examples=50, deadline=None)
@given(broadcastable_pairs())
def test_div_by_self_is_one(pairs):
    a, _ = map(_m, pairs)
    _assert_close((a / a).val, np.ones(a.shape))


# ---------------------------------------------------------------------------
# Uncertainty-propagation parity vs float64 NumPy oracle
# (formulas: reference measurand.py:106-279)
# ---------------------------------------------------------------------------

@pytest.fixture
def xy(rng):
    shape = (5, 7, 3)
    x = rng.uniform(0.1, 4.0, shape)
    y = rng.uniform(0.1, 4.0, shape)
    sx = rng.uniform(0.001, 0.2, shape)
    sy = rng.uniform(0.001, 0.2, shape)
    return x, sx, y, sy


def test_add_std_oracle(xy):
    x, sx, y, sy = xy
    r = Measurand(jnp.asarray(x), jnp.asarray(sx)) + \
        Measurand(jnp.asarray(y), jnp.asarray(sy))
    _assert_close(r.std, np.sqrt(sx ** 2 + sy ** 2))


def test_mul_std_oracle(xy):
    x, sx, y, sy = xy
    r = Measurand(jnp.asarray(x), jnp.asarray(sx)) * \
        Measurand(jnp.asarray(y), jnp.asarray(sy))
    _assert_close(r.std, np.sqrt((x * sy) ** 2 + (y * sx) ** 2))


def test_div_std_oracle(xy):
    x, sx, y, sy = xy
    r = Measurand(jnp.asarray(x), jnp.asarray(sx)) / \
        Measurand(jnp.asarray(y), jnp.asarray(sy))
    _assert_close(r.std,
                  np.sqrt((sx / y) ** 2 + ((x * sy) / y ** 2) ** 2))


def test_pow_std_oracle(xy):
    x, sx, y, sy = xy
    r = Measurand(jnp.asarray(x), jnp.asarray(sx)) ** \
        Measurand(jnp.asarray(y), jnp.asarray(sy))
    u1 = y * x ** (y - 1)
    u2 = np.log(x) * x ** y
    _assert_close(r.std, np.sqrt((u1 * sx) ** 2 + (u2 * sy) ** 2),
                  rtol=1e-10)


def test_log_e_oracle_modes(xy):
    x, sx, _, _ = xy
    m = Measurand(jnp.asarray(x), jnp.asarray(sx))
    # corrected: s/x; reference-compat: s/ln(x) (reference bug,
    # measurand.py:258)
    _assert_close(m.log_e().std, sx / x)
    _assert_close(m.log_e(compat="reference").std, sx / np.log(x))
    _assert_close(m.log_e().val, np.log(x))


def test_log_10_oracle(xy):
    x, sx, _, _ = xy
    m = Measurand(jnp.asarray(x), jnp.asarray(sx))
    _assert_close(m.log_10().val, np.log10(x))
    _assert_close(m.log_10().std, sx / (x * np.log(10.0)))


def test_scale_difference_oracle(xy):
    x, sx, y, sy = xy
    mult = 0.37
    a, r = Measurand.compute_difference(
        Measurand(jnp.asarray(x), jnp.asarray(sx)),
        Measurand(jnp.asarray(y), jnp.asarray(sy)), mult)
    _assert_close(a.val, x - mult * y)
    _assert_close(r.val, (x - mult * y) / (mult * y))
    _assert_close(a.std, np.sqrt(sx ** 2 + (mult * sy) ** 2))
    _assert_close(r.std, np.sqrt((sx / (mult * y)) ** 2
                                 + ((sy * x) / (mult * y ** 2)) ** 2))


def test_gaussian_weight_oracle(xy):
    x, sx, _, _ = xy
    m = Measurand(jnp.asarray(x), jnp.asarray(sx))
    w, dw = m.apply_gaussian_weight()
    w_ref = np.e ** (-30 * (x - 0.5) ** 2)
    _assert_close(w, w_ref, rtol=1e-12)
    _assert_close(dw, -60 * (x - 0.5) * w_ref, rtol=1e-12)


def test_interpolate_modes(xy):
    x, sx, y, sy = xy
    m0 = Measurand(jnp.asarray(x), jnp.asarray(sx))
    m1 = Measurand(jnp.asarray(y), jnp.asarray(sy))
    out = Measurand.interpolate(m0, m1, 1.0, 3.0, 2.0)
    _assert_close(out.val, (x * 1.0 + y * 1.0) / 2.0)
    a = b = 0.5
    _assert_close(out.std, np.sqrt((sx * a) ** 2 + (sy * b) ** 2))
    out_ref = Measurand.interpolate(m0, m1, 1.0, 3.0, 2.0,
                                    compat="reference")
    _assert_close(out_ref.std, np.sqrt(sx * a ** 2 + sy * b ** 2))


# ---------------------------------------------------------------------------
# linearize: LUT membership (reference test_measurand.py:447-467)
# ---------------------------------------------------------------------------

def test_linearize_lut_membership(rng, ftype):
    bits, chs = 256, 3
    icrf = np.sort(rng.uniform(0, 1, (bits, chs)), axis=0).astype(ftype)
    icrf_diff = np.gradient(icrf.astype(np.float64), 2 / (bits - 1),
                            axis=0).astype(ftype)
    val = rng.uniform(0, 1, (16, 16, chs)).astype(ftype)
    std = rng.uniform(0.001, 0.05, (16, 16, chs)).astype(ftype)
    m = Measurand(jnp.asarray(val), jnp.asarray(std))
    out = m.linearize(jnp.asarray(icrf), jnp.asarray(icrf_diff))
    for c in range(chs):
        assert np.isin(np.asarray(out.val[..., c]).ravel(),
                       icrf[:, c]).all()
    # oracle: exact reference indexing semantics (measurand.py:503-512)
    idx = np.around(val * 255).astype(np.uint8)
    expect = icrf[idx, np.arange(chs)]
    _assert_close(out.val, expect)
    _assert_close(out.std, icrf_diff[idx, np.arange(chs)] * std)


def test_linearize_integer_input(rng):
    bits = 256
    icrf = np.sort(rng.uniform(0, 1, (bits,)))
    dn = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    m = Measurand(jnp.asarray(dn))
    out = m.linearize(jnp.asarray(icrf))
    _assert_close(out.val, icrf[dn])
    assert out.std is None


# ---------------------------------------------------------------------------
# apply_thresholds: loop-oracle regression
# (reference test_measurand.py:470-522)
# ---------------------------------------------------------------------------

def _threshold_oracle(val, std, lower, upper):
    val = val.copy()
    std = None if std is None else std.copy()
    c = val.shape[-1]
    for ch in range(c):
        lo = -np.inf if lower is None or lower[ch] is None else lower[ch]
        hi = np.inf if upper is None or upper[ch] is None else upper[ch]
        mask = (val[..., ch] < lo) | (val[..., ch] > hi)
        val[..., ch][mask] = np.nan
        if std is not None:
            std[..., ch][mask] = np.nan
    return val, std


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=1, max_value=4),
       st.booleans(), st.booleans(), st.booleans())
def test_apply_thresholds_regression(ftype, chs, use_std, skip_lower,
                                     skip_upper):
    rng = np.random.default_rng(chs * 7 + use_std)
    val = rng.uniform(0, 1, (6, 5, chs)).astype(ftype)
    std = rng.uniform(0.01, 0.1, (6, 5, chs)).astype(ftype) \
        if use_std else None
    lower = None if skip_lower else \
        [None if i % 2 else 0.25 for i in range(chs)]
    upper = None if skip_upper else [0.75] * chs
    m = Measurand(jnp.asarray(val),
                  None if std is None else jnp.asarray(std))
    out = m.apply_thresholds(lower, upper)
    ov, os_ = _threshold_oracle(val, std, lower, upper)
    np.testing.assert_array_equal(np.asarray(out.val), ov)
    if use_std:
        np.testing.assert_array_equal(np.asarray(out.std), os_)


def test_apply_thresholds_length_mismatch():
    m = Measurand(jnp.ones((3, 3, 2)))
    with pytest.raises(ValueError):
        m.apply_thresholds([0.1], [0.9])


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def test_dimension_statistics_unweighted(rng):
    val = rng.uniform(0, 1, (8, 9, 3))
    val[rng.uniform(size=val.shape) < 0.2] = np.nan
    m = Measurand(jnp.asarray(val))
    stats = m.compute_dimension_statistics(axis=(0, 1))
    _assert_close(stats["mean"], np.nanmean(val, axis=(0, 1)))
    _assert_close(stats["std"], np.nanstd(val, axis=(0, 1)))
    assert stats["error"] is None


def test_dimension_statistics_weighted(rng):
    val = rng.uniform(0, 1, (8, 9, 3))
    std = rng.uniform(0.01, 0.3, (8, 9, 3))
    nanmask = rng.uniform(size=val.shape) < 0.15
    val[nanmask] = np.nan
    std[nanmask] = np.nan
    m = Measurand(jnp.asarray(val), jnp.asarray(std))
    stats = m.compute_dimension_statistics(axis=(0, 1))
    # oracle per reference measurand.py:341-346
    w = 1 / std
    sw = np.nansum(w, axis=(0, 1))
    mean = np.nansum(val * w, axis=(0, 1)) / sw
    spread = np.sqrt(np.nansum(w * (val - mean) ** 2, axis=(0, 1)) / sw)
    _assert_close(stats["mean"], mean)
    _assert_close(stats["std"], spread, rtol=1e-10)
    _assert_close(stats["error"], np.nanmean(std, axis=(0, 1)))


def test_channel_histogram_matches_numpy(rng):
    val = rng.uniform(0, 1, (32, 32, 3))
    val[rng.uniform(size=val.shape) < 0.1] = np.nan
    m = Measurand(jnp.asarray(val))
    hists = m.compute_channel_histogram(16, included_range=(0.0, 1.0))
    for c in range(3):
        finite = val[..., c][np.isfinite(val[..., c])]
        expect, edges = np.histogram(finite, bins=16, range=(0.0, 1.0))
        _assert_close(hists[c][0], expect)
        _assert_close(hists[c][1], edges)


def test_channel_histogram_weighted(rng):
    val = rng.uniform(0, 1, (24, 24, 1))
    std = rng.uniform(0.01, 0.2, (24, 24, 1))
    m = Measurand(jnp.asarray(val), jnp.asarray(std))
    hists = m.compute_channel_histogram(8, included_range=(0.0, 1.0),
                                        use_std=True)
    finite = np.isfinite(val[..., 0]) & (std[..., 0] != 0)
    expect, _ = np.histogram(val[..., 0][finite], bins=8, range=(0.0, 1.0),
                             weights=1 / std[..., 0][finite])
    _assert_close(hists[0][0], expect, rtol=1e-10)


def test_kde_matches_scipy(rng):
    from scipy.stats import gaussian_kde as scipy_kde
    val = rng.uniform(0, 1, (40, 40, 1))
    m = Measurand(jnp.asarray(val))
    out = m.compute_kernel_density_estimate(64, included_range=(0.0, 1.0))
    kde, x_range = out[0]
    ref = scipy_kde(val[..., 0].ravel(), "silverman")
    expect = ref.evaluate(np.asarray(x_range))
    _assert_close(kde, expect, rtol=1e-6, atol=1e-9)


def test_kde_weighted_matches_scipy(rng):
    from scipy.stats import gaussian_kde as scipy_kde
    val = rng.uniform(0, 1, (30, 30, 1))
    std = rng.uniform(0.05, 0.5, (30, 30, 1))
    m = Measurand(jnp.asarray(val), jnp.asarray(std))
    out = m.compute_kernel_density_estimate(32, included_range=(0.0, 1.0),
                                            use_std=True)
    kde, x_range = out[0]
    ref = scipy_kde(val[..., 0].ravel(), "silverman",
                    weights=1 / std[..., 0].ravel())
    _assert_close(kde, ref.evaluate(np.asarray(x_range)), rtol=1e-6,
                  atol=1e-9)


# ---------------------------------------------------------------------------
# extract / zeros_like / pytree behavior
# ---------------------------------------------------------------------------

def test_extract(rng):
    val = rng.uniform(0, 1, (4, 5, 3))
    std = rng.uniform(0, 0.1, (4, 5, 3))
    m = Measurand(jnp.asarray(val), jnp.asarray(std))
    sub = m.extract([0, 2])
    _assert_close(sub.val, val[..., [0, 2]])
    _assert_close(sub.std, std[..., [0, 2]])
    single = m.extract(1)
    assert single.shape == (4, 5, 1)


def test_measurand_is_pytree(rng):
    import jax
    val = rng.uniform(0.1, 1, (4, 4, 3))
    std = rng.uniform(0.01, 0.1, (4, 4, 3))
    m = Measurand(jnp.asarray(val), jnp.asarray(std))

    @jax.jit
    def f(m):
        return (m * m).compute_dimension_statistics(axis=(0, 1))["mean"]

    out = f(m)
    w = 1 / np.sqrt(2 * (val * std) ** 2)
    expect = np.nansum(val ** 2 * w, axis=(0, 1)) / np.nansum(w, axis=(0, 1))
    _assert_close(out, expect, rtol=1e-10)

    leaves = jax.tree_util.tree_leaves(m)
    assert len(leaves) == 2
    m2 = Measurand(jnp.asarray(val))
    assert len(jax.tree_util.tree_leaves(m2)) == 1


def test_scalar_promotion():
    m = Measurand(2.0, 0.1)
    assert m.val.shape == (1,)
    r = 3 * m
    _assert_close(r.val, [6.0])
    _assert_close(r.std, [0.3])


@settings(max_examples=40, deadline=None)
@given(broadcastable_pairs())
def test_mul_distributive_over_add(pairs):
    """a*(b+c) == a*b + a*c on values (reference test_measurand.py:313-378)."""
    a, b = map(_m, pairs)
    c = Measurand(jnp.ones_like(b.val) * 0.5)
    r1 = a * (b + c)
    r2 = a * b + a * c
    _assert_close(r1.val, r2.val, rtol=1e-10)


@settings(max_examples=40, deadline=None)
@given(broadcastable_pairs())
def test_div_distributive_over_add(pairs):
    """(a+b)/c == a/c + b/c on values (reference test_measurand.py:248-310)."""
    a, b = map(_m, pairs)
    c = Measurand(jnp.ones_like(a.val) * 2.0)
    try:
        r1 = (a + b) / c
        r2 = a / c + b / c
    except (ValueError, TypeError):
        return
    _assert_close(r1.val, r2.val, rtol=1e-10)


def test_div_by_zero_semantics():
    """Division by zero follows IEEE semantics like the reference
    (test_measurand.py:248-310): finite/0 -> inf, 0/0 -> nan."""
    num = Measurand(jnp.asarray([1.0, 0.0, -2.0]))
    den = Measurand(jnp.zeros(3))
    out = np.asarray((num / den).val)
    assert np.isposinf(out[0])
    assert np.isnan(out[1])
    assert np.isneginf(out[2])

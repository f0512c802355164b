"""Linearity-objective parity against a NumPy oracle of the reference.

Oracle re-implements analyze_linearity + _energy_function
(reference: modules/ICRF_calibration_exposure.py:66-201) with the full
(X, Y, N, N) broadcast; the streaming pairwise implementation must agree to
float tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.ops import linearity as lin


def oracle_analyze_linearity(stack, std_stack, lower, upper, use_relative,
                             exposures):
    """Reference ICRF_calibration_exposure.py:66-145, float64 NumPy."""
    X, Y, N = stack.shape
    pair_idx = np.triu_indices(N, k=1)
    mask = (stack < lower) | (stack > upper)
    masked = np.where(mask, np.nan, stack)
    ratios = exposures[:, None] / exposures[None, :]
    ratios[np.tril_indices(N, k=0)] = np.nan
    ratio_stack = ratios[None, None, :, :]
    gi = masked[..., :, None]
    gj = masked[..., None, :]
    scaled = gj * ratio_stack
    diff = gi - scaled
    if use_relative:
        diff = diff / scaled
    abs_diff = np.abs(diff)
    if std_stack is not None:
        si = std_stack[..., :, None]
        sj = std_stack[..., None, :]
        if use_relative:
            lstd = np.sqrt((si / scaled) ** 2
                           + ((gi * sj) / (ratio_stack * gj ** 2)) ** 2)
        else:
            lstd = np.sqrt(si ** 2 + (ratio_stack * sj) ** 2)
        finite = np.isfinite(abs_diff) & (lstd != 0)
        weights = np.where(finite, 1 / lstd, np.nan)
        valid = ~np.isnan(abs_diff) & ~np.isnan(weights)
        wsum = np.nansum(abs_diff * weights * valid, axis=(0, 1))
        vws = np.nansum(valid * weights, axis=(0, 1))
        with np.errstate(invalid="ignore"):
            results = wsum / vws
        results[vws == 0] = np.nan
    else:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            results = np.nanmean(abs_diff, axis=(0, 1))
    return results[pair_idx]


def oracle_energy(icrf_curve, stack_dn, std_stack, exposures, lower_dn,
                  upper_dn):
    """Reference _energy_function (ICRF_calibration_exposure.py:148-201)."""
    icrf = icrf_curve.copy()
    icrf += 1 - icrf[-1]
    icrf[0] = 0
    if icrf.max() > 1 or icrf.min() < 0:
        return np.inf
    if not np.all(icrf[1:] > icrf[:-1]):
        return np.inf
    lo, hi = icrf[lower_dn], icrf[upper_dn]
    g = icrf[stack_dn]
    vec = oracle_analyze_linearity(g, std_stack, lo, hi, True, exposures)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        energy = np.nanmean(vec)
    return np.inf if np.isnan(energy) else float(energy)


@pytest.fixture
def stacks(rng):
    X, Y, N = 12, 10, 5
    exposures = np.array([0.001, 0.002, 0.004, 0.008, 0.016])
    # synthetic linear scene observed through a gamma curve
    radiance = rng.uniform(0.05, 60.0, (X, Y))
    dn = np.clip((radiance[..., None] * exposures) ** (1 / 2.2), 0, 1)
    stack_dn = np.around(dn * 255).astype(np.uint8)
    std_stack = rng.uniform(0.001, 0.02, (X, Y, N))
    return stack_dn, std_stack, exposures


def _curve(rng):
    c = np.sort(rng.uniform(0, 1, 256))
    c[0], c[-1] = 0.0, 1.0
    return c


def test_energy_matches_oracle_unweighted(stacks, rng):
    stack_dn, _, exposures = stacks
    curve = np.linspace(0, 1, 256) ** 2.2
    P = stack_dn.shape[0] * stack_dn.shape[1]
    ii, jj = lin.upper_triangle_pairs(5)
    e = lin.linearity_energy(jnp.asarray(curve),
                             jnp.asarray(stack_dn.reshape(P, 5)), None,
                             jnp.asarray(exposures), 5, 250,
                             jnp.asarray(ii), jnp.asarray(jj))
    oe = oracle_energy(curve, stack_dn, None, exposures, 5, 250)
    np.testing.assert_allclose(float(e), oe, rtol=1e-10)


def test_energy_matches_oracle_weighted(stacks):
    stack_dn, std_stack, exposures = stacks
    curve = np.linspace(0, 1, 256) ** 2.2
    P = stack_dn.shape[0] * stack_dn.shape[1]
    ii, jj = lin.upper_triangle_pairs(5)
    e = lin.linearity_energy(jnp.asarray(curve),
                             jnp.asarray(stack_dn.reshape(P, 5)),
                             jnp.asarray(std_stack.reshape(P, 5)),
                             jnp.asarray(exposures), 5, 250,
                             jnp.asarray(ii), jnp.asarray(jj))
    oe = oracle_energy(curve, stack_dn, std_stack, exposures, 5, 250)
    np.testing.assert_allclose(float(e), oe, rtol=1e-10)


def test_energy_invalid_curves(stacks):
    stack_dn, _, exposures = stacks
    P = stack_dn.shape[0] * stack_dn.shape[1]
    ii, jj = lin.upper_triangle_pairs(5)

    def energy(curve):
        return float(lin.linearity_energy(
            jnp.asarray(curve), jnp.asarray(stack_dn.reshape(P, 5)), None,
            jnp.asarray(exposures), 5, 250, jnp.asarray(ii),
            jnp.asarray(jj)))

    flat = np.full(256, 0.5)          # non-monotone after pinning
    assert energy(flat) == np.inf
    decreasing = np.linspace(1, 0, 256)
    assert energy(decreasing) == np.inf


def test_energy_vmaps_over_population(stacks):
    import jax
    stack_dn, std_stack, exposures = stacks
    P = stack_dn.shape[0] * stack_dn.shape[1]
    ii, jj = lin.upper_triangle_pairs(5)
    rng = np.random.default_rng(11)
    pop = np.stack([np.linspace(0, 1, 256) ** g
                    for g in rng.uniform(1.5, 3.0, 8)])
    batched = jax.vmap(lambda c: lin.linearity_energy(
        c, jnp.asarray(stack_dn.reshape(P, 5)),
        jnp.asarray(std_stack.reshape(P, 5)), jnp.asarray(exposures), 5, 250,
        jnp.asarray(ii), jnp.asarray(jj)))
    energies = np.asarray(batched(jnp.asarray(pop)))
    for k in range(8):
        oe = oracle_energy(pop[k], stack_dn, std_stack, exposures, 5, 250)
        np.testing.assert_allclose(energies[k], oe, rtol=1e-9)


def test_valid_exposure_pairs_filters_ratio():
    exposures = np.array([0.0001, 0.01, 0.02, 0.1])
    ii, jj = lin.valid_exposure_pairs(exposures, min_ratio=0.1)
    pairs = set(zip(ii.tolist(), jj.tolist()))
    # 0.0001/0.01 = 0.01 < 0.1 rejected; 0.01/0.02 = 0.5 kept;
    # 0.01/0.1 = 0.0999... < 0.1 in float -> rejected (same float math as
    # the reference's `ratio < 0.1` test, exposure_series.py:298-300).
    assert (0, 1) not in pairs and (0, 2) not in pairs and (0, 3) not in pairs
    assert (1, 2) in pairs and (2, 3) in pairs and (1, 3) not in pairs


# ---------------------------------------------------------------------------
# randomized sweep: energy parity across curve/stack/limit space
# ---------------------------------------------------------------------------
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=12, deadline=None)
@given(st.integers(3, 7), st.integers(4, 40), st.booleans(),
       st.integers(0, 40), st.integers(200, 255),
       st.integers(0, 2 ** 31 - 1))
def test_energy_matches_oracle_random(n, pixels, use_std, lower_dn,
                                      upper_dn, seed):
    rng = np.random.default_rng(seed)
    exposures = 0.001 * 2.0 ** np.arange(n)
    radiance = rng.uniform(0.05, 60.0, (pixels, 1))
    dn = np.clip((radiance[..., None] * exposures) ** (1 / 2.2), 0, 1)
    stack_dn = np.around(dn * 255).astype(np.uint8)
    std_stack = rng.uniform(0.001, 0.02, (pixels, 1, n)) if use_std \
        else None
    # random monotone candidate (not necessarily the true gamma)
    curve = np.sort(rng.uniform(0, 1, 256))
    curve[0], curve[-1] = 0.0, 1.0

    ii, jj = lin.upper_triangle_pairs(n)
    e = lin.linearity_energy(
        jnp.asarray(curve), jnp.asarray(stack_dn.reshape(pixels, n)),
        None if std_stack is None
        else jnp.asarray(std_stack.reshape(pixels, n)),
        jnp.asarray(exposures), lower_dn, upper_dn,
        jnp.asarray(ii), jnp.asarray(jj))
    oe = oracle_energy(curve, stack_dn, std_stack, exposures, lower_dn,
                       upper_dn)
    if np.isinf(oe):
        assert not np.isfinite(float(e))
    else:
        np.testing.assert_allclose(float(e), oe, rtol=1e-9)

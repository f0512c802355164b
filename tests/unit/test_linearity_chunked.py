"""Chunked (pixel-streamed) linearity energy parity + 12-bit merge."""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.ops import hdr
from camera_linearity.ops import linearity as lin


@pytest.fixture
def problem(rng):
    n = 5
    pixels = 1000  # not a multiple of the chunk sizes below
    exposures = np.array([0.001, 0.002, 0.004, 0.008, 0.016])
    radiance = rng.uniform(0.05, 60.0, pixels)
    dn = np.clip((radiance[:, None] * exposures) ** (1 / 2.2), 0, 1)
    stack_dn = np.around(dn * 255).astype(np.int32)
    std = rng.uniform(0.001, 0.02, (pixels, n))
    curve = np.linspace(0, 1, 256) ** 2.2
    ii, jj = lin.upper_triangle_pairs(n)
    return stack_dn, std, exposures, curve, ii, jj


@pytest.mark.parametrize("chunk", [128, 333, 1000, 4096])
def test_chunked_energy_matches_unweighted(problem, chunk):
    stack_dn, _, exposures, curve, ii, jj = problem
    args = (jnp.asarray(curve), jnp.asarray(stack_dn), None,
            jnp.asarray(exposures), 5, 250, jnp.asarray(ii),
            jnp.asarray(jj))
    full = lin.linearity_energy(*args)
    chunked = lin.linearity_energy_chunked(*args, chunk=chunk)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-10)


@pytest.mark.parametrize("chunk", [128, 1000])
def test_chunked_energy_matches_weighted(problem, chunk):
    stack_dn, std, exposures, curve, ii, jj = problem
    args = (jnp.asarray(curve), jnp.asarray(stack_dn), jnp.asarray(std),
            jnp.asarray(exposures), 5, 250, jnp.asarray(ii),
            jnp.asarray(jj))
    full = lin.linearity_energy(*args)
    chunked = lin.linearity_energy_chunked(*args, chunk=chunk)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-10)


def test_chunked_energy_invalid_curve(problem):
    stack_dn, _, exposures, _, ii, jj = problem
    flat = jnp.full(256, 0.5)
    e = lin.linearity_energy_chunked(flat, jnp.asarray(stack_dn), None,
                                     jnp.asarray(exposures), 5, 250,
                                     jnp.asarray(ii), jnp.asarray(jj))
    assert float(e) == np.inf


# ---------------------------------------------------------------------------
# 12-bit merge support (BASELINE config 3 family)
# ---------------------------------------------------------------------------

def test_merge_12bit_tables(rng):
    bits = 4096
    n, h, w, c = 4, 16, 20, 3
    stack_val = rng.uniform(0.02, 0.98, (n, h, w, c))
    stack_std = rng.uniform(0.001, 0.01, (n, h, w, c))
    exposures = np.array([0.001, 0.002, 0.004, 0.008])
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / (bits - 1), axis=0)

    val, std = hdr.merge_stack(jnp.asarray(stack_val),
                               jnp.asarray(stack_std),
                               jnp.asarray(exposures), jnp.asarray(icrf),
                               jnp.asarray(icrf_diff))
    # oracle with 12-bit indexing (the reference's uint8 cast would wrap;
    # we int32-clip, SURVEY.md §7 build plan)
    idx = np.clip(np.around(stack_val * (bits - 1)).astype(int), 0,
                  bits - 1)
    chans = np.arange(c)
    g = icrf[idx, chans]
    wgt = np.e ** (-30 * (stack_val - 0.5) ** 2)
    sw = wgt.sum(axis=0)
    t = exposures.reshape(-1, 1, 1, 1)
    expect = (wgt * g / (sw * t)).sum(axis=0)
    np.testing.assert_allclose(np.asarray(val), expect, rtol=1e-10)
    assert np.all(np.isfinite(np.asarray(std)))


def test_exposure_pair_distribution(rng):
    from camera_linearity.models.exposure_series import ExposurePair
    from camera_linearity.models.image_set import ImageSet
    from camera_linearity import Measurand
    a = ImageSet("5ms BF s 50x.tif",
                 measurand=Measurand(jnp.asarray(rng.uniform(0.2, 0.8,
                                                             (16, 16, 3)))))
    b = ImageSet("10ms BF s 50x.tif",
                 measurand=Measurand(jnp.asarray(rng.uniform(0.2, 0.8,
                                                             (16, 16, 3)))))
    pair = ExposurePair(a, b)
    pair.compute_difference()
    abs_h, rel_h = pair.process_linearity_distribution(
        bins=8, included_range=(-1.0, 1.0))
    assert set(abs_h.keys()) == {0, 1, 2}
    hist, edges = abs_h[0]
    assert hist.shape == (8,) and edges.shape == (9,)
    assert float(jnp.sum(hist)) == 16 * 16


def test_population_chunked_matches_unchunked(rng):
    """population_linearity_energies_chunked == the precomputed-one-hot
    formulation for both weighted and unweighted objectives (the matmul
    objective at any resolution)."""
    import jax
    from camera_linearity.ops import linearity as lin
    P, N, bits, S = 300, 5, 256, 8
    dn = jnp.asarray(rng.integers(0, bits, (P, N)))
    std = jnp.asarray(rng.uniform(0.005, 0.02, (P, N)))
    ex = jnp.asarray(0.001 * 2.0 ** np.arange(N))
    ii, jj = lin.upper_triangle_pairs(N)
    ii, jj = jnp.asarray(ii), jnp.asarray(jj)
    curves = jnp.asarray(np.sort(rng.uniform(0, 1, (S, bits)), axis=1))
    onehot = lin.build_data_onehot(dn, bits)
    for sc in (None, std):
        e_pop = lin.population_linearity_energies(curves, onehot, sc, ex,
                                                  5, 250, ii, jj)
        e_chk = lin.population_linearity_energies_chunked(
            curves, dn, sc, ex, 5, 250, ii, jj, chunk=64)
        np.testing.assert_allclose(np.asarray(e_chk), np.asarray(e_pop),
                                   rtol=1e-10)


def test_population_hist_matches_onehot(rng):
    """The joint-histogram energy is exactly the unweighted pixel energy."""
    from camera_linearity.ops import linearity as lin
    P, N, bits, S = 400, 4, 256, 6
    dn = jnp.asarray(rng.integers(0, bits, (P, N)))
    ex = jnp.asarray(0.001 * 2.0 ** np.arange(N))
    ii, jj = lin.upper_triangle_pairs(N)
    ii, jj = jnp.asarray(ii), jnp.asarray(jj)
    curves = jnp.asarray(np.sort(rng.uniform(0, 1, (S, bits)), axis=1))
    hists = lin.pair_dn_histograms(dn, ii, jj, bits)
    assert int(jnp.sum(hists)) == P * len(ii)
    e_hist = lin.population_linearity_energies_hist(curves, hists, ex,
                                                    5, 250, ii, jj)
    e_pop = lin.population_linearity_energies(
        curves, lin.build_data_onehot(dn, bits), None, ex, 5, 250, ii, jj)
    np.testing.assert_allclose(np.asarray(e_hist), np.asarray(e_pop),
                               rtol=1e-9)


def test_hist_smooth_energy_matches_and_differentiates(rng):
    """The grad-safe histogram energy equals the exact energy on feasible
    curves and yields finite gradients (the polish path)."""
    import jax
    from camera_linearity.ops import linearity as lin
    P, N, bits = 300, 4, 256
    dn = jnp.asarray(rng.integers(0, bits, (P, N)))
    ex = jnp.asarray(0.001 * 2.0 ** np.arange(N))
    ii, jj = lin.upper_triangle_pairs(N)
    ii, jj = jnp.asarray(ii), jnp.asarray(jj)
    x = np.linspace(0, 1, bits)
    curve = jnp.asarray(x ** 2.2)
    hists = lin.pair_dn_histograms(dn, ii, jj, bits)
    e_smooth = lin.linearity_energy_hist_smooth(curve, hists, ex, 5, 250,
                                                ii, jj)
    e_exact = lin.linearity_energy(curve, dn, None, ex, 5, 250, ii, jj)
    np.testing.assert_allclose(float(e_smooth), float(e_exact), rtol=1e-9)
    g = jax.grad(lambda c: lin.linearity_energy_hist_smooth(
        c, hists, ex, 5, 250, ii, jj))(curve)
    assert np.isfinite(np.asarray(g)).all()

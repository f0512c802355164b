"""Tests for the device-resident differential-evolution ICRF calibration."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models import calibration as cal
from camera_linearity.models.icrf import icrf_from_params


def test_de_solves_sphere():
    energy = lambda x: jnp.sum((x - 0.3) ** 2)  # noqa: E731
    res = cal.differential_evolution(energy, 4,
                                     np.full(4, -2.0), np.full(4, 2.0),
                                     popsize=10, maxiter=200, tol=1e-4,
                                     mutation=(0.3, 1.0), recombination=0.7,
                                     seed=3)
    np.testing.assert_allclose(np.asarray(res.x), 0.3, atol=1e-2)
    assert float(res.energy) < 1e-6
    assert res.energy < res.initial_energy


def test_de_respects_bounds_and_x0():
    energy = lambda x: jnp.sum(x ** 2)  # noqa: E731
    res = cal.differential_evolution(energy, 3,
                                     np.array([1.0, 1.0, 1.0]),
                                     np.array([2.0, 3.0, 4.0]),
                                     x0=np.array([1.5, 1.5, 1.5]),
                                     popsize=8, maxiter=50, seed=1)
    pop = np.asarray(res.population)
    assert (pop >= np.array([1, 1, 1]) - 1e-9).all()
    assert (pop <= np.array([2, 3, 4]) + 1e-9).all()
    # optimum is the lower bound corner
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0, 1.0], atol=0.05)


def test_de_batched_cache_key_avoids_retrace():
    """A second ad-hoc solve with a FRESH closure but the same cache_key
    must reuse the compiled solver: the new closure is never traced (never
    even called), and the result is identical."""
    calls = {"a": 0, "b": 0}

    def make_energy(tag):
        def energy(x):
            calls[tag] += 1  # trace-time counter: jit calls this once
            return jnp.sum((x - 0.25) ** 2)
        return energy

    kw = dict(num_channels=2, num_params=3,
              bounds_lower=np.full(3, -1.0), bounds_upper=np.full(3, 1.0),
              popsize=4, maxiter=5, seed=2, cache_key="sphere-adhoc-test")
    res_a, _ = cal.differential_evolution_batched(
        make_energy("a"), (), **kw)
    assert calls["a"] > 0
    res_b, _ = cal.differential_evolution_batched(
        make_energy("b"), (), **kw)
    assert calls["b"] == 0, "same cache_key must not re-trace"
    np.testing.assert_array_equal(np.asarray(res_a.x), np.asarray(res_b.x))
    np.testing.assert_array_equal(np.asarray(res_a.energies),
                                  np.asarray(res_b.energies))


def test_de_energy_limit_stops_early():
    energy = lambda x: jnp.sum(x ** 2)  # noqa: E731
    res = cal.differential_evolution(energy, 2, np.full(2, -1.0),
                                     np.full(2, 1.0), popsize=10,
                                     maxiter=500, energy_limit=0.5, seed=0)
    assert res.n_iter < 500


def test_icrf_from_params_modes(rng):
    pca = rng.normal(size=(64, 3))
    mean = np.linspace(0, 1, 64)
    p = np.array([0.1, -0.2, 0.3])
    with_mean = icrf_from_params(jnp.asarray(p), jnp.asarray(pca),
                                 jnp.asarray(mean))
    np.testing.assert_allclose(np.asarray(with_mean), mean + pca @ p,
                               rtol=1e-12)
    p2 = np.array([2.0, 0.1, -0.2, 0.3])
    without = icrf_from_params(jnp.asarray(p2), jnp.asarray(pca),
                               None, datapoints=64)
    np.testing.assert_allclose(np.asarray(without),
                               np.linspace(0, 1, 64) ** 2.0 + pca @ p2[1:],
                               rtol=1e-10, atol=1e-12)


def _synthetic_problem(_unused_rng=None, gamma_true=2.2, n_exp=5,
                       pixels=200):
    # deterministic local generator: results must not depend on how many
    # draws other tests consumed from the shared session fixture
    rng = np.random.default_rng(1995)
    """Images of a linear scene through CRF = x**(1/gamma); solving should
    recover ICRF = x**gamma."""
    bits = 256
    datapoints = 256
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    radiance = rng.uniform(0.01, 0.35, pixels)
    linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
    crf_observed = np.clip(linear, 0, 1) ** (1 / gamma_true)
    stack_dn = np.around(crf_observed * 255).astype(np.int32)

    # PCA basis from a family of gamma ICRFs around the mean
    x = np.linspace(0, 1, datapoints)
    gammas = np.linspace(1.6, 3.0, 25)
    curves = np.stack([x ** g for g in gammas])
    mean_icrf = curves.mean(axis=0)
    centered = curves - mean_icrf
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    pca = vt[:5].T  # (datapoints, 5)
    return stack_dn, exposures, mean_icrf, pca, x ** gamma_true


def test_calibration_recovers_gamma_curve(rng):
    stack_dn, exposures, mean_icrf, pca, truth = _synthetic_problem(rng)
    cfg = CameraConfig(num_of_chs=1, datapoints=256)
    value_stacks = jnp.asarray(stack_dn[None])  # (C=1, P, N)
    icrf, e0, e1, _ = cal.calibration(
        -1.0, 1.0, channel_stacks=(value_stacks, None,
                                   jnp.asarray(exposures)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
        config=cfg, popsize=10, maxiter=150, tol=1e-3, rng_seed=5)
    assert icrf.shape == (256, 1)
    assert e1[0] < e0[0]
    # quantization floors the energy near 0.017 on this synthetic problem
    assert e1[0] < 0.03
    # recovered curve close to the generating gamma curve (the f32 device
    # trajectory legitimately lands a slightly different basin member
    # than the f64 CPU solve)
    err = np.max(np.abs(icrf[:, 0] - truth))
    assert err < (0.05 if jax.config.jax_enable_x64 else 0.065)
    # monotone and pinned
    assert icrf[0, 0] == 0.0
    assert np.all(np.diff(icrf[:, 0]) >= -1e-9)


def test_calibration_energy_forms_agree(rng):
    """Pinning energy_form selects each objective formulation explicitly;
    all three must produce the same seeded solve (identical trial
    trajectory -> near-identical energies), and invalid combinations
    raise."""
    stack_dn, exposures, mean_icrf, pca, _ = _synthetic_problem(rng)
    cfg = CameraConfig(num_of_chs=1, datapoints=256)
    kw = dict(channel_stacks=(jnp.asarray(stack_dn[None]), None,
                              jnp.asarray(exposures)),
              pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
              config=cfg, popsize=8, maxiter=15, tol=1e-9, rng_seed=5,
              refine_rounds=0, polish_steps=0)
    res = {form: cal.calibration(-1.0, 1.0, **kw, energy_form=form)
           for form in ("onehot", "hist", "chunked")}
    e_ref = float(res["onehot"][2][0])
    # f64 formulations agree to summation-order level; f32 (GPU mode) to
    # a few energy ULP
    e_tol = 1e-9 if jax.config.jax_enable_x64 else 1e-6
    for form, (icrf_f, e0, e1, _) in res.items():
        assert np.isfinite(icrf_f).all()
        assert abs(float(e1[0]) - e_ref) < e_tol, (form, float(e1[0]),
                                                   e_ref)
    np.testing.assert_allclose(res["hist"][0], res["onehot"][0], atol=1e-9)
    with pytest.raises(ValueError, match="unknown energy_form"):
        cal.calibration(-1.0, 1.0, **kw, energy_form="bogus")
    std_kw = dict(kw, channel_stacks=(
        jnp.asarray(stack_dn[None]),
        jnp.asarray(np.full(stack_dn.shape, 0.01)[None]),
        jnp.asarray(exposures)))
    with pytest.raises(ValueError, match="hist"):
        cal.calibration(-1.0, 1.0, **std_kw, energy_form="hist")
    # chunked serves std-weighted data; onehot too (parity of the two)
    _, _, e1c, _ = cal.calibration(-1.0, 1.0, **std_kw,
                                   energy_form="chunked")
    _, _, e1o, _ = cal.calibration(-1.0, 1.0, **std_kw,
                                   energy_form="onehot")
    np.testing.assert_allclose(float(e1c[0]), float(e1o[0]), rtol=1e-9)


def test_calibration_without_mean_icrf(rng):
    stack_dn, exposures, _, pca, truth = _synthetic_problem(rng)
    cfg = CameraConfig(num_of_chs=1, datapoints=256)
    icrf, e0, e1, _ = cal.calibration(
        -1.0, 1.0, initial_function=jnp.asarray(np.zeros(256)),
        channel_stacks=(jnp.asarray(stack_dn[None]), None,
                        jnp.asarray(exposures)),
        pca_arrays=pca[None], config=cfg, popsize=10, maxiter=120,
        tol=1e-3, rng_seed=2)
    assert e1[0] < e0[0]
    assert np.all(np.diff(icrf[:, 0]) >= -1e-9)


def test_calibration_return_base_expansion(rng):
    """return_base yields the solved datapoints-resolution curve whose
    np.interp expansion IS the returned full-size table — the pair that
    feeds merge_hdr's piecewise-linear fast path."""
    stack_dn, exposures, mean_icrf, pca, _ = _synthetic_problem(rng)
    cfg = CameraConfig(num_of_chs=1, datapoints=256, bit_depth=12)
    icrf, _, _, _, base = cal.calibration(
        -1.0, 1.0, channel_stacks=(jnp.asarray(stack_dn[None]), None,
                                   jnp.asarray(exposures)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
        config=cfg, popsize=10, maxiter=40, tol=1e-3, rng_seed=5,
        refine_rounds=0, polish_steps=0, return_base=True)
    assert base.shape == (256, 1)
    assert icrf.shape == (4096, 1)
    x, xb = np.arange(4096) / 4095.0, np.arange(256) / 255.0
    np.testing.assert_allclose(icrf[:, 0], np.interp(x, xb, base[:, 0]),
                               rtol=0, atol=1e-12)

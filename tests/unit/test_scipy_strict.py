"""Strict-mode parity: StrictDESolver reproduces SciPy's
DifferentialEvolutionSolver trajectory bit-for-bit, and a seeded
calibration_strict reproduces the reference solve's final curve to <=1e-6
(BASELINE 'agreeing with reference to 1e-6 (seeded)'; reference driver
ICRF_calibration_exposure.py:288-402)."""
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models.scipy_strict import (
    StrictDESolver, calibration_hybrid, calibration_strict,
    reference_energy)


def _build_problem(seed=7, n_exp=6, pixels=300, datapoints=256):
    rng = np.random.default_rng(seed)
    gamma = [2.0, 2.2, 2.4]
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    x = np.linspace(0, 1, datapoints)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:5].T
    stacks = []
    for c in range(3):
        radiance = rng.uniform(0.01, 0.35, pixels)
        linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
        dn = np.around(np.clip(linear, 0, 1) ** (1 / gamma[c])
                       * (datapoints - 1)).astype(np.int32)
        stacks.append(dn)
    return np.stack(stacks), exposures, mean_icrf, pca


@pytest.mark.parametrize("seed", [7, 1995])
def test_trajectory_bit_exact_with_scipy(seed):
    """Generation-by-generation, the strict solver's population, energies
    and RNG state are IDENTICAL to SciPy's on a nontrivial objective."""
    from scipy.optimize._differentialevolution import \
        DifferentialEvolutionSolver

    def rosen_ish(p):
        return float(np.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2
                            + (1 - p[:-1]) ** 2))

    bounds = [(-2.0, 2.0)] * 5
    kw = dict(strategy="currenttobest1bin", tol=0.01, x0=[0.0] * 5,
              mutation=(0, 1.95), recombination=0.4, init="sobol")
    sp = DifferentialEvolutionSolver(rosen_ish, bounds, rng=seed,
                                     popsize=2, **kw)
    st = StrictDESolver(rosen_ish, bounds, x0=[0.0] * 5, popsize=2,
                        mutation=(0, 1.95), recombination=0.4, tol=0.01,
                        seed=seed)
    assert st.num_population_members == sp.num_population_members
    np.testing.assert_array_equal(st.population, sp.population)

    for gen in range(25):
        x_sp, e_sp = next(sp)
        x_st, e_st = next(st)
        np.testing.assert_array_equal(st.population, sp.population,
                                      err_msg=f"generation {gen}")
        np.testing.assert_array_equal(st.population_energies,
                                      sp.population_energies,
                                      err_msg=f"generation {gen}")
        np.testing.assert_array_equal(x_st, x_sp)
        assert e_st == e_sp
        assert st.converged() == sp.converged()
    # the underlying RandomState streams stayed in lockstep
    a = sp.random_number_generator.uniform(size=4)
    b = st.random_number_generator.uniform(size=4)
    np.testing.assert_array_equal(a, b)


def test_trajectory_bit_exact_on_reference_objective():
    """Same lockstep check on the actual ICRF energy (inf rejections
    included — SciPy resamples out-of-bounds components; an inf-energy
    trial must leave the population untouched in both solvers)."""
    from scipy.optimize._differentialevolution import \
        DifferentialEvolutionSolver

    stacks, exposures, mean_icrf, pca = _build_problem(pixels=120)

    def func(p):
        return reference_energy(p, mean_icrf, pca, stacks[0][:, None, :],
                                None, 5, 250, True, exposures, 256)

    bounds = [(-1.0, 1.0)] * 5
    sp = DifferentialEvolutionSolver(
        func, bounds, rng=11, popsize=2, strategy="currenttobest1bin",
        tol=0.01, x0=[0.0] * 5, mutation=(0, 1.95), recombination=0.4,
        init="sobol")
    st = StrictDESolver(func, bounds, x0=[0.0] * 5, popsize=2,
                        mutation=(0, 1.95), recombination=0.4, tol=0.01,
                        seed=11)
    for gen in range(12):
        next(sp)
        next(st)
        np.testing.assert_array_equal(st.population, sp.population,
                                      err_msg=f"generation {gen}")
        np.testing.assert_array_equal(st.population_energies,
                                      sp.population_energies,
                                      err_msg=f"generation {gen}")


def test_calibration_strict_curve_matches_reference_1e6():
    """Seeded calibration_strict vs the reference solve (SciPy solver
    stepped with the reference's own double-step loop,
    ICRF_calibration_exposure.py:364-370): final curves agree <=1e-6 per
    BASELINE (bit-exact in practice)."""
    from scipy.optimize._differentialevolution import \
        DifferentialEvolutionSolver

    stacks, exposures, mean_icrf, pca = _build_problem()
    maxiter = 40
    rng_seed = 7

    ref_curves = []
    for c in range(3):
        def func(p, _c=c):
            return reference_energy(p, mean_icrf, pca,
                                    stacks[_c][:, None, :], None, 5, 250,
                                    True, exposures, 256)

        with DifferentialEvolutionSolver(
                func, [(-1, 1)] * 5, strategy="currenttobest1bin",
                tol=0.01, x0=[0] * 5, mutation=(0, 1.95),
                recombination=0.4, init="sobol",
                rng=rng_seed + c) as solver:
            number_of_iterations = 0
            for _step in solver:
                number_of_iterations += 1
                _, func_value = next(solver)   # reference double-step
                if solver.converged() \
                        or number_of_iterations == maxiter \
                        or func_value < 0.0:
                    break
        curve = mean_icrf + pca @ np.asarray(solver.x)
        curve = curve + (1 - curve[-1])
        curve[0] = 0
        ref_curves.append(np.clip(curve, 0, 1))
    ref = np.stack(ref_curves, axis=1)

    cfg = CameraConfig(num_of_chs=3, datapoints=256, bit_depth=8)
    icrf, e0, e1, iters = calibration_strict(
        -1.0, 1.0, channel_stacks=(stacks, None, exposures),
        pca_arrays=np.stack([pca] * 3),
        mean_icrf_arrays=np.stack([mean_icrf] * 3),
        rng_seed=rng_seed, maxiter=maxiter, config=cfg)

    assert np.max(np.abs(icrf - ref)) <= 1e-6
    assert np.all(e1 <= e0)
    assert np.all(iters >= 1)


def test_reference_energy_std_weighted_path():
    """The std-weighted objective runs and responds to the curve (the
    reference's nanaverage 1/std weighting, ICRF_calibration_exposure.py
    :134-136)."""
    stacks, exposures, mean_icrf, pca = _build_problem(pixels=80)
    std = np.full(stacks[0].shape, 0.01)[:, None, :]
    e_w = reference_energy(np.zeros(5), mean_icrf, pca,
                           stacks[0][:, None, :], std, 5, 250, True,
                           exposures, 256)
    assert np.isfinite(e_w) and e_w > 0
    # a deliberately non-monotone candidate is rejected with inf
    bad = np.full(5, 10.0)
    assert reference_energy(bad, mean_icrf, pca, stacks[0][:, None, :],
                            None, 5, 250, True, exposures, 256) == np.inf


def test_strict_x0_outside_bounds_raises():
    with pytest.raises(ValueError):
        StrictDESolver(lambda p: float(p @ p), [(-1, 1)] * 3,
                       x0=[5.0, 0, 0], seed=1)


def test_calibration_hybrid_improves_on_device_seed():
    """The hybrid's strict phase starts AT the device optimum (the seed
    joins SciPy's initial population) and can only improve it under the
    reference's float64 objective."""
    from camera_linearity.models.calibration import calibration

    stacks, exposures, mean_icrf, pca = _build_problem(pixels=200)
    cfg = CameraConfig(num_of_chs=3, datapoints=256, bit_depth=8)
    channel_stacks = (stacks, None, exposures)
    pca_c = np.stack([pca] * 3)
    mean_c = np.stack([mean_icrf] * 3)
    device_kwargs = dict(maxiter=30, refine_rounds=0, polish_steps=0)

    icrf, device_e, e_init, e_final, iters = calibration_hybrid(
        -1.0, 1.0, channel_stacks=channel_stacks, pca_arrays=pca_c,
        mean_icrf_arrays=mean_c, rng_seed=7, strict_maxiter=8,
        popsize=4, config=cfg, device_kwargs=device_kwargs)

    assert icrf.shape == (cfg.bits, 3)
    assert np.all(icrf >= 0) and np.all(icrf <= 1)
    np.testing.assert_allclose(icrf[0], 0.0)
    assert np.all(iters >= 1)
    # monotone improvement under the exact reference objective
    assert np.all(e_final <= e_init + 1e-12)

    # the strict phase started no worse than the device seed's own
    # reference energy: re-derive the seed and score it with the
    # reference objective
    *_, seed_params = calibration(
        -1.0, 1.0, channel_stacks=channel_stacks, pca_arrays=pca_c,
        mean_icrf_arrays=mean_c, rng_seed=7, config=cfg,
        popsize=4, return_params=True, **device_kwargs)
    for c in range(3):
        x0 = np.clip(seed_params[c], -1.0, 1.0)
        seed_e = reference_energy(x0, mean_icrf, pca,
                                  stacks[c][:, None, :], None, 5, 250,
                                  True, exposures, 256)
        assert e_init[c] <= seed_e + 1e-12


def test_calibration_hybrid_stall_limit():
    """strict_stall_limit ends the polish once the best energy stops
    improving: never MORE iterations than the unlimited run, and the
    match-or-improve guarantee (e_final <= e_init) is unaffected."""
    stacks, exposures, mean_icrf, pca = _build_problem(pixels=200)
    cfg = CameraConfig(num_of_chs=3, datapoints=256, bit_depth=8)
    channel_stacks = (stacks, None, exposures)
    kw = dict(channel_stacks=channel_stacks,
              pca_arrays=np.stack([pca] * 3),
              mean_icrf_arrays=np.stack([mean_icrf] * 3), rng_seed=7,
              strict_maxiter=12, popsize=4, config=cfg,
              device_kwargs=dict(maxiter=30, refine_rounds=0,
                                 polish_steps=0))
    _, _, e0_full, e1_full, iters_full = calibration_hybrid(-1.0, 1.0,
                                                            **kw)
    _, _, e0_st, e1_st, iters_st = calibration_hybrid(
        -1.0, 1.0, strict_stall_limit=2, **kw)
    np.testing.assert_allclose(e0_st, e0_full)  # identical seeds
    assert np.all(iters_st <= iters_full)
    assert np.all(e1_st <= e0_st + 1e-12)


def test_calibration_return_params_shape():
    """return_params appends the solved (C, num_params) vectors and they
    reproduce the returned base curve through icrf_from_params."""
    from camera_linearity.models.calibration import calibration

    stacks, exposures, mean_icrf, pca = _build_problem(pixels=120)
    cfg = CameraConfig(num_of_chs=3, datapoints=256, bit_depth=8)
    icrf, e0, e1, ratio, base, params = calibration(
        -1.0, 1.0, channel_stacks=(stacks, None, exposures),
        pca_arrays=np.stack([pca] * 3),
        mean_icrf_arrays=np.stack([mean_icrf] * 3), rng_seed=3,
        popsize=4, maxiter=10, refine_rounds=0, polish_steps=0,
        config=cfg, return_base=True, return_params=True)
    assert params.shape == (3, pca.shape[-1])
    for c in range(3):
        curve = mean_icrf + pca @ params[c]
        curve = curve + (1 - curve[-1])
        curve[0] = 0.0
        np.testing.assert_allclose(base[:, c], np.clip(curve, 0, 1),
                                   atol=5e-6)

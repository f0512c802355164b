"""ICRF calibration benchmark: device DE vs SciPy CPU reference.

Synthesizes the reference problem (gamma-CRF exposure stacks, DoRF-style
PCA basis), solves all three channels with the device-resident population-
batched DE, and times SciPy's DifferentialEvolutionSolver on one channel of
the identical problem with identical hyperparameters for the speedup
figure.  Prints one JSON line per measurement.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
import warnings

import numpy as np


def build_problem(seed=7, n_exp=6, pixels=2000, datapoints=256):
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


def scipy_reference_seconds(stack, exposures, mean_icrf, pca, maxiter=1000):
    from scipy.optimize._differentialevolution import \
        DifferentialEvolutionSolver
    n_exp = stack.shape[-1]

    def np_energy(params):
        curve = mean_icrf + pca @ params
        curve = curve + (1 - curve[-1])
        curve = curve.copy()
        curve[0] = 0
        if curve.max() > 1 or curve.min() < 0:
            return np.inf
        if not np.all(curve[1:] > curve[:-1]):
            return np.inf
        lo, hi = curve[5], curve[250]
        g = curve[stack]
        g = np.where((g < lo) | (g > hi), np.nan, g)
        ii, jj = np.triu_indices(n_exp, 1)
        r = exposures[ii] / exposures[jj]
        d = np.abs((g[:, ii] - r * g[:, jj]) / (r * g[:, jj]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            e = np.nanmean(np.nanmean(d, axis=0))
        return np.inf if np.isnan(e) else e

    t0 = time.time()
    with DifferentialEvolutionSolver(
            np_energy, [(-1, 1)] * 5, strategy="currenttobest1bin",
            tol=0.01, x0=[0] * 5, mutation=(0, 1.95), recombination=0.4,
            init="sobol", rng=7) as solver:
        nit = 0
        for _ in solver:
            nit += 1
            if solver.converged() or nit == maxiter:
                break
    return time.time() - t0, float(solver.population_energies.min()), nit


def main():
    import jax.numpy as jnp
    from camera_linearity import CameraConfig
    from camera_linearity.models import calibration as cal

    stacks, exposures, mean_icrf, pca = build_problem()
    cfg = CameraConfig(num_of_chs=3, datapoints=256)

    def solve():
        return cal.calibration(
            -1.0, 1.0,
            channel_stacks=(jnp.asarray(stacks), None,
                            jnp.asarray(exposures)),
            pca_arrays=np.stack([pca] * 3),
            mean_icrf_arrays=np.stack([mean_icrf] * 3),
            config=cfg, popsize=15, maxiter=1000, tol=0.01, rng_seed=7)

    t0 = time.time()
    icrf, e0, e1, _ = solve()
    cold = time.time() - t0
    t0 = time.time()
    solve()
    warm = time.time() - t0

    scipy_s, scipy_e, scipy_nit = scipy_reference_seconds(
        stacks[0], exposures, mean_icrf, pca)

    print(json.dumps({"metric": "icrf_calibration_3ch_wall",
                      "value": round(warm, 2), "unit": "s",
                      "cold_s": round(cold, 2),
                      "final_energies": [round(float(e), 4) for e in e1]}))
    print(json.dumps({"metric": "scipy_reference_1ch_wall",
                      "value": round(scipy_s, 2), "unit": "s",
                      "converged_at": scipy_nit,
                      "final_energy": round(scipy_e, 4)}))
    print(json.dumps({"metric": "speedup_vs_scipy_3ch_serial",
                      "value": round(3 * scipy_s / warm, 1), "unit": "x"}))
    print(json.dumps({"metric": "speedup_vs_scipy_joblib3",
                      "value": round(scipy_s / warm, 1), "unit": "x"}))


if __name__ == "__main__":
    main()

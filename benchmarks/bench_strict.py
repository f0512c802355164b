"""Strict / hybrid solver wall-clock at production scale.

The strict solver (models/scipy_strict.py) is the reference's SciPy
solve reproduced to the RNG draw in host float64 — including the
reference's own memory hot spot, the (X, Y, N, N) broadcast per
candidate (ICRF_calibration_exposure.py:108-121).  Its cost at a
production-shaped subsampled stack (the bench_calibration problem:
P=2000 pixels, N=6 exposures, 3 channels — the reference's
data_spacing=150 ballpark) was asserted but never measured; this script
records it next to the hybrid (device solve seeding a short strict
polish) and the pure device solve, so the "audit-grade at a fraction of
a cold strict solve's budget" claim carries numbers.

Prints one JSON line per solver.  The device/hybrid legs need the GPU;
pass --host-only to record just the cold strict solve (pure CPU).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "benchmarks"))

# JAX_COMPILATION_CACHE_DIR when set, else one fixed in-checkout directory
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device and hybrid legs (no GPU)")
    ap.add_argument("--strict-maxiter", type=int, default=1000,
                    help="cold strict budget (counted iterations; each "
                         "advances TWO generations, the reference's "
                         "double-step)")
    args = ap.parse_args()

    from bench_calibration import build_problem
    from camera_linearity import CameraConfig
    from camera_linearity.models import scipy_strict

    stacks, exposures, mean_icrf, pca = build_problem()
    cfg = CameraConfig(num_of_chs=3, datapoints=256)
    channel_stacks = (np.asarray(stacks, np.int32), None,
                      np.asarray(exposures))
    pca3 = np.stack([pca] * 3)
    mean3 = np.stack([mean_icrf] * 3)

    t0 = time.time()
    icrf_s, e0s, e1s, iters_s = scipy_strict.calibration_strict(
        -1.0, 1.0, channel_stacks, pca3, mean3, rng_seed=7,
        maxiter=args.strict_maxiter, config=cfg)
    strict_s = time.time() - t0
    print(json.dumps({
        "metric": "strict_solve_3ch_wall", "unit": "s",
        "value": round(strict_s, 2),
        "pixels": int(stacks.shape[1]), "exposures": int(stacks.shape[2]),
        "iterations": [int(i) for i in iters_s],
        "final_energies": [round(float(e), 5) for e in e1s]}), flush=True)

    if args.host_only:
        return

    import jax.numpy as jnp
    from camera_linearity.models import calibration as cal

    def device_solve():
        return cal.calibration(
            -1.0, 1.0,
            channel_stacks=(jnp.asarray(stacks), None,
                            jnp.asarray(exposures)),
            pca_arrays=pca3, mean_icrf_arrays=mean3,
            config=cfg, popsize=15, maxiter=1000, tol=0.01, rng_seed=7)

    device_solve()  # compile
    t0 = time.time()
    *_, e1d, _ = device_solve()
    device_s = time.time() - t0
    print(json.dumps({
        "metric": "device_solve_3ch_wall", "unit": "s",
        "value": round(device_s, 2),
        "final_energies_f32_objective": [round(float(e), 5)
                                         for e in e1d]}), flush=True)

    t0 = time.time()
    icrf_h, dev_e, e0h, e1h, iters_h = scipy_strict.calibration_hybrid(
        -1.0, 1.0, channel_stacks, pca3, mean3, rng_seed=7,
        strict_maxiter=100, config=cfg,
        device_kwargs=dict(maxiter=1000))
    hybrid_s = time.time() - t0
    print(json.dumps({
        "metric": "hybrid_solve_3ch_wall", "unit": "s",
        "value": round(hybrid_s, 2),
        "strict_iterations": [int(i) for i in iters_h],
        "seed_energies_ref_objective": [round(float(e), 5) for e in e0h],
        "final_energies_ref_objective": [round(float(e), 5) for e in e1h],
        "vs_cold_strict": round(strict_s / hybrid_s, 1)}), flush=True)


if __name__ == "__main__":
    main()

"""End-to-end walkthrough: synthetic captures -> calibration -> HDR.

Runs everywhere (CPU or GPU; auto-detected).  Generates a synthetic
exposure series of a gamma-encoded scene, solves the inverse camera
response function with the device-resident differential-evolution
solver, merges the series into an uncertainty-tracked HDR radiance map
through the fused kernel path, and runs the pairwise linearity analysis
— the same flow as the reference's README workflow
(reference: README.md:29-43), end to end in one script.

Usage: python examples/end_to_end.py [outdir]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np
import jax.numpy as jnp

from camera_linearity import CameraConfig
from camera_linearity.models import calibration as cal
from camera_linearity.models.exposure_series import ExposureSeries
from camera_linearity.models.image_set import ImageSet
from camera_linearity.ops.linearize import icrf_derivative


def make_captures(outdir: Path, gamma: float = 2.2, size: int = 64,
                  exposures_ms=(4, 8, 16), seed: int = 0):
    """Write a synthetic exposure series: radiance * t, gamma-encoded."""
    rng = np.random.default_rng(seed)
    outdir.mkdir(parents=True, exist_ok=True)
    radiance = rng.uniform(0.05, 0.55, (size, size, 3))
    for ms in exposures_ms:
        linear = np.clip(radiance * (ms / max(exposures_ms)), 0, 1)
        encoded = linear ** (1 / gamma)          # camera response
        s = ImageSet(outdir / f"{ms}ms BF scene 50x.tif",
                     value=jnp.asarray(encoded),
                     std=jnp.asarray(rng.uniform(0.002, 0.006,
                                                 (size, size, 3))))
        s.save_8bit(outdir / f"{ms}ms BF scene 50x.tif")
    return radiance


def main():
    outdir = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("/tmp/clt_demo")
    cfg = CameraConfig(num_of_chs=3, datapoints=256)
    gamma = 2.2
    make_captures(outdir / "captures", gamma=gamma)

    # --- 1. load the series ------------------------------------------------
    series = ExposureSeries.from_dir_path(outdir / "captures", config=cfg)[0]
    series.load_value_images()
    series.load_std_images()
    print(f"loaded {len(series.input_image_sets)} exposures")

    # --- 2. solve the ICRF (PCA basis around a power-law family) -----------
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.4, 3.2, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:5].T

    stack = jnp.stack([jnp.round(s.measurand.val * 255).astype(jnp.int32)
                       for s in series.input_image_sets])          # (N, H, W, C)
    stacks = jnp.transpose(stack, (3, 1, 2, 0)).reshape(
        3, -1, stack.shape[0])                               # (C, P, N)
    exp = jnp.asarray([s.features["exposure"] for s in series.input_image_sets])
    icrf_solved, e0, e1, _ = cal.calibration(
        -1.0, 1.0,
        channel_stacks=(stacks, None, exp),
        pca_arrays=np.stack([pca] * 3),
        mean_icrf_arrays=np.stack([mean_icrf] * 3),
        config=cfg, popsize=12, maxiter=150, tol=0.01, rng_seed=3)
    icrf_solved = np.asarray(icrf_solved)
    true_icrf = x ** gamma
    err = float(np.abs(icrf_solved - true_icrf[:, None]).mean())
    print(f"ICRF solved: energy {[round(float(e), 4) for e in e1]}, "
          f"mean |solved - x^{gamma}| = {err:.4f}")

    # --- 3. merge the stack into an HDR radiance map -----------------------
    icrf_j = jnp.asarray(icrf_solved)
    hdr = series.process_HDR_image(ICRF=icrf_j,
                                   ICRF_diff=icrf_derivative(icrf_j,
                                                             cfg.bits),
                                   use_std=True, apply_flat_field=False)
    hdr.save_64bit(outdir / "hdr.tif")
    print(f"HDR merged: val {hdr.measurand.val.shape}, "
          f"std tracked: {hdr.measurand.std is not None} -> "
          f"{outdir/'hdr.tif'}")

    # --- 4. linearity analysis across exposure pairs -----------------------
    # linearize() is functional: it returns a NEW series (pytree-style
    # immutability), it does not mutate in place
    lin = series.linearize(icrf_j)
    lin.initialize_exposure_pairs()
    lin.process_linearity(ICRF=icrf_j, use_std=True)
    abs_stats, rel_stats = lin.collect_exposure_pair_stats()
    rel_means = np.asarray(rel_stats["means"])
    print("pairwise relative-difference means per channel:",
          np.round(rel_means, 4).tolist())
    assert np.abs(rel_means).max() < 0.05, (
        "synthetic scene is ideally linear; large pairwise differences "
        "mean the linearization went wrong")
    print(f"done — artifacts in {outdir}")


if __name__ == "__main__":
    main()

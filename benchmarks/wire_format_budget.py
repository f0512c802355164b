"""Wire-format qualification for the config-5 upload stream.

Measures what each candidate host->device wire format for the scene
stacks does to the merged outputs (docs/kernel_design.md "Round-5: wire
formats").  The f16-std format halves the std plane's bytes; this script
verifies (a) the val output is bitwise untouched and (b) the merged std
deviates by no more than the f16 quantization bound propagated through
the merge — compare against the std estimator's own sampling noise at
N frames (~1/sqrt(2(N-1)), i.e. 2.2% at N=1000) to see why the format
is physically free.

Runs on any backend (the effect is a property of the quantization, not
the device); prints one JSON line per std-magnitude regime.
"""
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    import jax.numpy as jnp
    from camera_linearity.ops import hdr

    rng = np.random.default_rng(0)
    n, h, w, c = 3, 256, 256, 3
    exposures = jnp.asarray([0.005, 0.010, 0.020], jnp.float32)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    idiff = np.gradient(icrf, 2 / 255, axis=0)
    icrf_j = jnp.asarray(icrf, jnp.float32)
    idiff_j = jnp.asarray(idiff, jnp.float32)

    for label, lo, hi in [("video_std_of_mean_1000f", 1e-5, 2e-3),
                          ("still_image_std", 1e-3, 2e-2)]:
        val = rng.uniform(0.02, 0.98, (n, h, w, c)).astype(np.float32)
        std = rng.uniform(lo, hi, (n, h, w, c)).astype(np.float32)
        f16 = std.astype(np.float16).astype(np.float32)
        quant = float(np.max(np.abs(f16 - std) / std))
        v32, s32 = hdr.merge_stack(jnp.asarray(val), jnp.asarray(std),
                                   exposures, icrf_j, idiff_j)
        v16, s16 = hdr.merge_stack(jnp.asarray(val), jnp.asarray(f16),
                                   exposures, icrf_j, idiff_j)
        val_identical = bool(np.array_equal(np.asarray(v16),
                                            np.asarray(v32)))
        s32n, s16n = np.asarray(s32), np.asarray(s16)
        rel = np.abs(s16n - s32n) / np.maximum(np.abs(s32n), 1e-30)
        print(json.dumps({
            "metric": "wire_f16_std_error", "regime": label,
            "std_range": [lo, hi],
            "wire_quant_max_rel": round(quant, 6),
            "val_bitwise_identical": val_identical,
            "merged_std_max_rel": round(float(rel.max()), 6),
            "merged_std_mean_rel": round(float(rel.mean()), 8)}),
            flush=True)

        # u16-val + f16-std (native.WIRE_U16F16): the val plane ships as
        # fixed-point u16 on the 1/65535 grid.  Grid error is 7.63e-6
        # absolute — compare to the mean's OWN sampling noise, which at
        # N=1000 frames is std_of_mean itself (>= 6e-5 for any sensor
        # with >= 0.5 DN read noise): the wire adds noise ~100x below
        # what the estimator already carries.  Merged val bulk error
        # stays at quantization level; isolated pixels whose merge
        # weights flip across a threshold are counted separately (they
        # move between two statistically equivalent weightings).
        vq = (np.round(val * 65535.0).astype(np.uint16)
              .astype(np.float32) * np.float32(1.0 / 65535.0))
        vu, su = hdr.merge_stack(jnp.asarray(vq), jnp.asarray(f16),
                                 exposures, icrf_j, idiff_j)
        v32n, vun = np.asarray(v32), np.asarray(vu)
        vrel = np.abs(vun - v32n) / np.maximum(np.abs(v32n), 1e-30)
        crossed = vrel > 1e-3
        srel = np.abs(np.asarray(su) - s32n) / np.maximum(
            np.abs(s32n), 1e-30)
        print(json.dumps({
            "metric": "wire_u16_val_error", "regime": label,
            "val_grid_abs": round(0.5 / 65535, 9),
            "sampling_noise_floor_1000f_05dn": round(
                0.5 / 255 / np.sqrt(1000), 9),
            "merged_val_median_rel": round(float(np.median(vrel)), 9),
            "merged_val_q99_rel": round(float(np.quantile(vrel, 0.99)),
                                        9),
            "weight_flip_pixel_frac": round(float(crossed.mean()), 8),
            "merged_val_max_rel_unflipped": round(
                float(vrel[~crossed].max()) if (~crossed).any() else 0.0,
                9),
            "merged_std_max_rel": round(float(srel.max()), 6)}),
            flush=True)


if __name__ == "__main__":
    main()

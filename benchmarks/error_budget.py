"""Measured f32 error budget per BASELINE config (SURVEY §7 hard-part (e)).

For each of BASELINE.json's five configs this script runs the hot paths
in float32 on the default backend (the GPU, where one is present) and
compares against the SAME ops executed in float64 on a CPU subprocess.  The CPU-f64 path's agreement with the reference
semantics is pinned separately by the test suite's NumPy oracles
(tests/unit/test_hdr_merge.py, test_linearity.py, test_video.py), so the
deviation measured here is exactly the f32-vs-f64 budget of the
accelerator path.

Methodology notes:
  * All float inputs are quantized THROUGH float32 before both paths, so
    both evaluate identical representable values — the budget measures
    arithmetic error (accumulation order, transcendentals, LUT gathers),
    not input-representation error.  Without this, a value within
    f32-epsilon of a LUT-bin boundary indexes different table entries on
    the two paths and the comparison reports a full bin width.
  * LUT-indexed inputs are additionally kept AWAY from bin-rounding
    boundaries (values constructed as (dn + u)/max_dn with |u| <= 0.4),
    because round(x * max_dn) can legitimately land in adjacent bins when
    evaluated in f32 vs f64 for x within ~eps of a half-bin boundary.
    That is a property of the data, not of the kernel: a measured pixel
    sitting exactly on a quantization boundary is ambiguous at ANY
    precision.  (First measurement without this: config2 max rel 1.4e-2,
    entirely bin-width flips at 8.3M-sample scale.)
  * The calibration energies are measured on FEASIBLE (monotone,
    in-range) candidate curves.  Infeasible candidates take a large soft
    penalty whose magnitude is intentional (steers the DE away), so tiny
    f32 differences there amplify to huge absolute deviations with no
    effect on solver behavior.
  * Deviations are reported as max |a-b| (abs) and max |a-b|/|b| over
    |b| > floor (rel, floor=1e-3 of the output's max magnitude — relative
    error on near-zero outputs is not meaningful for imaging data).

Usage:  python benchmarks/error_budget.py            # f32 on default backend
        python benchmarks/error_budget.py --oracle F # (internal) f64 child
Prints the markdown table for docs/kernel_design.md (``--json PATH`` also
writes the rows).  The float64 child pins the CPU platform before its
backend starts, so it never opens the GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


# ---------------------------------------------------------------------------
# deterministic inputs, quantized through f32
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(20260818)
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)  # noqa: E731

    def icrf_pair(bits, c):
        icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
        icrf[0], icrf[-1] = 0.0, 1.0
        icrf = f32(icrf)
        diff = f32(np.gradient(np.asarray(icrf, np.float64),
                               2 / (bits - 1), axis=0))
        return icrf, diff

    def lut_safe(shape, max_dn):
        """[0,1] values whose round(x*max_dn) is unambiguous between f32
        and f64 evaluation: (dn + u)/max_dn with |u| <= 0.4 keeps a
        0.1-bin margin (~2.4e-5 at 12 bits, >> f32 eps)."""
        dn = rng.integers(0, max_dn + 1, shape).astype(np.float64)
        u = rng.uniform(-0.4, 0.4, shape)
        return f32(np.clip((dn + u) / max_dn, 0.0, 1.0))

    out = {}
    # config 1: grayscale 5-frame 8-bit 512x512 merge, no uncertainty
    icrf1, diff1 = icrf_pair(256, 1)
    out["config1"] = dict(
        stack_dn=rng.integers(0, 256, (5, 512, 512, 1)).astype(np.uint8),
        exposures=f32(0.001 * 2.0 ** np.arange(5)),
        icrf=icrf1, icrf_diff=diff1)
    # config 2: RGB 6-exposure merge with uncertainty (representative
    # 600x768 tile; the merge is pixelwise so the budget is size-invariant
    # — accumulation depth is the exposure axis, not the pixel count)
    icrf2, diff2 = icrf_pair(256, 3)
    out["config2"] = dict(
        stack_val=lut_safe((6, 600, 768, 3), 255),
        stack_std=f32(rng.uniform(0.001, 0.02, (6, 600, 768, 3))),
        exposures=f32(0.001 * 2.0 ** np.arange(6)),
        icrf=icrf2, icrf_diff=diff2)
    # config 3: corrections-fused merge on 12-bit stacks (dark bad-pixel
    # prologue + flat-field epilogue, 4096-entry tables built as the
    # reference builds them: np.interp expansions of a 256-point curve)
    base3, diffb3 = icrf_pair(256, 3)
    xs_full = np.arange(4096) / 4095.0
    xs_base = np.arange(256) / 255.0
    icrf3 = f32(np.stack([np.interp(xs_full, xs_base,
                                    np.asarray(base3, np.float64)[:, ch])
                          for ch in range(3)], axis=1))
    diff3 = f32(np.stack([np.interp(xs_full, xs_base,
                                    np.asarray(diffb3, np.float64)[:, ch])
                          for ch in range(3)], axis=1))
    n3, h3, w3 = 4, 256, 320
    dark = np.zeros((n3, h3, w3, 3), np.float32)
    hot_r = rng.integers(2, h3 - 2, 40)
    hot_c = rng.integers(2, w3 - 2, 40)
    dark[:, hot_r, hot_c, :] = 0.9
    out["config3"] = dict(
        stack_val=lut_safe((n3, h3, w3, 3), 4095),
        stack_std=f32(rng.uniform(0.001, 0.02, (n3, h3, w3, 3))),
        dark_stack=dark,
        exposures=f32([0.002, 0.004, 0.008, 0.016]),
        icrf=icrf3, icrf_diff=diff3,
        flat_val=f32(rng.uniform(0.7, 1.0, (h3, w3, 3))),
        flat_std=f32(rng.uniform(0.001, 0.01, (h3, w3, 3))))
    # config 4: calibration population energies, all three formulations
    n4, px = 6, 4096
    exposures4 = 0.001 * 2.0 ** np.arange(n4)
    radiance = rng.uniform(0.01, 0.4, px)
    linear = radiance[:, None] * (exposures4 / exposures4[-1])[None, :]
    stack_dn4 = np.around(np.clip(linear, 0, 1) ** (1 / 2.2) * 255
                          ).astype(np.int32)
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:5].T
    # feasible population: projections of the true gamma family onto the
    # basis — reconstructions stay monotone/in-range, so the energies
    # measured are penalty-free objective values (see module docstring)
    pop_all = (curves - mean_icrf) @ pca
    recon = mean_icrf + pop_all @ pca.T
    recon += 1 - recon[:, -1:]
    recon[:, 0] = 0
    ok = (np.all(np.diff(recon, axis=1) > 0, axis=1)
          & (recon.max(axis=1) <= 1) & (recon.min(axis=1) >= 0))
    pop = pop_all[ok][:24]
    assert pop.shape[0] >= 8, "too few feasible candidates"
    out["config4"] = dict(stack_dn=stack_dn4[None],
                          exposures=f32(exposures4),
                          pca=f32(pca), mean_icrf=f32(mean_icrf),
                          pop=f32(pop))
    # config 5: 1000-frame Welford mean/std (the deepest accumulation in
    # the suite) on a 64x96 RGB tile, plain + LUT-fused variants
    out["config5"] = dict(
        frames_dn=rng.integers(40, 220, (1000, 64, 96, 3)
                               ).astype(np.uint8),
        icrf=icrf2, )
    return out


# ---------------------------------------------------------------------------
# the measured computations (dtype comes from the caller)
# ---------------------------------------------------------------------------

def _compute(inp, ftype):
    import jax
    import jax.numpy as jnp
    from camera_linearity.ops import hdr, linearity as lin, welford as wf
    from camera_linearity.models import calibration as cal

    cast = lambda a: jnp.asarray(np.asarray(a, np.float64), ftype)  # noqa
    out = {}

    c1 = inp["config1"]
    v, _ = hdr.merge_hdr(jnp.asarray(c1["stack_dn"]), None,
                         cast(c1["exposures"]), cast(c1["icrf"]),
                         cast(c1["icrf_diff"]))
    out["config1.val"] = np.asarray(v, np.float64)

    c2 = inp["config2"]
    v, s = hdr.merge_hdr(cast(c2["stack_val"]), cast(c2["stack_std"]),
                         cast(c2["exposures"]), cast(c2["icrf"]),
                         cast(c2["icrf_diff"]))
    out["config2.val"] = np.asarray(v, np.float64)
    out["config2.std"] = np.asarray(s, np.float64)

    c3 = inp["config3"]
    v, s = hdr.merge_corrected(
        cast(c3["stack_val"]), cast(c3["stack_std"]),
        cast(c3["dark_stack"]), cast(c3["exposures"]), cast(c3["icrf"]),
        cast(c3["icrf_diff"]), jnp.asarray(0.05, ftype),
        flat_val=cast(c3["flat_val"]), flat_std=cast(c3["flat_std"]))
    out["config3.val"] = np.asarray(v, np.float64)
    out["config3.std"] = np.asarray(s, np.float64)

    c4 = inp["config4"]
    stack = jnp.asarray(c4["stack_dn"][0])
    n = stack.shape[-1]
    ii, jj = lin.upper_triangle_pairs(n)
    ii_j, jj_j = jnp.asarray(ii), jnp.asarray(jj)
    curves = jax.vmap(lambda prm: cal.icrf_from_params(
        jnp.asarray(prm, ftype), cast(c4["pca"]), cast(c4["mean_icrf"]),
        datapoints=256))(jnp.asarray(c4["pop"], ftype))
    onehot = lin.build_data_onehot(stack, 256)
    e_onehot = lin.population_linearity_energies(
        curves, onehot, None, cast(c4["exposures"]), 5, 250, ii_j, jj_j,
        penalty="soft")
    hists = lin.pair_dn_histograms(stack, ii_j, jj_j, 256)
    e_hist = lin.population_linearity_energies_hist(
        curves, hists, cast(c4["exposures"]), 5, 250, ii_j, jj_j,
        penalty="soft")
    e_chunk = lin.population_linearity_energies_chunked(
        curves, stack, None, cast(c4["exposures"]), 5, 250, ii_j, jj_j,
        penalty="soft", chunk=1024)
    out["config4.energy_onehot"] = np.asarray(e_onehot, np.float64)
    out["config4.energy_hist"] = np.asarray(e_hist, np.float64)
    out["config4.energy_chunked"] = np.asarray(e_chunk, np.float64)

    c5 = inp["config5"]
    frames = jnp.asarray(c5["frames_dn"])
    shape = frames.shape[1:]
    state = wf.welford_init(shape, dtype=ftype)
    frames_f = frames.astype(ftype) / 255.0
    for start in range(0, frames.shape[0], 250):
        state = wf.welford_update_batch(state, frames_f[start:start + 250])
    mean, std = wf.welford_finalize(state)
    out["config5.mean"] = np.asarray(mean, np.float64)
    out["config5.std"] = np.asarray(std, np.float64)
    state_l = wf.welford_init(shape, dtype=ftype)
    for start in range(0, frames.shape[0], 250):
        state_l = wf.welford_update_batch_lut(
            state_l, frames[start:start + 250], cast(c5["icrf"]), 255)
    mean_l, std_l = wf.welford_finalize(state_l)
    out["config5.mean_lut"] = np.asarray(mean_l, np.float64)
    out["config5.std_lut"] = np.asarray(std_l, np.float64)
    return out


def _run_oracle(npz_path: str) -> None:
    """Child entry: CPU backend, float64, write outputs."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    out = _compute(_inputs(), jnp.float64)
    np.savez(npz_path, **out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--oracle", help="(internal) write f64 outputs here")
    ap.add_argument("--json", help="also write the rows here")
    args = ap.parse_args()
    if args.oracle:
        _run_oracle(args.oracle)
        return 0

    with tempfile.TemporaryDirectory() as td:
        oracle_npz = os.path.join(td, "oracle.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("XLA_FLAGS", None)
        subprocess.run([sys.executable, __file__, "--oracle", oracle_npz],
                       check=True, env=env, cwd=str(REPO))
        oracle = dict(np.load(oracle_npz))

    import jax
    import jax.numpy as jnp
    backend = jax.default_backend()
    got = _compute(_inputs(), jnp.float32)

    rows = []
    for key in sorted(oracle):
        a, b = got[key], oracle[key]
        absdev = float(np.max(np.abs(a - b)))
        floor = 1e-3 * float(np.max(np.abs(b)))
        mask = np.abs(b) > floor
        reldev = float(np.max(np.abs(a - b)[mask] / np.abs(b)[mask])) \
            if mask.any() else 0.0
        rows.append({"output": key, "max_abs": absdev, "max_rel": reldev,
                     "out_scale": float(np.max(np.abs(b)))})

    dev = jax.devices()[0]
    result = {"backend": backend, "device_kind": dev.device_kind,
              "rows": rows}
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=2))
    print(f"backend: {backend} ({dev.device_kind})")
    print("| output | max abs dev | max rel dev (|y|>1e-3·max) |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['output']} | {r['max_abs']:.2e} | {r['max_rel']:.2e} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

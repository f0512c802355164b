#!/usr/bin/env python3
"""Bring-up check on an NVIDIA GPU: the main paths at full width.

Drives BASELINE configs 1-5 once, in one process, through the entry points
a user calls (``ops.hdr.merge_hdr`` / ``merge_batch`` / ``merge_corrected``,
``models.calibration.calibration``, ``models.pipeline.batch_video_to_hdr``),
with seeded random data at the widths BASELINE.json states.  Every merge
runs the GPU kernel (ops/hdr_triton.py) as compiled for the card and is
compared with the plain XLA path on the card and with a float64 NumPy
oracle; the calibration is compared with float64 on the CPU and with the
SciPy reference solver.  Any failed check exits non-zero.

    python chip_smoke.py           # one GPU: configs 1-5
    python chip_smoke.py --four    # four GPUs: sharded merge and
                                   # population-sharded calibration, each
                                   # against the same work on one GPU

Earlier lines report the card, each phase's shapes, compile and warm wall
times (for information only), memory analysis and errors against the
stated tolerances.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path[:0] = [str(REPO), str(REPO / "benchmarks")]
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache"))

import numpy as np  # noqa: E402

# BASELINE.json widths (configs 1-5); config 5's depth is cut to 100
# frames per exposure and 2 scenes (BASELINE: 1000 and 8).
C1 = dict(n=5, h=512, w=512, batch=32)
C2 = dict(n=6, h=1200, w=1920, c=3)
C3 = dict(n=6, h=1200, w=1920, c=3, bits=4096, hot_frac=1e-3)
C5 = dict(frames=100, scenes=2, h=2160, w=3840, exposures_ms=(5, 10, 20))
# 5 frames: a mean of 5 DNs never sits on a half-DN rounding tie
C5_SMALL = dict(frames=5, h=48, w=64)
FOUR = dict(scenes=4, n=3, h=2160, w=3840, c=3)

# Tolerances: ~10x the deviation measured on an H100 (docs/kernel_design.md
# "Numerics on the GPU"); the cause is float32 rounding in the weights,
# the divisions and the sum over N exposures (the f64 oracle sees none).
# Relative errors are taken where |reference| > 1e-3 of its maximum.
TOL_MERGE_VAL = 2e-5
TOL_MERGE_STD = 2e-4
TOL_KERNEL_VS_XLA = 2e-5
TOL_ENERGY = 5e-6
TOL_VIDEO = 6e-5
# The device solve (DE + refinement + polish) must end no worse than the
# SciPy reference solver's final energy on the same channel by this much.
TOL_SOLVE_VS_SCIPY = 0.02


class CheckFailed(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def max_errors(got, ref, floor: float = 1e-3):
    """(max abs, max rel) deviation; rel only where |ref| > floor*max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    dev = np.abs(got - ref)
    mask = np.abs(ref) > floor * float(np.max(np.abs(ref)))
    rel = float(np.max(dev[mask] / np.abs(ref[mask]))) if mask.any() else 0.0
    return float(np.max(dev)), rel


def check(name: str, got, ref, rtol: float, precision: str) -> None:
    got = np.asarray(got)
    if got.shape != np.shape(ref):
        raise CheckFailed(f"{name}: shape {got.shape} != {np.shape(ref)}")
    if not np.isfinite(got).all():
        raise CheckFailed(f"{name}: non-finite values")
    a, r = max_errors(got, ref)
    log(f"  {name}: max abs {a:.3e}  max rel {r:.3e}  (tol rel {rtol:g}; "
        f"{precision})")
    if r > rtol:
        raise CheckFailed(f"{name}: max rel {r:.3e} > {rtol:g}")


def timed_compile(fn, *args):
    """Compile ``fn`` for ``args``; returns (compiled, compile_s)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def warm_time(fn, iters: int = 10) -> float:
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def report_memory(compiled) -> None:
    m = compiled.memory_analysis()
    log(f"  memory: arguments {m.argument_size_in_bytes / 2**20:.1f} MiB, "
        f"outputs {m.output_size_in_bytes / 2**20:.1f} MiB, "
        f"temporaries {m.temp_size_in_bytes / 2**20:.1f} MiB")


def peak_memory() -> str:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.2f} GiB"


# ---------------------------------------------------------------------------
# inputs: quantized through float32 and kept 0.1 bin away from LUT-bin
# rounding boundaries, so the float32 and float64 paths index the same
# table entries (benchmarks/error_budget.py)
# ---------------------------------------------------------------------------

def lut_safe(rng, shape, max_dn):
    dn = rng.integers(0, max_dn + 1, shape).astype(np.float64)
    u = rng.uniform(-0.4, 0.4, shape)
    return np.clip((dn + u) / max_dn, 0.0, 1.0).astype(np.float32)


def tables(rng, bits, c):
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf = icrf.astype(np.float32)
    diff = np.gradient(icrf.astype(np.float64), 2 / (bits - 1), axis=0)
    return icrf, diff.astype(np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_config2(rng):
    import jax
    import jax.numpy as jnp
    from camera_linearity.ops import hdr
    from tests.unit.test_hdr_paths import oracle_merge
    n, h, w, c = C2["n"], C2["h"], C2["w"], C2["c"]
    log(f"[config 2] merge_hdr, val+std float32 {n}x{h}x{w}x{c}, "
        "256-entry tables")
    val = lut_safe(rng, (n, h, w, c), 255)
    std = rng.uniform(0.001, 0.02, (n, h, w, c)).astype(np.float32)
    ex = (0.001 * 2.0 ** np.arange(n)).astype(np.float32)
    icrf, diff = tables(rng, 256, c)
    args = tuple(jnp.asarray(a) for a in (val, std, ex, icrf, diff))
    compiled, cs = timed_compile(hdr.merge_hdr, *args)
    dt = warm_time(lambda: compiled(*args))
    log(f"  compile {cs:.2f} s, warm {dt * 1e3:.3f} ms/call")
    report_memory(compiled)
    got_v, got_s = compiled(*args)
    xla_v, xla_s = jax.jit(hdr.merge_stack)(*args)
    ref_v, ref_s = oracle_merge(val, std, ex, icrf, diff, "corrected")
    prec = "no matmul; float32, sum over N"
    check("value vs float64 oracle", got_v, ref_v, TOL_MERGE_VAL, prec)
    check("std vs float64 oracle", got_s, ref_s, TOL_MERGE_STD, prec)
    check("value kernel vs XLA", got_v, xla_v, TOL_KERNEL_VS_XLA, prec)
    check("std kernel vs XLA", got_s, xla_s, TOL_KERNEL_VS_XLA, prec)


def phase_config1(rng):
    import jax.numpy as jnp
    from camera_linearity.ops import hdr
    from tests.unit.test_hdr_paths import oracle_merge
    n, h, w, b = C1["n"], C1["h"], C1["w"], C1["batch"]
    log(f"[config 1] merge_hdr, uint8 {n}x{h}x{w}x1, no std; merge_batch "
        f"of {b} such stacks")
    dn = rng.integers(0, 256, (b, n, h, w, 1)).astype(np.uint8)
    ex = (0.001 * 2.0 ** np.arange(n)).astype(np.float32)
    icrf, diff = tables(rng, 256, 1)
    e, i, d = (jnp.asarray(a) for a in (ex, icrf, diff))
    one = jnp.asarray(dn[0])
    compiled, cs = timed_compile(
        lambda v: hdr.merge_hdr(v, None, e, i, d)[0], one)
    dt = warm_time(lambda: compiled(one), iters=50)
    log(f"  single: compile {cs:.2f} s, warm {dt * 1e6:.1f} us/call")
    report_memory(compiled)
    prec = "no matmul; float32, sum over N"
    check("single vs float64 oracle", compiled(one),
          oracle_merge(dn[0], None, ex, icrf, diff, "corrected")[0],
          TOL_MERGE_VAL, prec)
    batch = jnp.asarray(dn)
    compiled_b, cs = timed_compile(
        lambda v: hdr.merge_batch(v, None, e, i, d)[0], batch)
    dt = warm_time(lambda: compiled_b(batch))
    log(f"  batch: compile {cs:.2f} s, warm {dt * 1e3:.3f} ms/call")
    report_memory(compiled_b)
    got = np.asarray(compiled_b(batch))
    ref = np.stack([oracle_merge(dn[k], None, ex, icrf, diff, "corrected")[0]
                    for k in range(b)])
    check("batch vs float64 oracle", got, ref, TOL_MERGE_VAL, prec)


def phase_config3(rng):
    import jax
    import jax.numpy as jnp
    from camera_linearity.ops import filters, hdr
    from tests.unit.test_hdr_paths import (oracle_flat, oracle_merge,
                                           oracle_repair)
    n, h, w, c, bits = C3["n"], C3["h"], C3["w"], C3["c"], C3["bits"]
    log(f"[config 3] merge_corrected, val+std float32 {n}x{h}x{w}x{c}, "
        f"{bits}-entry tables, dark frames ({C3['hot_frac']:g} hot), "
        "flat field")
    val = lut_safe(rng, (n, h, w, c), bits - 1)
    std = rng.uniform(0.001, 0.02, (n, h, w, c)).astype(np.float32)
    dark = (rng.uniform(0, 1, (n, h, w, c)) < C3["hot_frac"]
            ).astype(np.float32)
    ex = (0.001 * 2.0 ** np.arange(n)).astype(np.float32)
    icrf, diff = tables(rng, bits, c)
    flat_v = rng.uniform(0.7, 1.0, (h, w, c)).astype(np.float32)
    flat_s = rng.uniform(0.001, 0.01, (h, w, c)).astype(np.float32)
    thr = np.float32(0.5)
    args = tuple(jnp.asarray(a) for a in (val, std, dark, ex, icrf, diff,
                                          thr, flat_v, flat_s))
    compiled, cs = timed_compile(hdr.merge_corrected, *args)
    dt = warm_time(lambda: compiled(*args))
    log(f"  compile {cs:.2f} s, warm {dt * 1e3:.3f} ms/call")
    report_memory(compiled)
    got_v, got_s = compiled(*args)

    @jax.jit
    def plain(v, s, dk, e, i, d, t, fv, fs):
        rv, rs = jax.vmap(lambda a, b, k: filters.bad_pixel_filter(
            a, b, k, t, 3))(v, s, dk)
        mv, ms = hdr.merge_stack(rv, rs, e, i, d)
        return filters.flat_field_correction(mv, ms, fv, fs, 0.05)

    xla_v, xla_s = plain(*args)
    hot = dark > thr
    rv = oracle_repair(val, hot)
    rs = oracle_repair(std, hot)
    mv, ms = oracle_merge(rv, rs, ex, icrf, diff, "corrected")
    ref_v, ref_s = oracle_flat(mv, ms, flat_v.astype(np.float64),
                               flat_s.astype(np.float64), 0.05)
    prec = "no matmul; float32, sum over N"
    check("value vs float64 oracle", got_v, ref_v, TOL_MERGE_VAL, prec)
    check("std vs float64 oracle", got_s, ref_s, TOL_MERGE_STD, prec)
    check("value kernel vs XLA", got_v, xla_v, TOL_KERNEL_VS_XLA, prec)
    check("std kernel vs XLA", got_s, xla_s, TOL_KERNEL_VS_XLA, prec)


def start_scipy_reference():
    """The SciPy reference solve of channel 0 (benchmarks/bench_calibration
    .py), in a CPU-only child that never touches JAX, running while the
    GPU phases do."""
    code = ("import json, sys; sys.path.insert(0, 'benchmarks'); "
            "from bench_calibration import build_problem, "
            "scipy_reference_seconds as ref; "
            "s, e, m, p = build_problem(); w, en, nit = ref(s[0], e, m, p); "
            "print(json.dumps({'wall_s': w, 'energy': en, 'nit': nit}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE, text=True)


def phase_config4(scipy_proc):
    import jax
    import jax.numpy as jnp
    from bench_calibration import build_problem
    from camera_linearity import CameraConfig
    from camera_linearity.models import calibration as cal
    from camera_linearity.models.icrf import icrf_from_params
    from camera_linearity.ops import linearity as lin
    stacks, exposures, mean_icrf, pca = build_problem()
    log(f"[config 4] calibration: {stacks.shape[0]} channels x "
        f"{stacks.shape[1]} px x {stacks.shape[2]} exposures, popsize=15, "
        "maxiter=1000, rng_seed=7")

    # energies of one fixed, feasible candidate population: float32 on
    # the GPU against float64 on the CPU
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    pop = (curves - mean_icrf) @ pca
    ii, jj = lin.upper_triangle_pairs(stacks.shape[2])

    def energies(ftype):
        cast = lambda a: jnp.asarray(np.asarray(a, np.float64), ftype)  # noqa
        cv = jax.vmap(lambda p: icrf_from_params(
            p, cast(pca), cast(mean_icrf), datapoints=256))(cast(pop))
        onehot = lin.build_data_onehot(jnp.asarray(stacks[0]), 256)
        return np.asarray(lin.population_linearity_energies(
            cv.astype(ftype), onehot.astype(ftype), None, cast(exposures),
            5, 250, jnp.asarray(ii), jnp.asarray(jj), penalty="soft"))

    e32 = energies(jnp.float32)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        e64 = energies(jnp.float64)
    feasible = e64 < 1.0  # penalized candidates amplify rounding on purpose
    if feasible.sum() < 8:
        raise CheckFailed(f"only {int(feasible.sum())} feasible candidates")
    check(f"population energies ({int(feasible.sum())} feasible) vs "
          "float64 CPU", e32[feasible], e64[feasible], TOL_ENERGY,
          "matmuls pinned HIGHEST")

    cfg = CameraConfig(num_of_chs=3, datapoints=256)

    def solve():
        return cal.calibration(
            -1.0, 1.0, channel_stacks=(jnp.asarray(stacks), None,
                                       jnp.asarray(exposures)),
            pca_arrays=np.stack([pca] * 3),
            mean_icrf_arrays=np.stack([mean_icrf] * 3), config=cfg,
            popsize=15, maxiter=1000, tol=0.01, rng_seed=7)

    t0 = time.perf_counter()
    solve()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    icrf, e0, e1, _ = solve()
    warm = time.perf_counter() - t0
    log(f"  solve: cold {cold:.2f} s (compile included), warm {warm:.3f} s; "
        f"peak device memory {peak_memory()}")
    if not np.isfinite(icrf).all() or icrf.shape != (256, 3):
        raise CheckFailed(f"calibration: bad ICRF {icrf.shape}")
    if not (np.asarray(e1) <= np.asarray(e0)).all():
        raise CheckFailed(f"calibration: energies rose {e0} -> {e1}")
    out, _ = scipy_proc.communicate(timeout=900)
    if scipy_proc.returncode:
        raise CheckFailed(f"SciPy reference exited {scipy_proc.returncode}")
    ref = json.loads(out.strip().splitlines()[-1])
    ratio = float(e1[0]) / ref["energy"]
    log(f"  final energies {np.round(e1, 5).tolist()}; SciPy reference "
        f"(channel 0): {ref['energy']:.5f} after {ref['nit']} generations "
        f"in {ref['wall_s']:.1f} s on the host CPU; device/SciPy "
        f"{ratio:.4f} (tol {1 + TOL_SOLVE_VS_SCIPY:g})")
    if ratio > 1 + TOL_SOLVE_VS_SCIPY:
        raise CheckFailed(f"calibration: channel 0 energy {e1[0]:.5f} vs "
                          f"SciPy {ref['energy']:.5f}")


def oracle_video_stacks(paths):
    """Mean and std-of-mean per video, float64, from cv2-decoded frames."""
    import cv2
    vals, stds = [], []
    for p in paths:
        cap = cv2.VideoCapture(str(p))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f.astype(np.float64) / 255.0)
        cap.release()
        f = np.stack(frames)
        vals.append(f.mean(axis=0))
        stds.append(f.std(axis=0, ddof=1) / np.sqrt(len(f)))
    return np.stack(vals), np.stack(stds)


def phase_config5():
    import jax
    import jax.numpy as jnp
    from camera_linearity.models import pipeline
    from camera_linearity.ops.linearize import icrf_derivative
    from camera_linearity.utils import observability as obs
    from bench_video import make_calibration_basis, make_videos
    from tests.unit.test_hdr_paths import oracle_merge
    f, s, h, w = C5["frames"], C5["scenes"], C5["h"], C5["w"]
    ems = C5["exposures_ms"]
    log(f"[config 5] batch_video_to_hdr: {s} scenes x {len(ems)} exposures "
        f"x {f} frames of {w}x{h} MJPG, decoded by cv2 on the host "
        "(the native libjpeg decoder needs libjpeg headers), calibration "
        "leg on")
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.2

    # small input against the float64 oracle (no calibration leg: the
    # merge uses the given ICRF)
    sm = C5_SMALL
    small = make_videos(sm["frames"], sm["h"], sm["w"], ems)
    res = pipeline.batch_video_to_hdr({"s0": small}, icrf, decoder="cv2")
    ov, osd = oracle_video_stacks(small)
    ex = np.asarray(ems, np.float64) / 1000.0
    ref_v, ref_s = oracle_merge(ov, osd, ex, icrf,
                                np.asarray(icrf_derivative(
                                    jnp.asarray(icrf), 256)), "corrected")
    m = res["s0"].measurand
    prec = "no matmul; float32 moments and merge"
    check(f"small {sm['w']}x{sm['h']} value vs float64 oracle", m.val,
          ref_v, TOL_VIDEO, prec)
    check(f"small {sm['w']}x{sm['h']} std vs float64 oracle", m.std,
          ref_s, TOL_VIDEO, prec)

    paths = make_videos(f, h, w, ems)
    pca, mean_icrf = make_calibration_basis()
    calibrate = dict(pca_arrays=pca, mean_icrf_arrays=mean_icrf,
                     spacing=max(1, h * w // 2000), popsize=15, maxiter=1000,
                     tol=0.01, rng_seed=7)
    t0 = time.perf_counter()
    pipeline.prewarm_batch_video_to_hdr(s, len(ems), h, w, icrf,
                                        calibrate=calibrate)
    log(f"  prewarm (buffers, compiles): {time.perf_counter() - t0:.1f} s")
    obs.reset_stage_times()
    t0 = time.perf_counter()
    out = pipeline.batch_video_to_hdr({f"scene{k}": paths for k in range(s)},
                                      icrf, calibrate=calibrate,
                                      decoder="cv2")
    jax.block_until_ready([r.measurand.val for r in out.values()])
    wall = time.perf_counter() - t0
    mp = f * len(ems) * s * h * w / 1e6
    log(f"  wall {wall:.2f} s for {mp:.0f} MP decoded; stage busy times "
        f"{obs.snapshot_stage_times()}; peak device memory {peak_memory()}")
    vals = [np.asarray(r.measurand.val) for r in out.values()]
    stds = [np.asarray(r.measurand.std) for r in out.values()]
    for v, sd in zip(vals, stds):
        if v.shape != (h, w, 3) or not (np.isfinite(v).all()
                                        and np.isfinite(sd).all()):
            raise CheckFailed(f"config 5: bad output {v.shape}")
    # every scene is the same three videos: the merges must agree exactly
    for v in vals[1:]:
        if not np.array_equal(v, vals[0]):
            raise CheckFailed("config 5: identical scenes merged differently")
    log(f"  {s} scene outputs finite, shape {(h, w, 3)}, identical across "
        "identical scenes")


def phase_four(rng):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bench_calibration import build_problem
    from camera_linearity import CameraConfig
    from camera_linearity.models import calibration as cal
    from camera_linearity.ops import hdr
    from camera_linearity.parallel import sharded
    devs = jax.devices()
    if len(devs) < 4:
        raise CheckFailed(f"--four needs 4 devices, found {len(devs)}")
    b, n, h, w, c = (FOUR[k] for k in ("scenes", "n", "h", "w", "c"))
    log(f"[four] merge_batch_sharded on a (data=2, pixel=2) mesh, "
        f"{b} scenes x {n}x{h}x{w}x{c} val+std float32")
    val = lut_safe(rng, (b, n, h, w, c), 255)
    std = rng.uniform(0.001, 0.02, (b, n, h, w, c)).astype(np.float32)
    ex = (0.001 * 2.0 ** np.arange(n)).astype(np.float32)
    icrf, diff = tables(rng, 256, c)
    e, i, d = (jnp.asarray(a) for a in (ex, icrf, diff))
    mesh = jax.make_mesh((2, 2), ("data", "pixel"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=devs[:4])
    spec = NamedSharding(mesh, P("data", None, "pixel", None, None))
    bv, bs = jax.device_put(val, spec), jax.device_put(std, spec)
    run = jax.jit(lambda v, s: sharded.merge_batch_sharded(v, s, e, i, d,
                                                           mesh))
    t0 = time.perf_counter()
    got_v, got_s = jax.block_until_ready(run(bv, bs))
    log(f"  sharded: first call {time.perf_counter() - t0:.2f} s, warm "
        f"{warm_time(lambda: run(bv, bs)) * 1e3:.3f} ms/call")
    one = jax.jit(lambda v, s: hdr.merge_batch(v, s, e, i, d))
    v1, s1 = jax.device_put(val, devs[0]), jax.device_put(std, devs[0])
    ref_v, ref_s = one(v1, s1)
    log(f"  one GPU: warm {warm_time(lambda: one(v1, s1)) * 1e3:.3f} ms/call")
    for name, g, r in (("value", got_v, ref_v), ("std", got_s, ref_s)):
        g, r = np.asarray(g), np.asarray(r)
        if not np.array_equal(g, r):
            raise CheckFailed(f"four: sharded {name} differs from one GPU "
                              f"(max abs {np.max(np.abs(g - r)):.3e})")
    log("  sharded value and std equal the one-GPU merge bit for bit")

    stacks, exposures, mean_icrf, pca = build_problem()
    # popsize 16 x 5 parameters = 80 members, a multiple of 4, so the
    # sharded and the one-GPU solve evolve populations of the same size
    log("[four] calibration(mesh=(data=4,), pop_axis='data'), 3 channels, "
        "popsize=16 (80 members), maxiter=1000, rng_seed=7")
    cfg = CameraConfig(num_of_chs=3, datapoints=256)
    kw = dict(channel_stacks=(jnp.asarray(stacks), None,
                              jnp.asarray(exposures)),
              pca_arrays=np.stack([pca] * 3),
              mean_icrf_arrays=np.stack([mean_icrf] * 3), config=cfg,
              popsize=16, maxiter=1000, tol=0.01, rng_seed=7)
    mesh1 = jax.make_mesh((4,), ("data",),
                          axis_types=(jax.sharding.AxisType.Auto,),
                          devices=devs[:4])
    t0 = time.perf_counter()
    icrf_m, e0_m, e1_m, _ = cal.calibration(-1.0, 1.0, mesh=mesh1,
                                            pop_axis="data", **kw)
    log(f"  sharded: {time.perf_counter() - t0:.2f} s (compile included)")
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        icrf_1, e0_1, e1_1, _ = cal.calibration(-1.0, 1.0, **kw)
    log(f"  one GPU: {time.perf_counter() - t0:.2f} s (compile included)")
    check("initial energies, sharded vs one GPU", e0_m, e0_1, TOL_ENERGY,
          "matmuls pinned HIGHEST")
    log(f"  final energies sharded {np.round(e1_m, 5).tolist()}, one GPU "
        f"{np.round(e1_1, 5).tolist()}")
    rel = np.max(np.abs(np.asarray(e1_m) - e1_1) / np.asarray(e1_1))
    if not np.isfinite(icrf_m).all() or rel > TOL_SOLVE_VS_SCIPY:
        raise CheckFailed(f"four: sharded final energies differ by {rel:.3e}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four-GPU path: sharded merge and population-"
                         "sharded calibration against one GPU")
    args = ap.parse_args(argv)
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {backend!r}",
              file=sys.stderr)
        return 2
    import camera_linearity  # noqa: F401  (fails outside a checkout)

    log(f"card: {card_line()}")
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    rng = np.random.default_rng(20261016)
    t_all = time.perf_counter()
    if args.four:
        phase_four(rng)
    else:
        scipy_proc = start_scipy_reference()
        try:
            for phase in (phase_config2, phase_config1, phase_config3):
                phase(rng)
            phase_config4(scipy_proc)
            phase_config5()
        finally:
            if scipy_proc.poll() is None:
                scipy_proc.kill()
                scipy_proc.wait()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

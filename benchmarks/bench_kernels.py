"""The merge kernel against XLA's plain path, on the GPU, at BASELINE widths.

For configs 1-3 this times the entry point as users call it (the Pallas
kernel of ops/hdr_triton.py on the GPU) beside the plain path XLA compiles
(ops/hdr.merge_stack and, for config 3, the vmapped median repair ahead of
it), both jitted on device-resident inputs, and reads each one's device
time from a profiler trace.  Bytes moved are arithmetic, from the shapes
(inputs read once, outputs written once), so ``GB/s`` and ``of_peak`` say
how close each comes to the card's published 3.35 TB/s; a 1 GiB copy is
timed beside them as the reachable rate.  Also timed: the merge in
row slabs (``row_chunk``) and the calibration's population energies (the
one-hot matmul and the joint-histogram forms).

    python benchmarks/bench_kernels.py      # GPU only; prints JSON lines
"""
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache"))

PEAK_HBM = 3.35e12   # H100 SXM, NVIDIA data sheet


def wall(fn, iters=20, trials=5):
    """Best-of-trials mean wall time per call, in seconds."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def device_time(fn, reps=10):
    """(device busy seconds per call, kernel launches per call) from a
    profiler trace of ``reps`` calls."""
    import jax
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        path = glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")[0]
        ns, launches = 0.0, 0
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    if "Memcpy" not in ev.name:
                        ns += ev.duration_ns
                        launches += 1
    return ns / reps / 1e9, launches / reps


def row(metric, impl, fn, args, pixels, nbytes):
    """Time ``jit(fn)(*args)``; the arrays travel as arguments, so XLA
    cannot fold them into the program as constants."""
    import jax
    jf = jax.jit(fn)
    w = wall(lambda: jf(*args))
    dev, launches = device_time(lambda: jf(*args))
    rec = {"metric": metric, "impl": impl, "wall_us": round(w * 1e6, 1),
           "device_us": round(dev * 1e6, 1), "launches": launches,
           "mp_per_s": round(pixels / 1e6 / w, 1)}
    if nbytes:
        rec["GB_per_s"] = round(nbytes / dev / 1e9, 1)
        rec["of_peak"] = round(nbytes / dev / PEAK_HBM, 3)
    print(json.dumps(rec), flush=True)


def tables(rng, bits, c):
    import jax.numpy as jnp
    t = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    t[0], t[-1] = 0.0, 1.0
    return (jnp.asarray(t, jnp.float32),
            jnp.asarray(np.gradient(t, 2 / (bits - 1), axis=0), jnp.float32))


def main() -> int:
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        print("bench_kernels: needs a GPU", file=sys.stderr)
        return 2
    from camera_linearity.ops import filters, hdr
    from camera_linearity.ops import linearity as lin
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "device_kind":
                      jax.devices()[0].device_kind}), flush=True)
    rng = np.random.default_rng(0)
    f32 = jnp.float32

    big = jnp.asarray(rng.uniform(0, 1, 256 << 20), f32)
    row("copy_1GiB", "xla", lambda x: x * 1.0001, (big,), 0,
        2 * big.nbytes)

    # config 2: val+std f32 in, val+std f32 out (168 B/px)
    n, h, w, c = 6, 1200, 1920, 3
    v = jnp.asarray(rng.uniform(0.02, 0.98, (n, h, w, c)), f32)
    s = jnp.asarray(rng.uniform(0.001, 0.02, (n, h, w, c)), f32)
    e = jnp.asarray(0.001 * 2.0 ** np.arange(n), f32)
    i256, d256 = tables(rng, 256, c)
    nbytes = (2 * n + 2) * h * w * c * 4
    a2 = (v, s, e, i256, d256)
    row("config2", "kernel", hdr.merge_hdr, a2, h * w, nbytes)
    row("config2", "xla", hdr.merge_stack, a2, h * w, nbytes)
    # 242 rows: what the removed automatic slab rule chose for this stack
    row("config2", "xla_row_chunk_242", lambda *a: hdr.merge_stack(
        *a, row_chunk=242), a2, h * w, nbytes)

    # config 3: + f32 dark frames in, 4096-entry tables, flat epilogue
    i4k, d4k = tables(rng, 4096, c)
    dark = jnp.asarray(rng.uniform(0, 1, (n, h, w, c)) > 0.999, f32)
    fv = jnp.asarray(rng.uniform(0.7, 1.0, (h, w, c)), f32)
    fs = jnp.asarray(rng.uniform(0.001, 0.01, (h, w, c)), f32)
    thr = jnp.asarray(0.5, f32)
    nbytes3 = (3 * n + 4) * h * w * c * 4
    a3 = (v, s, dark, e, i4k, d4k, thr, fv, fs)
    row("config3", "kernel", hdr.merge_corrected, a3, h * w, nbytes3)

    def plain3(v, s, dark, e, i, d, thr, fv, fs):
        rv, rs = jax.vmap(lambda a, b, k: filters.bad_pixel_filter(
            a, b, k, thr, 3))(v, s, dark)
        return filters.flat_field_correction(
            *hdr.merge_stack(rv, rs, e, i, d), fv, fs, 0.05)
    row("config3", "xla", plain3, a3, h * w, nbytes3)
    row("config3_merge_only", "xla", hdr.merge_stack, (v, s, e, i4k, d4k),
        h * w, nbytes)
    # 60 rows: what the removed automatic slab rule chose for this stack
    row("config3_merge_only", "xla_row_chunk_60", lambda *a: hdr.merge_stack(
        *a, row_chunk=60), (v, s, e, i4k, d4k), h * w, nbytes)

    # config 1: uint8 5x512x512x1, no std (5 B/px); and a batch of 32
    n1, h1 = 5, 512
    dn = jnp.asarray(rng.integers(0, 256, (32, n1, h1, h1, 1)), jnp.uint8)
    e1 = jnp.asarray(0.001 * 2.0 ** np.arange(n1), f32)
    i1, d1 = tables(rng, 256, 1)
    b1 = (n1 + 4) * h1 * h1
    a1 = (dn[0], e1, i1, d1)
    row("config1_single", "kernel", lambda q, *t: hdr.merge_hdr(
        q, None, *t)[0], a1, h1 * h1, b1)
    row("config1_single", "xla", lambda q, *t: hdr.merge_stack_u8(
        q, None, *t)[0], a1, h1 * h1, b1)
    a1b = (dn, e1, i1, d1)
    row("config1_batch32", "kernel", lambda q, *t: hdr.merge_batch(
        q, None, *t)[0], a1b, 32 * h1 * h1, 32 * b1)
    row("config1_batch32", "xla", lambda q, *t: jax.vmap(
        lambda x: hdr.merge_stack_u8(x, None, *t)[0])(q), a1b,
        32 * h1 * h1, 32 * b1)

    # config 4: one generation's population energies, 75 candidates on the
    # 2000 px x 6 exposure problem of benchmarks/bench_calibration.py
    sys.path.insert(0, str(REPO / "benchmarks"))
    from bench_calibration import build_problem
    stacks, exposures, mean_icrf, pca = build_problem()
    ii, jj = (jnp.asarray(a) for a in lin.upper_triangle_pairs(6))
    curves = jnp.asarray(mean_icrf[None] + rng.uniform(-0.05, 0.05, (75, 5))
                         @ pca.T, f32)
    ex = jnp.asarray(exposures, f32)
    stack = jnp.asarray(stacks[0])
    onehot = lin.build_data_onehot(stack, 256)
    hists = lin.pair_dn_histograms(stack, ii, jj, 256)
    row("config4_energies", "onehot_matmul",
        lambda c, o, x, i, j: lin.population_linearity_energies(
            c, o, None, x, 5, 250, i, j), (curves, onehot, ex, ii, jj), 0, 0)
    row("config4_energies", "joint_histograms",
        lambda c, hh, x, i, j: lin.population_linearity_energies_hist(
            c, hh, x, 5, 250, i, j), (curves, hists, ex, ii, jj), 0, 0)
    row("config4_histograms", "segment_sum",
        lambda st, i, j: lin.pair_dn_histograms(st, i, j, 256),
        (stack, ii, jj), 0, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device-backend Welford throughput, with and without ICRF linearization.

The one reference pipeline leg with no perf evidence through round 2 was
ICRF-linearized video statistics (reference:
modules/video_processing.py:200-208 — per-frame LUT apply feeding the
Welford update).  This measures three things at 4K:

* the pure device scan rate (staged batch, no decode): fused LUT+Welford
  program vs plain Welford — the kernel-side cost of linearization;
* end-to-end ``welford_algorithm(backend="device")`` on a real video file,
  ICRF on and off — decode + h2d (uint8) + scan;
* the host backend on the same file as the raw-DN reference point.

Usage: python benchmarks/bench_welford.py [--frames N] [--height H]
       [--width W]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def device_scan_rates(height, width, batch=32, iters=8):
    import jax
    import jax.numpy as jnp
    from camera_linearity.ops import welford as wf

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (batch, height, width, 3), np.uint8)
    staged = jnp.asarray(frames)
    icrf = jnp.asarray(
        np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.2, jnp.float32)
    state0 = wf.welford_init((height, width, 3))

    def plain():
        f32 = staged.astype(jnp.float32) / 255.0
        return wf.welford_update_batch(state0, f32)

    def fused():
        return wf.welford_update_batch_lut(state0, staged, icrf, 255)

    out = {}
    for name, fn in (("plain", plain), ("fused_lut", fused)):
        s = fn()
        jax.block_until_ready(s)
        float(jnp.sum(s.mean))  # full sync through the remote transport
        t0 = time.time()
        for _ in range(iters):
            s = fn()
        float(jnp.sum(s.mean))
        dt = (time.time() - t0) / iters
        out[name] = round(batch * height * width / 1e6 / dt, 1)
    return out


def e2e_rates(frames, height, width):
    from camera_linearity.models import video as video_mod
    from bench_video import make_videos

    path = make_videos(frames, height, width, (10,))[0]
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.2
    mp = frames * height * width / 1e6

    runs = {
        "device_raw": dict(ICRF=None, backend="device"),
        "device_icrf": dict(ICRF=icrf, backend="device"),
        "host_raw": dict(ICRF=None, backend="host"),
    }
    out = {}
    for name, kw in runs.items():
        video_mod.welford_algorithm(path, use_std=True, dtype=np.float32,
                                    **kw)  # warm compiles/buffers
        t0 = time.time()
        video_mod.welford_algorithm(path, use_std=True, dtype=np.float32,
                                    **kw)
        out[name] = round(mp / (time.time() - t0), 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--width", type=int, default=3840)
    args = ap.parse_args()

    scan = device_scan_rates(args.height, args.width)
    print(json.dumps({"metric": "welford_device_scan", "unit": "MP/s",
                      **scan}))
    e2e = e2e_rates(args.frames, args.height, args.width)
    print(json.dumps({"metric": "welford_e2e_video", "unit": "MP/s",
                      "frames": args.frames,
                      "resolution": f"{args.width}x{args.height}", **e2e}))


if __name__ == "__main__":
    main()

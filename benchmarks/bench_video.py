"""BASELINE config 5: video -> HDR end-to-end, decode included.

Matches the config's stated shape (1000-frame mean/std stacking per
exposure, 4K frames, batch of 8 scenes) when run with ``--full``; the
default is a scaled run with identical per-frame geometry (4K) so the
steady-state MP/s is representative of the full run (the pipeline is a
stream: decode -> exact host moments -> batched device merge).

Synthetic MJPG exposure videos are generated once per geometry and cached
under .bench_cache/ in the checkout (encoding costs more than decoding, so
the cache matters).  Scenes reuse the same underlying files — decode work, the
dominant cost, is still performed independently per scene, so the measured
end-to-end throughput is honest.

Reference flow being measured: mean/std frame stacking
(/root/reference/modules/video_processing.py:161-219) feeding the HDR merge
(/root/reference/modules/exposure_series.py:317-397), here as
pipeline.batch_video_to_hdr.
"""
import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# one fixed directory inside the checkout (gitignored).
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

CACHE = REPO / ".bench_cache" / "videos"


def make_videos(frames: int, height: int, width: int, exposures_ms):
    """Generate (and cache) one MJPG video per exposure; returns paths."""
    import cv2 as cv
    CACHE.mkdir(parents=True, exist_ok=True)
    key = hashlib.md5(
        f"{frames}x{height}x{width}x{list(exposures_ms)}".encode()
    ).hexdigest()[:10]
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    paths = []
    for ms in exposures_ms:
        path = CACHE / f"{key} scene {ms}ms.avi"
        paths.append(path)
        if path.exists():
            continue
        level = np.clip(base * (ms / max(exposures_ms)) * 230, 0, 255)
        writer = cv.VideoWriter(str(path), cv.VideoWriter_fourcc(*"MJPG"),
                                30, (width, height))
        # Pre-render a pool of distinct noisy frames and cycle it: MJPG is
        # intra-frame, so encode/decode cost per frame is unchanged, while
        # generation stops being RNG-bound (a fresh 4K gaussian field costs
        # more than encoding the frame).
        pool = [np.clip(level + rng.normal(0, 6, (height, width, 3)),
                        0, 255).astype(np.uint8) for _ in range(12)]
        for i in range(frames):
            writer.write(pool[i % len(pool)])
        writer.release()
    return paths


def measure_decode_floor(path: Path, max_frames: int = 200,
                         decoder: str = "cv2") -> float:
    """Pure decode rate (MP/s) of the SELECTED decoder — the host-side
    floor for the pipeline.  ``decoder`` matches the pipeline's flag so
    the floor is measured with the decoder the run actually uses."""
    import cv2 as cv
    geo = None
    if decoder != "cv2":
        from camera_linearity import native
        from camera_linearity.utils import avi
        # mirror BOTH halves of the pipeline's graceful fallback: native
        # decoder unavailable OR the file does not probe as an MJPG AVI
        if native.mjpeg_available():
            geo = avi.probe_mjpg(path)
        if geo is None:
            decoder = "cv2"
    if decoder != "cv2":
        h, w = geo
        dst = np.empty((h, w, 3), np.uint8)
        n = 0
        t0 = time.time()
        for chunk in avi.mjpg_chunks(path):
            native.jpeg_decode_bgr(chunk, dst,
                                   fast=decoder == "turbo_fast")
            n += 1
            if n >= max_frames:
                break
        return n * h * w / 1e6 / (time.time() - t0)
    cap = cv.VideoCapture(str(path))
    h = int(cap.get(cv.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv.CAP_PROP_FRAME_WIDTH))
    n = 0
    t0 = time.time()
    while n < max_frames:
        ret, _ = cap.read()
        if not ret:
            break
        n += 1
    dt = time.time() - t0
    cap.release()
    return n * h * w / 1e6 / dt


def measure_stats_rate(height: int, width: int) -> float:
    """Warm native moment-accumulation rate in MP/s of frame pixels.

    The exact statistics pass and decode run in turn on the host, so the
    pipeline's ceiling is the harmonic combination of the two — reported
    as ``cpu_floor_mps`` next to the decode-only floor."""
    from camera_linearity import native
    batch = np.random.default_rng(0).integers(
        0, 255, (16, height, width, 3), np.uint8)
    s = np.zeros((height, width, 3), np.uint64)
    q = np.zeros((height, width, 3), np.uint64)
    native.accum_moments_u8(batch, s, q)  # warm (page faults, code paths)
    t0 = time.time()
    native.accum_moments_u8(batch, s, q)
    dt = time.time() - t0
    return batch.shape[0] * height * width / 1e6 / dt


def make_calibration_basis(datapoints=256, n_basis=5):
    """DoRF-style PCA basis for the calibration leg (same construction as
    bench_calibration.build_problem, reused so the solver compile caches
    across benches)."""
    x = np.linspace(0, 1, datapoints)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:n_basis].T
    return np.stack([pca] * 3), np.stack([mean_icrf] * 3)


def run(frames: int, scenes: int, height: int, width: int,
        exposures_ms=(5, 10, 20)) -> dict:
    from camera_linearity import native
    from camera_linearity.models import pipeline
    from camera_linearity.utils import observability as obs
    native.tune_host_allocator()

    paths = make_videos(frames, height, width, exposures_ms)
    icrf = (np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.2)

    # BASELINE config 5 says "calibrate + merge": solve the ICRF from the
    # decoded stacks inside the measured region (CL_BENCH_NO_CAL skips the
    # leg for A/B attribution), and upload the scene statistics in the
    # u16-val + f16-std wire encoding — half the f32/f32 bytes, written
    # directly by the fused native finalize (CL_WIRE_VAL / CL_WIRE_STD
    # override; whether it pays on local PCIe is ROADMAP queue 3 item 2).
    wire_std = os.environ.get("CL_WIRE_STD", "f16")
    wire_val = os.environ.get("CL_WIRE_VAL", "u16")
    # bench default: the native libjpeg decoder with the fast DCT/upsample
    # profile, the closest pixel match to the reference decoder's own
    # output (max 4 DN, benchmarks/bench_decode.py); falls back to cv2 with
    # a warning when the native lib can't build (no libjpeg headers)
    decoder = os.environ.get("CL_DECODER", "turbo_fast")
    calibrate = None
    if not os.environ.get("CL_BENCH_NO_CAL"):
        pca, mean_icrf = make_calibration_basis()
        # ~2000 subsampled pixels, the reference's data_spacing ballpark
        spacing = max(1, height * width // 2000)
        calibrate = dict(pca_arrays=pca, mean_icrf_arrays=mean_icrf,
                         spacing=spacing, popsize=15, maxiter=1000,
                         tol=0.01, rng_seed=7)

    # Pay every one-time cost BEFORE the clock: device start, native
    # library build/load, buffer prefault, transfer-path setup, and the
    # exact-shape merge and calibration compiles — the stage breakdown
    # below attributes what IS in the measured region.
    t_att = time.time()
    warm = pipeline.prewarm_batch_video_to_hdr(scenes, len(exposures_ms),
                                               height, width, icrf,
                                               calibrate=calibrate,
                                               wire_val=wire_val,
                                               wire_std=wire_std)
    print(f"[bench_video] prewarm (device start, native build, buffers, "
          f"transfer, merge+calibration compile): {time.time()-t_att:.1f}s",
          file=sys.stderr, flush=True)

    scene_map = {f"scene{i}": paths for i in range(scenes)}
    obs.reset_stage_times()
    t0 = time.time()
    results = pipeline.batch_video_to_hdr(scene_map, icrf,
                                          wire_std=wire_std,
                                          wire_val=wire_val,
                                          calibrate=calibrate,
                                          decoder=decoder)
    # e2e ends with the HDR maps produced, COMPLETE, and device-resident
    # (where any further processing in this framework runs).  Block on the
    # merge outputs themselves; full host materialization is timed
    # separately (d2h_materialize_s).
    import jax
    jax.block_until_ready([s.measurand.val for s in results.values()])
    wall = time.time() - t0
    t1 = time.time()
    total = 0.0
    for s in results.values():
        total += float(np.asarray(s.measurand.val).sum())
    d2h = time.time() - t1

    decoded_frames = frames * len(exposures_ms) * scenes
    mp = decoded_frames * height * width / 1e6
    decode_floor = float(np.mean([measure_decode_floor(p, decoder=decoder)
                                  for p in paths]))
    # the REFERENCE pipeline's own ceiling (cv2.VideoCapture decode) for
    # the beats-the-reference comparison when the native decoder is live
    cv2_floor = decode_floor if decoder == "cv2" else float(
        np.mean([measure_decode_floor(p, 80, "cv2") for p in paths]))
    stats_rate = measure_stats_rate(height, width)
    return {
        "metric": "config5_video_to_hdr_e2e",
        "unit": "MP/s",
        "value": round(mp / wall, 2),
        "wall_s": round(wall, 1),
        "decoded_frames": decoded_frames,
        "scenes": scenes,
        "frames_per_exposure": frames,
        "resolution": f"{width}x{height}",
        # mean over ALL exposure videos: decode rate varies with frame
        # content (brighter frames carry more JPEG detail), and the
        # host's effective CPU rate drifts between runs
        "decode_floor_mps": round(decode_floor, 1),
        # decode and the exact statistics pass run in turn; their harmonic
        # combination is the pipeline's achievable ceiling
        "cpu_floor_mps": round(1.0 / (1.0 / decode_floor + 1.0 / stats_rate),
                               1),
        # the same harmonic floor at the reference's decoder: what any
        # cv2-decode pipeline (the reference included) can reach at best
        # on this host
        "cpu_floor_cv2_mps": round(
            1.0 / (1.0 / cv2_floor + 1.0 / stats_rate), 1),
        "stats_rate_mps": round(stats_rate, 1),
        "h2d_mbps": warm.get("h2d_mbps"),
        "d2h_materialize_s": round(d2h, 1),
        # wire format + calibration leg (BASELINE's "calibrate + merge"):
        # the solve shows up in stages.calibrate_s
        "wire_std": wire_std,
        "wire_val": wire_val,
        # decode_floor_mps above is measured with THIS decoder, so the
        # value/cpu_floor comparison stays apples-to-apples
        "decoder": decoder,
        "calibration_leg": calibrate is not None,
        "checksum": round(total, 2),
        # per-stage busy time (overlapped stages sum to MORE than wall_s;
        # the surplus is work hidden behind decode).  decode_s/stats_s run
        # on the prefetch/main threads, upload_s on the transfer thread;
        # assemble_s is the unhidden upload remainder + device stacking.
        "stages": obs.snapshot_stage_times(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="stated BASELINE size: 1000 frames/exposure, "
                         "4K, 8 scenes")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--width", type=int, default=3840)
    args = ap.parse_args()
    if args.full:
        args.frames, args.scenes = 1000, 8
    print(json.dumps(run(args.frames, args.scenes, args.height, args.width)))


if __name__ == "__main__":
    main()

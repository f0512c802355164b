"""Video statistics walkthrough: Welford stacking -> noise model -> HDR.

Runs everywhere (CPU or GPU).  Generates short synthetic exposure videos
of a static noisy scene, computes exact mean/uncertainty frames with the
streaming Welford/host-moments machinery, builds the sensor noise model
(per-DN std LUT via noise-profile histograms — the reference's
process_STD_data flow, video_processing.py:77-158), and merges the
per-exposure statistics into one uncertainty-tracked HDR radiance map
(pipeline.video_to_hdr).

Usage: python examples/video_pipeline.py [outdir]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np
import jax.numpy as jnp


def make_videos(outdir: Path, exposures_ms=(4, 8, 16), frames: int = 40,
                size=(48, 64), noise: float = 5.0, seed: int = 0):
    import cv2 as cv
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = size
    base = rng.uniform(0.1, 0.7, (h, w, 3))
    paths = []
    for ms in exposures_ms:
        p = outdir / f"scene {ms}ms.avi"
        paths.append(p)
        writer = cv.VideoWriter(str(p), cv.VideoWriter_fourcc(*"FFV1"), 10,
                                (w, h))
        level = np.clip(base * (ms / max(exposures_ms)), 0, 1) * 255
        for _ in range(frames):
            frame = np.clip(level + rng.normal(0, noise, (h, w, 3)), 0, 255)
            writer.write(np.around(frame).astype(np.uint8))
        writer.release()
    import cv2 as cv2chk
    cap = cv2chk.VideoCapture(str(paths[0]))
    ok, _ = cap.read()
    cap.release()
    if not ok:
        raise SystemExit("no usable lossless codec in this OpenCV build")
    return paths


def main():
    outdir = Path(sys.argv[1]) if len(sys.argv) > 1 \
        else Path("/tmp/clt_video_demo")
    from camera_linearity.models import pipeline, video as video_mod

    paths = make_videos(outdir)

    # --- 1. streaming statistics of one video --------------------------
    stats = video_mod.welford_algorithm(paths[-1], None, use_std=True,
                                        dtype=np.float32)
    print(f"welford: mean {stats['mean'].shape} "
          f"std-of-mean {stats['std'].shape} "
          f"(exact over {40} frames)")

    # --- 2. sensor noise model from the frame stream -------------------
    profiles, _ = video_mod.compute_noise_profiles([paths[-1]])
    counts = int(np.asarray(profiles).sum())
    std_lut = np.stack([
        np.asarray(video_mod.calculate_std(np.asarray(profiles[..., c])))
        for c in range(3)], axis=1)
    print(f"noise profiles: {counts} samples -> per-DN std LUT "
          f"{std_lut.shape}, peak std {std_lut.max():.4f} DN-scale")

    # --- 3. exposure videos -> uncertainty-tracked HDR -----------------
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)  # identity camera
    hdr = pipeline.video_to_hdr(paths, jnp.asarray(icrf))
    val = np.asarray(hdr.measurand.val)
    std = np.asarray(hdr.measurand.std)
    print(f"HDR from video: val {val.shape}, median rel-uncertainty "
          f"{np.median(std / np.maximum(val, 1e-9)):.4f}")
    hdr.save_64bit(outdir / "video_hdr.tif")
    print(f"done — artifacts in {outdir}")


if __name__ == "__main__":
    main()

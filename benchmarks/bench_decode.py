"""Decode-path shootout for the video pipeline's host-side floor.

Compares, on one cached bench video (same files bench_video.py uses):

  * ``videocapture`` — cv2.VideoCapture grab/retrieve (FFmpeg mjpeg decode
    + separate YUV->BGR pass; the reference's decoder and round-1..4
    pipeline path, modules/general_functions.py:226-251)
  * ``imdecode``     — cv2.imdecode on raw AVI JPEG chunks (bundled
    libjpeg-turbo, merged upsample+convert)
  * ``turbo``        — native libjpeg decoder (native/mjpeg.cpp), ISLOW
  * ``turbo_fast``   — same with JDCT_IFAST + plain chroma upsampling

and reports MP/s plus pixel deltas vs the videocapture output (mean |d|
and max |d| in DN), which is the qualification table for the pipeline's
``decoder="turbo"`` flag.  Decode accuracy context: MJPG itself quantizes
away ~+-2 DN of the original frame, so decoder deltas of that order are
codec-level noise, not bias — the bias row (mean signed delta) is what
must stay ~0 for statistics to be unaffected.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def run(frames: int = 60) -> dict:
    import cv2 as cv
    from camera_linearity import native
    from camera_linearity.utils import avi
    from bench_video import make_videos

    paths = make_videos(100, 2160, 3840, (5, 10, 20))
    path = paths[1]  # mid-exposure: representative JPEG detail level
    geom = avi.probe_mjpg(path)
    assert geom is not None, f"{path} is not an MJPG AVI"
    h, w = geom
    mp = frames * h * w / 1e6

    chunks = []
    for payload in avi.mjpg_chunks(path):
        chunks.append(payload)
        if len(chunks) >= frames:
            break

    out = {"resolution": f"{w}x{h}", "frames": frames}
    dst = np.empty((h, w, 3), np.uint8)

    # -- videocapture (reference path) --------------------------------
    cap = cv.VideoCapture(str(path))
    ref_first = None
    n = 0
    t0 = time.time()
    while n < frames:
        ok = cap.grab()
        if not ok:
            break
        ok, frame = cap.retrieve(dst)
        if not ok:
            break
        if n == 0:
            ref_first = np.array(frame if frame is not dst else dst)
        n += 1
    out["videocapture_mps"] = round(mp / (time.time() - t0), 1)
    cap.release()

    # -- imdecode (no dst= overload in this cv2 build: fresh output
    # allocation per frame is part of what this path costs) -------------
    t0 = time.time()
    for payload in chunks:
        buf = np.frombuffer(payload, np.uint8)
        cv.imdecode(buf, cv.IMREAD_COLOR)
    out["imdecode_mps"] = round(mp / (time.time() - t0), 1)
    imdecode_first = cv.imdecode(np.frombuffer(chunks[0], np.uint8),
                                 cv.IMREAD_COLOR)

    # -- native turbo (ISLOW, then IFAST) ------------------------------
    if native.mjpeg_available():
        for name, fast in (("turbo", False), ("turbo_fast", True)):
            t0 = time.time()
            for payload in chunks:
                native.jpeg_decode_bgr(payload, dst, fast=fast)
            out[f"{name}_mps"] = round(mp / (time.time() - t0), 1)
            native.jpeg_decode_bgr(chunks[0], dst, fast=fast)
            d = dst.astype(np.int16) - ref_first.astype(np.int16)
            out[f"{name}_vs_ref_mean_abs_dn"] = round(
                float(np.abs(d).mean()), 4)
            out[f"{name}_vs_ref_bias_dn"] = round(float(d.mean()), 5)
            out[f"{name}_vs_ref_max_abs_dn"] = int(np.abs(d).max())
    else:
        out["turbo"] = "unavailable"

    d = imdecode_first.astype(np.int16) - ref_first.astype(np.int16)
    out["imdecode_vs_ref_mean_abs_dn"] = round(float(np.abs(d).mean()), 4)
    out["imdecode_vs_ref_bias_dn"] = round(float(d.mean()), 5)
    out["imdecode_vs_ref_max_abs_dn"] = int(np.abs(d).max())
    return out


if __name__ == "__main__":
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    print(json.dumps(run(frames), indent=1))

"""Native MJPEG decode path: AVI chunk walker, libjpeg decoder, pipeline
integration (models/video.py decoder=..., native/mjpeg.cpp, utils/avi.py).

Decoder-accuracy context: MJPG quantizes away ~+-2 DN of the original
frame, so small per-pixel deltas BETWEEN decoders (different IDCT/upsample
implementations) are codec-level noise; the statistics tests bound the
decoder-induced error on the pipeline's outputs instead of demanding
bit-parity with cv2.
"""
import numpy as np
import pytest

cv = pytest.importorskip("cv2")

from camera_linearity import native
from camera_linearity.config import CameraConfig
from camera_linearity.models import video as video_mod
from camera_linearity.utils import avi


@pytest.fixture(scope="module")
def mjpg_avi(tmp_path_factory):
    """A small MJPG AVI plus the exact frames fed to the encoder.

    Frames are smooth (gradient + blurred noise), like real camera
    content: pure random noise maximizes chroma-subsampling edges, where
    different decoders' upsample filters legitimately diverge by tens of
    DN — that measures the fixture, not the decoder."""
    import cv2
    rng = np.random.default_rng(11)
    h, w, n = 48, 64, 9
    base = np.linspace(40.0, 215.0, w, dtype=np.float32)[None, :, None]
    frames = np.stack([
        np.clip(base + cv2.GaussianBlur(
            rng.normal(0, 40, (h, w, 3)).astype(np.float32), (0, 0), 2.5),
            0, 255).astype(np.uint8)
        for _ in range(n)])
    path = tmp_path_factory.mktemp("avi") / "scene 5ms.avi"
    writer = cv.VideoWriter(str(path), cv.VideoWriter_fourcc(*"MJPG"),
                            30, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    return path, frames


def _cv2_frames(path):
    cap = cv.VideoCapture(str(path))
    out = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


class TestAviWalker:
    def test_probe_geometry(self, mjpg_avi):
        path, frames = mjpg_avi
        assert avi.probe_mjpg(path) == frames.shape[1:3]

    def test_probe_rejects_non_avi(self, tmp_path):
        p = tmp_path / "not_an.avi"
        p.write_bytes(b"\x89PNG\r\n" + b"\x00" * 64)
        assert avi.probe_mjpg(p) is None
        assert avi.probe_mjpg(tmp_path / "missing.avi") is None

    def test_jpeg_geometry_tolerates_fill_bytes(self, mjpg_avi):
        """JPEG permits any number of 0xFF fill bytes before a marker
        (some hardware MJPG encoders pad with them); the geometry walk
        must skip them instead of derailing and rejecting the frame."""
        path, frames = mjpg_avi
        first = next(iter(avi.mjpg_chunks(path)))
        geo = frames.shape[1:3]
        assert avi._jpeg_geometry(first) == geo
        padded = first[:2] + b"\xff\xff\xff" + first[2:]
        assert avi._jpeg_geometry(padded) == geo

    def test_chunk_count_and_jpeg_payloads(self, mjpg_avi):
        path, frames = mjpg_avi
        chunks = list(avi.mjpg_chunks(path))
        assert len(chunks) == len(frames)
        for c in chunks:
            assert c[:2] == b"\xff\xd8"  # SOI
            assert c.rstrip(b"\x00")[-2:] == b"\xff\xd9"  # EOI (pre-pad)

    def test_chunks_decode_to_the_stream_frames(self, mjpg_avi):
        """Each chunk IS the corresponding stream frame: cv2.imdecode of
        chunk k must match cv2.VideoCapture's frame k within decoder
        noise (FFmpeg's mjpeg IDCT/upsample vs bundled libjpeg-turbo's
        differ by a few DN on smooth content) and with no bias."""
        path, frames = mjpg_avi
        ref = _cv2_frames(path)
        for k, chunk in enumerate(avi.mjpg_chunks(path)):
            img = cv.imdecode(np.frombuffer(chunk, np.uint8),
                              cv.IMREAD_COLOR)
            d = img.astype(np.int16) - ref[k].astype(np.int16)
            assert np.abs(d).max() <= 8
            # vs the PRE-ENCODE originals (ground truth), the chunk
            # decode must be at least as faithful as the stream decode
            d_chunk = img.astype(np.float64) - frames[k]
            d_ref = ref[k].astype(np.float64) - frames[k]
            assert abs(d_chunk.mean()) <= abs(d_ref.mean()) + 0.25

    def test_truncated_file_stops_cleanly(self, mjpg_avi, tmp_path):
        """Truncation at any point reads cleanly (no raise, no overread);
        some cut point must land mid-stream (a genuinely partial list) —
        where depends on how cv2 sized its header/index padding."""
        path, frames = mjpg_avi
        data = path.read_bytes()
        cut = tmp_path / "cut.avi"
        partial = False
        for frac in (0.95, 0.85, 0.7, 0.55, 0.4):
            cut.write_bytes(data[: int(len(data) * frac)])
            k = len(list(avi.mjpg_chunks(cut)))
            assert k <= len(frames)
            partial = partial or 0 < k < len(frames)
        assert partial


needs_turbo = pytest.mark.skipif(not native.mjpeg_available(),
                                 reason="native MJPEG decoder unavailable")


@needs_turbo
class TestNativeDecoder:
    def test_decode_matches_cv2(self, mjpg_avi):
        path, frames = mjpg_avi
        ref = _cv2_frames(path)
        dst = np.empty(ref.shape[1:], np.uint8)
        for k, chunk in enumerate(avi.mjpg_chunks(path)):
            native.jpeg_decode_bgr(chunk, dst)
            d = dst.astype(np.int16) - ref[k].astype(np.int16)
            # different IDCT/upsample implementations: codec-noise-level
            # deltas vs cv2 allowed; vs the pre-encode ORIGINALS the
            # native decode must be at least as unbiased as cv2's
            # (measured: turbo -0.38 DN vs cv2 -0.98 DN on this content)
            assert np.abs(d).max() <= 8
            d_turbo = dst.astype(np.float64) - frames[k]
            d_cv2 = ref[k].astype(np.float64) - frames[k]
            assert abs(d_turbo.mean()) <= abs(d_cv2.mean()) + 0.25

    def test_fast_dct_stays_within_codec_noise(self, mjpg_avi):
        path, _ = mjpg_avi
        ref = _cv2_frames(path)
        dst = np.empty(ref.shape[1:], np.uint8)
        chunk = next(iter(avi.mjpg_chunks(path)))
        native.jpeg_decode_bgr(chunk, dst, fast=True)
        d = dst.astype(np.int16) - ref[0].astype(np.int16)
        assert np.abs(d).max() <= 6
        assert abs(d.mean()) < 0.25

    def test_geometry_mismatch_raises(self, mjpg_avi):
        path, _ = mjpg_avi
        chunk = next(iter(avi.mjpg_chunks(path)))
        dst = np.empty((8, 8, 3), np.uint8)
        with pytest.raises(ValueError, match="geometry"):
            native.jpeg_decode_bgr(chunk, dst)

    def test_malformed_data_raises(self):
        dst = np.empty((8, 8, 3), np.uint8)
        with pytest.raises(ValueError):
            native.jpeg_decode_bgr(b"\xff\xd8 this is not a jpeg", dst)

    def test_dst_validation(self, mjpg_avi):
        path, _ = mjpg_avi
        chunk = next(iter(avi.mjpg_chunks(path)))
        with pytest.raises(ValueError, match="uint8"):
            native.jpeg_decode_bgr(chunk, np.empty((48, 64, 3), np.float32))
        with pytest.raises(ValueError, match="uint8"):
            native.jpeg_decode_bgr(
                chunk, np.empty((48, 128, 3), np.uint8)[:, ::2])


class TestPipelineIntegration:
    def test_resolve_decoder_fallback_on_non_mjpg(self, tmp_path, caplog):
        p = tmp_path / "x.avi"
        p.write_bytes(b"RIFF\x00\x00\x00\x00WAVE")
        import logging
        # the package logger is non-propagating (own stderr handler), so
        # attach caplog's capture handler to it directly
        log = logging.getLogger("camera_linearity")
        log.addHandler(caplog.handler)
        try:
            dec = video_mod._resolve_decoder("turbo", [p], 48, 64)
        finally:
            log.removeHandler(caplog.handler)
        assert dec == "cv2"
        assert any("falling back" in r.message for r in caplog.records)

    def test_resolve_decoder_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown decoder"):
            video_mod._resolve_decoder("ffmpeg", [], 1, 1)

    def test_bench_decode_floor_falls_back_on_non_mjpg(self, tmp_path):
        """benchmarks/bench_video.measure_decode_floor must mirror BOTH
        halves of the pipeline's fallback (native lib unavailable OR the
        file does not probe as MJPG) instead of unpacking probe_mjpg's
        None — a bench run on a non-MJPG video used to crash AFTER the
        measured pipeline had completed, losing the artifact."""
        import sys
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).parents[2] / "benchmarks"))
        import bench_video
        rng = np.random.default_rng(0)
        p = tmp_path / "scene 5ms.avi"
        w = cv.VideoWriter(str(p), cv.VideoWriter_fourcc(*"FFV1"), 10,
                           (32, 24))
        if not w.isOpened():
            pytest.skip("no lossless codec available")
        for _ in range(4):
            w.write(rng.integers(0, 255, (24, 32, 3)).astype(np.uint8))
        w.release()
        assert avi.probe_mjpg(p) is None  # precondition: probe rejects it
        rate = bench_video.measure_decode_floor(p, max_frames=4,
                                                decoder="turbo_fast")
        assert rate > 0  # measured via the cv2 fallback, no crash

    def test_resolve_decoder_env_default(self, monkeypatch, mjpg_avi):
        path, _ = mjpg_avi
        monkeypatch.delenv("CL_DECODER", raising=False)
        assert video_mod._resolve_decoder("auto", [path], 48, 64) == "cv2"

    @needs_turbo
    def test_welford_turbo_matches_cv2_stats(self, mjpg_avi):
        """Pipeline statistics through the turbo decoder agree with the
        cv2 path to decoder-noise level: the mean frame within ~1 DN,
        std-of-mean within the std's own scale."""
        path, _ = mjpg_avi
        cfg = CameraConfig(num_of_chs=3)
        ref = video_mod.welford_algorithm(path, None, use_std=True,
                                          config=cfg, backend="host",
                                          decoder="cv2")
        got = video_mod.welford_algorithm(path, None, use_std=True,
                                          config=cfg, backend="host",
                                          decoder="turbo")
        assert np.abs(got["mean"] - ref["mean"]).max() <= 2.5 / 255
        assert np.abs(got["std"] - ref["std"]).max() <= 2.5 / 255

    @needs_turbo
    def test_welford_turbo_exact_against_own_decode(self, mjpg_avi):
        """The turbo path's statistics are exactly the moments of the
        frames the native decoder produces (the oracle decodes the same
        chunks through the same decoder)."""
        path, _ = mjpg_avi
        cfg = CameraConfig(num_of_chs=3)
        got = video_mod.welford_algorithm(path, None, use_std=True,
                                          config=cfg, backend="host",
                                          decoder="turbo")
        dst = np.empty((48, 64, 3), np.uint8)
        decoded = []
        for chunk in avi.mjpg_chunks(path):
            native.jpeg_decode_bgr(chunk, dst)
            decoded.append(dst.astype(np.float64) / 255.0)
        decoded = np.stack(decoded)
        n = decoded.shape[0]
        mean = decoded.mean(0)
        std = decoded.std(0, ddof=1) / np.sqrt(n)
        np.testing.assert_allclose(got["mean"], mean, atol=1e-12)
        np.testing.assert_allclose(got["std"], std, atol=1e-12)

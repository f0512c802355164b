"""Video pipeline tests: Welford parity, noise profiles, STD extraction."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models import video
from camera_linearity.ops import welford as wf


def numpy_welford(frames):
    """Oracle: reference video_processing.py:188-215 update order."""
    mean = np.zeros(frames.shape[1:])
    m2 = np.zeros(frames.shape[1:])
    n = 0
    for f in frames:
        n += 1
        delta = f - mean
        mean = mean + delta / n
        m2 = m2 + delta * (f - mean)
    std = np.sqrt(m2 / (n - 1)) / np.sqrt(n)
    return mean, std


def test_welford_matches_oracle(rng):
    frames = rng.uniform(0, 1, (40, 8, 9, 3))
    state = wf.welford_init((8, 9, 3), dtype=jnp.float64)
    for start in range(0, 40, 16):
        state = wf.welford_update_batch(
            state, jnp.asarray(frames[start:start + 16]))
    mean, std = wf.welford_finalize(state)
    omean, ostd = numpy_welford(frames)
    np.testing.assert_allclose(np.asarray(mean), omean, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(std), ostd, rtol=1e-12,
                               atol=1e-14)
    assert int(state.count) == 40


def _write_video(path, frames_u8, fps=10):
    import cv2 as cv
    h, w = frames_u8.shape[1:3]
    writer = cv.VideoWriter(str(path),
                            cv.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    if not writer.isOpened():  # FFV1 (lossless) unavailable -> raw fallback
        writer = cv.VideoWriter(str(path),
                                cv.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in frames_u8:
        writer.write(f)
    writer.release()


@pytest.fixture
def avi(tmp_path, rng):
    frames = rng.integers(60, 200, (24, 32, 48, 3), dtype=np.uint8)
    path = tmp_path / "test 5ms.avi"
    _write_video(path, frames)
    import cv2 as cv
    cap = cv.VideoCapture(str(path))
    decoded = []
    while True:
        ret, f = cap.read()
        if not ret:
            break
        decoded.append(f)
    cap.release()
    if not decoded:
        pytest.skip("no usable video codec in this OpenCV build")
    return path, np.stack(decoded)


def test_welford_algorithm_on_file(avi):
    path, decoded = avi
    out = video.welford_algorithm(path, use_std=True, quantize=False)
    omean, ostd = numpy_welford(decoded.astype(np.float64) / 255)
    np.testing.assert_allclose(out["mean"], omean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["std"], ostd, rtol=1e-3, atol=1e-6)


def test_welford_algorithm_quantized(avi):
    path, decoded = avi
    out = video.welford_algorithm(path, use_std=False, quantize=True)
    omean, _ = numpy_welford(decoded.astype(np.float64) / 255)
    expect = np.around(omean * 255).astype(np.uint8)
    # f32 accumulation may flip borderline roundings by one DN
    diff = np.abs(out["mean"].astype(int) - expect.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.05


def test_welford_with_icrf_linearization(avi):
    path, decoded = avi
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.0
    out = video.welford_algorithm(path, ICRF=jnp.asarray(icrf),
                                  use_std=False, quantize=False)
    lin_frames = icrf[decoded.astype(int), np.arange(3)]
    omean, _ = numpy_welford(lin_frames)
    np.testing.assert_allclose(out["mean"], omean, rtol=1e-5, atol=1e-6)


def test_compute_noise_profiles(avi):
    path, decoded = avi
    profiles, mean_frame = video.compute_noise_profiles([path])
    assert profiles.shape == (256, 256, 3)
    # oracle: np.add.at over the same mean frame
    expect = np.zeros((256, 256, 3), int)
    for f in decoded:
        for c in range(3):
            np.add.at(expect[:, :, c],
                      (mean_frame[..., c].ravel().astype(int),
                       f[..., c].ravel().astype(int)), 1)
    np.testing.assert_array_equal(profiles, expect)
    # every pixel-frame observation lands somewhere
    assert profiles.sum() == decoded.shape[0] * np.prod(decoded.shape[1:])


def test_calculate_std_oracle(rng):
    cfg = CameraConfig()
    table = rng.integers(0, 50, (256, 256)).astype(float)
    out = np.asarray(video.calculate_std(jnp.asarray(table), cfg))
    import math
    for i in [0, 17, 255]:
        edges = np.linspace(0, 1, 256)
        hist = table[i]
        nz = np.nonzero(hist)
        h, e = hist[nz], edges[nz]
        mean = np.sum(h * e) / h.sum()
        std = math.sqrt(np.sum((e - mean) ** 2 * h) / h.sum())
        np.testing.assert_allclose(out[i], std, rtol=1e-6)


def test_clean_data_edges_properties():
    cfg = CameraConfig()
    # A strictly unimodal distribution centered on its row index passes
    # through the cleaning untouched (every smoothing condition is false).
    arr = np.zeros((256, 256), int)
    i = 128
    width = 10
    for k in range(-width, width + 1):
        arr[i, i + k] = 100 - abs(k) * 5
    cleaned = video.clean_data_edges(arr.copy(), cfg)
    np.testing.assert_array_equal(cleaned[i], arr[i])

    # A dip inside an otherwise unimodal row gets smoothed upward.
    arr2 = arr.copy()
    arr2[i, i - 3] = 1  # dip
    cleaned2 = video.clean_data_edges(arr2.copy(), cfg)
    assert cleaned2[i, i - 3] > 1
    # double-zero run toward the edge zeroes the tail
    arr3 = arr.copy()
    arr3[i, i - 5] = 0
    arr3[i, i - 6] = 0
    cleaned3 = video.clean_data_edges(arr3.copy(), cfg)
    assert np.all(cleaned3[i, :i - 5] == 0)


def test_process_video_writes_tifs(avi, tmp_path):
    path, _ = avi
    video.process_video(path, use_std=True)
    assert path.parent.joinpath(path.name.replace(".avi", ".mean.tif")
                                ).exists()
    assert path.parent.joinpath(path.name.replace(".avi", ".std.tif")
                                ).exists()


def test_process_std_data(tmp_path, rng):
    cfg = CameraConfig(
        data_path=str(tmp_path), std_file_name="std.txt",
        mean_data_files=("m_b.txt", "m_g.txt", "m_r.txt"))
    for name in cfg.mean_data_files:
        np.savetxt(tmp_path / name, rng.integers(0, 40, (256, 256)))
    out = video.process_STD_data(cfg)
    assert out.shape == (256, 3)
    assert (tmp_path / "std.txt").exists()
    assert np.all(out >= 0)


def test_welford_default_returns_float(avi):
    """The default (quantize=False) returns float arrays — docstring,
    signature and behavior agree."""
    path, decoded = avi
    out = video.welford_algorithm(path, use_std=True)
    assert out["mean"].dtype != np.uint8
    assert out["std"].dtype != np.uint8
    omean, ostd = numpy_welford(decoded.astype(np.float64) / 255)
    np.testing.assert_allclose(out["mean"], omean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["std"], ostd, rtol=1e-3, atol=1e-6)


def test_welford_backends_agree(avi):
    """host (exact integer moments) and device (f32/f64 scan) backends
    produce the same statistics; 'auto' without an ICRF takes the host
    path, whose output matches the f64 oracle exactly."""
    path, decoded = avi
    host = video.welford_algorithm(path, use_std=True, backend="host")
    dev = video.welford_algorithm(path, use_std=True, backend="device")
    np.testing.assert_allclose(host["mean"], dev["mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(host["std"], dev["std"], rtol=1e-3,
                               atol=1e-6)
    omean, ostd = numpy_welford(decoded.astype(np.float64) / 255)
    np.testing.assert_allclose(host["mean"], omean, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(host["std"], ostd, rtol=1e-12, atol=1e-15)


def test_welford_host_backend_rejects_icrf(avi):
    path, _ = avi
    icrf = jnp.asarray(np.linspace(0, 1, 256)[:, None].repeat(3, 1))
    with pytest.raises(ValueError, match="host"):
        video.welford_algorithm(path, ICRF=icrf, backend="host")
    with pytest.raises(ValueError, match="backend"):
        video.welford_algorithm(path, backend="gpu")


def test_prefetch_order_and_errors():
    items = [np.full((2, 2), i) for i in range(20)]
    out = list(video._prefetch(iter(items), depth=2))
    assert len(out) == 20
    for i, arr in enumerate(out):
        np.testing.assert_array_equal(arr, items[i])

    def boom():
        yield items[0]
        raise RuntimeError("decode failed")

    gen = video._prefetch(boom(), depth=2)
    next(gen)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(gen)


def test_welford_out_param_both_backends(avi):
    """out= writes the statistics into caller-provided stack slices on
    both backends (the videos_to_stacks fast path)."""
    path, decoded = avi
    h, w, c = decoded.shape[1:]
    ref = video.welford_algorithm(path, use_std=True, backend="host",
                                  dtype=np.float32)
    for backend in ("host", "device"):
        stack_v = np.zeros((2, h, w, c), np.float32)
        stack_s = np.zeros((2, h, w, c), np.float32)
        out = video.welford_algorithm(path, use_std=True, backend=backend,
                                      dtype=np.float32,
                                      out=(stack_v[1], stack_s[1]))
        assert out["mean"].base is stack_v
        assert not stack_v[0].any()
        rtol = 0 if backend == "host" else 1e-5
        np.testing.assert_allclose(stack_v[1], ref["mean"], rtol=rtol,
                                   atol=1e-6)
        np.testing.assert_allclose(stack_s[1], ref["std"], rtol=rtol,
                                   atol=1e-6)


def test_frame_batches_into_pool_contract():
    """The decode pool must be declared large enough for the prefetch depth
    it will be wrapped with — enforced at wiring time, before any decode."""
    pool = [np.empty((4, 8, 8, 3), np.uint8) for _ in range(3)]
    with pytest.raises(ValueError, match="prefetch"):
        next(video._frame_batches_into([], 4, pool, prefetch_depth=2))
    # len(pool) > depth + 1 is fine (and an empty file list yields nothing)
    assert list(video._frame_batches_into([], 4, pool,
                                          prefetch_depth=1)) == []


def _write_short_video(path, frames_u8):
    import cv2 as cv
    h, w = frames_u8.shape[1:3]
    writer = cv.VideoWriter(str(path), cv.VideoWriter_fourcc(*"FFV1"), 10,
                            (w, h))
    for f in frames_u8:
        writer.write(f)
    writer.release()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_welford_single_frame_std_zero_filled(tmp_path, rng, backend):
    """<2 frames: no std exists — a caller-provided out slice must be
    zeroed, never left as np.empty garbage flowing into a merge."""
    frames = rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8)
    path = tmp_path / "one 5ms.avi"
    _write_short_video(path, frames)
    import cv2 as cv
    cap = cv.VideoCapture(str(path))
    ok, _ = cap.read()
    cap.release()
    if not ok:
        pytest.skip("no usable video codec in this OpenCV build")
    mean_out = np.full((16, 16, 3), np.nan, np.float32)
    std_out = np.full((16, 16, 3), np.nan, np.float32)
    ret = video.welford_algorithm(path, use_std=True, backend=backend,
                                  dtype=np.float32,
                                  out=(mean_out, std_out))
    assert ret["std"] is None
    assert np.isfinite(mean_out).all()
    np.testing.assert_array_equal(std_out, 0.0)

"""Native staging library: build, parity with NumPy, and fallback paths."""
import numpy as np
import pytest

from camera_linearity import native


def test_native_builds_and_loads():
    # g++ is part of the supported toolchain; if truly absent the NumPy
    # fallbacks below still pass.
    assert native.available() in (True, False)


def test_u8_to_f32_parity(rng):
    arr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    out = native.u8_to_f32(arr, 1.0 / 255)
    # semantic is multiply-by-scale (not divide): compare bit-exact to that
    np.testing.assert_array_equal(
        out, arr.astype(np.float32) * np.float32(1.0 / 255))
    assert out.dtype == np.float32


def test_cfirst_relayout_parity(rng):
    arr = rng.integers(0, 256, (17, 29, 3), dtype=np.uint8)
    out = native.u8_hwc_to_cfirst_f32(arr, 1.0 / 255)
    expect = (arr.reshape(-1, 3).astype(np.float32)
              * np.float32(1.0 / 255)).T
    np.testing.assert_array_equal(out, np.ascontiguousarray(expect))
    assert out.shape == (3, 17 * 29)


def test_host_welford_matches_reference_loop(rng):
    frames = rng.integers(0, 256, (25, 11, 13, 3), dtype=np.uint8)
    acc = native.HostWelford((11, 13, 3), scale=1.0 / 255)
    acc.update(frames[:16])
    acc.update(frames[16:])
    mean, std = acc.finalize()

    # float64 oracle with reference operation order
    omean = np.zeros((11, 13, 3))
    om2 = np.zeros((11, 13, 3))
    for k, f in enumerate(frames, start=1):
        x = f.astype(np.float64) / 255
        delta = x - omean
        omean += delta / k
        om2 += delta * (x - omean)
    ostd = np.sqrt(om2 / (len(frames) - 1)) / np.sqrt(len(frames))
    np.testing.assert_allclose(mean, omean, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(std, ostd, rtol=1e-12, atol=1e-15)
    assert acc.count == 25


def test_host_welford_single_frame_shape(rng):
    acc = native.HostWelford((4, 4, 3), scale=1.0)
    acc.update(rng.integers(0, 2, (4, 4, 3), dtype=np.uint8))
    mean, std = acc.finalize()
    assert std is None  # < 2 frames


def test_numpy_fallback_paths(rng, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)  # force fallback
    arr = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    np.testing.assert_allclose(native.u8_to_f32(arr, 0.5),
                               arr.astype(np.float32) * 0.5)
    out = native.u8_hwc_to_cfirst_f32(arr, 1.0)
    assert out.shape == (3, 72)
    mean = np.zeros(arr.shape)
    m2 = np.zeros(arr.shape)
    count = native.welford_update_batch_u8(arr[None], mean, m2, 1.0, 0)
    assert count == 1
    np.testing.assert_allclose(mean, arr.astype(float))


def test_host_moments_exact_vs_oracle(rng):
    """Integer-moment accumulation equals the f64 Welford oracle to machine
    epsilon (it is exact integer math until finalization)."""
    frames = rng.integers(0, 256, (150, 9, 14, 3), dtype=np.uint8)
    acc = native.HostMoments((9, 14, 3), scale=1.0 / 255)
    acc.update(frames[:70])   # exercises the 64-frame sub-batch split
    acc.update(frames[70:])
    mean, std = acc.finalize()

    x = frames.astype(np.float64) / 255
    omean = x.mean(axis=0)
    ostd = x.std(axis=0, ddof=1) / np.sqrt(len(frames))
    np.testing.assert_allclose(mean, omean, rtol=1e-14, atol=1e-16)
    np.testing.assert_allclose(std, ostd, rtol=1e-12, atol=1e-16)
    assert acc.count == 150


def test_host_moments_single_frame(rng):
    acc = native.HostMoments((4, 5, 3), scale=1.0)
    acc.update(rng.integers(0, 256, (4, 5, 3), dtype=np.uint8))
    mean, std = acc.finalize()
    assert std is None
    assert mean.shape == (4, 5, 3)


def test_accum_moments_numpy_fallback(rng, monkeypatch):
    frames = rng.integers(0, 256, (67, 6, 7, 3), dtype=np.uint8)
    s_native = np.zeros((6, 7, 3), np.uint64)
    q_native = np.zeros((6, 7, 3), np.uint64)
    native.accum_moments_u8(frames, s_native, q_native)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    s_np = np.zeros((6, 7, 3), np.uint64)
    q_np = np.zeros((6, 7, 3), np.uint64)
    native.accum_moments_u8(frames, s_np, q_np)

    # integer accumulation: both paths are bit-identical
    np.testing.assert_array_equal(s_native, s_np)
    np.testing.assert_array_equal(q_native, q_np)
    flat = frames.reshape(67, -1).astype(np.uint64)
    np.testing.assert_array_equal(s_np.reshape(-1), flat.sum(0))
    np.testing.assert_array_equal(q_np.reshape(-1), (flat * flat).sum(0))


def test_host_moments_finalize_dtype_and_out(rng, monkeypatch):
    """f32 finalize == f64 finalize narrowed; out= slices receive identical
    results; the NumPy fallback matches the native pass bit-for-bit."""
    frames = rng.integers(0, 256, (40, 8, 11, 3), dtype=np.uint8)
    acc = native.HostMoments((8, 11, 3), scale=1.0 / 255)
    acc.update(frames)

    mean64, std64 = acc.finalize()
    mean32, std32 = acc.finalize(dtype=np.float32)
    np.testing.assert_array_equal(mean32, mean64.astype(np.float32))
    np.testing.assert_array_equal(std32, std64.astype(np.float32))

    stack_v = np.zeros((2, 8, 11, 3), np.float32)
    stack_s = np.zeros((2, 8, 11, 3), np.float32)
    mv, ms = acc.finalize(dtype=np.float32, out=(stack_v[1], stack_s[1]))
    assert mv.base is stack_v and ms.base is stack_s
    np.testing.assert_array_equal(stack_v[1], mean32)
    np.testing.assert_array_equal(stack_s[1], std32)
    assert not stack_v[0].any()

    with np.testing.assert_raises(ValueError):
        acc.finalize(dtype=np.float32, out=(np.zeros((8, 11, 3)),
                                            np.zeros((8, 11, 3))))

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    mean_np, std_np = acc.finalize()
    np.testing.assert_array_equal(mean_np, mean64)
    np.testing.assert_array_equal(std_np, std64)
    out_v = np.empty((8, 11, 3), np.float32)
    out_s = np.empty((8, 11, 3), np.float32)
    native.HostMoments.finalize(acc, dtype=np.float32, out=(out_v, out_s))
    np.testing.assert_array_equal(out_v, mean32)
    np.testing.assert_array_equal(out_s, std32)


def test_host_moments_finalize_out_shape_mismatch(rng):
    """A smaller out= array must raise, not become an out-of-bounds write
    through the native pass's raw pointers."""
    frames = rng.integers(0, 256, (4, 6, 8, 3), dtype=np.uint8)
    acc = native.HostMoments((6, 8, 3), scale=1.0 / 255)
    acc.update(frames)
    small = np.empty((5, 8, 3), np.float64)
    ok = np.empty((6, 8, 3), np.float64)
    with pytest.raises(ValueError, match="shape"):
        acc.finalize(use_std=True, out=(small, ok.copy()))
    with pytest.raises(ValueError, match="shape"):
        acc.finalize(use_std=True, out=(ok.copy(), small))
    # exact shapes still work
    mean, std = acc.finalize(use_std=True, out=(ok, ok.copy()))
    assert mean.shape == (6, 8, 3)


def test_host_moments_finalize_wire_u16f16(rng, monkeypatch):
    """The u16+f16 wire finalize (native.WIRE_U16F16): native pass and
    NumPy fallback are bit-identical, the dequantized mean is within the
    2^-17 grid bound of the f64 finalize, and the f16 std within 2^-11
    relative — the format's whole qualification (docs/kernel_design.md
    "Wire formats") rests on these bounds."""
    frames = rng.integers(0, 256, (120, 9, 13, 3), dtype=np.uint8)
    acc = native.HostMoments((9, 13, 3), scale=1.0 / 255)
    acc.update(frames)

    mean64, std64 = acc.finalize()
    mq, sq = acc.finalize(dtype=native.WIRE_U16F16)
    assert mq.dtype == np.uint16 and sq.dtype == np.float16
    # quantization bounds
    assert np.abs(mq / 65535.0 - mean64).max() <= 0.5 / 65535 + 1e-12
    rel = np.abs(sq.astype(np.float64) - std64) / np.maximum(std64, 1e-30)
    assert rel.max() <= 2.0 ** -11 + 1e-12

    # out= slices of a wire-typed stack, exact writes
    stack_v = np.zeros((2, 9, 13, 3), np.uint16)
    stack_s = np.zeros((2, 9, 13, 3), np.float16)
    acc.finalize(dtype=native.WIRE_U16F16, out=(stack_v[1], stack_s[1]))
    np.testing.assert_array_equal(stack_v[1], mq)
    np.testing.assert_array_equal(stack_s[1].view(np.uint16),
                                  sq.view(np.uint16))
    assert not stack_v[0].any()

    # dtype/shape validation
    with pytest.raises(ValueError, match="WIRE_U16F16"):
        acc.finalize(dtype=(np.uint16, np.float32))
    with pytest.raises(ValueError, match="shape"):
        acc.finalize(dtype=native.WIRE_U16F16,
                     out=(np.empty((9, 13, 3), np.float32),
                          np.empty((9, 13, 3), np.float16)))

    # NumPy fallback: bit-identical encoding
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    mq_f, sq_f = acc.finalize(dtype=native.WIRE_U16F16)
    np.testing.assert_array_equal(mq, mq_f)
    np.testing.assert_array_equal(sq.view(np.uint16),
                                  sq_f.view(np.uint16))


def test_wire_quantize_u16f16_saturates():
    """Out-of-range means saturate (a miscalibrated scale must clamp, not
    wrap) and exact grid points are preserved."""
    mean = np.asarray([-0.25, 0.0, 0.5, 1.0, 1.5])
    mq, _ = native.wire_quantize_u16f16(mean, None)
    np.testing.assert_array_equal(mq, [0, 0, 32768, 65535, 65535])

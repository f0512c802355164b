"""End-to-end video -> HDR pipeline (BASELINE config 5 family)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models import pipeline


def _write_video(path, frames_u8, fps=10):
    import cv2 as cv
    h, w = frames_u8.shape[1:3]
    writer = cv.VideoWriter(str(path), cv.VideoWriter_fourcc(*"FFV1"), fps,
                            (w, h))
    for f in frames_u8:
        writer.write(f)
    writer.release()


@pytest.fixture
def scene_videos(tmp_path, rng):
    """Three exposure videos of a static scene with shot-like noise."""
    base = rng.uniform(0.2, 0.5, (24, 32, 3))
    paths = []
    for ms in (4, 8, 16):
        mean_img = np.clip(base * (ms / 16), 0, 1)
        frames = np.clip(
            mean_img[None] + rng.normal(0, 0.02, (30, 24, 32, 3)), 0, 1)
        u8 = np.around(frames * 255).astype(np.uint8)
        p = tmp_path / f"scene {ms}ms.avi"
        _write_video(p, u8)
        paths.append(p)
    import cv2 as cv
    cap = cv.VideoCapture(str(paths[0]))
    ok, _ = cap.read()
    cap.release()
    if not ok:
        pytest.skip("no usable lossless codec")
    return paths, base


def test_videos_to_exposure_series(scene_videos):
    paths, base = scene_videos
    series = pipeline.videos_to_exposure_series(paths)
    assert len(series.input_image_sets) == 3
    exps = [s.features["exposure"] for s in series.input_image_sets]
    assert exps == sorted(exps)
    s0 = series.input_image_sets[0]
    assert s0.measurand.std is not None
    # mean frame close to the noiseless mean of the shortest exposure
    np.testing.assert_allclose(np.asarray(s0.measurand.val),
                               np.clip(base * 0.25, 0, 1), atol=0.03)


def test_video_to_hdr_end_to_end(scene_videos):
    paths, base = scene_videos
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)  # identity ICRF
    hdr = pipeline.video_to_hdr(paths, jnp.asarray(icrf))
    val = np.asarray(hdr.measurand.val)
    std = np.asarray(hdr.measurand.std)
    assert val.shape == (24, 32, 3)
    assert np.isfinite(val).all() and np.isfinite(std).all()
    # identity ICRF + linear scene: HDR ~ radiance/exposure scale
    # (value / (base/t_ref)) should be roughly constant
    expect = base / 0.016
    ratio = val / expect
    assert 0.8 < np.median(ratio) < 1.2
    assert hdr.is_hdr


def test_batch_video_to_hdr_pool_reuse_distinct_scenes(tmp_path, rng):
    """Scene 2 reuses scene 0's buffer pair (pool depth 2): uploaded
    statistics must be genuine copies — on the CPU backend jax zero-copies
    aligned host buffers, which aliased the pool and silently replaced
    early scenes' statistics with later ones before the copy gate."""
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    scenes = {}
    for si, name in enumerate(("a", "b", "c")):
        d = tmp_path / name
        d.mkdir()
        base = rng.uniform(0.15, 0.45, (24, 32, 3)) * (1.0 + 0.4 * si)
        paths = []
        for ms in (4, 8, 16):
            mean_img = np.clip(base * (ms / 16), 0, 1)
            frames = np.clip(
                mean_img[None] + rng.normal(0, 0.02, (12, 24, 32, 3)), 0, 1)
            p = d / f"{name} {ms}ms.avi"
            _write_video(p, np.around(frames * 255).astype(np.uint8))
            paths.append(p)
        import cv2 as cv
        cap = cv.VideoCapture(str(paths[0]))
        ok, _ = cap.read()
        cap.release()
        if not ok:
            pytest.skip("no usable lossless codec")
        scenes[name] = paths

    out = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    for name, paths in scenes.items():
        solo = pipeline.video_to_hdr(paths, jnp.asarray(icrf))
        np.testing.assert_allclose(np.asarray(out[name].measurand.val),
                                   np.asarray(solo.measurand.val),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"scene {name!r} statistics "
                                   "were replaced by a later scene's")


def test_batch_video_to_hdr_rejects_mismatched_exposures_before_decode(
        tmp_path, rng, monkeypatch):
    """Exposure sets are filename-derived; a mismatched batch must fail
    before any decode work happens."""
    d1, d2 = tmp_path / "s1", tmp_path / "s2"
    d1.mkdir(), d2.mkdir()
    frames = np.zeros((2, 24, 32, 3), np.uint8)
    scenes = {}
    for d, exps in ((d1, (4, 8)), (d2, (4, 16))):
        paths = []
        for ms in exps:
            p = d / f"x {ms}ms.avi"
            _write_video(p, frames)
            paths.append(p)
        scenes[d.name] = paths
    def _no_decode(*a, **k):
        raise AssertionError("decode started before the exposure check")

    monkeypatch.setattr(pipeline, "videos_to_stacks", _no_decode)
    with pytest.raises(ValueError, match="exposures"):
        pipeline.batch_video_to_hdr(scenes, jnp.asarray(
            np.linspace(0, 1, 256)[:, None].repeat(3, 1)))


def test_batch_video_to_hdr(scene_videos, tmp_path, rng):
    paths, base = scene_videos
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    scenes = {"a": paths, "b": paths}
    out = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    assert set(out.keys()) == {"a", "b"}
    np.testing.assert_allclose(np.asarray(out["a"].measurand.val),
                               np.asarray(out["b"].measurand.val))

def test_batch_video_to_hdr_wire_std_f16(scene_videos):
    """The f16 std wire format (docs/kernel_design.md "Wire formats"):
    val output is bitwise identical to the f32-wire run (the val plane is
    untouched), std deviates by at most the f16 quantization bound
    (2^-11 relative) propagated through the merge."""
    paths, _ = scene_videos
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    scenes = {"a": paths}
    full = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                       wire_std="f32")["a"]
    half = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                       wire_std="f16")["a"]
    np.testing.assert_array_equal(np.asarray(half.measurand.val),
                                  np.asarray(full.measurand.val))
    np.testing.assert_allclose(np.asarray(half.measurand.std),
                               np.asarray(full.measurand.std),
                               rtol=1.5e-3, atol=1e-9)
    with pytest.raises(ValueError, match="wire_std"):
        pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                    wire_std="f8")


def test_batch_video_to_hdr_wire_val_u16(scene_videos):
    """The u16-val + f16-std wire format (wire_val='u16'): the fused
    native finalize writes the wire encoding directly, the device
    dequantizes, and the merged outputs stay within the propagated
    quantization bounds of the full-width run — val within the 2^-17
    grid amplified by the merge's 1/exposure scaling, std within the
    f16 bound (docs/kernel_design.md "Wire formats")."""
    paths, _ = scene_videos
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    scenes = {"a": paths}
    from camera_linearity.ops import hdr as hdr_ops
    from camera_linearity.ops.linearize import icrf_derivative
    full = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                       wire_std="f32")["a"]
    wire = pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                       wire_val="u16")["a"]
    fv = np.asarray(full.measurand.val)
    wv = np.asarray(wire.measurand.val)

    # exact oracle: the wire run must equal merging the DEQUANTIZED wire
    # stacks at full width — transport adds nothing beyond quantization
    vstack, sstack, exps, _ = pipeline.videos_to_stacks(paths, wire=True)
    assert vstack.dtype == np.uint16 and sstack.dtype == np.float16
    inv = np.float32(1.0 / 65535.0)
    bv = jnp.asarray(vstack.astype(np.float32) * inv)[None]
    bs = jnp.asarray(sstack.astype(np.float32))[None]
    icrf_j = jnp.asarray(icrf)
    ov, os_ = hdr_ops.merge_batch(bv, bs, jnp.asarray(exps), icrf_j,
                                  icrf_derivative(icrf_j, 256))
    # rtol 1e-5: XLA fuses the on-device dequant into the merge, so the
    # multiply's rounding can differ from this host-side oracle by ulps
    np.testing.assert_allclose(wv, np.asarray(ov[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(wire.measurand.std),
                               np.asarray(os_[0]), rtol=1e-5, atol=1e-9)

    # vs the full-width run: quantization-level agreement in bulk; the
    # rare exceptions are pixels whose merge weights flip across a
    # threshold (precise statistics at realistic scale live in
    # benchmarks/wire_format_budget.py — this noisy 24x32 scene only
    # supports loose bounds)
    rel = np.abs(wv - fv) / np.maximum(np.abs(fv), 1e-6)
    assert np.median(rel) <= 1e-5
    assert (rel > 0.05).mean() <= 5e-3
    with pytest.raises(ValueError, match="wire_val"):
        pipeline.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                    wire_val="u8")


def test_batch_video_to_hdr_calibration_leg(scene_videos):
    """BASELINE config 5's "calibrate + merge": the ICRF solves from the
    decoded stacks and drives the merge (a gamma-distorted scene merged
    with the SOLVED curve must differ from the identity-ICRF merge, and
    the leg's stage time must be attributed)."""
    from camera_linearity.utils import observability as obs
    paths, _ = scene_videos
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    spec = dict(pca_arrays=np.stack([vt[:3].T] * 3),
                mean_icrf_arrays=np.stack([mean_icrf] * 3),
                spacing=7, popsize=6, maxiter=4, rng_seed=3)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    obs.reset_stage_times()
    out = pipeline.batch_video_to_hdr({"a": paths}, jnp.asarray(icrf),
                                      calibrate=spec)["a"]
    assert obs.snapshot_stage_times().get("calibrate_s", 0) > 0
    assert np.isfinite(np.asarray(out.measurand.val)).all()
    plain = pipeline.batch_video_to_hdr({"a": paths},
                                        jnp.asarray(icrf))["a"]
    assert not np.allclose(np.asarray(out.measurand.val),
                           np.asarray(plain.measurand.val))


def test_batch_video_to_hdr_distributed_calibration_leg(scene_videos):
    """The multi-host flow's calibration leg (owner subsample ->
    allgather broadcast -> identical solve everywhere) must produce the
    same merge as the single-host leg on a 1-process mesh, and the
    decoder/calibrate arguments must survive the process_count()>1
    dispatch in batch_video_to_hdr (they were silently dropped once)."""
    from camera_linearity.parallel import distributed as dist
    paths, _ = scene_videos
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    spec = dict(pca_arrays=np.stack([vt[:3].T] * 3),
                mean_icrf_arrays=np.stack([mean_icrf] * 3),
                spacing=7, popsize=6, maxiter=4, rng_seed=3)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    mesh = dist.scene_mesh()
    out_d = pipeline.batch_video_to_hdr_distributed(
        {"a": paths, "b": paths}, jnp.asarray(icrf), calibrate=spec,
        mesh=mesh)
    out_s = pipeline.batch_video_to_hdr(
        {"a": paths, "b": paths}, jnp.asarray(icrf), calibrate=spec,
        mesh=mesh)
    for k in ("a", "b"):
        np.testing.assert_allclose(np.asarray(out_d[k].measurand.val),
                                   np.asarray(out_s[k].measurand.val),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(out_d[k].measurand.std),
                                   np.asarray(out_s[k].measurand.std),
                                   rtol=1e-7, atol=1e-9)
    # and the solved curve actually drove the distributed merge
    plain = pipeline.batch_video_to_hdr_distributed(
        {"a": paths, "b": paths}, jnp.asarray(icrf), mesh=mesh)
    assert not np.allclose(np.asarray(out_d["a"].measurand.val),
                           np.asarray(plain["a"].measurand.val))


def test_batch_video_to_hdr_rejects_mismatched_exposures(scene_videos,
                                                         tmp_path):
    """Scenes with differing exposure sets must be rejected, not silently
    merged with one scene's exposure vector (round-2 bug: the LAST scene's
    exposures were applied to every scene)."""
    import shutil
    paths, _ = scene_videos
    other_dir = tmp_path / "other_scene"
    other_dir.mkdir()
    other = []
    # same frame content, different exposure descriptors: 4/8/20 vs 4/8/16
    for p, ms in zip(paths, (4, 8, 20)):
        q = other_dir / f"scene {ms}ms.avi"
        shutil.copy(p, q)
        other.append(q)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    with pytest.raises(ValueError, match="scene 'b'.*exposure"):
        pipeline.batch_video_to_hdr({"a": paths, "b": other},
                                    jnp.asarray(icrf))


def test_batch_video_to_hdr_rejects_empty_scenes():
    icrf = jnp.asarray(np.linspace(0, 1, 256)[:, None].repeat(3, 1))
    with pytest.raises(ValueError, match="scenes is empty"):
        pipeline.batch_video_to_hdr({}, icrf)
    with pytest.raises(ValueError, match="scene 'a' has no videos"):
        pipeline.batch_video_to_hdr({"a": []}, icrf)


def test_scene_stack_pool_checkout_is_exclusive():
    """Concurrent checkouts of the SAME geometry must get DISTINCT buffer
    pairs (round-3 advisor finding: the shared dict handed two concurrent
    batch_video_to_hdr calls the same mmap pair, which then decoded and
    finalized into each other's scene statistics)."""
    shape, dt = (2, 8, 8, 3), np.float64
    k1, p1 = pipeline._checkout_scene_stack_pool(shape, dt)
    k2, p2 = pipeline._checkout_scene_stack_pool(shape, dt)
    ids1 = {id(b) for pair in p1 for b in pair}
    ids2 = {id(b) for pair in p2 for b in pair}
    assert not ids1 & ids2
    pipeline._return_scene_stack_pool(k1, p1)
    pipeline._return_scene_stack_pool(k2, p2)
    # a fresh checkout reuses a returned (warm) pool rather than allocating
    _, p3 = pipeline._checkout_scene_stack_pool(shape, dt)
    assert {id(b) for pair in p3 for b in pair} & (ids1 | ids2)


def test_scene_stack_pool_bounds_cached_geometries():
    pipeline._SCENE_STACKS.clear()
    keys = []
    for n in (2, 3, 4):
        k, p = pipeline._checkout_scene_stack_pool((n, 4, 4, 1), np.float64)
        pipeline._return_scene_stack_pool(k, p)
        keys.append(k)
    assert len(pipeline._SCENE_STACKS) <= pipeline._MAX_CACHED_GEOMETRIES
    # most recently returned geometries survive
    assert keys[-1] in pipeline._SCENE_STACKS


def test_concurrent_batch_video_to_hdr_is_isolated(scene_videos, tmp_path,
                                                   rng):
    """Two concurrent batch_video_to_hdr calls with the same geometry must
    not corrupt each other (round-3 advisor finding — and the deeper bug:
    video._host_buffers shared the MOMENT ACCUMULATORS, so concurrent
    welford runs summed into each other's statistics)."""
    from concurrent.futures import ThreadPoolExecutor
    import cv2 as cv
    paths, _ = scene_videos
    icrf = jnp.asarray(np.linspace(0, 1, 256)[:, None].repeat(3, 1))
    expected = np.asarray(
        pipeline.batch_video_to_hdr({"s": paths}, icrf)["s"].measurand.val)
    # a second scene with distinct content, same geometry/exposures
    other_dir = tmp_path / "bright"
    other_dir.mkdir()
    base = rng.uniform(0.6, 0.9, (24, 32, 3))
    other = []
    for ms in (4, 8, 16):
        img = np.clip(base * (ms / 16), 0, 1)
        frames = np.clip(img[None] + rng.normal(0, 0.02, (30, 24, 32, 3)),
                         0, 1)
        u8 = np.around(frames * 255).astype(np.uint8)
        p = other_dir / f"scene {ms}ms.avi"
        w = cv.VideoWriter(str(p), cv.VideoWriter_fourcc(*"FFV1"), 10,
                           (32, 24))
        for f in u8:
            w.write(f)
        w.release()
        other.append(p)
    with ThreadPoolExecutor(2) as ex:
        f1 = ex.submit(pipeline.batch_video_to_hdr, {"s": paths}, icrf)
        f2 = ex.submit(pipeline.batch_video_to_hdr, {"s": other}, icrf)
        r1, r2 = f1.result(), f2.result()
    np.testing.assert_allclose(
        np.asarray(r1["s"].measurand.val), expected,
        err_msg="concurrent run diverged from the serial result")
    assert abs(float(np.asarray(r2["s"].measurand.val).mean())
               - float(expected.mean())) > 1e-3

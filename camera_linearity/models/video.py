"""Video processing: streaming mean/std frames, noise profiles, STD data.

Pipeline layer over ops/welford.py mirroring the reference
(modules/video_processing.py).  Host-side OpenCV decode feeds fixed-size
frame batches to the device; all statistics run jitted.  The reference's
uint8 quantization of outputs is available behind ``quantize=True`` —
including its bug of rounding the [0,1]-scaled std straight to uint8
(video_processing.py:214-215, almost always 0); the default returns float
arrays.
"""
from __future__ import annotations

import os
import queue
import threading
from functools import partial
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig, DEFAULT_CONFIG
from .. import native
from ..ops import welford as wf
from ..ops.linearize import linearize
from ..utils import io

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv = None
    _HAS_CV2 = False

Array = jnp.ndarray

__all__ = ["video_frame_generator", "welford_algorithm",
           "compute_noise_profiles", "clean_data_edges", "calculate_std",
           "process_STD_data", "process_video", "process_directory"]


def video_frame_generator(video_path: Path) -> Iterator[np.ndarray]:
    """Yield frames of a video; None when exhausted
    (general_functions.py:226-251)."""
    video = cv.VideoCapture(str(video_path))
    if not video.isOpened():
        raise ValueError(f"Unable to open video file at {video_path}")
    try:
        while True:
            ret, frame = video.read()
            if not ret:
                yield None
                break
            yield frame
    finally:
        video.release()


def _frame_batches(file_paths: List[Path], batch_size: int
                   ) -> Iterator[np.ndarray]:
    """Yield fixed-size (batch_size, H, W, C) batches, then one final
    shorter batch if frames remain.  Downstream consumers route the
    remainder through a single-frame path so only TWO shapes ever compile
    (full batch + single frame) regardless of video length."""
    batch: List[np.ndarray] = []
    for file_path in file_paths:
        for frame in video_frame_generator(file_path):
            if frame is None:
                break
            batch.append(frame)
            if len(batch) == batch_size:
                yield np.stack(batch)
                batch = []
    if batch:
        yield np.stack(batch)


# Warm-buffer cache: geometry key -> list of idle (decode pool, moment
# accumulators) sets.  Checkout REMOVES a set (so two concurrent host-
# backend statistics runs of the same geometry never decode into — or,
# worse, ACCUMULATE into — each other's buffers); return puts it back
# warm for the next call.  Bounded: a 4K decode pool is ~1.6 GB.
_HOST_BUFFERS: Dict[tuple, list] = {}
_HOST_BUFFERS_LOCK = threading.Lock()
_MAX_CACHED_GEOMETRIES = 2


def _checkout_host_buffers(batch_size: int, height: int, width: int,
                           chs: int):
    """Check out an EXCLUSIVE decode pool + moment-accumulator pair.

    Allocated as dedicated prefaulted mmaps (``native.mmap_buffer``) and
    recycled across calls: the brk heap's first-touch fault rate on
    virtualized hosts is pathological (~0.09 GB/s vs ~7 GB/s warm), so the
    GBs of staging the host statistics path needs must never fault inside
    the decode loop.  The accumulators are zeroed per run by HostMoments.
    Callers return the set via ``_return_host_buffers`` when the run's
    finalize has read the accumulators.
    """
    key = (batch_size, height, width, chs)
    with _HOST_BUFFERS_LOCK:
        idle = _HOST_BUFFERS.get(key)
        if idle:
            buffers = idle.pop()
            if not idle:
                del _HOST_BUFFERS[key]
            return key, buffers
    pool = [native.mmap_buffer((batch_size, height, width, chs),
                               np.uint8) for _ in range(4)]
    bufs = (native.mmap_buffer((height, width, chs), np.uint64),
            native.mmap_buffer((height, width, chs), np.uint64))
    return key, (pool, bufs)


_MAX_IDLE_PER_GEOMETRY = 2


def _return_host_buffers(key, buffers) -> None:
    with _HOST_BUFFERS_LOCK:
        idle = _HOST_BUFFERS.setdefault(key, [])
        # bound idle sets PER KEY too: a burst of N concurrent
        # same-geometry runs would otherwise pin N multi-GB buffer sets
        # for process lifetime (extras just drop; munmap on GC)
        if len(idle) < _MAX_IDLE_PER_GEOMETRY:
            idle.append(buffers)
        while len(_HOST_BUFFERS) > _MAX_CACHED_GEOMETRIES:
            # evict an arbitrary other geometry (dict order = insertion)
            oldest = next(k for k in _HOST_BUFFERS if k != key)
            del _HOST_BUFFERS[oldest]


def _frame_batches_into(file_paths: List[Path], batch_size: int,
                        pool: List[np.ndarray],
                        prefetch_depth: int = 0
                        ) -> Iterator[np.ndarray]:
    """Decode frames directly into a rotating pool of preallocated batch
    buffers via ``grab``+``retrieve(out)`` and yield views of them.

    Fresh 25 MB frame allocations cost more than the decode itself on this
    class of host (first-touch page faults); reusing warm buffers makes the
    loop run at the decoder's native rate.  Safe together with ``_prefetch``
    only while ``len(pool) > depth + 1`` (depth buffers queued, one in the
    consumer's hands, one being filled) — callers MUST declare the prefetch
    depth they will wrap this iterator with so the invariant is enforced at
    wiring time.  The consumer must be done with a yielded view by the time
    it requests the ``len(pool)-1``-th batch after it — true for synchronous
    host accumulation (``HostMoments.update`` returns only after reading the
    batch).
    """
    if len(pool) <= prefetch_depth + 1:
        raise ValueError(
            f"decode pool of {len(pool)} buffers cannot back a prefetch "
            f"depth of {prefetch_depth}: need len(pool) > depth + 1 "
            "(queued buffers + consumer's view + the one being filled) or "
            "yielded views are overwritten while still in use")
    from ..utils.observability import stage_times
    from time import perf_counter
    slot = 0
    filled = 0
    buf = pool[slot]
    for file_path in file_paths:
        video = cv.VideoCapture(str(file_path))
        if not video.isOpened():
            video.release()
            raise ValueError(f"Unable to open video file at {file_path}")
        try:
            t0 = perf_counter()
            while True:
                if not video.grab():
                    break
                dst = buf[filled]
                ret, frame = video.retrieve(dst)
                if not ret:
                    break
                if frame is not dst and frame.base is not buf:
                    np.copyto(dst, frame)  # codec returned its own buffer
                filled += 1
                if filled == batch_size:
                    # decode busy-time only: the clock pauses across the
                    # yield (the queue hand-off blocks when the consumer
                    # is the bottleneck, and that wait is not decoding)
                    stage_times.add("decode_s", perf_counter() - t0)
                    yield buf
                    t0 = perf_counter()
                    slot = (slot + 1) % len(pool)
                    buf = pool[slot]
                    filled = 0
            stage_times.add("decode_s", perf_counter() - t0)
        finally:
            video.release()
    if filled:
        yield buf[:filled]


def _frame_batches_into_turbo(file_paths: List[Path], batch_size: int,
                              pool: List[np.ndarray],
                              prefetch_depth: int = 0,
                              fast: bool = False) -> Iterator[np.ndarray]:
    """``_frame_batches_into`` on the native libjpeg decode path.

    Walks each AVI's raw MJPEG chunks (utils/avi.py) and decodes them
    straight into the pool buffers with the native libjpeg(-turbo) decoder
    (native/mjpeg.cpp) — skipping cv2.VideoCapture's separate YUV->BGR
    conversion pass, the difference that makes this the faster decoder on
    decode-bound single-core hosts (measured: benchmarks/bench_decode.py).
    Same pool/prefetch invariants as ``_frame_batches_into``; ``fast``
    selects JDCT_IFAST + plain chroma upsampling.

    Callers gate on :func:`native.mjpeg_available` and
    ``utils.avi.probe_mjpg`` (the per-frame geometry check in the native
    decoder still rejects mid-stream geometry changes).
    """
    if len(pool) <= prefetch_depth + 1:
        raise ValueError(
            f"decode pool of {len(pool)} buffers cannot back a prefetch "
            f"depth of {prefetch_depth}: need len(pool) > depth + 1 "
            "(queued buffers + consumer's view + the one being filled) or "
            "yielded views are overwritten while still in use")
    from ..utils import avi as avi_mod
    from ..utils.observability import stage_times
    from time import perf_counter
    slot = 0
    filled = 0
    buf = pool[slot]
    for file_path in file_paths:
        t0 = perf_counter()
        for payload in avi_mod.mjpg_chunks(file_path):
            native.jpeg_decode_bgr(payload, buf[filled], fast=fast)
            filled += 1
            if filled == batch_size:
                stage_times.add("decode_s", perf_counter() - t0)
                yield buf
                t0 = perf_counter()
                slot = (slot + 1) % len(pool)
                buf = pool[slot]
                filled = 0
        stage_times.add("decode_s", perf_counter() - t0)
    if filled:
        yield buf[:filled]


def _resolve_decoder(decoder: str, file_paths: List[Path],
                     height: int, width: int) -> str:
    """Resolve the ``decoder`` choice for the host statistics path.

    ``"auto"`` reads env ``CL_DECODER`` (default ``"cv2"`` — the
    reference's decoder; pixel parity with it is exact only for itself).
    ``"turbo"``/``"turbo_fast"`` require the native libjpeg decoder AND
    every input to probe as an MJPG AVI of the expected geometry;
    otherwise the call logs a warning and falls back to cv2 (same
    statistics, reference decode path).
    """
    if decoder == "auto":
        decoder = os.environ.get("CL_DECODER", "cv2")
    if decoder not in ("cv2", "turbo", "turbo_fast"):
        raise ValueError(f"unknown decoder {decoder!r}; expected 'auto', "
                         "'cv2', 'turbo' or 'turbo_fast'")
    if decoder == "cv2":
        return decoder
    from ..utils import avi as avi_mod
    from ..utils.observability import get_logger
    if not native.mjpeg_available():
        get_logger().warning(
            "decoder=%s requested but the native MJPEG decoder is "
            "unavailable; falling back to cv2", decoder)
        return "cv2"
    for p in file_paths:
        if avi_mod.probe_mjpg(p) != (height, width):
            get_logger().warning(
                "decoder=%s requested but %s is not an MJPG AVI of "
                "geometry (%d, %d); falling back to cv2",
                decoder, p, height, width)
            return "cv2"
    return decoder


_PREFETCH_DONE = object()


def _prefetch(iterator: Iterator[np.ndarray], depth: int = 2
              ) -> Iterator[np.ndarray]:
    """Run ``iterator`` on a background thread, handing items over through a
    bounded queue — double-buffers host video decode against downstream
    transfer/compute.  OpenCV's decoder releases the GIL, so on multi-core
    hosts the next batch decodes while the device consumes the current one;
    exceptions raised by the producer re-raise at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        # decode is the pipeline's critical path: boost it above transfer
        # threads, whose remote-transport calls spin the CPU on slow links
        from ..utils.general import set_thread_priority
        set_thread_priority(-5)
        try:
            for item in iterator:
                q.put(item)
            q.put(_PREFETCH_DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised downstream
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _PREFETCH_DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


@partial(jax.jit, static_argnames=("max_dn",))
def _prepare_frames(frames_u8, icrf_dev, max_dn: int):
    """uint8 frames -> float (optionally ICRF-linearized) on device."""
    if icrf_dev is not None:
        out, _ = linearize(frames_u8.astype(jnp.int32), None, icrf_dev,
                           max_dn=max_dn)
        return out.astype(jnp.float32)
    return frames_u8.astype(jnp.float32) / max_dn


_single_update = jax.jit(wf.welford_update)


@partial(jax.jit, static_argnames=("max_dn",))
def _single_update_lut(state, frame_dn, icrf_dev, max_dn: int):
    """Remainder-batch path of the fused LUT+Welford update."""
    x, _ = linearize(frame_dn.astype(jnp.int32), None, icrf_dev,
                     max_dn=max_dn)
    return wf.welford_update(state, x.astype(state.mean.dtype))


def probe_geometry(video_path: Path) -> Tuple[int, int]:
    """(height, width) of a video file's frames."""
    video = cv.VideoCapture(str(video_path))
    if not video.isOpened():
        video.release()
        raise ValueError(f"Unable to open video file at {video_path}")
    width = int(video.get(cv.CAP_PROP_FRAME_WIDTH))
    height = int(video.get(cv.CAP_PROP_FRAME_HEIGHT))
    video.release()
    return height, width


def welford_algorithm(file_paths: Union[Path, List[Path]],
                      ICRF: Optional[Array] = None,
                      use_std: bool = False,
                      config: CameraConfig = DEFAULT_CONFIG,
                      batch_size: int = 32,
                      quantize: bool = False,
                      backend: str = "auto",
                      dtype=np.float64,
                      out=None,
                      decoder: str = "auto") -> Dict[str, np.ndarray]:
    """Mean (and std-of-mean) frame over all frames of the given videos
    (video_processing.py:161-219).

    Frames linearize through the ICRF LUT on device when one is given
    (fixing the reference's ``if ICRF:`` array-truthiness bug,
    video_processing.py:200).  The default returns float arrays;
    ``quantize=True`` opts into the reference's uint8 outputs, including
    its bug of rounding the [0,1]-scale std straight to uint8.  ``dtype``
    selects the output float type: float32 narrows on the final store
    (arithmetic is unchanged), sparing device-bound consumers a full-frame
    conversion pass; the pair ``native.WIRE_U16F16`` writes the qualified
    u16-mean + f16-std host->device wire encoding instead (still one fused
    store pass on the host backend).  ``out=(mean, std)`` writes results
    into caller-provided ``dtype`` arrays (e.g. slices of an exposure
    stack).

    ``backend`` selects where the statistics accumulate:

    * ``"device"`` — jitted ``lax.scan`` Welford over staged frame batches.
    * ``"host"`` — exact integer moment accumulation (``native.HostMoments``)
      directly on the raw uint8 frames; no device transfer.  Only valid
      without an ICRF (linearized frames are no longer integer DN).
    * ``"auto"`` — ``"host"`` when no ICRF is given (the raw-DN stream never
      has to cross the host↔device link), otherwise ``"device"``.

    ``decoder`` selects the host-path video decoder: ``"cv2"``
    (cv2.VideoCapture — the reference's decoder), ``"turbo"`` (native
    libjpeg-turbo on raw MJPG AVI chunks, skips cv2's separate YUV->BGR
    pass; falls back to cv2 with a warning when the native decoder or the
    container format is unsupported), ``"turbo_fast"`` (adds JDCT_IFAST +
    plain chroma upsampling; decoder deltas qualified in
    benchmarks/bench_decode.py), or ``"auto"`` (env ``CL_DECODER``,
    default cv2).  Only the host statistics backend decodes through it;
    the device backend always uses cv2.

    Decode always runs on a prefetch thread, double-buffered against the
    consuming stage.
    """
    if not isinstance(file_paths, list):
        file_paths = [file_paths]
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    if quantize and isinstance(dtype, (tuple, list)):
        raise ValueError("quantize=True is incompatible with a wire dtype "
                         "pair (outputs are already integer-encoded)")

    height, width = probe_geometry(file_paths[0])

    max_dn = config.max_dn
    icrf_dev = None if ICRF is None else jnp.asarray(ICRF)
    if backend == "host" and icrf_dev is not None:
        raise ValueError("backend='host' accumulates raw integer DN and "
                         "cannot apply an ICRF; use backend='device'")
    if backend == "auto":
        backend = "host" if icrf_dev is None else "device"

    if backend == "host":
        from ..utils.observability import stage as _stage
        native.tune_host_allocator()
        chs = config.num_of_chs
        with _stage("buffers_s"):
            buf_key, (pool, bufs) = _checkout_host_buffers(
                min(batch_size, 16), height, width, chs)
        acc = native.HostMoments((height, width, chs), 1.0 / max_dn,
                                 _buffers=bufs)
        dec = _resolve_decoder(decoder, file_paths, height, width)
        if dec == "cv2":
            batches = _frame_batches_into(file_paths, pool[0].shape[0],
                                          pool, prefetch_depth=2)
        else:
            batches = _frame_batches_into_turbo(
                file_paths, pool[0].shape[0], pool, prefetch_depth=2,
                fast=dec == "turbo_fast")
        for batch in _prefetch(batches, depth=2):
            with _stage("stats_s"):
                acc.update(batch)
        with _stage("finalize_s"):
            mean_np, std_np = acc.finalize(use_std=use_std, dtype=dtype,
                                           out=out)
        # Return only on CLEAN completion: finalize has read the
        # accumulators and the prefetch producer is exhausted.  On an
        # exception the abandoned producer thread may still be decoding
        # into the pool — leaking the set is safe, handing it to another
        # call mid-write is not.
        _return_host_buffers(buf_key, (pool, bufs))
        if use_std and std_np is None and out is not None:
            # <2 frames: no std exists — zero the caller's slice rather
            # than leaving np.empty garbage to flow into a merge
            out[1][...] = 0
    else:
        from ..utils.general import stage_to_device
        batches = _prefetch(_frame_batches(file_paths, batch_size))
        state = wf.welford_init((height, width, config.num_of_chs))
        n_frames = 0
        for batch in batches:
            staged = stage_to_device(batch)
            n_frames += batch.shape[0]
            if icrf_dev is not None:
                # LUT fused into the scan body: ONE program, uint8 input
                # traffic, no linearized (B,H,W,C) float intermediate
                if batch.shape[0] == batch_size:
                    state = wf.welford_update_batch_lut(state, staged,
                                                        icrf_dev, max_dn)
                else:
                    for k in range(batch.shape[0]):
                        state = _single_update_lut(state, staged[k],
                                                   icrf_dev, max_dn)
                continue
            frames = _prepare_frames(staged, None, max_dn)
            if batch.shape[0] == batch_size:
                state = wf.welford_update_batch(state, frames)
            else:  # remainder: single-frame path, avoids a new scan compile
                for k in range(batch.shape[0]):
                    state = _single_update(state, frames[k])

        want_std = use_std and n_frames >= 2
        mean, std = wf.welford_finalize(state, use_std=want_std)
        if isinstance(dtype, (tuple, list)):
            # wire-encoded outputs (see native.WIRE_U16F16): quantize with
            # the shared NumPy reference so device- and host-backend runs
            # produce the identical encoding
            if tuple(np.dtype(d) for d in dtype) != native.WIRE_U16F16:
                raise ValueError("welford_algorithm: the only supported "
                                 "dtype pair is native.WIRE_U16F16")
            mean_np, std_np = native.wire_quantize_u16f16(
                np.asarray(mean), np.asarray(std) if want_std else None,
                out=out)
            if out is not None and use_std and not want_std:
                out[1][...] = 0
            return {"mean": mean_np, "std": std_np}
        mean_np = np.asarray(mean).astype(dtype, copy=False)
        std_np = np.asarray(std).astype(dtype, copy=False) if want_std \
            else None
        if out is not None:
            out[0][...] = mean_np
            mean_np = out[0]
            if std_np is not None:
                out[1][...] = std_np
                std_np = out[1]
            elif use_std:  # <2 frames: zero the slice, not garbage
                out[1][...] = 0

    if quantize:
        mean_np = np.around(mean_np * max_dn).astype(np.uint8)
        if std_np is not None:
            # reference rounds the [0,1]-scale std directly (bug kept
            # behind the quantize flag; video_processing.py:214-215)
            std_np = np.around(std_np).astype(np.uint8)
    return {"mean": mean_np, "std": std_np}


def _profile_update(profiles, frame, mean_dev, bits: int):
    chs = profiles.shape[-1]
    combined = mean_dev * bits + frame.astype(jnp.int32)
    flat = combined.reshape(-1, chs)

    def per_channel(col):
        return jax.ops.segment_sum(jnp.ones_like(col, jnp.int32), col,
                                   num_segments=bits * bits)
    counts = jax.vmap(per_channel, in_axes=1, out_axes=1)(flat)
    return profiles + counts.reshape(bits, bits, chs)


_profile_one_frame = jax.jit(_profile_update, static_argnames=("bits",))


@partial(jax.jit, static_argnames=("bits",))
def _profile_accumulate(profiles, frames, mean_dev, bits: int):
    return jax.lax.scan(
        lambda p, f: (_profile_update(p, f, mean_dev, bits), None),
        profiles, frames)[0]


def compute_noise_profiles(video_files: List[Path],
                           config: CameraConfig = DEFAULT_CONFIG,
                           batch_size: int = 16):
    """Per-channel 2-D histograms of (mean DN, observed DN) occupancy
    (video_processing.py:77-106).

    The reference's ``np.add.at`` scatter becomes a device ``segment_sum``
    over combined (mean*bits + frame) keys — a sort-based reduction XLA
    handles well, where a naive scatter-add would serialize.
    """
    bits = config.bits
    chs = config.num_of_chs
    mean_frame = welford_algorithm(video_files, None, False, config=config,
                                   quantize=True)["mean"]
    mean_dev = jnp.asarray(mean_frame.astype(np.int32))

    profiles = jnp.zeros((bits, bits, chs), jnp.int32)
    for video_file in video_files:
        for batch in _prefetch(_frame_batches([video_file], batch_size)):
            if batch.shape[0] == batch_size:
                profiles = _profile_accumulate(profiles, jnp.asarray(batch),
                                               mean_dev, bits)
            else:
                frames = jnp.asarray(batch)
                for k in range(batch.shape[0]):
                    profiles = _profile_one_frame(profiles, frames[k],
                                                  mean_dev, bits)
    return np.asarray(profiles), mean_frame


def clean_data_edges(base_data_arr: np.ndarray,
                     config: CameraConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Smooth noise-distribution edges and enforce monotonicity toward each
    distribution's center (video_processing.py:12-74).

    Inherently sequential per-row smoothing over a (bits, bits) table —
    small host-side data, kept in NumPy.
    """
    arr = base_data_arr.copy()
    min_dn, max_dn = config.min_dn, config.max_dn
    for i in range(config.bits):
        dist = arr[i, :]
        center = i

        m = center - 1
        while m > min_dn:
            if dist[m] == 0 and dist[m - 1] == 0:
                dist[:m] = 0
                break
            if dist[m - 1] >= dist[m] or dist[m + 1] <= dist[m]:
                dist[m] = (dist[m - 1] + dist[m + 1]) // 2
            m -= 1

        m = center + 1
        while m < max_dn:
            if dist[m] == 0 and dist[m + 1] == 0:
                dist[m:] = 0
                break
            if dist[m + 1] >= dist[m] or dist[m - 1] <= dist[m]:
                dist[m] = (dist[m - 1] + dist[m + 1]) // 2
            m += 1

        m = min_dn + 1
        while m < center:
            if dist[m] == 0 and dist[m - 1] != 0 and dist[m + 1] != 0:
                dist[m] = dist[m - 1]
            elif dist[m] == dist[m + 1] and dist[m] != 0:
                dist[m + 1] += 1
                m -= 1
            m += 1

        m = max_dn - 1
        while m > center:
            if dist[m] == 0 and dist[m - 1] != 0 and dist[m + 1] != 0:
                dist[m] = dist[m + 1]
            elif dist[m] == dist[m - 1] and dist[m] != 0:
                dist[m - 1] += 1
                m += 1
            m -= 1

        arr[i, :] = dist
    return arr


def calculate_std(mean_data_array: Array,
                  config: CameraConfig = DEFAULT_CONFIG) -> Array:
    """Expected std per signal level from the noise histograms
    (video_processing.py:109-133), vectorized over all DN rows at once
    (the reference loops rows and has an unimported ``math.sqrt``).
    Rows with zero counts yield 0.
    """
    data = jnp.asarray(mean_data_array, jnp.float64
                       if jax.config.jax_enable_x64 else jnp.float32)
    datapoints = data.shape[1]
    edges = jnp.linspace(0.0, 1.0, datapoints, dtype=data.dtype)
    counts = jnp.sum(data, axis=1)
    safe = jnp.where(counts == 0, 1.0, counts)
    mean = jnp.sum(data * edges, axis=1) / safe
    var = jnp.sum((edges - mean[:, None]) ** 2 * data, axis=1) / safe
    return jnp.where(counts == 0, 0.0, jnp.sqrt(var))


def process_STD_data(config: CameraConfig = DEFAULT_CONFIG,
                     pass_result: bool = True) -> Optional[np.ndarray]:
    """Condense per-channel mean-data tables to the per-DN STD LUT and
    save it (video_processing.py:136-158)."""
    cfg = config
    std_data = np.zeros((cfg.max_dn + 1, cfg.num_of_chs))
    for i, mean_file in enumerate(cfg.mean_data_files):
        table = io.read_txt_to_array(mean_file, cfg.data_path)
        std_data[:, i] = np.asarray(calculate_std(table, cfg))
    io.save_txt(Path(cfg.data_path).joinpath(cfg.std_file_name), std_data)
    return std_data if pass_result else None


def _save_frame(save_path: Path, arr: np.ndarray) -> None:
    """uint8 frames via OpenCV; float frames as 64-bit tifs."""
    if arr.dtype == np.uint8:
        cv.imwrite(str(save_path), arr)
    else:
        io.save_image(save_path, arr)


def process_video(video_path: Path, ICRF: Optional[Array] = None,
                  use_std: bool = True,
                  config: CameraConfig = DEFAULT_CONFIG,
                  quantize: bool = False, decoder: str = "auto") -> None:
    """Mean/std frames of one video, saved as tifs
    (video_processing.py:222-236).  Float (64-bit tif) outputs by
    default; ``quantize=True`` writes the reference's uint8 frames."""
    ret = welford_algorithm(video_path, ICRF, use_std, config=config,
                            quantize=quantize, decoder=decoder)
    for key, arr in ret.items():
        if arr is not None:
            save_path = video_path.parent.joinpath(
                video_path.name.replace(".avi", f".{key}.tif"))
            _save_frame(save_path, arr)


def process_directory(dir_path: Path, ICRF: Optional[Array] = None,
                      separately: bool = True,
                      config: CameraConfig = DEFAULT_CONFIG,
                      quantize: bool = False, decoder: str = "auto") -> None:
    """Process every .avi in a directory, separately or pooled
    (video_processing.py:239-274).  Float outputs by default, like
    process_video."""
    video_files = sorted(dir_path.glob("*.avi"))
    if not separately:
        ret = welford_algorithm(list(video_files), ICRF, use_std=True,
                                config=config, quantize=quantize,
                                decoder=decoder)
        for key, arr in ret.items():
            if arr is not None:
                _save_frame(dir_path.joinpath(f"total_{key}.tif"), arr)
        return
    for path in video_files:
        ret = welford_algorithm(path, ICRF, use_std=True, config=config,
                                quantize=quantize, decoder=decoder)
        for key, arr in ret.items():
            if arr is None:
                continue
            save_dir = path.parent.joinpath(key)
            save_dir.mkdir(exist_ok=True)
            if key == "std":
                name = path.name.replace(".avi", " STD.tif")
            else:
                name = path.name.replace(".avi", ".tif")
            _save_frame(save_dir.joinpath(name), arr)

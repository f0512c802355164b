"""ctypes bindings for the native host-staging library.

Builds ``stager.cpp`` into ``_stager.so`` on first use (g++, cached by
source mtime) and exposes NumPy-friendly wrappers.  Every entry point has a
pure-NumPy fallback so the package works without a compiler; ``available()``
reports which path is active.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "u8_to_f32", "u8_hwc_to_cfirst_f32",
           "welford_update_batch_u8", "HostWelford",
           "accum_moments_u8", "HostMoments", "tune_host_allocator",
           "mmap_buffer", "WIRE_U16F16", "wire_quantize_u16f16",
           "mjpeg_available", "jpeg_decode_bgr"]

# The qualified host->device wire encoding for (mean, std_of_mean) frame
# pairs: u16 fixed-point mean (grid 1/65535 on the [0,1] DN scale,
# absolute error <= 2^-17) + IEEE f16 std (relative error <= 2^-11).
# Qualification table: docs/kernel_design.md "Wire formats";
# measurement: benchmarks/wire_format_budget.py.
WIRE_U16F16 = (np.dtype(np.uint16), np.dtype(np.float16))


def wire_quantize_u16f16(mean: np.ndarray, std: Optional[np.ndarray],
                         out=None):
    """Quantize f32/f64 (mean, std) frames to the u16+f16 wire encoding.

    Bit-identical to the fused native finalize's stores
    (``clt_finalize_moments_u64_wire``): mean maps through
    ``min(max(mean*65535 + 0.5, 0), 65535)`` truncated to uint16, std
    narrows f64->f16 round-to-nearest-even.  This is the shared NumPy
    reference used by the fallback path and by device-backend callers
    that only hold float statistics.
    """
    m = np.asarray(mean, np.float64) * 65535.0 + 0.5
    np.minimum(np.maximum(m, 0.0, out=m), 65535.0, out=m)
    if out is not None:
        out[0][...] = m.astype(np.uint16)
        mq = out[0]
        if std is not None:
            out[1][...] = np.asarray(std, np.float64)
            sq = out[1]
        else:
            sq = None
    else:
        mq = m.astype(np.uint16)
        sq = None if std is None else np.asarray(std).astype(np.float16)
    return mq, sq


def tune_host_allocator() -> bool:
    """Host-allocator policy hook for the streaming paths (now a no-op).

    Measured on this class of virtualized host: glibc *heap* (brk) pages
    fault on first touch at ~0.09 GB/s, fresh anonymous *mmap* pages at
    ~1.4 GB/s, and warm (already-faulted) pages at ~7 GB/s.  Round 1 raised
    M_MMAP_THRESHOLD to keep big buffers on the heap for warm reuse — but
    that sends every COLD large allocation through the pathological brk
    path (16x slower than mmap first-touch).  The current design instead
    leaves glibc at its defaults (large NumPy temporaries become plain
    mmaps, 1.4 GB/s worst case) and routes the big persistent streaming
    buffers through :func:`mmap_buffer`, which prefaults them once.
    Kept as an API entry point so callers have one place that owns this
    policy; returns True.
    """
    return True


def mmap_buffer(shape, dtype, prefault: bool = True) -> np.ndarray:
    """NumPy array backed by a dedicated anonymous mmap (THP-advised).

    For multi-hundred-MB buffers that live for the whole process (decode
    pools, moment accumulators): backing them with their own mapping avoids
    the brk heap's pathological first-touch fault rate, requests
    transparent hugepages (MADV_HUGEPAGE) where the kernel honors madvise,
    and — with ``prefault`` — pays the page-fault cost once, up front, at
    sequential-fill speed rather than scattered through a decode loop.
    """
    import mmap as _mmap
    dt = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dt.itemsize
    buf = _mmap.mmap(-1, nbytes)
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                     14)  # MADV_HUGEPAGE
    except (OSError, ValueError):
        pass
    arr = np.frombuffer(buf, dtype=dt).reshape(shape)
    if prefault:
        arr.view(np.uint8).reshape(-1)[:] = 0
    return arr

_DIR = Path(__file__).parent
_SRC = _DIR / "stager.cpp"
_MJPEG_SRC = _DIR / "mjpeg.cpp"


def _host_tag(src: Path = _SRC) -> str:
    """Identify the CPU + source the library was compiled for.

    ``-march=native`` output is only valid on hosts with the same feature
    set; a lib baked into a container image on an AVX-512 builder would
    SIGILL at first call on an older host (CDLL load succeeds — failure
    is at execution, past the fallback gate).  The tag hashes the machine
    + cpuinfo feature flags AND the source contents (mtime lies under
    wheel/timestamp-normalizing installers, and a cache dir can be shared
    by installs of different versions), so any mismatch rebuilds.
    """
    import hashlib
    import platform
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
    except OSError:
        pass
    try:
        src_bytes = src.read_bytes()
    except OSError:
        src_bytes = b""
    h = hashlib.md5(usedforsecurity=False)  # cache key, not security
    h.update(platform.machine().encode())
    h.update(feats.encode())
    h.update(src_bytes)
    return h.hexdigest()[:10]


def _lib_path(stem: str = "_stager", src: Path = _SRC) -> Path:
    """Per-host lib location: next to the source when writable, else a
    user cache dir (read-only installs).  May raise on exotic hosts
    (unwritable HOME, FIPS quirks) — callers degrade to the NumPy
    fallback."""
    name = f"{stem}-{_host_tag(src)}.so"
    if os.access(_DIR, os.W_OK):
        return _DIR / name
    cache = Path(os.environ.get("XDG_CACHE_HOME",
                                Path.home() / ".cache"))
    d = cache / "camera_linearity"
    d.mkdir(parents=True, exist_ok=True)
    return d / name


_lib: Optional[ctypes.CDLL] = None
_tried = False

_NTHREADS = min(16, os.cpu_count() or 1)


def _build(lib_path: Path, src: Path = _SRC, extra_flags=()) -> bool:
    # Compile to a process-private temp name and os.rename() into place:
    # rename is atomic on POSIX, so a concurrent first-use in another
    # process either sees no file (and builds its own temp) or a COMPLETE
    # lib — never a half-written one mid-g++ (CDLL of a truncated ELF
    # fails and would silently pin that process to the NumPy fallback).
    tmp = lib_path.with_name(f"{lib_path.stem}.tmp{os.getpid()}.so")
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            str(src), "-o", str(tmp)] + list(extra_flags)
    # -march=native vectorizes the u8 moment accumulation ~1.4x wider
    # (AVX2 vs baseline SSE2); fall back to the portable build where the
    # compiler rejects it
    for cmd in ([base[0], "-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, lib_path)
            _prune_stale_libs(lib_path)
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            continue
    try:
        tmp.unlink(missing_ok=True)
    except OSError:
        pass
    return False


def _prune_stale_libs(keep: Path, min_age_s: float = 600.0) -> None:
    """Drop libs built for dead source/host hashes (they accumulate one
    per code change otherwise); best-effort — a lib mapped by a running
    process keeps working after unlink on POSIX.

    Only libs older than ``min_age_s`` are touched: a concurrently
    running process with a DIFFERENT source hash (e.g. two package
    versions sharing the cache dir) has a window between its os.replace
    and its CDLL in which deleting its fresh lib would silently pin it
    to the NumPy fallback."""
    import time
    now = time.time()
    stem = keep.name.split("-")[0]  # _stager / _mjpeg: prune only own kind
    for p in keep.parent.glob(f"{stem}-*.so"):
        # another process's in-flight temp build is not stale
        if p == keep or ".tmp" in p.name:
            continue
        try:
            if now - p.stat().st_mtime >= min_age_s:
                p.unlink()
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Everything up to a successfully-bound CDLL degrades to the NumPy
    # fallback: path resolution (unwritable HOME), hashing (exotic
    # builds), building (no compiler), loading, and symbol binding (a
    # stale shared cache lib from another install).
    try:
        lib_path = _lib_path()
        # the filename embeds host + source-content hashes, so existence
        # IS freshness — no mtime trust
        if not lib_path.exists() and not _build(lib_path):
            return None
        lib = ctypes.CDLL(str(lib_path))
    except Exception:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    try:
        lib.clt_u8_to_f32.argtypes = [u8p, f32p, ctypes.c_size_t,
                                      ctypes.c_float, ctypes.c_int]
        lib.clt_u8_hwc_to_cfirst_f32.argtypes = [
            u8p, f32p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_float,
            ctypes.c_int]
        lib.clt_welford_update_u8.argtypes = [
            u8p, f64p, f64p, ctypes.c_size_t, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int]
        lib.clt_welford_update_batch_u8.argtypes = [
            u8p, f64p, f64p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int]
        lib.clt_accum_moments_u8.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, u64p, u64p,
            ctypes.c_int]
        lib.clt_finalize_moments_u64.argtypes = [
            u64p, u64p, ctypes.c_size_t, ctypes.c_double, ctypes.c_double,
            f64p, f64p, ctypes.c_int]
        lib.clt_finalize_moments_u64_f32.argtypes = [
            u64p, u64p, ctypes.c_size_t, ctypes.c_double, ctypes.c_double,
            f32p, f32p, ctypes.c_int]
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.clt_finalize_moments_u64_wire.argtypes = [
            u64p, u64p, ctypes.c_size_t, ctypes.c_double, ctypes.c_double,
            u16p, u16p, ctypes.c_int]
        lib.clt_version.restype = ctypes.c_int
    except AttributeError:
        return None  # symbol mismatch: lib from another source version
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


_mjpeg_lib: Optional[ctypes.CDLL] = None
_mjpeg_tried = False


def _load_mjpeg() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the libjpeg-backed MJPEG decoder.

    Its own shared library: linking needs the system libjpeg(-turbo) dev
    files, and a host without them must degrade ONLY this decoder — the
    stager library's paths stay native."""
    global _mjpeg_lib, _mjpeg_tried
    if _mjpeg_lib is not None or _mjpeg_tried:
        return _mjpeg_lib
    _mjpeg_tried = True
    try:
        lib_path = _lib_path("_mjpeg", _MJPEG_SRC)
        if not lib_path.exists() and not _build(lib_path, _MJPEG_SRC,
                                                extra_flags=("-ljpeg",)):
            return None
        lib = ctypes.CDLL(str(lib_path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.clt_jpeg_decode_bgr.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.clt_jpeg_decode_bgr.restype = ctypes.c_int
        lib.clt_mjpeg_version.restype = ctypes.c_int
    except Exception:
        return None
    _mjpeg_lib = lib
    return _mjpeg_lib


def mjpeg_available() -> bool:
    return _load_mjpeg() is not None


def jpeg_decode_bgr(src, dst: np.ndarray, fast: bool = False) -> None:
    """Decode one JPEG byte string/buffer into ``dst`` (H, W, 3) BGR uint8.

    Backed by the system libjpeg(-turbo) with its merged SIMD
    upsample+color-convert path (``fast=True`` adds JDCT_IFAST + plain
    chroma upsampling — qualified in benchmarks/bench_decode.py).  Raises
    ValueError on malformed data or geometry mismatch; callers that need a
    decoder fallback should gate on :func:`mjpeg_available` instead of
    catching this.
    """
    lib = _load_mjpeg()
    if lib is None:
        raise RuntimeError("native MJPEG decoder unavailable "
                           "(libjpeg dev files or compiler missing)")
    if dst.dtype != np.uint8 or dst.ndim != 3 or dst.shape[2] != 3 or \
            not dst.flags.c_contiguous or not dst.flags.writeable:
        raise ValueError("dst must be a writable C-contiguous "
                         "(H, W, 3) uint8 array")
    # zero-copy pointer to the source payload (np.frombuffer accepts both
    # read-only bytes and writable buffers without copying)
    flat = np.frombuffer(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.clt_jpeg_decode_bgr(
        flat.ctypes.data_as(u8p), flat.size,
        dst.ctypes.data_as(u8p), dst.shape[0], dst.shape[1],
        1 if fast else 0)
    if rc != 0:
        reasons = {-1: "libjpeg decode error",
                   -2: f"frame geometry != {dst.shape[:2]}",
                   -3: "not a 3-component image"}
        raise ValueError(f"jpeg_decode_bgr: {reasons.get(rc, rc)}")


def _as_u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def u8_to_f32(arr: np.ndarray, scale: float) -> np.ndarray:
    """arr.astype(f32) * scale, threaded natively when available."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return arr.astype(np.float32) * np.float32(scale)
    out = np.empty(arr.shape, np.float32)
    lib.clt_u8_to_f32(_as_u8_ptr(arr),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      arr.size, scale, _NTHREADS)
    return out


def u8_hwc_to_cfirst_f32(arr: np.ndarray, scale: float) -> np.ndarray:
    """(..., C) interleaved uint8 -> (C, pixels) planar float32 with
    normalization — the fused merge kernel's channel-first layout."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    channels = arr.shape[-1]
    pixels = arr.size // channels
    lib = _load()
    if lib is None:
        flat = arr.reshape(pixels, channels).astype(np.float32) * scale
        return np.ascontiguousarray(flat.T)
    out = np.empty((channels, pixels), np.float32)
    lib.clt_u8_hwc_to_cfirst_f32(
        _as_u8_ptr(arr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pixels, channels, scale, _NTHREADS)
    return out


def welford_update_batch_u8(frames: np.ndarray, mean: np.ndarray,
                            m2: np.ndarray, scale: float,
                            start_count: int) -> int:
    """In-place Welford over a (B, ...) uint8 frame batch; returns the new
    frame count.  Operation order matches video_processing.py:206-208."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    batch = frames.shape[0]
    n = frames.size // batch
    lib = _load()
    if lib is None:
        count = start_count
        fm = mean.reshape(-1)
        f2 = m2.reshape(-1)
        for b in range(batch):
            count += 1
            x = frames[b].reshape(-1).astype(np.float64) * scale
            delta = x - fm
            fm += delta / count
            f2 += delta * (x - fm)
        return count
    lib.clt_welford_update_batch_u8(
        _as_u8_ptr(frames),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        batch, n, scale, start_count, _NTHREADS)
    return start_count + batch


def accum_moments_u8(frames: np.ndarray, sum_: np.ndarray,
                     sumsq: np.ndarray) -> None:
    """In-place exact integer accumulation of per-element sum and sum of
    squares over a (B, ...) uint8 frame batch (tiled native kernel; NumPy
    reduction fallback)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    batch = frames.shape[0]
    n = frames.size // batch
    lib = _load()
    if lib is None:
        flat = frames.reshape(batch, -1)
        sum_.reshape(-1)[:] += flat.sum(axis=0, dtype=np.uint64)
        sumsq.reshape(-1)[:] += (flat.astype(np.uint32) ** 2).sum(
            axis=0, dtype=np.uint64)
        return
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.clt_accum_moments_u8(_as_u8_ptr(frames), batch, n,
                             sum_.ctypes.data_as(u64p),
                             sumsq.ctypes.data_as(u64p), _NTHREADS)


class HostMoments:
    """Exact streaming first/second moments of a raw uint8 frame stream.

    Replaces the running float Welford update for DN data: sums and sums of
    squares accumulate as exact integers (zero rounding error at any frame
    count), and finalization recovers the same statistics as the reference's
    frame-by-frame loop (modules/video_processing.py:206-215):

        mean = (sum / n) * scale
        M2   = (sumsq - sum^2 / n) * scale^2      == Welford M2, exactly
        std_of_mean = sqrt(M2 / (n-1)) / sqrt(n)

    Memory traffic per frame is ~1 byte per element (u32 tile partials stay
    in cache), several times faster than the f64 Welford path — the margin
    that lets a single-core host keep statistics ahead of video decode.
    """

    def __init__(self, shape, scale: float, _buffers=None):
        if _buffers is not None:
            # caller-provided accumulators (reused across runs: fresh large
            # allocations fault pages far slower than warm reuse on some
            # virtualized hosts); zeroed here
            self.sum, self.sumsq = _buffers
            self.sum.fill(0)
            self.sumsq.fill(0)
        else:
            self.sum = np.zeros(shape, np.uint64)
            self.sumsq = np.zeros(shape, np.uint64)
        self.count = 0
        self.scale = float(scale)

    def update(self, frames: np.ndarray) -> None:
        if frames.ndim == self.sum.ndim:
            frames = frames[None]
        accum_moments_u8(frames, self.sum, self.sumsq)
        self.count += frames.shape[0]

    def finalize(self, use_std: bool = True, dtype=np.float64, out=None
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Recover (mean, std_of_mean) from the integer accumulators.

        Runs as ONE fused native pass writing only the two outputs: the
        equivalent NumPy expression allocates ~8 full-frame f64
        temporaries, which on virtualized hosts (first-touch page faults
        ~60x slower than warm access) costs seconds per 4K frame and was
        the dominant term of the video pipeline, ahead of decode.

        ``dtype`` float32 narrows on store (arithmetic stays f64 — results
        are bit-identical to finalizing in f64 then casting) and skips the
        extra full-frame conversion pass device-bound callers would pay.
        ``dtype=WIRE_U16F16`` (the pair ``(uint16, float16)``) writes the
        qualified host->device WIRE encoding directly — u16 fixed-point
        mean + f16 std — still one fused pass, zero extra host cost over
        f32 (see :data:`WIRE_U16F16`).
        ``out=(mean, std)`` writes into caller-provided C-contiguous
        ``dtype`` arrays (std entry ignored when no std is produced) —
        e.g. slices of a preassembled exposure stack, skipping the
        intermediate per-video frames entirely.
        """
        n = float(self.count)
        want_std = use_std and self.count >= 2
        if isinstance(dtype, (tuple, list)):
            return self._finalize_wire(n, want_std, tuple(
                np.dtype(d) for d in dtype), out)
        dt = np.dtype(dtype)
        if out is not None:
            # shape must match exactly: the native pass writes
            # self.sum.size elements through raw pointers, so a smaller
            # out would be a silent out-of-bounds heap write
            if out[0].dtype != dt or not out[0].flags.c_contiguous or \
                    out[0].shape != self.sum.shape or \
                    (want_std and (out[1].dtype != dt
                                   or not out[1].flags.c_contiguous
                                   or out[1].shape != self.sum.shape)):
                raise ValueError("finalize out= arrays must be "
                                 f"C-contiguous {dt} of shape "
                                 f"{self.sum.shape}")
        lib = _load()
        if lib is not None and dt in (np.float32, np.float64):
            fn = (lib.clt_finalize_moments_u64 if dt == np.float64
                  else lib.clt_finalize_moments_u64_f32)
            cty = ctypes.c_double if dt == np.float64 else ctypes.c_float
            outp = ctypes.POINTER(cty)
            if out is not None:
                mean = out[0]
                std = out[1] if want_std else None
            else:
                mean = np.empty(self.sum.shape, dt)
                std = np.empty(self.sum.shape, dt) if want_std else None
            u64p = ctypes.POINTER(ctypes.c_uint64)
            fn(self.sum.ctypes.data_as(u64p),
               self.sumsq.ctypes.data_as(u64p),
               self.sum.size, ctypes.c_double(n),
               ctypes.c_double(self.scale),
               mean.ctypes.data_as(outp),
               std.ctypes.data_as(outp) if want_std else
               ctypes.cast(None, outp),
               _NTHREADS)
            return mean, std
        mean, std = self._finalize_f64(n, want_std)
        if out is not None:
            out[0][...] = mean
            mean = out[0]
            if want_std:
                out[1][...] = std
                std = out[1]
            return mean, std
        return (mean.astype(dt, copy=False),
                None if std is None else std.astype(dt, copy=False))

    def _finalize_wire(self, n: float, want_std: bool, dtypes, out):
        """Fused finalize straight into the u16+f16 wire encoding."""
        if dtypes != WIRE_U16F16:
            raise ValueError("finalize: the only supported dtype pair is "
                             f"WIRE_U16F16 (uint16, float16), got {dtypes}")
        vd, sd = dtypes
        if out is not None:
            if out[0].dtype != vd or not out[0].flags.c_contiguous or \
                    out[0].shape != self.sum.shape or \
                    (want_std and (out[1].dtype != sd
                                   or not out[1].flags.c_contiguous
                                   or out[1].shape != self.sum.shape)):
                raise ValueError("finalize out= arrays must be "
                                 f"C-contiguous ({vd}, {sd}) of shape "
                                 f"{self.sum.shape}")
        lib = _load()
        if lib is not None:
            if out is not None:
                mean = out[0]
                std = out[1] if want_std else None
            else:
                mean = np.empty(self.sum.shape, vd)
                std = np.empty(self.sum.shape, sd) if want_std else None
            u64p = ctypes.POINTER(ctypes.c_uint64)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.clt_finalize_moments_u64_wire(
                self.sum.ctypes.data_as(u64p),
                self.sumsq.ctypes.data_as(u64p),
                self.sum.size, ctypes.c_double(n),
                ctypes.c_double(self.scale),
                mean.ctypes.data_as(u16p),
                # f16 is pointer-compatible with u16 (same bit width);
                # the native side stores via _Float16
                std.ctypes.data_as(u16p) if want_std else
                ctypes.cast(None, u16p),
                _NTHREADS)
            return mean, std
        # NumPy fallback: f64 finalize, then the shared wire quantizer
        mean64, std64 = self._finalize_f64(n, want_std)
        return wire_quantize_u16f16(mean64, std64, out=out)

    def _finalize_f64(self, n: float, want_std: bool):
        """The plain f64 NumPy finalize expression (fallback helper)."""
        s = self.sum.astype(np.float64)
        mean = s / n * self.scale
        std = None
        if want_std:
            m2 = (self.sumsq.astype(np.float64) - s * s / n) \
                * self.scale ** 2
            np.maximum(m2, 0.0, out=m2)
            std = np.sqrt(m2 / (n - 1.0)) / np.sqrt(n)
        return mean, std


class HostWelford:
    """Host-side streaming Welford accumulator over raw uint8 frames.

    A native-threaded alternative to the device scan (ops/welford.py) for
    environments where frames should not cross to the accelerator — same
    finalization semantics as video_processing.py:210-215.
    """

    def __init__(self, shape, scale: float):
        self.mean = np.zeros(shape, np.float64)
        self.m2 = np.zeros(shape, np.float64)
        self.count = 0
        self.scale = float(scale)

    def update(self, frames: np.ndarray) -> None:
        if frames.ndim == len(self.mean.shape):
            frames = frames[None]
        self.count = welford_update_batch_u8(frames, self.mean, self.m2,
                                             self.scale, self.count)

    def finalize(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.count < 2:
            return self.mean.copy(), None
        std = np.sqrt(self.m2 / (self.count - 1)) / np.sqrt(self.count)
        return self.mean.copy(), std

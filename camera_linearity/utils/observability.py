"""Structured logging and device profiling.

The reference's only observability is ad-hoc prints (SURVEY.md §5;
ICRF_calibration_exposure.py:366-368, video_processing.py:260-262).  Here:
a namespaced stdlib logger, a jax.profiler trace context for capturing
device timelines (viewable in TensorBoard/XProf), and a lightweight
wall-clock scope that synchronizes device work so timings are honest on
asynchronous backends.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Iterator, Optional

import jax

__all__ = ["get_logger", "trace", "timed", "stage", "stage_times",
           "reset_stage_times", "snapshot_stage_times"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "camera_linearity",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class _StageTimes:
    """Process-global per-stage wall-time accumulator.

    Pipelines report how long each stage of a run actually spent working
    (decode, statistics, upload, merge, ...) so a single end-to-end wall
    number is attributable from the emitted artifacts alone — on hosts
    where transfer bandwidth varies by orders of magnitude between runs,
    an unattributed total is nearly meaningless.  Threads report
    concurrently (decode runs on a prefetch thread), so per-stage times
    are busy-time, not exclusive wall slices: overlapped stages sum to
    more than the wall clock, and that surplus is the overlap working.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._times[name] = self._times.get(name, 0.0) + seconds

    def reset(self) -> None:
        with self._lock:
            self._times.clear()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._times)


stage_times = _StageTimes()


def reset_stage_times() -> None:
    stage_times.reset()


def snapshot_stage_times(round_to: int = 2) -> Dict[str, float]:
    return {k: round(v, round_to)
            for k, v in sorted(stage_times.snapshot().items())}


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Accumulate this block's wall time under ``name`` in the
    process-global stage recorder (no device sync — callers time host-side
    busy work; device work should be blocked on inside the block when it
    is the quantity being attributed)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stage_times.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def timed(label: str, logger: Optional[logging.Logger] = None,
          sync: bool = True) -> Iterator[dict]:
    """Wall-clock a block; blocks on outstanding device work first and
    after (asynchronous dispatch otherwise under-reports)."""
    logger = logger or get_logger()
    if sync:
        (jax.device_put(0.0) + 0).block_until_ready()
    info: dict = {}
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        if sync:
            (jax.device_put(0.0) + 0).block_until_ready()
        info["seconds"] = time.perf_counter() - t0
        logger.info("%s: %.3f s", label, info["seconds"])

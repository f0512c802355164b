"""Shared numeric utilities (reference: modules/general_functions.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig

Array = jnp.ndarray

__all__ = [
    "is_broadcastable", "choose_evenly_spaced_points", "predict_output_shape",
    "map_linearity_limits", "interpolate_data", "stage_to_device",
    "set_thread_priority",
]


def set_thread_priority(nice: int) -> bool:
    """Set the CALLING thread's scheduling niceness (Linux: nice values are
    per-task, and ``who=0`` addresses the current thread).

    The video pipeline splits the host's CPU between decode, statistics and
    device-transfer threads; it deprioritizes the transfer threads so that
    decode, its bottleneck, keeps the cores.  Negative niceness needs
    privilege; returns False (no-op) where unsupported.
    """
    import os
    try:
        os.setpriority(os.PRIO_PROCESS, 0, nice)
        return True
    except (AttributeError, OSError, PermissionError):
        return False


def stage_to_device(arr: np.ndarray, max_bytes: int = 128 << 20) -> Array:
    """Host->device transfer chunked along axis 0.

    Large arrays ship as <=``max_bytes`` slices and concatenate on device
    (one device-memory copy).  Whether the chunking pays on a local PCIe
    link is not measured yet (ROADMAP queue 3).
    """
    if arr.nbytes <= max_bytes or arr.shape[0] <= 1:
        return jnp.asarray(arr)
    pieces = int(np.ceil(arr.nbytes / max_bytes))
    pieces = min(pieces, arr.shape[0])
    return jnp.concatenate(
        [jnp.asarray(chunk) for chunk in np.array_split(arr, pieces, axis=0)],
        axis=0)


def is_broadcastable(shape1: Tuple[int, ...], shape2: Tuple[int, ...]) -> bool:
    """NumPy broadcast-compatibility test (general_functions.py:14-24)."""
    if not shape1 or not shape2:
        raise ValueError("Shapes cannot be empty")
    for a, b in zip(shape1[::-1], shape2[::-1]):
        if a == 1 or b == 1 or a == b:
            continue
        return False
    return True


def choose_evenly_spaced_points(array, step_x: int,
                                step_y: Optional[int] = None):
    """Stride-subsample the two leading axes (general_functions.py:27-44)."""
    if step_y is None:
        step_y = step_x
    return array[::step_x, ::step_y, ...]


def predict_output_shape(input_shape: Tuple[int, int], step_x: int,
                         step_y: Optional[int] = None) -> Tuple[int, int]:
    """Output shape of choose_evenly_spaced_points
    (general_functions.py:47-67)."""
    if step_y is None:
        step_y = step_x
    rows, cols = input_shape
    return (rows + step_x - 1) // step_x, (cols + step_y - 1) // step_y


def map_linearity_limits(lower_limit: Optional[int], upper_limit: Optional[int],
                         icrf: Optional[Array],
                         config: CameraConfig) -> Tuple[Array, Array]:
    """Map DN-domain inclusion limits into the linear domain via the ICRF
    (general_functions.py:97-129).

    ``lower_limit``/``upper_limit`` are DN distances from the range edges;
    None falls back to the config's linearity limits.  Without an ICRF the
    limits are normalized to [0,1].
    """
    chs = config.num_of_chs
    if lower_limit is None:
        lower = np.array([config.lower_linearity_limit] * chs, dtype=float)
    else:
        lower = np.array([lower_limit] * chs, dtype=float)
    if upper_limit is None:
        upper = np.array([config.upper_linearity_limit] * chs, dtype=float)
    else:
        upper = np.array([config.max_dn - upper_limit] * chs, dtype=float)

    if icrf is None:
        return (jnp.asarray(lower / config.max_dn),
                jnp.asarray(upper / config.max_dn))

    icrf = jnp.asarray(icrf)
    lo_idx = jnp.asarray(lower.astype(int))
    hi_idx = jnp.asarray(upper.astype(int))
    ch_idx = jnp.arange(chs)
    if icrf.ndim == 1:
        return icrf[lo_idx], icrf[hi_idx]
    return icrf[lo_idx, ch_idx], icrf[hi_idx, ch_idx]


def interpolate_data(clean_data_arr: Array, bits: int,
                     datapoints: int) -> Array:
    """Row-wise resample of a (bits, bits)-style table to ``datapoints``
    columns (general_functions.py:70-94)."""
    if bits == datapoints:
        return clean_data_arr
    x_old = jnp.linspace(0.0, 1.0, bits)
    x_new = jnp.linspace(0.0, 1.0, datapoints)
    rows = [jnp.interp(x_new, x_old, clean_data_arr[i, :])
            for i in range(clean_data_arr.shape[0])]
    return jnp.stack(rows, axis=0)

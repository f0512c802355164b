"""ICRF LUT linearization ops.

The reference maps 8-bit DNs through a per-channel LUT, with the LUT's
derivative scaling the uncertainty (modules/measurand.py:471-541).  Here the
same gather is expressed in jnp; on the GPU the tables (at most a few
hundred KB) stay cache-resident, and the merge hot path does its gathers
inside the fused kernel instead (ops/hdr_triton.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

Array = jnp.ndarray

__all__ = ["dn_indices", "lut_lookup", "linearize", "icrf_derivative",
           "interpolate_curve"]


def dn_indices(val: Array, max_dn: int) -> Array:
    """Quantize [0,1] float values to integer DN indices.

    The reference casts through uint8 (measurand.py:503), which both rounds
    and wraps; we round and clip instead so bit depths beyond 8 work.  For
    8-bit in-range data the two agree exactly.
    """
    if jnp.issubdtype(val.dtype, jnp.integer):
        return val.astype(jnp.int32)
    idx = jnp.round(val * max_dn).astype(jnp.int32)
    return jnp.clip(idx, 0, max_dn)


def lut_lookup(idx: Array, luts: Array) -> Array:
    """Per-channel LUT lookup ``luts[idx[..., c], c]``.

    ``idx``: integer array (..., C); ``luts``: (bits, C).  Returns (..., C).
    """
    return luts[idx, jnp.arange(luts.shape[1])]


def linearize(val: Array, std: Optional[Array], icrf: Array,
              icrf_diff: Optional[Array] = None,
              max_dn: Optional[int] = None) -> Tuple[Array, Optional[Array]]:
    """Apply the ICRF LUT per channel.

    ``icrf`` has shape (bits, C) for multi-channel data whose trailing axis is
    the channel axis, or (bits,) / (bits, 1) for single-channel data
    (measurand.py:487-541).  Uncertainty maps through the LUT derivative:
    std_out = icrf_diff[idx, c] * std.
    """
    if max_dn is None:
        max_dn = icrf.shape[0] - 1
    idx = dn_indices(val, max_dn)

    multi_channel = icrf.ndim == 2 and val.ndim >= 1 and \
        val.shape[-1] == icrf.shape[1] and icrf.shape[1] >= 2
    if multi_channel:
        out = lut_lookup(idx, icrf)
        if std is None or icrf_diff is None:
            return out, None
        return out, lut_lookup(idx, icrf_diff) * std

    lut = icrf if icrf.ndim == 2 else icrf[:, None]
    out = lut_lookup(idx[..., None], lut[:, :1])[..., 0]
    if std is None or icrf_diff is None:
        return out, None
    dlut = icrf_diff if icrf_diff.ndim == 2 else icrf_diff[:, None]
    return out, lut_lookup(idx[..., None], dlut[:, :1])[..., 0] * std


def icrf_derivative(icrf: Array, bits: int) -> Array:
    """Central-difference derivative of an ICRF curve.

    Uses the reference's spacing convention dx = 2/(bits-1)
    (general_functions.py:270, ICRF_calibration_exposure.py:171) — note this
    is twice the [0,1] grid spacing; kept for parity.  Fixes the reference bug
    where read_ICRF_file returns the ICRF itself as its derivative
    (general_functions.py:275).
    """
    dx = 2.0 / (bits - 1)
    return jnp.gradient(icrf, dx, axis=0)


def interpolate_curve(curve: Array, new_points: int) -> Array:
    """Resample a (datapoints, C) or (datapoints,) curve to ``new_points``
    on a uniform [0,1] grid (ICRF_calibration_exposure.py:204-216)."""
    old_points = curve.shape[0]
    if old_points == new_points:
        return curve
    x_new = jnp.linspace(0.0, 1.0, new_points)
    x_old = jnp.linspace(0.0, 1.0, old_points)
    if curve.ndim == 1:
        return jnp.interp(x_new, x_old, curve)
    cols = [jnp.interp(x_new, x_old, curve[:, c])
            for c in range(curve.shape[1])]
    return jnp.stack(cols, axis=1)

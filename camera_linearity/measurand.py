"""Measurand: a value array paired with its uncertainty, as a JAX pytree.

The reference implements this as a mutable dual-backend (NumPy/CuPy) class
hierarchy — AbstractMeasurand / NumpyMeasurand / CupyMeasurand plus an
array_wrapper dispatch layer and a factory
(reference: modules/measurand.py, modules/cupy_measurand.py,
modules/measurand_factory.py, modules/array_wrapper.py).  In JAX the entire
dual-backend design collapses into a single immutable pytree dataclass over
jax.numpy: device placement replaces the np/cp class split, and functional
updates replace in-place mutation (required under jit anyway).

Semantics: ``val`` and ``std`` have identical shapes; ``std`` may be None
(no uncertainty tracking).  The trailing axis is the independent/channel
axis.  All arithmetic propagates uncertainty to first order with the exact
formulas of the reference (see ops/uncertainty.py for per-op citations).

Being a registered pytree, a Measurand passes transparently through jit,
vmap, scan, shard_map and pjit; whether ``std`` is present is part of the
pytree structure, so the compiler specializes each case.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .ops import linearize as lin_ops
from .ops import stats as stats_ops
from .ops import uncertainty as u
from .ops import filters as filt_ops

Array = jnp.ndarray
ScalarType = Union[int, float]
InputType = Union[Array, np.ndarray, ScalarType, "Measurand"]

__all__ = ["Measurand"]


def _as_val_std(other: InputType) -> Tuple[Array, Optional[Array]]:
    if isinstance(other, Measurand):
        return other.val, other.std
    if isinstance(other, (int, float)):
        return jnp.asarray(other, dtype=jnp.result_type(float)), None
    if isinstance(other, (jnp.ndarray, np.ndarray)):
        return jnp.asarray(other), None
    raise TypeError(f"Invalid operand type: {type(other)}")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Measurand:
    """Immutable (value, uncertainty) pair with first-order propagation."""

    val: Array
    std: Optional[Array] = None

    def __post_init__(self):
        # Normalize host scalars/lists at construction; traced arrays pass
        # through untouched.  Mirrors NumpyMeasurand input normalization
        # (measurand.py:695-714).
        val = self.val
        std = self.std
        if isinstance(val, (int, float)):
            object.__setattr__(self, "val", jnp.asarray([float(val)]))
        elif not isinstance(val, jnp.ndarray) and val is not None:
            object.__setattr__(self, "val", jnp.asarray(val))
        if isinstance(std, (int, float)):
            object.__setattr__(self, "std", jnp.asarray([float(std)]))
        elif not isinstance(std, jnp.ndarray) and std is not None:
            object.__setattr__(self, "std", jnp.asarray(std))

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self.val.shape

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def channels(self) -> int:
        """Size of the trailing (independent) axis."""
        return self.val.shape[-1] if self.val.ndim else 1

    def __repr__(self):
        std_shape = None if self.std is None else self.std.shape
        return (f"Measurand(val.shape={tuple(self.val.shape)}, "
                f"std.shape={std_shape})")

    def with_val(self, val: Array) -> "Measurand":
        return dataclasses.replace(self, val=val)

    def with_std(self, std: Optional[Array]) -> "Measurand":
        return dataclasses.replace(self, std=std)

    def zeros_like(self) -> "Measurand":
        """Zero-filled measurand of the same shape (measurand.py:304-316)."""
        return Measurand(jnp.zeros_like(self.val),
                         None if self.std is None
                         else jnp.zeros_like(self.std))

    # reference method name (measurand.py:304)
    zeros_like_measurand = zeros_like

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host copies of (val, std) — the migration shim for the
        reference's measurand_to_numpy (measurand_factory.py:38)."""
        return (np.asarray(self.val),
                None if self.std is None else np.asarray(self.std))

    # --- arithmetic ----------------------------------------------------
    def __add__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.add(self.val, self.std, ov, os))

    __radd__ = __add__

    def __sub__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.sub(self.val, self.std, ov, os))

    def __neg__(self) -> "Measurand":
        return Measurand(*u.neg(self.val, self.std))

    def __mul__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.mul(self.val, self.std, ov, os))

    __rmul__ = __mul__

    def __truediv__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.div(self.val, self.std, ov, os))

    def __pow__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.pow(self.val, self.std, ov, os))

    def log_e(self, compat: str = "corrected") -> "Measurand":
        return Measurand(*u.log_e(self.val, self.std, compat=compat))

    def log_10(self) -> "Measurand":
        return Measurand(*u.log_10(self.val, self.std))

    # --- statistics ----------------------------------------------------
    def compute_dimension_statistics(self, axis=None) -> dict:
        """NaN-aware (inverse-uncertainty-weighted) mean/std/error
        (measurand.py:318-350)."""
        return stats_ops.dimension_statistics(self.val, self.std, axis=axis)

    def compute_channel_histogram(self, bins: int,
                                  included_range: Optional[Tuple[float, float]]
                                  = None,
                                  channels: Optional[List[int]] = None,
                                  use_std: bool = False) -> dict:
        """Per-channel weighted histograms (measurand.py:430-469)."""
        if channels is None:
            channels = list(range(self.channels))
        out = {}
        for c in channels:
            out[c] = stats_ops.weighted_histogram(
                self.val[..., c], bins, included_range,
                self.std[..., c] if (use_std and self.std is not None)
                else None)
        return out

    def compute_kernel_density_estimate(self, data_points: int,
                                        included_range: Optional[
                                            Tuple[float, float]] = None,
                                        channels: Optional[List[int]] = None,
                                        use_std: bool = False) -> dict:
        """Per-channel Gaussian KDE, Silverman bandwidth
        (measurand.py:716-761)."""
        if channels is None:
            channels = list(range(self.channels))
        out = {}
        for c in channels:
            vals = self.val[..., c]
            finite_vals = vals[jnp.isfinite(vals)] if not isinstance(
                vals, jax.core.Tracer) else vals
            if included_range is None:
                lo = float(jnp.nanmin(jnp.where(jnp.isfinite(vals), vals,
                                                jnp.nan)))
                hi = float(jnp.nanmax(jnp.where(jnp.isfinite(vals), vals,
                                                jnp.nan)))
            else:
                lo, hi = included_range
            x_range = jnp.linspace(lo, hi, data_points)
            kde = stats_ops.gaussian_kde(
                vals, x_range,
                self.std[..., c] if (use_std and self.std is not None)
                else None)
            out[c] = (kde, x_range)
            del finite_vals
        return out

    # --- masking / extraction ------------------------------------------
    def apply_thresholds(self, lower=None, upper=None) -> "Measurand":
        """NaN-mask values outside per-channel thresholds.

        Functional counterpart of the reference's in-place variant
        (measurand.py:375-428): returns a new Measurand.  ``lower``/``upper``
        are sequences with one entry per channel; None entries (or None for
        the whole argument) skip that bound.
        """
        c = self.channels
        def norm(bounds, fill):
            if bounds is None:
                return None
            seq = list(bounds) if isinstance(bounds, (list, tuple)) else None
            if seq is not None:
                if len(seq) != c:
                    raise ValueError(
                        "Threshold length must match the independent axis.")
                return jnp.asarray(
                    [fill if b is None else float(b) for b in seq],
                    dtype=self.val.dtype)
            return jnp.asarray(bounds, dtype=self.val.dtype)
        lo = norm(lower, -np.inf)
        hi = norm(upper, np.inf)
        return Measurand(*stats_ops.apply_thresholds(self.val, self.std,
                                                     lo, hi))

    def extract(self, dims: Optional[Union[int, List[int]]] = None,
                axis: int = -1) -> "Measurand":
        """Take slices along ``axis`` (measurand.py:352-373)."""
        target = [dims] if isinstance(dims, int) else dims
        val = jnp.take(self.val, jnp.asarray(target), axis=axis)
        std = None if self.std is None else jnp.take(
            self.std, jnp.asarray(target), axis=axis)
        return Measurand(val, std)

    # --- domain ops ----------------------------------------------------
    def linearize(self, icrf: Array, icrf_diff: Optional[Array] = None,
                  max_dn: Optional[int] = None) -> "Measurand":
        """ICRF LUT linearization (measurand.py:471-541)."""
        return Measurand(*lin_ops.linearize(self.val, self.std, icrf,
                                            icrf_diff, max_dn=max_dn))

    def apply_gaussian_weight(self) -> Tuple[Array, Array]:
        """HDR weighting function and derivative (measurand.py:606-618)."""
        return u.gaussian_weight(self.val)

    def filter_larger_than_by_map(self, map_m: "Measurand",
                                  threshold_value: float,
                                  kernel_size: int = 3) -> "Measurand":
        """Median-replace pixels where ``map_m.val > threshold``
        (measurand.py:543-557, with the masked-assignment bug fixed)."""
        return Measurand(*filt_ops.bad_pixel_filter(
            self.val, self.std, map_m.val, threshold_value, kernel_size))

    def normalize_by_map(self, map_m: "Measurand",
                         mid_percentage: float = 0.05) -> "Measurand":
        """Flat-field correction with 3-term uncertainty
        (measurand.py:559-604)."""
        return Measurand(*filt_ops.flat_field_correction(
            self.val, self.std, map_m.val, map_m.std, mid_percentage))

    # --- static combinators --------------------------------------------
    @staticmethod
    def compute_difference(x: "Measurand", y: "Measurand",
                           multiplier: float
                           ) -> Tuple["Measurand", "Measurand"]:
        """(absolute, relative) scaled difference (measurand.py:620-655)."""
        (av, as_), (rv, rs) = u.scale_difference(x.val, x.std, y.val, y.std,
                                                 multiplier)
        return Measurand(av, as_), Measurand(rv, rs)

    @staticmethod
    def interpolate(x0: "Measurand", x1: "Measurand", y0: float, y1: float,
                    y: float, compat: str = "corrected") -> "Measurand":
        """Linear interpolation between measurands (measurand.py:657-681)."""
        return Measurand(*u.lerp(x0.val, x0.std, x1.val, x1.std, y0, y1, y,
                                 compat=compat))

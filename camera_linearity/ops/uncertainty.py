"""First-order (GUM) uncertainty-propagation primitives.

Pure functions over ``(val, std)`` array pairs, where ``std`` may be ``None``.
These are the jit/vmap-friendly building blocks behind
:class:`camera_linearity.measurand.Measurand` and are reused directly
inside fused kernels.

Formulas mirror the reference implementation exactly
(reference: modules/measurand.py:106-279, 606-681) except where the reference
has documented bugs; those sites take a ``compat`` switch
(``"corrected"`` — proper first-order propagation, the default — or
``"reference"`` — replicate the reference arithmetic bit-for-bit for parity
testing).  See SURVEY.md §7.7.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

Array = jnp.ndarray
ValStd = Tuple[Array, Optional[Array]]

__all__ = [
    "add", "sub", "neg", "mul", "div", "pow", "log_e", "log_10",
    "scale_difference", "lerp", "gaussian_weight",
]


def _zeros_like_if_none(std: Optional[Array], ref: Array) -> Array:
    return jnp.zeros_like(ref) if std is None else std


def _combine(std1: Optional[Array], std2: Optional[Array],
             x1: Array, x2: Array, f1, f2) -> Optional[Array]:
    """sqrt((f1*s1)**2 + (f2*s2)**2) with None-std short circuits."""
    if std1 is None and std2 is None:
        return None
    s1 = _zeros_like_if_none(std1, x1)
    s2 = _zeros_like_if_none(std2, x2)
    return jnp.sqrt((f1 * s1) ** 2 + (f2 * s2) ** 2)


def add(x1: Array, s1: Optional[Array], x2: Array,
        s2: Optional[Array]) -> ValStd:
    """x1 + x2; std = sqrt(s1^2 + s2^2)  (measurand.py:106-128)."""
    val = x1 + x2
    if s1 is None and s2 is None:
        return val, None
    return val, jnp.sqrt(_zeros_like_if_none(s1, x1) ** 2
                         + _zeros_like_if_none(s2, x2) ** 2)


def sub(x1: Array, s1: Optional[Array], x2: Array,
        s2: Optional[Array]) -> ValStd:
    """x1 - x2; std = sqrt(s1^2 + s2^2)  (measurand.py:130-150)."""
    val = x1 - x2
    if s1 is None and s2 is None:
        return val, None
    return val, jnp.sqrt(_zeros_like_if_none(s1, x1) ** 2
                         + _zeros_like_if_none(s2, x2) ** 2)


def neg(x: Array, s: Optional[Array]) -> ValStd:
    """-x; std unchanged  (measurand.py:152-163)."""
    return -x, s


def mul(x1: Array, s1: Optional[Array], x2: Array,
        s2: Optional[Array]) -> ValStd:
    """x1 * x2; std = sqrt((x1 s2)^2 + (x2 s1)^2)  (measurand.py:190-211)."""
    val = x1 * x2
    return val, _combine(s1, s2, x1, x2, x2, x1)


def div(x1: Array, s1: Optional[Array], x2: Array,
        s2: Optional[Array]) -> ValStd:
    """x1 / x2; std = sqrt((s1/x2)^2 + (x1 s2 / x2^2)^2)
    (measurand.py:165-188)."""
    val = x1 / x2
    return val, _combine(s1, s2, x1, x2, 1.0 / x2, x1 / (x2 ** 2))


def pow(x1: Array, s1: Optional[Array], x2: Array,
        s2: Optional[Array]) -> ValStd:  # noqa: A001 - mirrors __pow__
    """x1 ** x2 with std = sqrt((x2 x1^(x2-1) s1)^2 + (ln(x1) x1^x2 s2)^2)
    (measurand.py:217-241)."""
    val = x1 ** x2
    return val, _combine(s1, s2, x1, x2,
                         x2 * x1 ** (x2 - 1.0),
                         jnp.log(x1) * x1 ** x2)


def log_e(x: Array, s: Optional[Array], compat: str = "corrected") -> ValStd:
    """Natural log.

    ``corrected``: std = s / x (first-order propagation of ln).
    ``reference``: std = s / ln(x) — replicates reference bug
    (measurand.py:258; SURVEY.md §7.7).
    """
    val = jnp.log(x)
    if s is None:
        return val, None
    if compat == "reference":
        return val, s / jnp.log(x)
    return val, s / x


def log_10(x: Array, s: Optional[Array]) -> ValStd:
    """Base-10 log; std = s / (x ln 10)  (measurand.py:262-279)."""
    val = jnp.log10(x)
    if s is None:
        return val, None
    return val, s / (x * jnp.log(jnp.asarray(10.0, dtype=x.dtype)))


def scale_difference(x: Array, sx: Optional[Array], y: Array,
                     sy: Optional[Array],
                     multiplier) -> Tuple[ValStd, ValStd]:
    """Absolute and relative scaled difference of two measurands.

    abs = x - m*y;  rel = abs / (m*y), with first-order stds
    (measurand.py:620-655).  Returns ((abs_val, abs_std), (rel_val, rel_std)).
    """
    scale_term = multiplier * y
    abs_val = x - scale_term
    rel_val = abs_val / scale_term

    if sx is None and sy is None:
        return (abs_val, None), (rel_val, None)

    sx_ = 0.0 if sx is None else sx
    sy_ = 0.0 if sy is None else sy
    abs_std = jnp.sqrt(sx_ ** 2 + (multiplier * sy_) ** 2)
    rel_std = jnp.sqrt((sx_ / (multiplier * y)) ** 2
                       + ((sy_ * x) / (multiplier * y ** 2)) ** 2)
    return (abs_val, abs_std), (rel_val, rel_std)


def lerp(x0: Array, s0: Optional[Array], x1: Array, s1: Optional[Array],
         y0: float, y1: float, y: float,
         compat: str = "corrected") -> ValStd:
    """Linear interpolation between two measurands at ordinate ``y``.

    val = (x0 (y1-y) + x1 (y-y0)) / (y1-y0)   (measurand.py:657-681).

    ``corrected``: std = sqrt((a s0)^2 + (b s1)^2) with a=(y1-y)/(y1-y0),
    b=(y-y0)/(y1-y0).  ``reference`` replicates measurand.py:679, which omits
    squaring of the stds.
    """
    a = (y1 - y) / (y1 - y0)
    b = (y - y0) / (y1 - y0)
    val = x0 * a + x1 * b
    if s0 is None and s1 is None:
        return val, None
    s0_ = 0.0 if s0 is None else s0
    s1_ = 0.0 if s1 is None else s1
    if compat == "reference":
        return val, jnp.sqrt(s0_ * a ** 2 + s1_ * b ** 2)
    return val, jnp.sqrt((s0_ * a) ** 2 + (s1_ * b) ** 2)


def gaussian_weight(x: Array) -> Tuple[Array, Array]:
    """HDR merge weighting: w = e^(-30 (x-1/2)^2), dw/dx = -60 (x-1/2) w
    (measurand.py:606-618).  Returns (w, dw)."""
    w = jnp.exp(-30.0 * (x - 0.5) ** 2)
    dw = -60.0 * (x - 0.5) * w
    return w, dw

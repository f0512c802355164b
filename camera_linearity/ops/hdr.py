"""HDR exposure-stack merging with uncertainty propagation.

The reference merges with two Python passes over a list of images — a
sum-of-weights prologue and an accumulation loop, each a chain of NumPy ops
(reference: modules/exposure_series.py:317-397).  Here the stack is a single
``(N, H, W, C)`` device array and both passes are fused into one jitted
computation over the exposure axis; XLA fuses the per-exposure elementwise
chain (weight -> LUT gather -> accumulate) into two reductions over the
exposure axis.  On the GPU the entry points (``merge_hdr``,
``merge_batch``, ``merge_corrected``) run the single-sweep Pallas kernel
of ops/hdr_triton.py instead, which reads the stack once; ``merge_stack``
and ``merge_stack_u8`` are the plain paths, used on every other backend
and as the kernel's reference.

Weight/accumulation semantics (exposure_series.py:382-394):

    w_n, dw_n = gaussian_weight(x_n)         # from the *raw* value image
    g_n, dg_n = linearize(x_n, s_n)          # ICRF LUT + derivative * std
    HDR   = sum_n  w_n g_n / (SW t_n)
    std^2 = sum_n (((dw_n g_n + w_n dg_n)/SW - dw_n w_n g_n/SW^2) * D / t_n)^2

where ``SW = sum_n w_n`` and ``D`` is ``dg_n`` in ``compat='reference'``
mode — replicating exposure_series.py:389 exactly — or the input std ``s_n``
in ``compat='corrected'`` mode (first-order propagation: the bracket is
dHDR/dx_n with dg/dx = icrf'(x), so it must be scaled by the std of x_n, not
by dg_n; SURVEY.md §7.7).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .linearize import dn_indices, lut_lookup
from .uncertainty import gaussian_weight

Array = jnp.ndarray

__all__ = ["sum_of_weights", "merge_stack", "merge_stack_u8", "merge_hdr",
           "merge_corrected", "merge_batch"]


def _use_kernel() -> bool:
    """The single-sweep kernel compiles for the GPU only."""
    return jax.default_backend() == "gpu"


@partial(jax.jit, static_argnames=("compat",))
def merge_batch(batch_val: Array, batch_std: Optional[Array],
                exposures: Array, icrf: Array, icrf_diff: Array,
                compat: str = "corrected"
                ) -> Tuple[Array, Optional[Array]]:
    """Merge a (B, N, H, W, C) batch of scenes in one device call: the
    merge of :func:`merge_hdr`, vmapped over the scene axis (the kernel's
    vmap becomes one more grid axis, so the batch is one launch)."""
    def one(v, s):
        return merge_hdr(v, s, exposures, icrf, icrf_diff, compat=compat)
    if batch_std is None:
        return jax.vmap(lambda v: one(v, None)[0])(batch_val), None
    return jax.vmap(one)(batch_val, batch_std)


def sum_of_weights(stack_val: Array) -> Tuple[Array, Array]:
    """Sum of gaussian weights over the exposure axis and its square
    (exposure_series.py:317-345)."""
    w, _ = gaussian_weight(stack_val)
    sw = jnp.sum(w, axis=0)
    return sw, sw ** 2


def _merge_core(x, idx, stack_std, exposures, icrf, icrf_diff, compat):
    """Shared merge math on normalized values ``x`` and DN indices ``idx``
    (both (N, H, W, C))."""
    dtype = x.dtype
    w_all, dw_all = gaussian_weight(x)
    sw = jnp.sum(w_all, axis=0)
    sw2 = sw ** 2
    t = exposures.astype(dtype).reshape(-1, 1, 1, 1)

    g = lut_lookup(idx, icrf).astype(dtype)
    hdr_val = jnp.sum(w_all * g / (sw * t), axis=0)
    if stack_std is None:
        return hdr_val, None

    dg = lut_lookup(idx, icrf_diff).astype(dtype) * stack_std
    bracket = (dw_all * g + w_all * dg) / sw - (dw_all * w_all * g) / sw2
    scale = dg if compat == "reference" else stack_std
    hdr_var = jnp.sum(((bracket * scale) / t) ** 2, axis=0)
    return hdr_val, jnp.sqrt(hdr_var)


def _chunked_over_rows(core, h, row_chunk, *stacks):
    """Apply ``core`` over (N, row_chunk, W, C) slabs via lax.map, bounding
    the lookup intermediate to one slab at a time.  Rows pad up to a chunk
    multiple; padding is sliced off the result."""
    k = -(-h // row_chunk)
    pad = k * row_chunk - h

    def prep(s):
        if pad:
            s = jnp.pad(s, [(0, 0), (0, pad)] + [(0, 0)] * (s.ndim - 2))
        n = s.shape[0]
        s = s.reshape(n, k, row_chunk, *s.shape[2:])
        return jnp.moveaxis(s, 1, 0)  # (k, N, rc, W, C)

    slabs = tuple(prep(s) for s in stacks)
    out = jax.lax.map(lambda xs: core(*xs), slabs)

    def unchunk(o):
        if o is None:
            return None
        o = o.reshape(k * row_chunk, *o.shape[2:])
        return o[:h] if pad else o

    return tuple(unchunk(o) for o in out)


@partial(jax.jit, static_argnames=("compat", "row_chunk"))
def merge_stack(stack_val: Array, stack_std: Optional[Array],
                exposures: Array, icrf: Array, icrf_diff: Array,
                compat: str = "corrected",
                row_chunk: Optional[int] = None
                ) -> Tuple[Array, Optional[Array]]:
    """Merge a preprocessed ``(N, H, W, C)`` stack into an HDR radiance map.

    ``stack_val`` holds [0,1] float values (dark/bad-pixel corrections are a
    prologue, see models/exposure_series.py); ``exposures`` is ``(N,)``;
    ``icrf``/``icrf_diff`` are ``(bits, C)``.  Returns ``(hdr_val, hdr_std)``
    with ``hdr_std`` None when ``stack_std`` is None.

    ``row_chunk`` > 0 merges the stack in slabs of that many rows
    (``lax.map``), bounding the intermediates to one slab at a time; None
    or 0 merges the whole stack at once.
    """
    h = stack_val.shape[1]
    max_dn = icrf.shape[0] - 1

    if stack_std is None:
        def core(sv):
            return _merge_core(sv, dn_indices(sv, max_dn), None, exposures,
                               icrf, icrf_diff, compat)
        if not row_chunk or row_chunk >= h:
            return core(stack_val)
        (val,) = _chunked_over_rows(lambda sv: (core(sv)[0],), h, row_chunk,
                                    stack_val)
        return val, None

    def core2(sv, ss):
        return _merge_core(sv, dn_indices(sv, max_dn), ss, exposures,
                           icrf, icrf_diff, compat)
    if not row_chunk or row_chunk >= h:
        return core2(stack_val, stack_std)
    return _chunked_over_rows(core2, h, row_chunk, stack_val, stack_std)


@partial(jax.jit, static_argnames=("compat", "row_chunk"))
def merge_stack_u8(stack_dn: Array, stack_std: Optional[Array],
                   exposures: Array, icrf: Array, icrf_diff: Array,
                   compat: str = "corrected",
                   row_chunk: Optional[int] = None
                   ) -> Tuple[Array, Optional[Array]]:
    """Merge directly from an integer-DN stack (the native 8-bit path).

    ``stack_dn``: (N, H, W, C) uint8/int DNs.  Keeping the stack in uint8
    on device cuts HBM read traffic 4x vs pre-normalized float and removes
    the per-pixel round: ``x = dn/max_dn`` exactly reproduces the
    reference's 8-bit load normalization (image_set.py:223), and ``dn`` is
    itself the LUT index.
    """
    h = stack_dn.shape[1]
    max_dn = icrf.shape[0] - 1
    dtype = icrf.dtype if jnp.issubdtype(icrf.dtype, jnp.floating) \
        else jnp.float32

    def to_x(dn):
        idx = dn.astype(jnp.int32)
        return idx.astype(dtype) * (1.0 / max_dn), idx

    if stack_std is None:
        def core(dn):
            x, idx = to_x(dn)
            return _merge_core(x, idx, None, exposures, icrf, icrf_diff,
                               compat)
        if not row_chunk or row_chunk >= h:
            return core(stack_dn)
        (val,) = _chunked_over_rows(lambda dn: (core(dn)[0],), h, row_chunk,
                                    stack_dn)
        return val, None

    def core2(dn, ss):
        x, idx = to_x(dn)
        return _merge_core(x, idx, ss, exposures, icrf, icrf_diff, compat)
    if not row_chunk or row_chunk >= h:
        return core2(stack_dn, stack_std)
    return _chunked_over_rows(core2, h, row_chunk, stack_dn, stack_std)


@partial(jax.jit, static_argnames=("compat", "kernel_size",
                                   "mid_percentage"))
def merge_corrected(stack_val: Array, stack_std: Optional[Array],
                    dark_stack: Array, exposures: Array, icrf: Array,
                    icrf_diff: Array, dark_threshold: Array,
                    flat_val: Optional[Array] = None,
                    flat_std: Optional[Array] = None,
                    mid_percentage: float = 0.05,
                    compat: str = "corrected", kernel_size: int = 3
                    ) -> Tuple[Array, Optional[Array]]:
    """Corrections-fused merge: bad-pixel prologue -> merge -> flat epilogue
    in ONE jitted computation (BASELINE config 3; reference runs the
    prologue as a per-image Python pass, exposure_series.py:371-381, and
    the epilogue as a separate call, :415-417).

    ``dark_stack`` is (N, H, W, C) of per-exposure dark frames — all-zero
    planes for exposures without a matched dark (the repair is then an
    exact no-op, like the reference's skip) — OR a precomputed uint8
    hot-pixel mask (``ops.filters.hot_pixel_mask``; darks are fixed
    calibration data, so the mask is computed once and stages at a
    quarter of the bytes).

    On the GPU with the reference's 3x3 window the repair runs inside the
    merge kernel (ops/hdr_triton.py), so the stack is read once; elsewhere
    the median repair runs vmapped over the exposure axis ahead of the
    plain merge.
    """
    from .filters import bad_pixel_filter, flat_field_correction
    # merge_corrected's documented contract: an integer-dtype dark_stack
    # IS a precomputed hot-pixel mask (hot_pixel_mask); float dark frames
    # compare against the threshold
    dark_is_mask = bool(jnp.issubdtype(dark_stack.dtype, jnp.integer))
    if _use_kernel() and kernel_size == 3:
        from .hdr_triton import merge_fused
        hdr_val, hdr_std = merge_fused(
            stack_val, stack_std, exposures, icrf, icrf_diff, compat=compat,
            hot=dark_stack, threshold=None if dark_is_mask else dark_threshold)
    else:
        if stack_std is None:
            fixed_val = jax.vmap(
                lambda v, d: bad_pixel_filter(v, None, d, dark_threshold,
                                              kernel_size, dark_is_mask)[0])(
                stack_val, dark_stack)
            fixed_std = None
        else:
            fixed_val, fixed_std = jax.vmap(
                lambda v, s, d: bad_pixel_filter(v, s, d, dark_threshold,
                                                 kernel_size, dark_is_mask))(
                stack_val, stack_std, dark_stack)
        hdr_val, hdr_std = merge_hdr(fixed_val, fixed_std, exposures, icrf,
                                     icrf_diff, compat=compat)
    if flat_val is not None:
        hdr_val, hdr_std = flat_field_correction(hdr_val, hdr_std, flat_val,
                                                 flat_std, mid_percentage)
    return hdr_val, hdr_std


def merge_hdr(stack_val: Array, stack_std: Optional[Array], exposures: Array,
              icrf: Array, icrf_diff: Array, compat: str = "corrected"
              ) -> Tuple[Array, Optional[Array]]:
    """Merge an (N, H, W, C) stack of float values or integer DNs.

    On the GPU this is the single-sweep kernel (ops/hdr_triton.py); on
    other backends the plain path (:func:`merge_stack`, or
    :func:`merge_stack_u8` for integer stacks).  Both compute the same
    math; the tests hold each to the float64 NumPy oracle.
    """
    if _use_kernel():
        from .hdr_triton import merge_fused
        return merge_fused(stack_val, stack_std, exposures, icrf, icrf_diff,
                           compat=compat)
    if jnp.issubdtype(stack_val.dtype, jnp.integer):
        return merge_stack_u8(stack_val, stack_std, exposures, icrf,
                              icrf_diff, compat=compat)
    return merge_stack(stack_val, stack_std, exposures, icrf, icrf_diff,
                       compat=compat)

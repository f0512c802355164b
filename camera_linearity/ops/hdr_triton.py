"""Single-sweep HDR merge kernel for NVIDIA GPUs (Pallas, Triton route).

XLA compiles the plain merge (:func:`ops.hdr.merge_stack`) into two
fusions: one reduces the sum of weights over the exposure axis, the next
re-reads the value stack to accumulate the HDR value and variance.  Here
one program owns a tile of elements across all N exposures and reads it
from device memory once (its second look at the tile hits the cache):
per element it moves N x (value + std) in and (value + std) out.  The ICRF lookups are gathers from the flattened
``(bits * C,)`` tables, which stay resident in L1/L2.

The optional hot-pixel prologue (``hot``) repairs flagged elements with
the 3x3 median of their spatial neighbourhood before the merge, like
:func:`ops.filters.bad_pixel_filter` with ``kernel_size=3``: neighbour
loads are masked to the flagged lanes, so the repair costs reads only
where a pixel is hot.

Math and semantics are :func:`ops.hdr.merge_stack`'s; the tests check the
kernel in interpret mode against that path and the float64 NumPy oracle.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .filters import _MEDIAN9_NET

Array = jnp.ndarray

__all__ = ["merge_fused"]

# Elements per program, and warps per program without / with the
# hot-pixel prologue: the fastest of 256-2048 elements x 4 or 8 warps at
# the BASELINE config-2 and config-3 widths on an H100 (docs/kernel_design.md).
_BLOCK = 256
_NUM_WARPS = (4, 8)


def _round_half_even(y):
    """``jnp.round`` for y >= 0, from floor alone (Triton has no rint)."""
    r = jnp.floor(y)
    frac = y - r
    odd = (r - 2.0 * jnp.floor(0.5 * r)) == 1.0
    up = (frac > 0.5) | ((frac == 0.5) & odd)
    return jnp.where(up, r + 1.0, r)


def _median9(vals):
    vals = list(vals)
    for a, b in _MEDIAN9_NET:
        vals[a], vals[b] = (jnp.minimum(vals[a], vals[b]),
                            jnp.maximum(vals[a], vals[b]))
    return vals[4]


def _kernel(*refs, n, c, h, wc, max_dn, has_std, compat, prologue,
            dark_is_mask, dtype):
    it = iter(refs)
    val_ref = next(it)
    std_ref = next(it) if has_std else None
    if prologue:
        dark_ref = next(it)
        thr_ref = next(it)
    t_ref = next(it)
    tab_ref = next(it)
    dtab_ref = next(it) if has_std else None
    out_val_ref = next(it)
    out_std_ref = next(it) if has_std else None

    size = h * wc
    offs = pl.program_id(0) * _BLOCK + jnp.arange(_BLOCK)
    inb = offs < size
    ch = offs % c
    integer_in = jnp.issubdtype(val_ref.dtype, jnp.integer)

    if prologue:
        thr = thr_ref[0]

    def nbrs():
        # 3x3 neighbourhood, symmetric padding by one: an edge pixel is
        # its own out-of-range neighbour.  Recomputed per use, so no
        # index array stays live across exposures.
        row = offs // wc
        col = offs % wc
        for dy in (-1, 0, 1):
            r = jnp.clip(row + dy, 0, h - 1) * wc
            for dx in (-c, 0, c):
                yield r + jnp.where((col + dx < 0) | (col + dx >= wc), col,
                                    col + dx)

    def load_val(k):
        v = plt.load(val_ref.at[k, offs], mask=inb, other=0)
        if not prologue:
            return v, None
        d = plt.load(dark_ref.at[k, offs], mask=inb, other=0)
        hot = ((d != 0) if dark_is_mask else (d > thr)) & inb
        return jnp.where(hot, _median9(
            plt.load(val_ref.at[k, q], mask=hot, other=0)
            for q in nbrs()), v), hot

    def load_std(k, hot):
        s = plt.load(std_ref.at[k, offs], mask=inb, other=0)
        if prologue:
            s = jnp.where(hot, _median9(
                plt.load(std_ref.at[k, q], mask=hot, other=0)
                for q in nbrs()), s)
        return s.astype(dtype)

    def weights(v):
        if integer_in:
            idx = v.astype(jnp.int32)
            x = idx.astype(dtype) * (1.0 / max_dn)
        else:
            x = v.astype(dtype)
            idx = jnp.clip(_round_half_even(x * max_dn), 0, max_dn
                           ).astype(jnp.int32)
        w = jnp.exp(-30.0 * (x - 0.5) ** 2)
        return w, -60.0 * (x - 0.5) * w, idx * c + ch

    # Pass 1 reduces the sum of weights; pass 2 re-reads the block's
    # exposures (from cache: the block read them an instant ago) and
    # accumulates.  Only the running sums stay live across exposures,
    # which keeps the program's registers from spilling.
    sw = jnp.zeros((_BLOCK,), dtype)
    for k in range(n):
        sw = sw + weights(load_val(k)[0])[0]
    sw2 = sw * sw
    acc_val = jnp.zeros_like(sw)
    acc_var = jnp.zeros_like(sw)
    for k in range(n):
        v, hot = load_val(k)
        w, dw, q = weights(v)
        t = t_ref[k].astype(dtype)
        g = plt.load(tab_ref.at[q], mask=inb, other=0).astype(dtype)
        acc_val = acc_val + w * g / (sw * t)
        if has_std:
            s = load_std(k, hot)
            fprime = plt.load(dtab_ref.at[q], mask=inb,
                              other=0).astype(dtype)
            dg = fprime * s
            bracket = (dw * g + w * dg) / sw - (dw * w * g) / sw2
            scale = dg if compat == "reference" else s
            term = bracket * scale / t
            acc_var = acc_var + term * term
    plt.store(out_val_ref.at[offs], acc_val, mask=inb)
    if has_std:
        plt.store(out_std_ref.at[offs], jnp.sqrt(acc_var), mask=inb)


@partial(jax.jit, static_argnames=("compat", "interpret"))
def merge_fused(stack_val: Array, stack_std: Optional[Array],
                exposures: Array, icrf: Array, icrf_diff: Array,
                compat: str = "corrected", hot: Optional[Array] = None,
                threshold=None, interpret: bool = False
                ) -> Tuple[Array, Optional[Array]]:
    """Merge an ``(N, H, W, C)`` stack in one pass over device memory.

    Same contract as :func:`ops.hdr.merge_stack` (float values in [0, 1]
    or integer DNs, ``icrf``/``icrf_diff`` of shape ``(bits, C)``).  With
    ``hot`` (an ``(N, H, W, C)`` map of dark frames, compared against
    ``threshold``, or an integer hot-pixel mask when ``threshold`` is
    None) the flagged elements are first replaced by their 3x3 median.

    Compiles for the GPU only; ``interpret=True`` runs the kernel in the
    Pallas interpreter, which is how the tests reach it on the CPU.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError("merge_fused is a GPU kernel; use "
                           "ops.hdr.merge_stack on other backends")
    n, h, w, c = stack_val.shape
    wc = w * c
    has_std = stack_std is not None
    prologue = hot is not None
    dtype = icrf.dtype if jnp.issubdtype(icrf.dtype, jnp.floating) \
        else jnp.float32
    args = [stack_val.reshape(n, h * wc)]
    if has_std:
        args.append(stack_std.reshape(n, h * wc))
    dark_is_mask = False
    if prologue:
        dark_is_mask = threshold is None
        thr = jnp.zeros((1,), dtype) if dark_is_mask else \
            jnp.asarray(threshold, hot.dtype).reshape(1)
        args += [hot.reshape(n, h * wc), thr]
    args += [exposures.astype(dtype), icrf.astype(dtype).reshape(-1)]
    if has_std:
        args.append(icrf_diff.astype(dtype).reshape(-1))
    out_shape = [jax.ShapeDtypeStruct((h * wc,), dtype)] * (2 if has_std
                                                            else 1)
    kernel = partial(_kernel, n=n, c=c, h=h, wc=wc,
                     max_dn=icrf.shape[0] - 1, has_std=has_std,
                     compat=compat, prologue=prologue,
                     dark_is_mask=dark_is_mask, dtype=dtype)
    outs = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(pl.cdiv(h * wc, _BLOCK),),
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS[prologue],
                                           num_stages=1),
        backend="triton", interpret=interpret, name="hdr_merge_fused",
    )(*args)
    val = outs[0].reshape(h, w, c)
    return val, (outs[1].reshape(h, w, c) if has_std else None)

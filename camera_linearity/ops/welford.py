"""Streaming Welford mean/variance over frame batches.

The reference updates mean/M2 one frame at a time in a Python loop
(reference: modules/video_processing.py:161-219).  Here the numerically
identical update (same operation order) runs as a ``lax.scan`` over
device-resident frame batches: the host decodes and stages B frames, one
jitted scan consumes them.  State is a pytree, so the scan nests under jit,
vmap (batch of scenes) and shard_map (spatial sharding) unchanged.
"""
from __future__ import annotations


from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

__all__ = ["WelfordState", "welford_init", "welford_update",
           "welford_update_batch", "welford_update_batch_lut",
           "welford_finalize"]


class WelfordState(NamedTuple):
    count: Array   # () int32 - frames consumed
    mean: Array    # (H, W, C)
    m2: Array      # (H, W, C)


def welford_init(shape, dtype=jnp.float32) -> WelfordState:
    return WelfordState(count=jnp.zeros((), jnp.int32),
                        mean=jnp.zeros(shape, dtype),
                        m2=jnp.zeros(shape, dtype))


def welford_update(state: WelfordState, frame: Array) -> WelfordState:
    """One frame: delta = x - mean; mean += delta/n; m2 += delta*(x - mean)
    (video_processing.py:206-208, exact order)."""
    count = state.count + 1
    delta = frame - state.mean
    mean = state.mean + delta / count.astype(frame.dtype)
    m2 = state.m2 + delta * (frame - mean)
    return WelfordState(count=count, mean=mean, m2=m2)


@jax.jit
def welford_update_batch(state: WelfordState, frames: Array) -> WelfordState:
    """Consume a (B, H, W, C) batch with a scan (order-identical to the
    frame-by-frame loop).  The state buffers are not donated."""
    return jax.lax.scan(lambda s, f: (welford_update(s, f), None),
                        state, frames)[0]


@partial(jax.jit, static_argnames=("max_dn",))
def welford_update_batch_lut(state: WelfordState, frames_dn: Array,
                             icrf: Array, max_dn: int) -> WelfordState:
    """Consume a (B, H, W, C) integer-DN batch, linearizing each frame
    through the ICRF LUT INSIDE the scan body (reference applies the LUT
    per frame before its update, video_processing.py:200-208).

    One jit for lookup + update means the linearized float frames are
    never materialized as a (B, H, W, C) HBM intermediate between two
    programs — each scan step's lookup feeds the update directly — and the
    batch crosses host->device as uint8 (4x less link traffic than staging
    pre-linearized floats).
    """
    from .linearize import linearize

    def step(s, f):
        x, _ = linearize(f.astype(jnp.int32), None, icrf, max_dn=max_dn)
        return welford_update(s, x.astype(s.mean.dtype)), None

    return jax.lax.scan(step, state, frames_dn)[0]


def welford_finalize(state: WelfordState, use_std: bool = True
                     ) -> Tuple[Array, Optional[Array]]:
    """mean and the std of the mean: sqrt(m2/(n-1))/sqrt(n)
    (video_processing.py:210-215)."""
    if not use_std:
        return state.mean, None
    n = state.count.astype(state.mean.dtype)
    std_of_mean = jnp.sqrt(state.m2 / (n - 1.0)) / jnp.sqrt(n)
    return state.mean, std_of_mean

"""Sharded pipeline variants: multi-device merge, statistics and calibration.

Two complementary styles:

* **GSPMD (jit + shardings)** for the compute-dense paths — the HDR merge is
  elementwise over pixels, so sharding the row axis needs no communication
  at all and XLA partitions the fused kernel for free.
* **shard_map + explicit collectives** for the reductions — pair statistics
  reduce over the sharded pixel axes, so local NaN-aware partial sums
  combine with ``psum`` across devices, mirroring how the reference's
  ``compute_dimension_statistics`` (measurand.py:318-350) would have to
  behave across devices.

The DE calibration shards its population axis: trial generation and energy
evaluation are population-parallel; only argmin/mean/std of the (S,)
energies cross devices per generation (a few scalars).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import hdr as hdr_ops

Array = jnp.ndarray

__all__ = ["merge_batch_sharded", "dimension_statistics_sharded",
           "pair_stats_sharded"]


def merge_batch_sharded(batch_val: Array, batch_std: Optional[Array],
                        exposures: Array, icrf: Array, icrf_diff: Array,
                        mesh: Mesh, compat: str = "corrected"
                        ) -> Tuple[Array, Optional[Array]]:
    """HDR-merge a (B, N, H, W, C) batch of scenes across the mesh.

    Scenes shard over ``data``, rows over ``pixel`` (BASELINE config 5's
    batch-of-scenes axis).  The merge is pointwise over pixels, so the
    partitioned program has zero communication.  Each device merges its
    local (B_loc, N, H_loc, W, C) block with ops/hdr.merge_batch; that is
    a Pallas kernel on the GPU, which a GSPMD jit cannot partition, hence
    the ``shard_map``.
    """
    in_spec = P("data", None, "pixel", None, None)
    out_spec = P("data", "pixel", None, None)
    # check_vma=False: the Pallas kernel's outputs carry no varying-axes
    # annotation
    smap = partial(jax.shard_map, mesh=mesh, check_vma=False)

    if batch_std is None:
        @partial(smap, in_specs=(in_spec, P(), P(), P()), out_specs=out_spec)
        def run_v(bv, ex, a, b):
            return hdr_ops.merge_batch(bv, None, ex, a, b, compat=compat)[0]
        return run_v(batch_val, exposures, icrf, icrf_diff), None

    @partial(smap, in_specs=(in_spec, in_spec, P(), P(), P()),
             out_specs=(out_spec, out_spec))
    def run(bv, bs, ex, a, b):
        return hdr_ops.merge_batch(bv, bs, ex, a, b, compat=compat)

    return run(batch_val, batch_std, exposures, icrf, icrf_diff)


def dimension_statistics_sharded(val: Array, std: Optional[Array],
                                 mesh: Mesh, axis_name: str = "pixel"):
    """NaN-aware (weighted) mean/std/error over the leading (sharded) axis
    with explicit psum collectives.

    Equivalent to ops.stats.dimension_statistics(axis=(0, 1)) on a
    (H, W, C) array whose H axis is sharded over ``axis_name``: each device
    reduces its local rows, then the partial sums combine across devices.
    """
    spec_in = P(axis_name, None, None)

    if std is None:
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(spec_in,), out_specs=(P(), P(), P()))
        def stats(v):
            finite = jnp.isfinite(v)
            n = jax.lax.psum(jnp.sum(finite, axis=(0, 1)), axis_name)
            s1 = jax.lax.psum(
                jnp.sum(jnp.where(finite, v, 0.0), axis=(0, 1)), axis_name)
            s2 = jax.lax.psum(
                jnp.sum(jnp.where(finite, v * v, 0.0), axis=(0, 1)),
                axis_name)
            mean = s1 / n
            var = s2 / n - mean ** 2
            return mean, jnp.sqrt(jnp.maximum(var, 0.0)), mean * jnp.nan

        mean, spread, _ = stats(val)
        return {"mean": mean, "std": spread, "error": None}

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_in, spec_in), out_specs=(P(), P(), P()))
    def stats(v, s):
        finite = jnp.isfinite(v) & jnp.isfinite(s)
        w = jnp.where(finite, 1.0 / s, 0.0)
        sw = jax.lax.psum(jnp.sum(w, axis=(0, 1)), axis_name)
        swv = jax.lax.psum(jnp.sum(jnp.where(finite, w * v, 0.0),
                                   axis=(0, 1)), axis_name)
        mean = swv / sw
        swd = jax.lax.psum(
            jnp.sum(jnp.where(finite, w * (v - mean) ** 2, 0.0),
                    axis=(0, 1)), axis_name)
        spread = jnp.sqrt(swd / sw)
        n = jax.lax.psum(jnp.sum(finite, axis=(0, 1)), axis_name)
        s_sum = jax.lax.psum(jnp.sum(jnp.where(finite, s, 0.0),
                                     axis=(0, 1)), axis_name)
        return mean, spread, s_sum / n

    mean, spread, error = stats(val, std)
    return {"mean": mean, "std": spread, "error": error}


def pair_stats_sharded(short_val: Array, long_val: Array,
                       short_std: Optional[Array],
                       long_std: Optional[Array], ratio: float,
                       mesh: Mesh, axis_name: str = "pixel"):
    """Sharded absolute/relative exposure-pair statistics.

    The elementwise difference stays local to each device's rows; only the
    statistics reduce (exposure_series.py:443-446 across devices).
    """
    from ..ops.uncertainty import scale_difference
    (av, astd), (rv, rstd) = scale_difference(
        short_val, short_std, long_val, long_std, ratio)
    return (dimension_statistics_sharded(av, astd, mesh, axis_name),
            dimension_statistics_sharded(rv, rstd, mesh, axis_name))

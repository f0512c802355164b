"""Device-mesh construction and sharding helpers.

The reference's only parallelism is joblib processes across color channels
(reference: modules/ICRF_calibration_exposure.py:383-386) and optional CuPy
offload.  Here jax.sharding replaces both: a mesh with a ``data`` axis
(batch of scenes) and a ``pixel`` axis (spatial rows), XLA inserting the
collectives (NCCL between GPUs) from sharding annotations.  These
helpers centralize mesh/axis conventions for the sharded pipelines in
parallel/sharded.py.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_pixel_mesh", "shard_scene_stack",
           "shard_batch_of_scenes", "replicate"]


def make_mesh(axis_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Mesh over the available devices; defaults to a 1-D ``data`` axis of
    all devices.

    Axis types are forced to Auto (classic GSPMD propagation) — jax 0.9's
    default Explicit mode requires sharding-in-types support from every op
    and breaks gather-style indexing on sharded operands.
    """
    devices = jax.devices()
    if axis_shape is None:
        axis_shape = (len(devices),)
    axis_names = tuple(axis_names)
    return jax.make_mesh(
        axis_shape, axis_names,
        axis_types=(jax.sharding.AxisType.Auto,) * len(axis_names))


def data_pixel_mesh(n_data: Optional[int] = None,
                    n_pixel: Optional[int] = None) -> Mesh:
    """2-D mesh (data, pixel): scenes shard over ``data``, image rows over
    ``pixel``."""
    n = len(jax.devices())
    if n_data is None and n_pixel is None:
        # favor the pixel axis; scenes may be few
        n_data, n_pixel = 1, n
    elif n_data is None:
        n_data = n // n_pixel
    elif n_pixel is None:
        n_pixel = n // n_data
    return jax.make_mesh(
        (n_data, n_pixel), ("data", "pixel"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)


def shard_scene_stack(stack, mesh: Mesh, row_axis: str = "pixel"):
    """Shard an (N, H, W, C) exposure stack over image rows."""
    spec = P(None, row_axis, None, None)
    return jax.device_put(stack, NamedSharding(mesh, spec))


def shard_batch_of_scenes(batch, mesh: Mesh):
    """Shard a (B, N, H, W, C) batch: scenes over ``data``, rows over
    ``pixel``."""
    spec = P("data", None, "pixel", None, None)
    return jax.device_put(batch, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))

"""Unit tests for parallel.distributed's helpers in single-process mode.

The real 2-process flow (jax.distributed wiring, Gloo collectives, cross-process
scene sharding) is validated end to end by
tests/integration/test_distributed.py; these cover the helper logic —
mesh shape, block assignment, the global-batch round trip — on the
8-device virtual mesh where it degrades to (1, n_devices).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.parallel import distributed as dist

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def test_scene_mesh_single_process_shape():
    mesh = dist.scene_mesh()
    assert dict(mesh.shape) == {"data": 1, "pixel": len(jax.devices())}
    # behaves like data_pixel_mesh(1, n): every device on the pixel axis
    assert len(set(np.asarray(mesh.devices).ravel())) == len(jax.devices())


def test_local_scene_block_owns_everything_single_process():
    mesh = dist.scene_mesh()
    assert dist.local_scene_block(6, mesh) == slice(0, 6)


def test_local_scene_block_rejects_uneven_split():
    mesh = jax.make_mesh((2, 4), ("data", "pixel"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with pytest.raises(ValueError, match="shard evenly"):
        dist.local_scene_block(3, mesh)
    # single process owns BOTH data rows -> the whole contiguous range
    assert dist.local_scene_block(4, mesh) == slice(0, 4)


def test_global_batch_roundtrip(rng):
    """global_scene_batch -> sharded array -> fetch_local_scenes is the
    identity on this process's block (single process: the whole batch)."""
    mesh = dist.scene_mesh()
    local = rng.uniform(0, 1, (4, 3, 8, 8, 3))
    garr = dist.global_scene_batch(local, mesh, 4)
    assert garr.shape == (4, 3, 8, 8, 3)
    # scenes over data, rows over pixel
    spec = garr.sharding.spec
    assert spec[0] == "data" and spec[2] == "pixel"
    back = dist.fetch_local_scenes(garr, mesh, slice(0, 4))
    np.testing.assert_array_equal(back, local)


def test_initialize_noop_without_configuration(monkeypatch):
    """With no args and no CL_* env, initialize() is a no-op returning
    False — library users pay nothing for the multi-host capability."""
    for var in ("CL_COORDINATOR_ADDRESS", "CL_NUM_PROCESSES",
                "CL_PROCESS_ID", "CL_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False
    assert jax.process_count() == 1

"""Multi-process entry point: jax.distributed wiring + process-aware meshes.

SURVEY §5 names the reference's only cross-worker parallelism — joblib
processes across color channels (reference
ICRF_calibration_exposure.py:383-386).  Here the equivalent is
``jax.distributed.initialize`` plus XLA collectives (NCCL between GPUs),
with BASELINE config 5's batch-of-scenes axis laid over processes.

Two layouts:

* **One process, all local GPUs** (the common case, and the one for a
  single host whose GPUs NVLink joins all to all): no initialization at
  all; :func:`scene_mesh` is ``(1, n_devices)`` and pipelines shard
  scenes or rows over the local devices as they choose.
* **Several processes** (several hosts, or one process per GPU): every
  process calls :func:`initialize` with an explicit coordinator address,
  process count and process id — nothing discovers a cluster on its own.
  :func:`scene_mesh` is then ``(data, pixel)`` with ``data`` spanning the
  processes and ``pixel`` the devices local to each.  Scenes shard as
  contiguous blocks over ``data``; each process decodes ONLY its own
  block (host-local IO) and feeds it in as the process-local shard of
  one global array.

Initialization must happen before any other jax API touches the backend;
call :func:`initialize` first thing in worker ``main``s.
tests/integration/test_distributed.py runs the multi-process flow with
two localhost CPU processes.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "shutdown", "is_initialized", "scene_mesh",
           "local_scene_block", "global_scene_batch", "fetch_local_scenes"]

_INITIALIZED = False

_ENV_COORD = "CL_COORDINATOR_ADDRESS"
_ENV_NPROC = "CL_NUM_PROCESSES"
_ENV_PID = "CL_PROCESS_ID"
_ENV_LOCAL_DEVICES = "CL_LOCAL_DEVICE_IDS"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> bool:
    """Join (or skip joining) a multi-process jax runtime; idempotent.

    Resolution order per argument: explicit parameter, then environment
    (``CL_COORDINATOR_ADDRESS`` / ``CL_NUM_PROCESSES`` / ``CL_PROCESS_ID``
    / ``CL_LOCAL_DEVICE_IDS`` as a comma list).  A multi-process run must
    give all three of address, count and id (e.g. ``localhost:<port>``
    on one host).  With NO configuration anywhere this is a no-op —
    single-process mode, the common case — so library users pay nothing
    for the multi-process capability.

    Must run before any jax call that initializes the backend.  Returns
    True when the runtime is multi-process after the call.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get(_ENV_COORD)
    if num_processes is None and env.get(_ENV_NPROC):
        num_processes = int(env[_ENV_NPROC])
    if process_id is None and env.get(_ENV_PID):
        process_id = int(env[_ENV_PID])
    if local_device_ids is None and env.get(_ENV_LOCAL_DEVICES):
        local_device_ids = [int(x) for x in
                            env[_ENV_LOCAL_DEVICES].split(",") if x]
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return False
    if any(v is None for v in given):
        raise ValueError("multi-process initialization needs a coordinator "
                         "address, a process count and a process id; got "
                         f"{given}")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _INITIALIZED = True
    return jax.process_count() > 1


def is_initialized() -> bool:
    return _INITIALIZED


def shutdown() -> None:
    global _INITIALIZED
    if _INITIALIZED:
        jax.distributed.shutdown()
        _INITIALIZED = False


def scene_mesh() -> Mesh:
    """The canonical ``(data, pixel)`` scene mesh.

    ``data`` spans the processes (length ``jax.process_count()``),
    ``pixel`` the devices within each process.  Single-process, this is
    ``(1, n_devices)`` — identical semantics to
    parallel.mesh.data_pixel_mesh, so pipelines written against this mesh
    run unchanged from one GPU to several hosts.
    """
    nproc = jax.process_count()
    local = jax.local_device_count()
    # row p = the devices of process p, in device-id order
    devs = np.asarray(sorted(jax.devices(),
                             key=lambda d: (d.process_index, d.id))
                      ).reshape(nproc, local)
    return Mesh(devs, ("data", "pixel"),
                axis_types=(jax.sharding.AxisType.Auto,) * 2)


def local_scene_block(n_scenes: int, mesh: Mesh) -> slice:
    """The contiguous block of scene indices THIS process owns when the
    scene axis shards over ``data``.

    Block (not round-robin) assignment, because that is how a
    ``PartitionSpec("data", ...)`` sharding lays the axis out across the
    mesh's device order — the decode work each process does is exactly the
    shard :func:`global_scene_batch` expects from it.
    """
    n_data = mesh.shape["data"]
    if n_scenes % n_data:
        raise ValueError(
            f"{n_scenes} scenes do not shard evenly over the {n_data}-way "
            "data axis; pad the batch or choose a divisor mesh")
    per = n_scenes // n_data
    # which data-axis coordinate(s) are local to this process?  With the
    # scene_mesh layout each process owns exactly one data row, but derive
    # it from the mesh rather than assuming (supports data axes wider than
    # the process count on a single host).
    pid = jax.process_index()
    rows = sorted({i for i in range(n_data)
                   if any(d.process_index == pid
                          for d in np.asarray(mesh.devices)[i].ravel())})
    if len(rows) == 1:
        return slice(rows[0] * per, (rows[0] + 1) * per)
    if rows == list(range(rows[0], rows[0] + len(rows))):
        return slice(rows[0] * per, (rows[0] + len(rows)) * per)
    raise ValueError("this process's data-axis rows are non-contiguous; "
                     "scene blocks cannot be expressed as one slice")


def global_scene_batch(local_val: np.ndarray, mesh: Mesh,
                       n_scenes: int) -> jax.Array:
    """Assemble the global (B, N, H, W, C) scene batch from this process's
    host-local block (its decoded scenes), sharded scenes-over-``data``
    and rows-over-``pixel``.

    The host->device transfer is purely local (each process uploads only
    the bytes its own devices hold); no cross-process data movement
    happens here or in the zero-communication merge that follows.
    """
    spec = P("data", None, "pixel", None, None)
    global_shape = (n_scenes,) + tuple(local_val.shape[1:])
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_val, global_shape)


def fetch_local_scenes(global_out: jax.Array, mesh: Mesh,
                       block: slice) -> np.ndarray:
    """Materialize THIS process's merged scenes as one host array.

    The merge output shards (data, pixel, ...); regathering the row axis
    is an all-gather among the process's own devices (the scene axis stays
    put), after which every local device holds a replica of the process's
    full scene block.
    """
    spec = P("data", *([None] * (global_out.ndim - 1)))
    gathered = jax.device_put(global_out, NamedSharding(mesh, spec))
    shards = {s.index[0].start or 0: s.data
              for s in gathered.addressable_shards}
    per = (block.stop - block.start) // max(1, len(shards))
    ordered = [np.asarray(shards[k]) for k in sorted(shards)]
    out = np.concatenate(ordered, axis=0)
    if out.shape[0] != block.stop - block.start:
        raise AssertionError(
            f"addressable scene block {out.shape[0]} != owned block "
            f"{block.stop - block.start} (per-shard {per})")
    return out

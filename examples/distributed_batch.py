"""Multi-process batch video->HDR walkthrough (BASELINE config 5 at scale).

Demonstrates the multi-process flow of ``parallel.distributed``: every
process runs THIS SAME script; the scene batch shards as contiguous
blocks over the mesh's ``data`` (process) axis, each process decodes only its
own block host-locally, the merge executes as one globally-sharded
computation with zero cross-scene communication, and each process gets
its own scenes' HDR results back.

Run it three ways:

1. Single process (the degenerate case — behaves exactly like
   ``batch_video_to_hdr``)::

       python examples/distributed_batch.py /tmp/dist_demo

2. Two processes on one machine (CPU backend, like the integration
   test)::

       CL_COORDINATOR_ADDRESS=localhost:9911 CL_NUM_PROCESSES=2 \
       CL_PROCESS_ID=0 python examples/distributed_batch.py /tmp/dist_demo &
       CL_COORDINATOR_ADDRESS=localhost:9911 CL_NUM_PROCESSES=2 \
       CL_PROCESS_ID=1 python examples/distributed_batch.py /tmp/dist_demo

3. Several GPU hosts: launch one process per host with the same
   CL_COORDINATOR_ADDRESS / CL_NUM_PROCESSES and its own CL_PROCESS_ID
   (nothing discovers the cluster on its own).  The GPUs of ONE host need
   no processes at all: one process drives them all.

The CLI equivalent is ``python -m camera_linearity ...
--coordinator HOST:PORT --num-processes N --process-id I``.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

# On CPU multi-process demos each process needs its own virtual devices;
# harmless single-process.
if os.environ.get("CL_NUM_PROCESSES"):
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")

import numpy as np


def make_scene_videos(root: Path, n_scenes: int = 4, seed: int = 7):
    import cv2 as cv
    rng = np.random.default_rng(seed)
    for k in range(n_scenes):
        sdir = root / f"scene{k}"
        if sdir.exists():
            continue
        sdir.mkdir(parents=True)
        base = rng.uniform(0.1, 0.8, (24, 32, 3))
        for ms in (2, 4, 8):
            u8 = np.clip(base * (ms / 8) * 255
                         + rng.normal(0, 4, (6, 24, 32, 3)),
                         0, 255).astype(np.uint8)
            writer = cv.VideoWriter(str(sdir / f"scene {ms}ms.avi"),
                                    cv.VideoWriter_fourcc(*"FFV1"), 10,
                                    (32, 24))
            for f in u8:
                writer.write(f)
            writer.release()


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "/tmp/dist_demo")

    # 1. Join the multi-process runtime BEFORE any other jax call.  With
    #    no CL_* env this is a no-op and the script runs single-process.
    #    The localhost demo must ALSO pin the CPU backend before joining —
    #    a local GPU would otherwise be opened by both processes.  On
    #    several GPU hosts, drop this (each host's GPUs ARE the point).
    if os.environ.get("CL_NUM_PROCESSES"):
        import jax
        jax.config.update("jax_platforms", "cpu")
    from camera_linearity.parallel import distributed as dist
    multi = dist.initialize()

    import jax
    import jax.numpy as jnp
    from camera_linearity import CameraConfig
    from camera_linearity.models import pipeline

    pid, nproc = jax.process_index(), jax.process_count()
    print(f"[{pid}] joined: {nproc} process(es), "
          f"{jax.local_device_count()} local / {len(jax.devices())} "
          f"global devices (multi={multi})")

    # 2. Every process must see the same scene dict (same order!); only
    #    process 0 writes the demo data, the rest wait for it.
    scenes_dir = root / "scenes"
    if pid == 0:
        make_scene_videos(scenes_dir)
    if multi:
        # cheap readiness barrier: a tiny global psum
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = dist.scene_mesh()
        token = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("data")),
            np.ones(jax.local_device_count()), (len(jax.devices()),))
        jnp.sum(token).block_until_ready()
    scene_names = sorted(p.name for p in scenes_dir.iterdir() if p.is_dir())
    scenes = {name: sorted((scenes_dir / name).glob("*.avi"))
              for name in scene_names}

    # 3. One call: decode local block -> globally-sharded merge -> local
    #    results.  (A solved ICRF would come from `calibrate`; the demo
    #    uses a gamma curve.)
    cfg = CameraConfig()
    x = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    icrf = jnp.asarray(x ** 2.2)
    results = pipeline.batch_video_to_hdr(scenes, icrf, config=cfg)

    for name, hdr in results.items():
        v = np.asarray(hdr.measurand.val)
        print(f"[{pid}] {name}: HDR {v.shape}, radiance mean "
              f"{v.mean():.4g}, std mean "
              f"{np.asarray(hdr.measurand.std).mean():.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

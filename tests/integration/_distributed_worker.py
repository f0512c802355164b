"""Worker process for the 2-process multi-host integration test.

Run as ``python _distributed_worker.py SCENES_DIR OUT_DIR`` with the
``CL_COORDINATOR_ADDRESS`` / ``CL_NUM_PROCESSES`` / ``CL_PROCESS_ID``
environment set (exercising parallel/distributed.py's env wiring).  Each
worker joins the 2-process CPU-backend runtime (4 virtual devices per
process -> an 8-device global mesh with collectives over Gloo), runs the
distributed batch video->HDR flow and a population-sharded calibration
step over the global mesh, verifies against a locally-computed oracle,
and writes ``result_<pid>.json`` for the parent test to assert on.
"""
import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> None:
    scenes_dir, out_dir = Path(sys.argv[1]), Path(sys.argv[2])
    from camera_linearity.parallel import distributed as dist

    assert dist.initialize(), "env wiring should yield a multi-process run"
    pid, nproc = jax.process_index(), jax.process_count()
    assert nproc == 2 and len(jax.devices()) == 8, (
        nproc, len(jax.devices()))
    assert len(jax.local_devices()) == 4

    mesh = dist.scene_mesh()
    assert dict(mesh.shape) == {"data": 2, "pixel": 4}, dict(mesh.shape)
    # the data axis must be the PROCESS axis: each mesh row's
    # devices belong to one process
    rows = np.asarray(mesh.devices)
    assert all(len({d.process_index for d in row}) == 1 for row in rows)

    # --- distributed batch video->HDR (BASELINE config 5 shape) --------
    from camera_linearity import CameraConfig
    from camera_linearity.models import pipeline
    from camera_linearity.ops import hdr as hdr_ops

    cfg = CameraConfig()
    scene_names = sorted(p.name for p in scenes_dir.iterdir()
                         if p.is_dir())
    scenes = {name: sorted((scenes_dir / name).glob("*.avi"))
              for name in scene_names}
    rng = np.random.default_rng(0)
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    icrf_j = jnp.asarray(icrf)
    icrf_diff_j = jnp.asarray(icrf_diff)

    results = pipeline.batch_video_to_hdr(scenes, icrf_j, icrf_diff_j,
                                          config=cfg, mesh=mesh)
    # each process gets exactly its contiguous block of scenes back
    expected = scene_names[pid * 2:(pid + 1) * 2]
    assert list(results) == expected, (list(results), expected)

    # oracle: decode THIS process's scenes again and merge single-device
    max_err = 0.0
    for name in expected:
        val, std, exposures, _ = pipeline.videos_to_stacks(scenes[name],
                                                           cfg)
        ov, os_ = hdr_ops.merge_batch(jnp.asarray(val[None]),
                                      jnp.asarray(std[None]),
                                      jnp.asarray(exposures),
                                      icrf_j, icrf_diff_j)
        m = results[name].measurand
        max_err = max(max_err,
                      float(jnp.max(jnp.abs(m.val - ov[0]))),
                      float(jnp.max(jnp.abs(m.std - os_[0]))))
    assert max_err < 1e-9, f"distributed merge diverges: {max_err}"

    # --- an explicit cross-process collective: psum over the data axis -
    from functools import partial

    @partial(jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
    def dcn_total(x):
        return jax.lax.psum(jnp.sum(x), "data")

    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), np.full(4, float(pid + 1)), (8,))
    total = float(dcn_total(garr))
    assert total == 4 * 1.0 + 4 * 2.0, total

    # --- population-sharded DE calibration over the global mesh --------
    from camera_linearity.models import calibration as cal
    pop_mesh = jax.make_mesh((8,), ("pop",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    n_exp, pixels = 4, 48
    exp2 = 0.001 * 2.0 ** np.arange(n_exp)
    radiance = rng.uniform(0.01, 0.35, pixels)
    linear = radiance[:, None] * (exp2 / exp2[-1])[None, :]
    stack_dn = np.around(np.clip(linear, 0, 1) ** (1 / 2.2) * 255
                         ).astype(np.int32)
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:4].T
    ccfg = CameraConfig(num_of_chs=1, datapoints=256)
    icrf_solved, e0, e1, _ = cal.calibration(
        -1.0, 1.0,
        channel_stacks=(jnp.asarray(stack_dn[None]), None,
                        jnp.asarray(exp2)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
        config=ccfg, popsize=8, maxiter=3, tol=1e-6, rng_seed=5,
        mesh=pop_mesh, pop_axis="pop")
    assert np.isfinite(icrf_solved).all()
    assert float(e1[0]) <= float(e0[0]) + 1e-12

    # --- the calibration leg on the multi-host path ---------------------
    # (process 0 owns global scene 0 and subsamples it; the allgather-sum
    # broadcast must hand every process the same data, so both processes
    # solve the same curve and merge with it.  Oracle: each worker decodes
    # scene 0 itself — the test filesystem is shared — runs the identical
    # solve, and merges its local scenes single-device.)
    spec = dict(pca_arrays=np.stack([pca] * 3),
                mean_icrf_arrays=np.stack([mean_icrf] * 3),
                spacing=17, popsize=6, maxiter=4, rng_seed=3)
    res_cal = pipeline.batch_video_to_hdr(scenes, icrf_j, icrf_diff_j,
                                          config=cfg, mesh=mesh,
                                          calibrate=spec)
    assert list(res_cal) == expected, (list(res_cal), expected)
    val0, _, exps0, _ = pipeline.videos_to_stacks(
        scenes[scene_names[0]], cfg)
    n0, h0, w0, c0 = val0.shape
    sub0 = val0.reshape(n0, h0 * w0, c0)[:, ::17, :]
    spec_ns = {k: v for k, v in spec.items() if k != "spacing"}
    icrf_c, icrf_diff_c = pipeline._calibrate_from_subsample(
        jnp.asarray(sub0), jnp.asarray(exps0), cfg, spec_ns)
    max_cal_err = 0.0
    for name in expected:
        val, std, exposures, _ = pipeline.videos_to_stacks(scenes[name],
                                                           cfg)
        ov, os_ = hdr_ops.merge_batch(jnp.asarray(val[None]),
                                      jnp.asarray(std[None]),
                                      jnp.asarray(exposures),
                                      icrf_c, icrf_diff_c)
        m = res_cal[name].measurand
        max_cal_err = max(max_cal_err,
                          float(jnp.max(jnp.abs(m.val - ov[0]))),
                          float(jnp.max(jnp.abs(m.std - os_[0]))))
    assert max_cal_err < 1e-9, (
        f"distributed calibrate leg diverges: {max_cal_err}")

    (out_dir / f"result_{pid}.json").write_text(json.dumps({
        "pid": pid, "scenes": expected, "max_merge_err": max_err,
        "max_cal_err": max_cal_err,
        "dcn_total": total, "e0": float(e0[0]), "e1": float(e1[0])}))
    print(f"[worker {pid}] OK", flush=True)


if __name__ == "__main__":
    main()

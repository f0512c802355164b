"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The reference has no distributed code (SURVEY.md §2); these validate the
scaling paths: sharded merge parity, explicit-psum statistics
parity, and population-sharded calibration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.ops import hdr as hdr_ops
from camera_linearity.ops import stats as stats_ops
from camera_linearity.parallel import mesh as mesh_mod
from camera_linearity.parallel import sharded

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.data_pixel_mesh(n_data=2, n_pixel=4)


def test_merge_batch_sharded_parity(rng, mesh):
    b, n, h, w, c = 4, 3, 16, 24, 3
    batch_val = rng.uniform(0.05, 0.95, (b, n, h, w, c))
    batch_std = rng.uniform(0.001, 0.01, (b, n, h, w, c))
    exposures = np.array([0.001, 0.002, 0.004])
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)

    bv = mesh_mod.shard_batch_of_scenes(jnp.asarray(batch_val), mesh)
    bs = mesh_mod.shard_batch_of_scenes(jnp.asarray(batch_std), mesh)
    out_val, out_std = sharded.merge_batch_sharded(
        bv, bs, jnp.asarray(exposures), jnp.asarray(icrf),
        jnp.asarray(icrf_diff), mesh)

    for i in range(b):
        ref_val, ref_std = hdr_ops.merge_stack(
            jnp.asarray(batch_val[i]), jnp.asarray(batch_std[i]),
            jnp.asarray(exposures), jnp.asarray(icrf),
            jnp.asarray(icrf_diff))
        np.testing.assert_allclose(np.asarray(out_val[i]),
                                   np.asarray(ref_val), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(out_std[i]),
                                   np.asarray(ref_std), rtol=1e-12)
    # scenes live on the data axis, rows on the pixel axis
    assert len(out_val.sharding.device_set) == 8


def test_sharded_stats_parity(rng, mesh):
    h, w, c = 32, 16, 3
    val = rng.uniform(0, 1, (h, w, c))
    std = rng.uniform(0.01, 0.2, (h, w, c))
    mask = rng.uniform(size=(h, w, c)) < 0.1
    val[mask] = np.nan
    std[mask] = np.nan

    from jax.sharding import NamedSharding, PartitionSpec as P
    v = jax.device_put(jnp.asarray(val),
                       NamedSharding(mesh, P("pixel", None, None)))
    s = jax.device_put(jnp.asarray(std),
                       NamedSharding(mesh, P("pixel", None, None)))

    got = sharded.dimension_statistics_sharded(v, s, mesh)
    expect = stats_ops.dimension_statistics(jnp.asarray(val),
                                            jnp.asarray(std), axis=(0, 1))
    np.testing.assert_allclose(np.asarray(got["mean"]),
                               np.asarray(expect["mean"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got["std"]),
                               np.asarray(expect["std"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got["error"]),
                               np.asarray(expect["error"]), rtol=1e-10)


def test_sharded_stats_unweighted(rng, mesh):
    val = rng.uniform(0, 1, (32, 8, 3))
    val[rng.uniform(size=val.shape) < 0.2] = np.nan
    from jax.sharding import NamedSharding, PartitionSpec as P
    v = jax.device_put(jnp.asarray(val),
                       NamedSharding(mesh, P("pixel", None, None)))
    got = sharded.dimension_statistics_sharded(v, None, mesh)
    np.testing.assert_allclose(np.asarray(got["mean"]),
                               np.nanmean(val, axis=(0, 1)), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got["std"]),
                               np.nanstd(val, axis=(0, 1)), rtol=1e-10)
    assert got["error"] is None


def test_population_sharded_calibration(rng):
    from camera_linearity import CameraConfig
    from camera_linearity.models import calibration as cal
    mesh = mesh_mod.make_mesh((8,), ("data",))

    gamma = 2.2
    n_exp, pixels = 4, 64
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    radiance = rng.uniform(0.01, 0.35, pixels)
    linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
    stack_dn = np.around(np.clip(linear, 0, 1) ** (1 / gamma) * 255
                         ).astype(np.int32)
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:5].T

    cfg = CameraConfig(num_of_chs=1, datapoints=256)
    icrf, e0, e1, _ = cal.calibration(
        -1.0, 1.0,
        channel_stacks=(jnp.asarray(stack_dn[None]), None,
                        jnp.asarray(exposures)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
        config=cfg, popsize=10, maxiter=40, tol=1e-3, rng_seed=5,
        mesh=mesh, pop_axis="data")
    assert e1[0] <= e0[0]
    assert np.all(np.isfinite(icrf))


def test_merge_batch_matches_per_scene(rng):
    """ops.hdr.merge_batch (the batched fast path) == per-scene merges."""
    import jax.numpy as jnp
    from camera_linearity.ops import hdr
    b, n, h, w, c = 3, 4, 16, 24, 3
    val = jnp.asarray(rng.uniform(0.05, 0.95, (b, n, h, w, c)),
                      jnp.float32)
    std = jnp.asarray(rng.uniform(0.001, 0.02, (b, n, h, w, c)),
                      jnp.float32)
    ex = jnp.asarray([0.001, 0.002, 0.004, 0.008], jnp.float32)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0).astype(np.float32)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_d = np.gradient(icrf.astype(np.float64), 2 / 255,
                         axis=0).astype(np.float32)
    icrf_j, icrf_dj = jnp.asarray(icrf), jnp.asarray(icrf_d)
    bv, bs = hdr.merge_batch(val, std, ex, icrf_j, icrf_dj)
    for i in range(b):
        rv, rs = hdr.merge_stack(val[i], std[i], ex, icrf_j, icrf_dj)
        np.testing.assert_allclose(np.asarray(bv[i]), np.asarray(rv),
                                   rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(bs[i]), np.asarray(rs),
                                   rtol=5e-4, atol=1e-6)
    v_only, s_only = hdr.merge_batch(val, None, ex, icrf_j, icrf_dj)
    assert s_only is None
    np.testing.assert_allclose(np.asarray(v_only), np.asarray(bv),
                               rtol=5e-5, atol=1e-6)


def test_pair_stats_sharded_parity(rng, mesh):
    """pair_stats_sharded == the single-device pair statistics: the
    difference stays chip-local, only the reductions psum."""
    h, w, c = 32, 8, 3
    short_v = rng.uniform(0.1, 0.4, (h, w, c))
    long_v = rng.uniform(0.4, 0.9, (h, w, c))
    short_s = rng.uniform(0.005, 0.02, (h, w, c))
    long_s = rng.uniform(0.005, 0.02, (h, w, c))
    ratio = 0.5

    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = NamedSharding(mesh, P("pixel", None, None))
    args = [jax.device_put(jnp.asarray(a), spec)
            for a in (short_v, long_v, short_s, long_s)]
    got_abs, got_rel = sharded.pair_stats_sharded(args[0], args[1],
                                                  args[2], args[3], ratio,
                                                  mesh)

    from camera_linearity.ops.uncertainty import scale_difference
    (av, astd), (rv, rstd) = scale_difference(
        jnp.asarray(short_v), jnp.asarray(short_s), jnp.asarray(long_v),
        jnp.asarray(long_s), ratio)
    exp_abs = stats_ops.dimension_statistics(av, astd, axis=(0, 1))
    exp_rel = stats_ops.dimension_statistics(rv, rstd, axis=(0, 1))
    for got, exp in ((got_abs, exp_abs), (got_rel, exp_rel)):
        for k in ("mean", "std", "error"):
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(exp[k]), rtol=1e-10)

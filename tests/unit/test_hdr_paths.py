"""Every merge contract, on the plain path and on the GPU kernel, against
the float64 NumPy oracle.

Each case runs twice: ``plain`` through the entry points as the CPU runs
them (``merge_hdr`` / ``merge_batch`` / ``merge_corrected`` and the
explicit ``row_chunk`` of ``merge_stack``), ``kernel`` through the Pallas
kernel of ops/hdr_triton.py in interpret mode.  The oracle is the
reference's two-pass merge (modules/exposure_series.py:317-397), its
median hot-pixel repair (measurand.py:543-557, scipy.ndimage semantics)
and its flat-field epilogue (measurand.py:559-604), in float64 NumPy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from camera_linearity.ops import filters, hdr, hdr_triton


def oracle_merge(val, std, exposures, icrf, icrf_diff, compat):
    icrf = np.asarray(icrf, np.float64)
    icrf_diff = np.asarray(icrf_diff, np.float64)
    max_dn = icrf.shape[0] - 1
    chans = np.arange(icrf.shape[1])
    integer = np.issubdtype(val.dtype, np.integer)

    def prep(i):
        if integer:
            idx = val[i].astype(np.int64)
            return idx / max_dn, idx
        x = val[i].astype(np.float64)
        return x, np.clip(np.around(x * max_dn), 0, max_dn).astype(np.int64)

    sw = sum(np.exp(-30.0 * (prep(i)[0] - 0.5) ** 2)
             for i in range(len(exposures)))
    out_v = out_var = 0.0
    for i, t in enumerate(exposures):
        x, idx = prep(i)
        w = np.exp(-30.0 * (x - 0.5) ** 2)
        dw = -60.0 * (x - 0.5) * w
        g = icrf[idx, chans]
        out_v = out_v + w * g / (sw * t)
        if std is not None:
            dg = icrf_diff[idx, chans] * std[i]
            bracket = (dw * g + w * dg) / sw - dw * w * g / sw ** 2
            scale = dg if compat == "reference" else std[i]
            out_var = out_var + (bracket * scale / t) ** 2
    return out_v, (None if std is None else np.sqrt(out_var))


def oracle_repair(stack, hot):
    med = np.stack([ndimage.median_filter(s, size=(3, 3, 1), mode="reflect")
                    for s in stack])
    return np.where(hot, med, stack)


def oracle_flat(val, std, flat_val, flat_std, mid=0.05):
    h, w = flat_val.shape[:2]
    dx, dy = int(np.floor(h * mid)), int(np.floor(w * mid))
    k = int((np.floor(1.0 / mid) - 1) // 2)
    roi = (slice(k * dx, (k + 1) * dx), slice(k * dy, (k + 1) * dy))
    m = flat_val[roi].mean(axis=(0, 1))
    ms = flat_std[roi].mean(axis=(0, 1))
    out_v = val / flat_val * m
    if std is None:
        return out_v, None
    u = std ** 2 / flat_val ** 2 * m ** 2 \
        + val ** 2 / flat_val ** 4 * flat_std ** 2 * m ** 2 \
        + val ** 2 / flat_val ** 2 * ms ** 2
    return out_v, np.sqrt(u)


CASES = {
    "corrected": {},
    "reference": dict(compat="reference"),
    "no_std": dict(std=False),
    "uint8_dns": dict(u8=True),
    "uint8_dns_no_std": dict(u8=True, std=False),
    "grayscale": dict(c=1),
    "bits_1024": dict(bits=1024),
    "bits_4096": dict(bits=4096),
    "bits_16384": dict(bits=16384),
    "bits_65536": dict(bits=65536),
    "batch": dict(batch=3),
    "batch_no_std": dict(batch=3, std=False),
    "row_chunk": dict(row_chunk=7),
    "dark_frames": dict(dark="frames"),
    "dark_frames_no_std": dict(dark="frames", std=False),
    "dark_uint8_mask": dict(dark="mask"),
    "dark_flat_field": dict(dark="frames", flat=True),
    "dark_flat_field_no_std": dict(dark="frames", flat=True, std=False),
    "dark_4096_reference": dict(dark="frames", bits=4096,
                                compat="reference"),
    "dark_grayscale": dict(dark="frames", c=1),
}


def _case_inputs(rng, spec):
    n, h, w = 4, 21, 30            # ragged sizes: grid tails and edges
    c = spec.get("c", 3)
    bits = spec.get("bits", 256)
    lead = (spec["batch"],) if "batch" in spec else ()
    shape = lead + (n, h, w, c)
    if spec.get("u8"):
        val = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        val = rng.uniform(0.02, 0.98, shape)
    std = rng.uniform(0.001, 0.02, shape) if spec.get("std", True) else None
    exposures = 0.001 * 2.0 ** np.arange(n)
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / (bits - 1), axis=0)
    dark = None
    if "dark" in spec:
        dark = (rng.uniform(0, 1, (n, h, w, c)) > 0.9).astype(np.float64)
        dark[0, 0, 0, 0] = dark[-1, -1, -1, -1] = 1.0   # corners
    flat = None
    if spec.get("flat"):
        flat = (rng.uniform(0.7, 1.0, (h, w, c)),
                rng.uniform(0.001, 0.01, (h, w, c)))
    return val, std, exposures, icrf, icrf_diff, dark, flat


def _run(impl, spec, val, std, exposures, icrf, icrf_diff, dark, flat):
    compat = spec.get("compat", "corrected")
    j = jnp.asarray
    s = None if std is None else j(std)
    tabs = (j(exposures), j(icrf), j(icrf_diff))
    thr = j(0.5)
    if impl == "kernel":
        def merge(v, sd, **kw):
            return hdr_triton.merge_fused(v, sd, *tabs, compat=compat,
                                          interpret=True, **kw)
        if "batch" in spec:
            if s is None:
                return jax.vmap(lambda v: merge(v, None)[0])(j(val)), None
            return jax.vmap(merge)(j(val), s)
        if dark is None:
            return merge(j(val), s)
        if spec["dark"] == "mask":
            out = merge(j(val), s, hot=filters.hot_pixel_mask(j(dark), thr))
        else:
            out = merge(j(val), s, hot=j(dark), threshold=thr)
        if flat is None:
            return out
        return filters.flat_field_correction(*out, j(flat[0]), j(flat[1]),
                                             0.05)
    if "batch" in spec:
        return hdr.merge_batch(j(val), s, *tabs, compat=compat)
    if "row_chunk" in spec:
        return hdr.merge_stack(j(val), s, *tabs, compat=compat,
                               row_chunk=spec["row_chunk"])
    if dark is None:
        return hdr.merge_hdr(j(val), s, *tabs, compat=compat)
    hot = filters.hot_pixel_mask(j(dark), thr) if spec["dark"] == "mask" \
        else j(dark)
    fv, fs = (None, None) if flat is None else (j(flat[0]), j(flat[1]))
    return hdr.merge_corrected(j(val), s, hot, *tabs, thr, fv, fs,
                               compat=compat)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_merge_matches_float64_oracle(rng, case, impl):
    spec = CASES[case]
    val, std, exposures, icrf, icrf_diff, dark, flat = _case_inputs(rng,
                                                                    spec)
    got_v, got_s = _run(impl, spec, val, std, exposures, icrf, icrf_diff,
                        dark, flat)
    compat = spec.get("compat", "corrected")
    if "batch" in spec:
        refs = [oracle_merge(val[b], None if std is None else std[b],
                             exposures, icrf, icrf_diff, compat)
                for b in range(spec["batch"])]
        want_v = np.stack([r[0] for r in refs])
        want_s = None if std is None else np.stack([r[1] for r in refs])
    else:
        v, s = val, std
        if dark is not None:
            hot = dark > 0.5
            v = oracle_repair(val, hot)
            s = None if std is None else oracle_repair(std, hot)
        want_v, want_s = oracle_merge(v, s, exposures, icrf, icrf_diff,
                                      compat)
        if flat is not None:
            want_v, want_s = oracle_flat(want_v, want_s, *flat)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-10,
                               atol=1e-12)
    if std is None:
        assert got_s is None
    else:
        np.testing.assert_allclose(np.asarray(got_s), want_s, rtol=1e-10,
                                   atol=1e-12)


def test_uint8_mask_matches_dark_frames(rng):
    """A precomputed uint8 hot-pixel mask gives bit-identical merges to the
    float dark frames it was computed from, on both paths; an integer map
    WITHOUT mask semantics keeps the '> threshold' contract."""
    n, h, w, c = 3, 16, 20, 2
    val = jnp.asarray(rng.uniform(0.05, 0.95, (n, h, w, c)))
    std = jnp.asarray(rng.uniform(0.001, 0.01, (n, h, w, c)))
    dark = jnp.asarray(rng.uniform(0, 1, (n, h, w, c)))
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    tabs = (jnp.asarray(0.001 * 2.0 ** np.arange(n)), jnp.asarray(icrf),
            jnp.asarray(np.gradient(icrf, 2 / 255, axis=0)))
    thr = jnp.asarray(0.6)
    mask = filters.hot_pixel_mask(dark, thr)
    assert mask.dtype == jnp.uint8
    for got, want in (
            (hdr.merge_corrected(val, std, mask, *tabs, thr),
             hdr.merge_corrected(val, std, dark, *tabs, thr)),
            (hdr_triton.merge_fused(val, std, *tabs, hot=mask,
                                    interpret=True),
             hdr_triton.merge_fused(val, std, *tabs, hot=dark,
                                    threshold=thr, interpret=True))):
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    int_map = (np.asarray(dark) * 255).astype(np.uint8)
    hv, _ = jax.vmap(lambda v, s, m: filters.bad_pixel_filter(
        v, s, m, jnp.asarray(100.0), 3))(val, std, jnp.asarray(int_map))
    ov, _ = jax.vmap(lambda v, s, m: filters.bad_pixel_filter(
        v, s, m, jnp.asarray(100.0), 3))(val, std,
                                         jnp.asarray(int_map, jnp.float64))
    np.testing.assert_array_equal(np.asarray(hv), np.asarray(ov))


def test_merge_fused_refuses_to_compile_off_gpu(rng):
    """Off the GPU the kernel raises instead of silently interpreting."""
    v = jnp.asarray(rng.uniform(0.1, 0.9, (2, 4, 4, 1)))
    tabs = (jnp.asarray([1.0, 2.0]), jnp.linspace(0, 1, 256)[:, None],
            jnp.ones((256, 1)))
    with pytest.raises(RuntimeError, match="GPU kernel"):
        hdr_triton.merge_fused(v, None, *tabs)


def test_round_half_even_matches_numpy():
    y = np.array([0.0, 0.5, 1.5, 2.5, 2.4999, 2.5001, 254.5, 255.5, 3.0,
                  4095.5, 65534.5, 7.49999999])
    np.testing.assert_array_equal(np.asarray(hdr_triton._round_half_even(
        jnp.asarray(y))), np.around(y))


# ---------------------------------------------------------------------------
# randomized shapes: grid tails, dtypes and the value-only variant across
# the small-shape space, kernel (interpret mode) against the oracle
# ---------------------------------------------------------------------------
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 5), st.integers(3, 26), st.integers(8, 70),
       st.integers(1, 3), st.booleans(), st.booleans(),
       st.integers(0, 2 ** 31 - 1))
def test_kernel_parity_random_shapes(n, h, w, c, use_std, int_dns, seed):
    rng = np.random.default_rng(seed)
    if int_dns:
        val = rng.integers(0, 256, (n, h, w, c)).astype(np.uint8)
    else:
        val = rng.uniform(0.0, 1.0, (n, h, w, c))
    std = rng.uniform(0.001, 0.02, (n, h, w, c)) if use_std else None
    exposures = 0.001 * 2.0 ** np.arange(n)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    j = jnp.asarray
    got_v, got_s = hdr_triton.merge_fused(
        j(val), None if std is None else j(std), j(exposures), j(icrf),
        j(icrf_diff), interpret=True)
    want_v, want_s = oracle_merge(val, std, exposures, icrf, icrf_diff,
                                  "corrected")
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-10,
                               atol=1e-12)
    if use_std:
        np.testing.assert_allclose(np.asarray(got_s), want_s, rtol=1e-10,
                                   atol=1e-12)
    else:
        assert got_s is None


# ---------------------------------------------------------------------------
# on the card: the kernel as compiled for the GPU against the plain path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dark", [False, True])
def test_compiled_kernel_matches_plain_path(gpu, rng, dark):
    n, h, w, c = 6, 120, 192, 3
    val = jnp.asarray(rng.uniform(0.02, 0.98, (n, h, w, c)), jnp.float32)
    std = jnp.asarray(rng.uniform(0.001, 0.02, (n, h, w, c)), jnp.float32)
    icrf = np.sort(rng.uniform(0, 1, (4096, c)), axis=0)
    tabs = (jnp.asarray(0.001 * 2.0 ** np.arange(n), jnp.float32),
            jnp.asarray(icrf, jnp.float32),
            jnp.asarray(np.gradient(icrf, 2 / 4095, axis=0), jnp.float32))
    if dark:
        d = jnp.asarray(rng.uniform(0, 1, (n, h, w, c)) > 0.99, jnp.float32)
        thr = jnp.asarray(0.5, jnp.float32)
        got = hdr.merge_corrected(val, std, d, *tabs, thr)
        rv, rs = jax.vmap(lambda v, s, k: filters.bad_pixel_filter(
            v, s, k, thr, 3))(val, std, d)
        want = hdr.merge_stack(rv, rs, *tabs)
    else:
        got = hdr.merge_hdr(val, std, *tabs)
        want = hdr.merge_stack(val, std, *tabs)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(wnt),
                                   rtol=2e-5, atol=1e-7)

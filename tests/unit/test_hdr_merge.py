"""HDR merge parity against a pure-NumPy oracle of the reference semantics.

The oracle re-implements the reference's two-pass merge loop
(reference: modules/exposure_series.py:317-397) in float64 NumPy, including
the exact std accumulation formula; merge_stack must match to float tolerance
in 'reference' compat mode, and match the corrected first-order formula in
'corrected' mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.ops import hdr


def numpy_reference_merge(stack_val, stack_std, exposures, icrf, icrf_diff,
                          mode="reference"):
    """Oracle: reference exposure_series.py:317-394 semantics, vectorized."""
    n, h, w_, c = stack_val.shape
    chans = np.arange(c)
    # pass 1: sum of weights
    sw = np.zeros((h, w_, c))
    for i in range(n):
        x = stack_val[i]
        sw += np.e ** (-30 * (x - 0.5) ** 2)
    sw2 = sw ** 2
    # pass 2
    val = np.zeros((h, w_, c))
    var = np.zeros((h, w_, c))
    for i in range(n):
        x = stack_val[i]
        s = stack_std[i]
        t = exposures[i]
        w = np.e ** (-30 * (x - 0.5) ** 2)
        dw = -60 * (x - 0.5) * w
        # int64, not the reference's uint8 (image_set.py:223 loads 8-bit
        # images): this oracle also serves >8-bit tables, where a uint8
        # index would silently wrap mod 256
        idx = np.around(x * (icrf.shape[0] - 1)).astype(np.int64)
        g = icrf[idx, chans]
        dg = icrf_diff[idx, chans] * s
        val += (w * g) / (sw * t)
        bracket = (dw * g + w * dg) / sw - (dw * w * g) / sw2
        scale = dg if mode == "reference" else s
        var += ((bracket * scale) / t) ** 2
    return val, np.sqrt(var)


@pytest.fixture
def merge_inputs(rng):
    n, h, w, c = 5, 24, 32, 3
    stack_val = rng.uniform(0.02, 0.98, (n, h, w, c))
    stack_std = rng.uniform(0.001, 0.02, (n, h, w, c))
    exposures = np.array([0.001, 0.002, 0.005, 0.01, 0.02])
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    return stack_val, stack_std, exposures, icrf, icrf_diff


@pytest.mark.parametrize("mode", ["reference", "corrected"])
def test_merge_stack_matches_oracle(merge_inputs, mode):
    stack_val, stack_std, exposures, icrf, icrf_diff = merge_inputs
    val, std = hdr.merge_stack(jnp.asarray(stack_val),
                               jnp.asarray(stack_std),
                               jnp.asarray(exposures), jnp.asarray(icrf),
                               jnp.asarray(icrf_diff), compat=mode)
    oval, ostd = numpy_reference_merge(stack_val, stack_std, exposures,
                                       icrf, icrf_diff, mode=mode)
    np.testing.assert_allclose(np.asarray(val), oval, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(std), ostd, rtol=1e-10, atol=1e-12)


def test_merge_stack_no_std(merge_inputs):
    stack_val, _, exposures, icrf, icrf_diff = merge_inputs
    val, std = hdr.merge_stack(jnp.asarray(stack_val), None,
                               jnp.asarray(exposures), jnp.asarray(icrf),
                               jnp.asarray(icrf_diff))
    assert std is None
    oval, _ = numpy_reference_merge(stack_val, np.zeros_like(stack_val),
                                    exposures, icrf, icrf_diff)
    np.testing.assert_allclose(np.asarray(val), oval, rtol=1e-10)


def test_merge_float32_close_to_float64(merge_inputs):
    """The device working dtype (f32) must stay within 1e-6 relative of the
    float64 oracle — the BASELINE parity requirement."""
    stack_val, stack_std, exposures, icrf, icrf_diff = merge_inputs
    val32, std32 = hdr.merge_stack(
        jnp.asarray(stack_val, jnp.float32), jnp.asarray(stack_std,
                                                         jnp.float32),
        jnp.asarray(exposures, jnp.float32), jnp.asarray(icrf, jnp.float32),
        jnp.asarray(icrf_diff, jnp.float32))
    oval, ostd = numpy_reference_merge(stack_val, stack_std, exposures,
                                       icrf, icrf_diff, mode="corrected")
    np.testing.assert_allclose(np.asarray(val32), oval, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(std32), ostd, rtol=5e-4, atol=5e-6)


def test_sum_of_weights(merge_inputs):
    stack_val, *_ = merge_inputs
    sw, sw2 = hdr.sum_of_weights(jnp.asarray(stack_val))
    expect = np.sum(np.e ** (-30 * (stack_val - 0.5) ** 2), axis=0)
    np.testing.assert_allclose(np.asarray(sw), expect, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sw2), expect ** 2, rtol=1e-12)

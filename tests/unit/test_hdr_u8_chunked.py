"""uint8 merge path and row-chunked execution parity."""
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.ops import hdr


@pytest.fixture
def inputs(rng):
    n, h, w, c = 5, 37, 29, 3  # odd sizes exercise chunk padding
    dn = rng.integers(0, 256, (n, h, w, c)).astype(np.uint8)
    std = rng.uniform(0.001, 0.02, (n, h, w, c))
    exposures = 0.001 * 2.0 ** np.arange(n)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    return dn, std, exposures, icrf, icrf_diff


def test_u8_matches_float_path(inputs):
    dn, std, exposures, icrf, icrf_diff = inputs
    args = (jnp.asarray(std), jnp.asarray(exposures), jnp.asarray(icrf),
            jnp.asarray(icrf_diff))
    uval, ustd = hdr.merge_stack_u8(jnp.asarray(dn), *args)
    fval, fstd = hdr.merge_stack(jnp.asarray(dn.astype(np.float64) / 255),
                                 *args)
    np.testing.assert_allclose(np.asarray(uval), np.asarray(fval),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ustd), np.asarray(fstd),
                               rtol=1e-12)


@pytest.mark.parametrize("row_chunk", [8, 16, 37])
def test_chunked_matches_unchunked(inputs, row_chunk):
    dn, std, exposures, icrf, icrf_diff = inputs
    args = (jnp.asarray(std), jnp.asarray(exposures), jnp.asarray(icrf),
            jnp.asarray(icrf_diff))
    full = hdr.merge_stack_u8(jnp.asarray(dn), *args, row_chunk=0)
    chunked = hdr.merge_stack_u8(jnp.asarray(dn), *args,
                                 row_chunk=row_chunk)
    np.testing.assert_allclose(np.asarray(chunked[0]), np.asarray(full[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(chunked[1]), np.asarray(full[1]),
                               rtol=1e-12)


def test_chunked_no_std(inputs):
    dn, _, exposures, icrf, icrf_diff = inputs
    full, none_std = hdr.merge_stack_u8(
        jnp.asarray(dn), None, jnp.asarray(exposures), jnp.asarray(icrf),
        jnp.asarray(icrf_diff), row_chunk=0)
    chunked, cstd = hdr.merge_stack_u8(
        jnp.asarray(dn), None, jnp.asarray(exposures), jnp.asarray(icrf),
        jnp.asarray(icrf_diff), row_chunk=10)
    assert none_std is None and cstd is None
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               rtol=1e-12)

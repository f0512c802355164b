"""Test configuration: the JAX CPU backend with 8 virtual devices by default.

Mirrors the reference's backend-switch fixture idea (reference:
tests/conftest.py:13-31 selects NumPy vs CuPy via --use-cupy): the suite
runs on the CPU backend by default, including an 8-device virtual mesh for
the sharding tests, with float64 enabled so parity tests against the
float64 NumPy oracles are exact.  ``CL_TEST_PLATFORM=gpu`` runs it on the
GPU instead (see README "Testing"); tests marked ``gpu`` need the card and
skip elsewhere.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

_platform = os.environ.get("CL_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    jax.config.update("jax_platforms", "cpu")
    # float64 for exact parity against the float64 NumPy oracles
    jax.config.update("jax_enable_x64", True)
elif _platform != "gpu":
    raise ValueError(f"CL_TEST_PLATFORM must be 'cpu' or 'gpu', got "
                     f"{_platform!r}")

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

if _platform == "gpu":
    # GPU mode computes in float32 (the device dtype), while the oracles
    # are float64 NumPy with rtol as tight as 1e-13: those tolerances
    # assert accumulation-order identity, a CPU/x64 parity property.  GPU
    # runs apply a FLOOR to assert_allclose tolerances instead, so every
    # comparison still runs against the same oracles at float32
    # strictness; assert_array_equal and integer checks are untouched.
    #
    # The floors are per test family, ~10x the deviations measured on an
    # H100 by benchmarks/error_budget.py (docs/kernel_design.md "Numerics
    # on the GPU"); the default covers transcendental-heavy ops.
    _orig_allclose = np.testing.assert_allclose

    _FAMILY_FLOORS = {
        # merges: measured max rel 1.7e-5 (config 2 std)
        "test_hdr_merge": (2e-4, 2e-6),
        "test_hdr_paths": (2e-4, 2e-6),
        "test_hdr_u8_chunked": (2e-4, 2e-6),
        "test_hdr_corrections": (2e-4, 2e-6),
        "test_merge_properties": (2e-4, 2e-6),
        # calibration energies: measured max rel 2.3e-7
        "test_linearity": (3e-6, 1e-6),
        "test_linearity_chunked": (3e-6, 1e-6),
        # Welford / video: measured max rel 2.4e-6
        "test_video": (3e-5, 1e-6),
    }
    _DEFAULT_FLOOR = (5e-4, 2e-6)
    _current_floor = [_DEFAULT_FLOOR]

    def _f32_floored_allclose(actual, desired, rtol=1e-7, atol=0, **kw):
        frtol, fatol = _current_floor[0]
        return _orig_allclose(actual, desired, rtol=max(rtol, frtol),
                              atol=max(atol, fatol), **kw)

    np.testing.assert_allclose = _f32_floored_allclose

    @pytest.fixture(autouse=True)
    def _select_f32_floor(request):
        name = request.node.path.stem if hasattr(request.node, "path") \
            else Path(str(request.node.fspath)).stem
        _current_floor[0] = _FAMILY_FLOORS.get(name, _DEFAULT_FLOOR)
        yield
        _current_floor[0] = _DEFAULT_FLOOR


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu`` take this)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with CL_TEST_PLATFORM=gpu "
                    "on the card)")
    return jax.devices()[0]


@pytest.fixture()
def rng(request):
    """Per-test deterministic generator.

    Seeded from the test's node id (stable across runs and machines), so
    each test's data is independent of execution order — a session-scoped
    shared stream made test data depend on which tests ran before, which
    surfaced as order-dependent flakes near f32 LUT-bin boundaries.
    """
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode()) ^ 1995
    return np.random.default_rng(seed)


@pytest.fixture(scope="session")
def n_devices():
    return len(jax.devices())


@pytest.fixture(scope="session")
def ftype():
    """The canonical float dtype of the device under test (float64 on the
    CPU parity gate, float32 on the GPU).

    LUT-indexing tests must cast their inputs through this dtype so the
    NumPy oracle quantizes the SAME values the device sees — otherwise an
    input within f32-epsilon of a bin boundary rounds to different LUT
    entries on the two paths and the comparison sees a full bin-width
    error rather than a rounding error."""
    return jax.dtypes.canonicalize_dtype(np.float64)

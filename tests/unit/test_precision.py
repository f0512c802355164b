"""Float32 matmuls on the main path run at full precision.

On a GPU a float32 ``dot_general`` with default precision may run in TF32
(a 10-bit mantissa).  Every float32 ``dot_general`` that the merge, one
DE generation and the DoRF covariance trace to must pin
``Precision.HIGHEST`` (or be indexing, which has no precision at all).
The jaxprs are traced in float32, as they run on the GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity.models import calibration as cal
from camera_linearity.models import dorf
from camera_linearity.ops import hdr, hdr_triton
from camera_linearity.ops import linearity as lin


def _f32_dots(jaxpr):
    """Every float32 dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    found = []

    def visit(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general" and any(
                    v.aval.dtype == jnp.float32 for v in eqn.invars):
                found.append(eqn)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "eqns"):
                        visit(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        visit(sub.jaxpr)
    visit(jaxpr.jaxpr)
    return found


def _assert_highest(dots):
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (
            f"float32 dot_general at precision {prec}: {eqn}")


def _merge_inputs(n=4, h=8, w=12, c=3, bits=256):
    rng = np.random.default_rng(0)
    f = jnp.float32
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    return (jnp.asarray(rng.uniform(0.05, 0.95, (n, h, w, c)), f),
            jnp.asarray(rng.uniform(0.001, 0.01, (n, h, w, c)), f),
            jnp.asarray(0.001 * 2.0 ** np.arange(n), f),
            jnp.asarray(icrf, f),
            jnp.asarray(np.gradient(icrf, 2 / (bits - 1), axis=0), f))


def _de_generation_jaxpr():
    """jaxpr of the batched solver's segment: its while body is one DE
    generation (trial generation + population energies + selection)."""
    rng = np.random.default_rng(1)
    f = jnp.float32
    n_exp, px, dp, k = 4, 40, 256, 5
    stack = rng.integers(10, 240, (px, n_exp))
    pca = np.linalg.qr(rng.normal(size=(dp, k)))[0]
    mean = np.linspace(0, 1, dp) ** 2.2
    ii, jj = lin.upper_triangle_pairs(n_exp)
    energy_fn = cal._make_population_energy(True, "soft", 5, 250, dp, False)
    channel_data = (
        jnp.asarray(pca[None], f), jnp.asarray(mean[None], f),
        lin.build_data_onehot(jnp.asarray(stack), dp)[None],
        jnp.asarray(0.001 * 2.0 ** np.arange(n_exp), f)[None],
        jnp.asarray(ii)[None], jnp.asarray(jj)[None])
    _, segment = cal._make_batched_solver(energy_fn, True, 0.4, 0.0, 1.95,
                                          0.01, 0.0)
    s = 15 * k
    state = (jnp.asarray(rng.uniform(0, 1, (1, s, k)), f),
             jnp.zeros((1, s), f), jax.random.PRNGKey(0)[None],
             jnp.asarray(0), jnp.zeros(1, bool), jnp.full(1, 10))
    bounds = jnp.full((1, k), -1.0, f), jnp.full((1, k), 1.0, f)
    return jax.make_jaxpr(segment)(state, jnp.asarray(10), *bounds,
                                   *channel_data)


@pytest.mark.parametrize("path", ["merge_hdr", "merge_hdr_kernel",
                                  "merge_corrected", "de_generation",
                                  "covariance_matrix"])
def test_float32_dots_are_highest(path):
    with jax.enable_x64(False):
        if path == "merge_hdr":
            jp = jax.make_jaxpr(hdr.merge_hdr)(*_merge_inputs())
        elif path == "merge_hdr_kernel":
            jp = jax.make_jaxpr(lambda *a: hdr_triton.merge_fused(
                *a, interpret=True))(*_merge_inputs())
        elif path == "merge_corrected":
            v, s, e, i, d = _merge_inputs(bits=4096)
            jp = jax.make_jaxpr(hdr.merge_corrected)(
                v, s, jnp.zeros_like(v), e, i, d, jnp.float32(0.5),
                jnp.ones_like(v[0]), jnp.ones_like(s[0]))
        elif path == "de_generation":
            jp = _de_generation_jaxpr()
        else:
            data = jnp.asarray(np.random.default_rng(2).uniform(
                0, 1, (25, 64)), jnp.float32)
            jp = jax.make_jaxpr(dorf.covariance_matrix)(data,
                                                        data.mean(axis=0))
    dots = _f32_dots(jp)
    if path in ("de_generation", "covariance_matrix"):
        assert dots, "expected float32 matmuls on this path"
    _assert_highest(dots)


def _evolve_onehot(key, pop, energies, scale, recombination):
    """The former one-hot-matmul member selection, kept as the oracle."""
    s, d = pop.shape
    k_r0, k_r1, k_cross, k_fill, k_bounds = jax.random.split(key, 5)
    i = jnp.arange(s)
    a = jax.random.randint(k_r0, (s,), 0, s - 1)
    r0 = a + (a >= i)
    b = jax.random.randint(k_r1, (s,), 0, s - 2)
    lo, hi = jnp.minimum(i, r0), jnp.maximum(i, r0)
    r1 = b + (b >= lo)
    r1 = r1 + (r1 >= hi)
    hp = jax.lax.Precision.HIGHEST
    best = jnp.matmul((i == jnp.argmin(energies)).astype(pop.dtype), pop,
                      precision=hp)
    pop_r0 = jnp.matmul((r0[:, None] == i).astype(pop.dtype), pop,
                        precision=hp)
    pop_r1 = jnp.matmul((r1[:, None] == i).astype(pop.dtype), pop,
                        precision=hp)
    mutant = pop + scale * (best[None, :] - pop + pop_r0 - pop_r1)
    cross = jax.random.uniform(k_cross, (s, d)) < recombination
    fill = jax.random.randint(k_fill, (s,), 0, d)
    cross = cross | (jnp.arange(d)[None, :] == fill[:, None])
    trial = jnp.where(cross, mutant, pop)
    resample = jax.random.uniform(k_bounds, (s, d), pop.dtype)
    return jnp.where((trial < 0.0) | (trial > 1.0), resample, trial)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evolve_population_selects_the_onehot_rows(seed):
    """Indexed member selection gives exactly the trial rows that the
    one-hot matmul form gave."""
    rng = np.random.default_rng(seed)
    pop = jnp.asarray(rng.uniform(0, 1, (75, 5)))
    energies = jnp.asarray(rng.uniform(0, 1, 75))
    key = jax.random.PRNGKey(seed)
    scale = jnp.asarray(rng.uniform(0, 1.95))
    np.testing.assert_array_equal(
        np.asarray(cal._evolve_population(key, pop, energies, scale, 0.4)),
        np.asarray(_evolve_onehot(key, pop, energies, scale, 0.4)))

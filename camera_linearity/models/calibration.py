"""Device-resident ICRF calibration: population-batched differential evolution.

The reference steps SciPy's ``DifferentialEvolutionSolver`` from Python,
evaluating one candidate at a time per channel in joblib worker processes
(reference: modules/ICRF_calibration_exposure.py:288-402).  Here the whole
solve runs on device: the population's energies evaluate as ONE vmapped
batch per generation, channels ride a second vmap axis, and the generation
loop is a ``lax.while_loop`` — a single jit compilation covers the entire
calibration.

DE semantics follow SciPy's ``strategy='currenttobest1bin'`` with
``updating='deferred'`` (the mode SciPy itself switches to when
parallelized): per-generation dithered mutation factor, binomial crossover
with a guaranteed crossover point, out-of-bounds trial components resampled
uniformly, and greedy selection.  The reference's convergence rule is kept:
stop when std(E) <= tol * |mean(E)|, at ``maxiter`` generations, or when the
best energy falls below ``energy_limit``
(ICRF_calibration_exposure.py:357-370).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig, DEFAULT_CONFIG
from ..ops import linearity as lin_ops
from ..ops.linearize import interpolate_curve
from ..utils import general as gf
from ..utils import io
from .icrf import icrf_from_params
from .image_set import ImageSet

Array = jnp.ndarray

__all__ = ["DEResult", "differential_evolution", "calibration",
           "initialize_channel_image_stacks", "sobol_init_population"]


@dataclass
class DEResult:
    """Solver output: best member + full final state."""
    x: Array                 # (D,) best parameters (denormalized)
    energy: Array            # () best energy
    population: Array        # (S, D) final population (denormalized)
    energies: Array          # (S,) final energies
    n_iter: int
    converged: bool
    initial_energy: Array    # () best energy of the initial population


def sobol_init_population(num_members: int, num_params: int,
                          seed) -> np.ndarray:
    """Sobol' sequence init in the normalized [0,1]^D space, bit-exact with
    SciPy's ``init='sobol'`` (``init_population_qmc``: ``qmc.Sobol(d,
    seed=rng).random(n)``; reference driver
    ICRF_calibration_exposure.py:357-370 with ``seed=<int>``).

    Two fidelity details: SciPy seeds the sampler with the solver's
    ``RandomState`` (``check_random_state(int)``), not the raw int — an int
    seed here goes through the same conversion; and drawing the next
    power-of-two block then truncating yields the identical point set to
    ``random(n)`` (Sobol' points are a deterministic prefix) without
    tripping the balance-properties UserWarning on every run.
    """
    from scipy.stats import qmc
    rng = np.random.RandomState(seed) if isinstance(seed, (int, np.integer)) \
        else seed
    sampler = qmc.Sobol(d=num_params, seed=rng)
    m = max(1, int(np.ceil(np.log2(num_members))))
    return sampler.random_base2(m)[:num_members]


def _evolve_population(key: Array, pop: Array, energies: Array,
                       scale: Array, recombination: float) -> Array:
    """Whole-population trial generation.

    SciPy currenttobest1bin semantics per member i (reference driver:
    ICRF_calibration_exposure.py:357-370): mutant = x_i + F (x_best - x_i
    + x_r0 - x_r1) with distinct r0, r1 != i, binomial crossover with one
    guaranteed point, out-of-[0,1] components resampled uniformly
    (SciPy _ensure_constraint).  Member rows are selected by indexing,
    which is exact at any matmul precision.
    """
    s, d = pop.shape
    dtype = pop.dtype
    k_r0, k_r1, k_cross, k_fill, k_bounds = jax.random.split(key, 5)
    i = jnp.arange(s)

    a = jax.random.randint(k_r0, (s,), 0, s - 1)
    r0 = a + (a >= i)  # uniform over {0..s-1} \ {i}
    b = jax.random.randint(k_r1, (s,), 0, s - 2)
    lo = jnp.minimum(i, r0)
    hi = jnp.maximum(i, r0)
    r1 = b + (b >= lo)
    r1 = r1 + (r1 >= hi)  # uniform over {0..s-1} \ {i, r0}

    best = pop[jnp.argmin(energies)]                         # (D,)
    mutant = pop + scale * (best[None, :] - pop + pop[r0] - pop[r1])

    cross = jax.random.uniform(k_cross, (s, d)) < recombination
    fill_point = jax.random.randint(k_fill, (s,), 0, d)
    cross = cross | (jnp.arange(d)[None, :] == fill_point[:, None])
    trial = jnp.where(cross, mutant, pop)

    resample = jax.random.uniform(k_bounds, (s, d), dtype)
    out = (trial < 0.0) | (trial > 1.0)
    return jnp.where(out, resample, trial)


def differential_evolution(energy_fn: Callable[[Array], Array],
                           num_params: int,
                           bounds_lower: Array, bounds_upper: Array,
                           x0: Optional[np.ndarray] = None,
                           popsize: int = 15,
                           mutation: Tuple[float, float] = (0.0, 1.95),
                           recombination: float = 0.4,
                           tol: float = 0.01,
                           maxiter: int = 1000,
                           energy_limit: float = 0.0,
                           seed: int = 7) -> DEResult:
    """Run DE fully on device; ``energy_fn`` maps (D,) params -> scalar.

    The per-generation trial population evaluates as one ``vmap`` batch —
    this is the "population parallel" axis the reference leaves on the
    table (it steps candidates serially, ICRF_calibration_exposure.py:362).
    """
    d = num_params
    s = max(5, popsize * d)
    lower = jnp.asarray(bounds_lower, jnp.float64
                        if jax.config.jax_enable_x64 else jnp.float32)
    upper = jnp.asarray(bounds_upper, lower.dtype)

    def denorm(pop_norm):
        return lower + pop_norm * (upper - lower)

    init_pop = sobol_init_population(s, d, seed)
    if x0 is not None:
        x0_norm = (np.asarray(x0, float) - np.asarray(bounds_lower)) / (
            np.asarray(bounds_upper) - np.asarray(bounds_lower))
        init_pop = init_pop.copy()
        init_pop[0] = np.clip(x0_norm, 0, 1)
    pop0 = jnp.asarray(init_pop, lower.dtype)

    batched_energy = jax.vmap(lambda p: energy_fn(denorm(p)))
    energies0 = batched_energy(pop0)

    key0 = jax.random.PRNGKey(seed)
    m_lo, m_hi = mutation

    def cond(state):
        pop, energies, key, nit, done = state
        return (~done) & (nit < maxiter)

    def body(state):
        pop, energies, key, nit, _ = state
        key, k_scale, k_gen = jax.random.split(key, 3)
        scale = jax.random.uniform(k_scale, (), pop.dtype, m_lo, m_hi)
        trials = _evolve_population(k_gen, pop, energies, scale,
                                    recombination)
        trial_energies = batched_energy(trials)
        accept = trial_energies < energies
        pop = jnp.where(accept[:, None], trials, pop)
        energies = jnp.where(accept, trial_energies, energies)
        nit = nit + 1

        finite = jnp.isfinite(energies)
        e_mean = jnp.where(jnp.all(finite), jnp.mean(energies), jnp.inf)
        e_std = jnp.where(jnp.all(finite), jnp.std(energies), jnp.inf)
        converged = e_std <= tol * jnp.abs(e_mean)
        under_limit = jnp.min(energies) < energy_limit
        return pop, energies, key, nit, converged | under_limit

    state0 = (pop0, energies0, key0, jnp.asarray(0), jnp.asarray(False))
    pop, energies, _, nit, done = jax.lax.while_loop(cond, body, state0)

    best = jnp.argmin(energies)
    return DEResult(
        x=denorm(pop[best]), energy=energies[best],
        population=denorm(pop), energies=energies,
        n_iter=int(nit), converged=bool(done),
        initial_energy=jnp.min(energies0))


# User-declared solver cache keys -> the first energy callable registered
# under each key.  "Same key" is a promise that the callable computes the
# same function: repeated ad-hoc solves (fresh closures each call) reuse
# the jitted solver instead of re-tracing it (~2-4 s per trace).
_ENERGY_KEY_REGISTRY: dict = {}


@lru_cache(maxsize=64)
def _make_batched_solver(energy_fn: Callable, population_energy: bool,
                         recombination: float, m_lo: float, m_hi: float,
                         tol: float, energy_limit: float):
    """Build (initial_energies, solve_segment) jitted once per static
    configuration.

    Caching on the (hashable) energy function + scalar hyperparameters lets
    repeated calibrations reuse the jit cache instead of re-tracing the
    whole solver (~2-4 s per call otherwise).  Bounds arrays travel as
    runtime arguments.
    """

    def channel_energy(pop_c, lower_c, upper_c, *data_c):
        denormed = lower_c + pop_c * (upper_c - lower_c)
        if population_energy:
            return energy_fn(denormed, *data_c)
        return jax.vmap(lambda prm: energy_fn(prm, *data_c))(denormed)

    def all_energy(pop, lower, upper, *channel_data):
        # lower/upper are (C, D): per-channel bounds (the refinement
        # stages re-solve each channel in a box around its own best)
        return jax.vmap(
            lambda pc, lo, up, *dc: channel_energy(pc, lo, up, *dc)
        )(pop, lower, upper, *channel_data)

    def channel_generation(key, pop, energies):
        key, k_scale, k_gen = jax.random.split(key, 3)
        scale = jax.random.uniform(k_scale, (), pop.dtype, m_lo, m_hi)
        trials = _evolve_population(k_gen, pop, energies, scale,
                                    recombination)
        return key, trials

    @jax.jit
    def initial_energies(pop0, lower, upper, *channel_data):
        return all_energy(pop0, lower, upper, *channel_data)

    @jax.jit
    def solve_segment(state, end_nit, lower, upper, *channel_data):
        """Run generations until all channels converge or nit reaches
        ``end_nit`` (dynamic)."""

        def cond(state):
            _, _, _, nit, done, _ = state
            return (~jnp.all(done)) & (nit < end_nit)

        def body(state):
            pop, energies, keys, nit, done, frozen_at = state
            keys, trials = jax.vmap(channel_generation)(keys, pop, energies)
            trial_energies = all_energy(trials, lower, upper, *channel_data)
            accept = (trial_energies < energies) & ~done[:, None]
            pop = jnp.where(accept[:, :, None], trials, pop)
            energies = jnp.where(accept, trial_energies, energies)
            nit = nit + 1

            finite = jnp.all(jnp.isfinite(energies), axis=1)
            e_mean = jnp.where(finite, jnp.mean(energies, axis=1), jnp.inf)
            e_std = jnp.where(finite, jnp.std(energies, axis=1), jnp.inf)
            newly_done = (e_std <= tol * jnp.abs(e_mean)) | \
                (jnp.min(energies, axis=1) < energy_limit)
            frozen_at = jnp.where(~done & newly_done, nit, frozen_at)
            return pop, energies, keys, nit, done | newly_done, frozen_at

        return jax.lax.while_loop(cond, body, state)

    return initial_energies, solve_segment


def differential_evolution_batched(energy_fn: Callable,
                                   channel_data: Tuple,
                                   num_channels: int,
                                   num_params: int,
                                   bounds_lower: Array, bounds_upper: Array,
                                   x0: Optional[np.ndarray] = None,
                                   popsize: int = 15,
                                   mutation: Tuple[float, float] = (0.0, 1.95),
                                   recombination: float = 0.4,
                                   tol: float = 0.01,
                                   maxiter: int = 1000,
                                   energy_limit: float = 0.0,
                                   seed: int = 7,
                                   mesh=None, pop_axis: str = "data",
                                   checkpoint_path=None,
                                   checkpoint_every: int = 0,
                                   population_energy: bool = False,
                                   cache_key=None):
    """All channels' DE solves as ONE device computation.

    ``energy_fn(params, *per_channel_data) -> scalar``; every element of
    ``channel_data`` has a leading channel axis (or is None/shared).  The
    population axis vmaps inside each channel and the channel axis vmaps
    over solvers — a (C, S)-batched energy evaluation per generation, one
    compile for the whole calibration.  Converged channels freeze in place
    until the loop exits (reference solves channels in separate joblib
    processes, ICRF_calibration_exposure.py:383-386).

    Returns a DEResult whose fields carry a leading channel axis, plus the
    per-channel iteration count at which each channel froze.

    ``bounds_lower``/``bounds_upper``/``x0`` may be (D,) shared or (C, D)
    per-channel (the refinement stages of :func:`calibration` re-solve
    each channel in a box around its own stage-1 best).

    With ``mesh``, the population axis shards over ``pop_axis``: trial
    generation and energy evaluation run population-parallel on each device
    and only the generation's scalar reductions (argmin/mean/std of the
    energies) cross devices.

    The jitted solver caches on ``energy_fn``'s identity; a fresh closure
    per call re-traces it (~2-4 s).  Pass a hashable ``cache_key`` to
    declare "any callable under this key computes the same function" —
    repeated ad-hoc solves then reuse the compiled solver (the FIRST
    callable registered under the key stays the traced one).
    """
    if cache_key is not None:
        energy_fn = _ENERGY_KEY_REGISTRY.setdefault(
            (cache_key, bool(population_energy)), energy_fn)
    d = num_params
    s = max(5, popsize * d)
    if mesh is not None:
        n_shards = mesh.shape[pop_axis]
        s = -(-s // n_shards) * n_shards  # round up to shardable size
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    lower_np = np.broadcast_to(np.asarray(bounds_lower, float),
                               (num_channels, d))
    upper_np = np.broadcast_to(np.asarray(bounds_upper, float),
                               (num_channels, d))
    lower = jnp.asarray(lower_np, dtype)
    upper = jnp.asarray(upper_np, dtype)

    def denorm(pop_norm):
        # pop_norm: (C, ..., D); bounds broadcast per channel
        shape = (num_channels,) + (1,) * (pop_norm.ndim - 2) + (d,)
        return lower.reshape(shape) + pop_norm * (upper - lower
                                                  ).reshape(shape)

    x0_np = None if x0 is None else np.broadcast_to(
        np.asarray(x0, float), (num_channels, d))
    pops = []
    for c in range(num_channels):
        init_pop = sobol_init_population(s, d, seed + c)
        if x0_np is not None:
            x0_norm = (x0_np[c] - lower_np[c]) / (upper_np[c] - lower_np[c])
            init_pop = init_pop.copy()
            init_pop[0] = np.clip(x0_norm, 0, 1)
        pops.append(init_pop)
    pop0 = jnp.asarray(np.stack(pops), dtype)  # (C, S, D)

    m_lo, m_hi = mutation
    keys0 = jax.vmap(jax.random.PRNGKey)(
        jnp.arange(seed, seed + num_channels))

    initial_energies, solve_segment = _make_batched_solver(
        energy_fn, population_energy, float(recombination), float(m_lo),
        float(m_hi), float(tol), float(energy_limit))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        pop0 = jax.device_put(pop0,
                              NamedSharding(mesh, P(None, pop_axis, None)))
        keys0 = jax.device_put(keys0, NamedSharding(mesh, P()))
        channel_data = tuple(
            None if d is None else jax.device_put(d, NamedSharding(mesh,
                                                                   P()))
            for d in channel_data)

    # --- resume or fresh start ----------------------------------------
    from ..utils.checkpoint import DECheckpoint
    resumed = DECheckpoint.try_load(checkpoint_path) \
        if checkpoint_path is not None else None
    if resumed is not None:
        pop_r, energies_r, keys_r, nit_r, done_r = resumed
        state = (pop_r.astype(dtype), energies_r.astype(dtype), keys_r,
                 jnp.asarray(int(nit_r)), done_r,
                 jnp.full(num_channels, maxiter))
        e0 = jnp.min(energies_r, axis=1)
    else:
        energies0 = initial_energies(pop0, lower, upper, *channel_data)
        e0 = jnp.min(energies0, axis=1)
        state = (pop0, energies0, keys0, jnp.asarray(0),
                 jnp.zeros(num_channels, bool),
                 jnp.full(num_channels, maxiter))

    segment = checkpoint_every if (checkpoint_path is not None
                                   and checkpoint_every) else maxiter
    while True:
        nit_now = int(state[3])
        if bool(jnp.all(state[4])) or nit_now >= maxiter:
            break
        end = min(maxiter, nit_now + segment)
        state = solve_segment(state, jnp.asarray(end), lower, upper,
                              *channel_data)
        if checkpoint_path is not None:
            DECheckpoint.save(checkpoint_path, state[0], state[1],
                              state[2], int(state[3]), state[4])

    pop, energies, _, nit, done, frozen_at = state
    best = jnp.argmin(energies, axis=1)
    ch = jnp.arange(num_channels)
    return DEResult(x=denorm(pop[ch, best]), energy=energies[ch, best],
                    population=denorm(pop), energies=energies,
                    n_iter=int(nit), converged=bool(jnp.all(done)),
                    initial_energy=e0), frozen_at


# ---------------------------------------------------------------------------
# calibration driver (reference ICRF_calibration_exposure.py:219-402)
# ---------------------------------------------------------------------------

def initialize_channel_image_stacks(image_path: Path, use_std: bool,
                                    data_spacing,
                                    config: CameraConfig = DEFAULT_CONFIG):
    """Load, stride-subsample and stack calibration images per channel
    (ICRF_calibration_exposure.py:219-285).

    Returns (value_stacks (C, P, N) uint DNs, std_stacks (C, P, N) or None,
    exposures (N,), pixel_ratio).
    """
    sets = ImageSet.multiple_from_path(image_path, config=config)
    sets.sort(key=lambda s: s.features["exposure"])
    if isinstance(data_spacing, tuple):
        x_step, y_step = data_spacing
    else:
        x_step = y_step = data_spacing

    vals, stds, exposures = [], [], []
    for s in sets:
        exposures.append(s.features["exposure"])
        s.load_value_image(bit64=True)
        if use_std:
            s.load_std_image()
        v = gf.choose_evenly_spaced_points(np.asarray(s.measurand.val),
                                           x_step, y_step)
        vals.append(v.reshape(-1, v.shape[-1]))
        if use_std:
            st = gf.choose_evenly_spaced_points(np.asarray(s.measurand.std),
                                                x_step, y_step)
            stds.append(st.reshape(-1, st.shape[-1]))
        s.release()

    # (N, P, C) -> (C, P, N)
    value_stacks = np.stack(vals).transpose(2, 1, 0)
    std_stacks = np.stack(stds).transpose(2, 1, 0) if use_std else None
    full = config.im_size_x * config.im_size_y
    pixel_ratio = value_stacks.shape[1] / full if full else 0.0
    return (jnp.asarray(value_stacks), None if std_stacks is None
            else jnp.asarray(std_stacks), jnp.asarray(exposures, float),
            pixel_ratio)


@lru_cache(maxsize=64)
def _make_population_energy(use_mean: bool, penalty: str, lower_dn: int,
                            upper_dn: int, datapoints: int, with_std: bool):
    """Population-batched channel energy with a stable identity, so the
    jitted solver built around it caches across calibration() calls."""

    def fn(params_s, pca_c, mean_c, onehot_c, exposures_c, ii_c, jj_c,
           *rest):
        std_c = rest[0] if with_std else None
        mean_for_curve = mean_c if use_mean else None
        curves = jax.vmap(
            lambda prm: icrf_from_params(prm, pca_c, mean_for_curve,
                                         datapoints=datapoints))(params_s)
        return lin_ops.population_linearity_energies(
            curves, onehot_c, std_c, exposures_c, lower_dn, upper_dn,
            ii_c, jj_c, penalty=penalty)
    return fn


@lru_cache(maxsize=64)
def _make_population_energy_hist(use_mean: bool, penalty: str,
                                 lower_dn: int, upper_dn: int,
                                 datapoints: int):
    """Population energy from per-pair joint DN histograms — O(K * bits^2)
    per generation, independent of image resolution (the unweighted
    objective depends on the data only through those histograms)."""

    def fn(params_s, pca_c, mean_c, hists_c, exposures_c, ii_c, jj_c):
        mean_for_curve = mean_c if use_mean else None
        curves = jax.vmap(
            lambda prm: icrf_from_params(prm, pca_c, mean_for_curve,
                                         datapoints=datapoints))(params_s)
        return lin_ops.population_linearity_energies_hist(
            curves, hists_c, exposures_c, lower_dn, upper_dn,
            ii_c, jj_c, penalty=penalty)
    return fn


@lru_cache(maxsize=64)
def _make_population_energy_chunked(use_mean: bool, penalty: str,
                                    lower_dn: int, upper_dn: int,
                                    datapoints: int, with_std: bool,
                                    chunk: int):
    """Population-matmul energy with the data one-hot built per pixel
    chunk inside a scan — keeps the matmul formulation at any resolution
    (the precomputed one-hot caps at ~1 GB)."""

    def fn(params_s, pca_c, mean_c, stack_c, exposures_c, ii_c, jj_c,
           *rest):
        std_c = rest[0] if with_std else None
        mean_for_curve = mean_c if use_mean else None
        curves = jax.vmap(
            lambda prm: icrf_from_params(prm, pca_c, mean_for_curve,
                                         datapoints=datapoints))(params_s)
        return lin_ops.population_linearity_energies_chunked(
            curves, stack_c, std_c, exposures_c, lower_dn, upper_dn,
            ii_c, jj_c, penalty=penalty, chunk=chunk)
    return fn


@lru_cache(maxsize=64)
def _make_polisher(use_mean: bool, penalty: str, lower_dn: int,
                   upper_dn: int, datapoints: int, steps: int, lr: float):
    """Post-DE gradient polish: Adam on the grad-safe histogram energy,
    per channel, accepting the result only when the EXACT DE objective
    strictly improves.

    The reference's manually-stepped SciPy solver never polishes (the
    polish of scipy.optimize.differential_evolution lives outside the
    stepping loop it uses, ICRF_calibration_exposure.py:357-370) — this is
    how the device solver strictly dominates SciPy's final energies while
    keeping identical DE hyperparameters.
    """
    import optax

    exact = _make_population_energy_hist(use_mean, penalty, lower_dn,
                                         upper_dn, datapoints)

    def smooth_e(prm, pca_c, mean_c, hists_c, exposures_c, ii_c, jj_c):
        mean_for_curve = mean_c if use_mean else None
        curve = icrf_from_params(prm, pca_c, mean_for_curve,
                                 datapoints=datapoints)
        return lin_ops.linearity_energy_hist_smooth(
            curve, hists_c, exposures_c, lower_dn, upper_dn, ii_c, jj_c)

    @jax.jit
    def polish(params, *cd):
        def one(prm_c, *dc):
            opt = optax.adam(lr)

            def step(carry, _):
                p, st = carry
                g = jax.grad(smooth_e)(p, *dc)
                up, st = opt.update(g, st)
                return (optax.apply_updates(p, up), st), None

            (pf, _), _ = jax.lax.scan(step, (prm_c, opt.init(prm_c)),
                                      None, length=steps)
            e_old = exact(prm_c[None], *dc)[0]
            e_new = exact(pf[None], *dc)[0]
            better = e_new < e_old
            return (jnp.where(better, pf, prm_c),
                    jnp.where(better, e_new, e_old))
        return jax.vmap(one)(params, *cd)

    return polish


def calibration(lower_PCA_limit: float, upper_PCA_limit: float,
                initial_function: Optional[Array] = None,
                data_spacing=150,
                data_limits: Tuple[int, int] = (5, 250),
                use_std: bool = False,
                image_path: Optional[Path] = None,
                energy_limit: float = 0.0,
                rng_seed: int = 7,
                config: CameraConfig = DEFAULT_CONFIG,
                channel_stacks=None,
                pca_arrays: Optional[np.ndarray] = None,
                mean_icrf_arrays: Optional[np.ndarray] = None,
                popsize: int = 15,
                maxiter: int = 1000,
                tol: float = 0.01,
                mutation: Tuple[float, float] = (0.0, 1.95),
                recombination: float = 0.4,
                penalty: str = "soft",
                mesh=None, pop_axis: str = "data",
                checkpoint_path=None, checkpoint_every: int = 0,
                polish_steps: int = 200, polish_lr: float = 5e-3,
                refine_rounds: int = 2, refine_width: float = 0.075,
                refine_maxiter: int = 500, return_base: bool = False,
                energy_form: str = "auto", return_params: bool = False):
    """Solve the per-channel ICRF by differential evolution
    (ICRF_calibration_exposure.py:288-402).

    Data can come from ``image_path`` (loaded + subsampled like the
    reference) or be injected via ``channel_stacks`` =
    (value_stacks (C,P,N) DNs, std_stacks or None, exposures).  The PCA
    basis / mean curves load from config files unless given directly as
    arrays of shape (C, datapoints, K) / (C, datapoints).

    ``energy_form`` selects the population-batched objective formulation:
    "auto" (default, by memory footprint), "onehot" (precomputed one-hot
    matmul), "hist" (per-pair joint DN histograms, unweighted data only)
    or "chunked" (pixel chunks streamed through the matmul in a scan).
    All three compute the same objective; tests assert their agreement.

    Returns (ICRF (bits, C), initial_energies (C,), final_energies (C,),
    pixel_ratio).  With ``return_base`` the solved (datapoints, C) curve
    is appended; the returned full-size table is its exact np.interp
    expansion.
    With ``return_params`` the solved (C, num_params) parameter vectors
    are appended last — the seed for :func:`~camera_linearity.models
    .scipy_strict.calibration_hybrid`'s exact strict phase.
    """
    cfg = config
    chs = cfg.num_of_chs

    if channel_stacks is not None:
        value_stacks, std_stacks, exposures = channel_stacks
        pixel_ratio = 0.0
    else:
        value_stacks, std_stacks, exposures, pixel_ratio = \
            initialize_channel_image_stacks(image_path, use_std,
                                            data_spacing, config=cfg)

    if pca_arrays is None:
        pca_arrays = np.stack([
            io.read_txt_to_array(cfg.pca_files[c], cfg.data_path)
            for c in range(chs)])
    use_mean_icrf = initial_function is None
    if use_mean_icrf:
        if mean_icrf_arrays is None:
            mean_icrf_arrays = np.stack([
                io.read_txt_to_array(cfg.mean_icrf_files[c], cfg.data_path)
                for c in range(chs)])
    else:
        mean_icrf_arrays = None

    num_pca = pca_arrays.shape[-1]
    if use_mean_icrf:
        limits = [(lower_PCA_limit, upper_PCA_limit)] * num_pca
        x0 = [0.0] * num_pca
    else:
        limits = [(1.0, 8.0)] + [(lower_PCA_limit, upper_PCA_limit)] * num_pca
        x0 = [3.0] + [0.0] * num_pca
    lower_b = np.array([lo for lo, _ in limits])
    upper_b = np.array([hi for _, hi in limits])

    n = value_stacks.shape[-1]
    ii, jj = lin_ops.upper_triangle_pairs(n)
    ii_j, jj_j = jnp.asarray(ii), jnp.asarray(jj)
    lower_dn, upper_dn = int(data_limits[0]), int(data_limits[1])

    value_stacks = jnp.asarray(value_stacks, jnp.int32)

    pca_j = jnp.asarray(np.asarray(pca_arrays), float)           # (C, dp, K)
    mean_j = None if mean_icrf_arrays is None else \
        jnp.asarray(np.asarray(mean_icrf_arrays), float)         # (C, dp)
    use_std_stacks = std_stacks is not None

    exposures_c = jnp.tile(exposures[None, :], (chs, 1))
    ii_c = jnp.tile(ii_j[None, :], (chs, 1))
    jj_c = jnp.tile(jj_j[None, :], (chs, 1))

    # Dummy per-channel placeholders keep the vmapped signature uniform.
    mean_data = mean_j if use_mean_icrf else \
        jnp.zeros((chs, cfg.datapoints))
    std_data = std_stacks if use_std_stacks else None

    # Population-batched objective — three formulations, all evaluating
    # the whole population per generation:
    #  * precomputed-one-hot matmul (fastest) while the (P*N, bits)
    #    one-hot fits in ~1 GB;
    #  * unweighted data condenses into per-pair joint DN histograms —
    #    O(K * bits^2) per generation, resolution-independent;
    #  * std-weighted full-resolution data streams pixel chunks through
    #    the same matmul inside a scan.
    # The round-1 per-candidate vmapped fallback is gone: every size now
    # keeps a population-batched formulation.
    # ``energy_form`` pins a formulation explicitly ("onehot" | "hist" |
    # "chunked"); "auto" picks by memory footprint.  The histogram form
    # requires unweighted data (it condenses pixels away and cannot carry
    # per-pixel stds).
    if energy_form not in ("auto", "onehot", "hist", "chunked"):
        raise ValueError(f"unknown energy_form {energy_form!r}; expected "
                         "'auto', 'onehot', 'hist' or 'chunked'")
    if energy_form == "hist" and use_std_stacks:
        raise ValueError("energy_form='hist' cannot weight by per-pixel "
                         "stds (the histogram condenses pixels away); use "
                         "'onehot' or 'chunked'")
    total_obs = int(np.prod(value_stacks.shape[1:]))
    onehot_bytes = total_obs * cfg.datapoints * 4
    if energy_form == "auto":
        use_onehot = onehot_bytes <= (1 << 30)
        use_hist = not use_onehot and not use_std_stacks
    else:
        use_onehot = energy_form == "onehot"
        use_hist = energy_form == "hist"

    if use_onehot:
        onehots = jnp.stack([
            lin_ops.build_data_onehot(value_stacks[c], cfg.datapoints)
            for c in range(chs)])
        energy_fn = _make_population_energy(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints,
            use_std_stacks)
        channel_data = (pca_j, mean_data, onehots, exposures_c, ii_c, jj_c)
        if use_std_stacks:
            channel_data = channel_data + (std_data,)
    elif use_hist:
        hists = jnp.stack([
            lin_ops.pair_dn_histograms(value_stacks[c], ii_j, jj_j,
                                       cfg.datapoints)
            for c in range(chs)])
        energy_fn = _make_population_energy_hist(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints)
        channel_data = (pca_j, mean_data, hists, exposures_c, ii_c, jj_c)
    else:
        energy_fn = _make_population_energy_chunked(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints,
            use_std_stacks, 16384)
        channel_data = (pca_j, mean_data, value_stacks, exposures_c, ii_c,
                        jj_c)
        if use_std_stacks:
            channel_data = channel_data + (std_data,)

    result, _frozen = differential_evolution_batched(
        energy_fn, channel_data, chs, len(x0), lower_b, upper_b,
        x0=np.array(x0), popsize=popsize, maxiter=maxiter, tol=tol,
        mutation=mutation, recombination=recombination,
        energy_limit=energy_limit, seed=rng_seed,
        mesh=mesh, pop_axis=pop_axis,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        population_energy=True)

    best_x = result.x
    initial_energies = np.asarray(result.initial_energy, float)
    final_energies = np.asarray(result.energy, float)

    # Refinement rounds: re-solve each channel with tol=0 in a narrowed
    # per-channel box around its best (the global stage finds the basin;
    # a short local DE extracts its floor — measured to close most of the
    # residual energy gap to long SciPy runs at ~1/200 the cost).  Accept
    # per channel only on strict improvement.
    for rr in range(refine_rounds):
        # geometric shrink: each round searches a 4x tighter box
        span = refine_width * (upper_b - lower_b) / (4.0 ** rr)
        bx = np.asarray(best_x, float)
        result_r, _ = differential_evolution_batched(
            energy_fn, channel_data, chs, len(x0),
            bx - span[None, :], bx + span[None, :],
            x0=bx, popsize=popsize, maxiter=refine_maxiter, tol=0.0,
            mutation=mutation, recombination=recombination,
            energy_limit=energy_limit, seed=rng_seed + 1000 * (rr + 1),
            mesh=mesh, pop_axis=pop_axis, population_energy=True)
        improved = np.asarray(result_r.energy, float) < final_energies
        best_x = jnp.where(jnp.asarray(improved)[:, None], result_r.x,
                           best_x)
        final_energies = np.where(improved,
                                  np.asarray(result_r.energy, float),
                                  final_energies)

    # Gradient polish (unweighted objective only): Adam on the grad-safe
    # histogram energy, accepted per channel only on strict improvement
    # of the exact DE objective.
    if polish_steps and not use_std_stacks:
        if not use_hist:
            hists = jnp.stack([
                lin_ops.pair_dn_histograms(value_stacks[c], ii_j, jj_j,
                                           cfg.datapoints)
                for c in range(chs)])
        polisher = _make_polisher(use_mean_icrf, penalty, lower_dn,
                                  upper_dn, cfg.datapoints,
                                  int(polish_steps), float(polish_lr))
        best_x, polished_e = polisher(best_x, pca_j, mean_data, hists,
                                      exposures_c, ii_c, jj_c)
        final_energies = np.asarray(polished_e, float)

    icrf_out = np.zeros((cfg.datapoints, chs))
    for c in range(chs):
        mean_c = mean_j[c] if use_mean_icrf else None
        curve = np.asarray(icrf_from_params(best_x[c], pca_j[c], mean_c,
                                            datapoints=cfg.datapoints))
        # endpoint renormalization + clip (:388-396)
        curve = curve + (1.0 - curve[-1])
        curve[0] = 0.0
        icrf_out[:, c] = np.clip(curve, 0.0, 1.0)

    icrf_interpolated = np.asarray(interpolate_curve(jnp.asarray(icrf_out),
                                                     cfg.bits))
    out = (icrf_interpolated, initial_energies, final_energies, pixel_ratio)
    if return_base:
        out = out + (icrf_out,)
    if return_params:
        out = out + (np.asarray(best_x, float),)
    return out

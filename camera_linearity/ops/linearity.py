"""Pairwise exposure-linearity analysis and the calibration energy.

The reference materializes an ``(X, Y, N, N)`` all-pairs broadcast per energy
evaluation (reference: modules/ICRF_calibration_exposure.py:66-145) — the
memory hot spot of the whole package.  Here pairs are enumerated once as
static upper-triangle index vectors of length K = N(N-1)/2 and every
reduction streams over pixels, so peak memory is O(P*K) for the small
subsampled solver stacks and O(tile*K) inside kernels — never O(P*N^2)
broadcast temporaries.  The whole function vmaps over a population of
candidate ICRFs (models/calibration.py) so the entire DE population
evaluates as one batched device computation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .linearize import lut_lookup
from .stats import nanaverage

Array = jnp.ndarray

__all__ = ["upper_triangle_pairs", "valid_exposure_pairs",
           "pairwise_linearity", "linearity_energy",
           "linearity_energy_chunked", "pin_endpoints",
           "monotonicity_penalty_mask", "constraint_violation",
           "population_linearity_energies",
           "population_linearity_energies_chunked",
           "pair_dn_histograms", "population_linearity_energies_hist",
           "linearity_energy_hist_smooth", "build_data_onehot"]


def upper_triangle_pairs(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static i<j index vectors, row-major — matches np.triu_indices(n, 1)
    ordering used at ICRF_calibration_exposure.py:93,143."""
    ii, jj = np.triu_indices(n, k=1)
    return ii.astype(np.int32), jj.astype(np.int32)


def valid_exposure_pairs(exposures: np.ndarray, min_ratio: float = 0.1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """i<j pairs whose exposure ratio t_i/t_j >= min_ratio
    (exposure_series.py:283-304 rejects ratio < 0.1)."""
    ii, jj = upper_triangle_pairs(len(exposures))
    ratio = exposures[ii] / exposures[jj]
    keep = ratio >= min_ratio
    return ii[keep], jj[keep]


def pairwise_linearity(stack_val: Array, stack_std: Optional[Array],
                       exposures: Array, ii: Array, jj: Array,
                       use_relative: bool) -> Tuple[Array, Optional[Array]]:
    """Per-pair |difference| over a pixels-last-but-one stack.

    ``stack_val``: (..., N) with N the exposure axis; returns (..., K) of
    |g_i - r g_j| (absolute) or |(g_i - r g_j)/(r g_j)| (relative) plus the
    first-order std of the (relative) difference when ``stack_std`` given —
    formulas of ICRF_calibration_exposure.py:108-130.
    """
    g_i = stack_val[..., ii]
    g_j = stack_val[..., jj]
    r = (exposures[ii] / exposures[jj]).astype(stack_val.dtype)
    scaled = g_j * r
    diff = g_i - scaled
    if use_relative:
        diff = diff / scaled
    abs_diff = jnp.abs(diff)

    if stack_std is None:
        return abs_diff, None
    s_i = stack_std[..., ii]
    s_j = stack_std[..., jj]
    if use_relative:
        std = jnp.sqrt((s_i / scaled) ** 2
                       + ((g_i * s_j) / (r * g_j ** 2)) ** 2)
    else:
        std = jnp.sqrt(s_i ** 2 + (r * s_j) ** 2)
    return abs_diff, std


def pin_endpoints(icrf: Array) -> Array:
    """Anchor a candidate ICRF curve: shift so the top end hits 1, pin the
    bottom to 0 (ICRF_calibration_exposure.py:167-168)."""
    icrf = icrf + (1.0 - icrf[-1])
    return icrf.at[0].set(0.0)


def monotonicity_penalty_mask(icrf: Array) -> Array:
    """True when the curve is invalid: outside [0,1] or non-strictly-
    increasing.  The reference early-returns inf
    (ICRF_calibration_exposure.py:174-179) — data-dependent control flow jit
    can't take; under jit this mask selects an inf energy instead."""
    out_of_range = (jnp.max(icrf) > 1.0) | (jnp.min(icrf) < 0.0)
    non_monotone = jnp.any(icrf[1:] <= icrf[:-1])
    return out_of_range | non_monotone


def constraint_violation(icrf: Array) -> Array:
    """Graded magnitude of the [0,1]-range and monotonicity violations.

    Zero for valid curves.  Used by the solver's 'soft' penalty mode: the
    reference's hard-inf rejection gives differential evolution no signal to
    find the feasible region; a graded penalty ranks infeasible candidates
    by how badly they violate, which speeds convergence dramatically while
    leaving energies of feasible curves untouched."""
    decreasing = jnp.sum(jnp.maximum(icrf[:-1] - icrf[1:], 0.0))
    over = jnp.maximum(jnp.max(icrf) - 1.0, 0.0)
    under = jnp.maximum(-jnp.min(icrf), 0.0)
    return decreasing + over + under


def linearity_energy(icrf_curve: Array, stack_dn: Array,
                     stack_std: Optional[Array], exposures: Array,
                     lower_dn: int, upper_dn: int,
                     ii: Array, jj: Array,
                     use_relative: bool = True,
                     penalty: str = "hard") -> Array:
    """Scalar linearity energy of one candidate ICRF over one channel stack.

    Faithful jit-able port of _energy_function + analyze_linearity
    (ICRF_calibration_exposure.py:66-201): endpoint pinning, validity -> inf,
    candidate-mapped thresholds, LUT application to the integer DN stack,
    per-pair NaN-masked (optionally 1/std-weighted) mean over pixels, then
    nanmean over pairs.

    ``stack_dn``: (P, N) integer DNs; ``stack_std``: (P, N) float or None;
    ``ii``/``jj``: precomputed pair indices.  vmap over a leading candidate
    axis of ``icrf_curve`` for population-batched evaluation.
    """
    icrf = pin_endpoints(icrf_curve)
    invalid = monotonicity_penalty_mask(icrf)

    lo = icrf[lower_dn]
    hi = icrf[upper_dn]

    # (P, N) linearized values
    g = lut_lookup(stack_dn.astype(jnp.int32)[..., None],
                   icrf[:, None])[..., 0]
    g = jnp.where((g < lo) | (g > hi), jnp.nan, g)

    abs_diff, pair_std = pairwise_linearity(g, stack_std, exposures, ii, jj,
                                            use_relative)
    if stack_std is not None:
        finite = jnp.isfinite(abs_diff) & (pair_std != 0)
        weights = jnp.where(finite, 1.0 / pair_std, jnp.nan)
        per_pair = nanaverage(abs_diff, weights, axis=0)
    else:
        per_pair = jnp.nanmean(abs_diff, axis=0)

    energy = jnp.nanmean(per_pair)
    energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
    if penalty == "soft":
        # Feasible curves keep the exact reference energy; infeasible ones
        # get a large graded penalty instead of inf (see
        # constraint_violation) so the solver can climb into feasibility.
        soft = 1e3 * (1.0 + constraint_violation(icrf))
        return jnp.where(invalid, soft, energy)
    return jnp.where(invalid, jnp.inf, energy)


def population_linearity_energies(curves: Array, data_onehot: Array,
                                  stack_std: Optional[Array],
                                  exposures: Array,
                                  lower_dn: int, upper_dn: int,
                                  ii: Array, jj: Array,
                                  use_relative: bool = True,
                                  penalty: str = "soft") -> Array:
    """Energies of a WHOLE candidate population in one wide matmul.

    Key observation: per generation only the candidate curves change — the
    observed DNs are static.  So instead of vmapping a per-candidate LUT
    gather (which materializes per-candidate one-hots), precompute the
    one-hot of the DATA once, ``data_onehot``: (P*N, bits), and evaluate

        g_all = data_onehot @ curves.T          # (P*N, S), S wide

    for the entire population per generation.  On the reference-sized
    solver problem this drops the per-generation cost ~10x vs the vmapped
    energy (the matmul has a wide N dimension, unlike per-pixel lookups).

    ``curves``: (S, datapoints) raw candidate curves (un-pinned);
    ``stack_std``: (P, N) or None; returns (S,) energies with the same
    semantics as :func:`linearity_energy` under the given ``penalty``.
    """
    s = curves.shape[0]
    n = exposures.shape[0]
    pinned = jax.vmap(pin_endpoints)(curves)                  # (S, dp)
    invalid = jax.vmap(monotonicity_penalty_mask)(pinned)     # (S,)
    lo_t = pinned[:, lower_dn]                                # (S,)
    hi_t = pinned[:, upper_dn]

    g_flat = jnp.dot(data_onehot, pinned.T,
                     precision=jax.lax.Precision.HIGHEST)     # (P*N, S)
    g = g_flat.reshape(-1, n, s)                              # (P, N, S)
    g = jnp.where((g < lo_t) | (g > hi_t), jnp.nan, g)

    g_i = g[:, ii, :]                                         # (P, K, S)
    g_j = g[:, jj, :]
    r = (exposures[ii] / exposures[jj]).astype(g.dtype)[None, :, None]
    scaled = g_j * r
    diff = g_i - scaled
    if use_relative:
        diff = diff / scaled
    abs_diff = jnp.abs(diff)

    if stack_std is not None:
        s_i = stack_std[:, ii, None]
        s_j = stack_std[:, jj, None]
        if use_relative:
            pair_std = jnp.sqrt((s_i / scaled) ** 2
                                + ((g_i * s_j) / (r * g_j ** 2)) ** 2)
        else:
            pair_std = jnp.sqrt(s_i ** 2 + (r * s_j) ** 2)
        finite = jnp.isfinite(abs_diff) & (pair_std != 0)
        wgt = jnp.where(finite, 1.0 / pair_std, 0.0)
        num = jnp.sum(jnp.where(finite, abs_diff * wgt, 0.0), axis=0)
        den = jnp.sum(wgt, axis=0)                            # (K, S)
        per_pair = jnp.where(den == 0, jnp.nan, num / den)
    else:
        per_pair = jnp.nanmean(abs_diff, axis=0)              # (K, S)

    energies = jnp.nanmean(per_pair, axis=0)                  # (S,)
    energies = jnp.where(jnp.isnan(energies), jnp.inf, energies)
    if penalty == "soft":
        soft = 1e3 * (1.0 + jax.vmap(constraint_violation)(pinned))
        return jnp.where(invalid, soft, energies)
    return jnp.where(invalid, jnp.inf, energies)


def build_data_onehot(stack_dn: Array, bits: int,
                      dtype=jnp.float32) -> Array:
    """Static (P*N, bits) one-hot of the observed DNs for
    :func:`population_linearity_energies`."""
    flat = stack_dn.reshape(-1).astype(jnp.int32)
    iota = jnp.arange(bits, dtype=jnp.int32)
    return (flat[:, None] == iota).astype(dtype)


def population_linearity_energies_chunked(curves: Array, stack_dn: Array,
                                          stack_std: Optional[Array],
                                          exposures: Array,
                                          lower_dn: int, upper_dn: int,
                                          ii: Array, jj: Array,
                                          use_relative: bool = True,
                                          penalty: str = "soft",
                                          chunk: int = 16384) -> Array:
    """Population-matmul energies at ANY pixel count.

    :func:`population_linearity_energies` precomputes a (P*N, bits)
    one-hot of the data — above ~1 GB that is not materializable.  Here a
    ``lax.scan`` walks pixel chunks, builds the chunk's one-hot on the fly
    and runs the same wide (chunk*N, bits) @ (bits, S) matmul,
    accumulating per-(K, S) weighted sums — peak memory is
    O(chunk * (bits + K*S)) regardless of P, and the per-generation cost
    keeps the matmul formulation (~10x over the vmapped per-candidate
    energy) at full resolution.  Same semantics/results as the
    unchunked version to float tolerance.
    """
    s = curves.shape[0]
    n = exposures.shape[0]
    bits = curves.shape[1]
    k = ii.shape[0]
    pinned = jax.vmap(pin_endpoints)(curves)                  # (S, dp)
    invalid = jax.vmap(monotonicity_penalty_mask)(pinned)
    lo_t = pinned[:, lower_dn]
    hi_t = pinned[:, upper_dn]
    curves_t = pinned.T                                       # (dp, S)
    r = (exposures[ii] / exposures[jj]).astype(curves.dtype)[None, :, None]

    p = stack_dn.shape[0]
    n_chunks = -(-p // chunk)
    pad = n_chunks * chunk - p
    dn = jnp.pad(stack_dn, ((0, pad), (0, 0))).reshape(n_chunks, chunk, n)
    if stack_std is not None:
        sstd = jnp.pad(stack_std, ((0, pad), (0, 0))).reshape(
            n_chunks, chunk, n)
    live = (jnp.arange(n_chunks * chunk).reshape(n_chunks, chunk) < p)
    iota = jnp.arange(bits, dtype=jnp.int32)

    def body(carry, inputs):
        num, den = carry
        if stack_std is None:
            dn_c, live_c = inputs
            std_c = None
        else:
            dn_c, std_c, live_c = inputs
        onehot = (dn_c.reshape(-1, 1) == iota).astype(curves.dtype)
        g = jnp.dot(onehot, curves_t,
                    precision=jax.lax.Precision.HIGHEST)      # (chunk*N, S)
        g = g.reshape(chunk, n, s)
        g = jnp.where((g < lo_t) | (g > hi_t), jnp.nan, g)
        g_i, g_j = g[:, ii, :], g[:, jj, :]
        scaled = g_j * r
        diff = g_i - scaled
        if use_relative:
            diff = diff / scaled
        abs_diff = jnp.abs(diff)
        if std_c is not None:
            s_i = std_c[:, ii, None]
            s_j = std_c[:, jj, None]
            if use_relative:
                pair_std = jnp.sqrt((s_i / scaled) ** 2
                                    + ((g_i * s_j) / (r * g_j ** 2)) ** 2)
            else:
                pair_std = jnp.sqrt(s_i ** 2 + (r * s_j) ** 2)
            finite = jnp.isfinite(abs_diff) & (pair_std != 0) \
                & live_c[:, None, None]
            wgt = jnp.where(finite, 1.0 / pair_std, 0.0)
        else:
            finite = jnp.isfinite(abs_diff) & live_c[:, None, None]
            wgt = finite.astype(abs_diff.dtype)
        num = num + jnp.sum(jnp.where(finite, abs_diff * wgt, 0.0), axis=0)
        den = den + jnp.sum(wgt, axis=0)
        return (num, den), None

    zero = jnp.zeros((k, s), curves.dtype)
    inputs = (dn, sstd, live) if stack_std is not None else (dn, live)
    (num, den), _ = jax.lax.scan(body, (zero, zero), inputs)
    per_pair = jnp.where(den == 0, jnp.nan, num / den)        # (K, S)
    energies = jnp.nanmean(per_pair, axis=0)
    energies = jnp.where(jnp.isnan(energies), jnp.inf, energies)
    if penalty == "soft":
        soft = 1e3 * (1.0 + jax.vmap(constraint_violation)(pinned))
        return jnp.where(invalid, soft, energies)
    return jnp.where(invalid, jnp.inf, energies)


def pair_dn_histograms(stack_dn: Array, ii: Array, jj: Array,
                       bits: int) -> Array:
    """Joint (dn_i, dn_j) occupancy per exposure pair: (K, bits, bits).

    The unweighted linearity energy depends on the data only through how
    many pixels show each (dn_i, dn_j) combination per pair — so the whole
    pixel axis condenses into K joint histograms ONCE, and every energy
    evaluation afterwards is O(K * bits^2) independent of resolution.
    Built with segment_sum.
    """
    # jnp.asarray, not .astype: a NumPy stack_dn would otherwise hit the
    # vmapped tracer indices below with NumPy fancy indexing and fail
    dn = jnp.asarray(stack_dn, jnp.int32)

    def one_pair(i, j):
        combined = dn[:, i] * bits + dn[:, j]
        return jax.ops.segment_sum(jnp.ones_like(combined, jnp.int32),
                                   combined, num_segments=bits * bits
                                   ).reshape(bits, bits)

    return jax.vmap(one_pair)(jnp.asarray(ii), jnp.asarray(jj))


def population_linearity_energies_hist(curves: Array, hists: Array,
                                       exposures: Array,
                                       lower_dn: int, upper_dn: int,
                                       ii: Array, jj: Array,
                                       use_relative: bool = True,
                                       penalty: str = "soft") -> Array:
    """Resolution-independent population energies from joint histograms.

    For the unweighted objective (the reference's default: no std images,
    ICRF_calibration_exposure.py:139) the per-pair mean over pixels of
    |g[dn_i] - r g[dn_j]| / (r g[dn_j]) is exactly

        sum_ab H_k(a,b) valid(a,b) d_k(a,b) / sum_ab H_k(a,b) valid(a,b)

    with ``H_k`` from :func:`pair_dn_histograms`.  Per generation this
    costs O(S * K * bits^2) — a few hundred microseconds for the full
    DE population at ANY image resolution, where the pixel-streamed
    formulations scale with P.  Exact same masking/NaN semantics as
    :func:`linearity_energy`.
    """
    k = ii.shape[0]
    pinned = jax.vmap(pin_endpoints)(curves)                  # (S, dp)
    invalid = jax.vmap(monotonicity_penalty_mask)(pinned)
    lo_t = pinned[:, lower_dn][:, None]                       # (S, 1)
    hi_t = pinned[:, upper_dn][:, None]
    valid_dn = (pinned >= lo_t) & (pinned <= hi_t)            # (S, bits)
    g_mask = jnp.where(valid_dn, pinned, jnp.nan)
    r_all = (exposures[ii] / exposures[jj]).astype(curves.dtype)

    hists_f = hists.astype(curves.dtype)                      # (K, b, b)

    def per_pair(h_k, r_k):
        gi = g_mask[:, :, None]                               # (S, b, 1)
        gj = g_mask[:, None, :] * r_k                         # (S, 1, b)
        diff = gi - gj
        if use_relative:
            diff = diff / gj
        d = jnp.abs(diff)                                     # (S, b, b)
        ok = jnp.isfinite(d)
        w = ok.astype(d.dtype) * h_k[None]
        num = jnp.sum(jnp.where(ok, d, 0.0) * h_k[None], axis=(1, 2))
        den = jnp.sum(w, axis=(1, 2))
        return jnp.where(den == 0, jnp.nan, num / den)        # (S,)

    per = jax.lax.map(lambda args: per_pair(*args), (hists_f, r_all))
    energies = jnp.nanmean(per, axis=0)                       # (S,)
    energies = jnp.where(jnp.isnan(energies), jnp.inf, energies)
    if penalty == "soft":
        soft = 1e3 * (1.0 + jax.vmap(constraint_violation)(pinned))
        return jnp.where(invalid, soft, energies)
    return jnp.where(invalid, jnp.inf, energies)


def linearity_energy_hist_smooth(icrf_curve: Array, hists: Array,
                                 exposures: Array,
                                 lower_dn: int, upper_dn: int,
                                 ii: Array, jj: Array,
                                 use_relative: bool = True,
                                 penalty_weight: float = 1e3) -> Array:
    """Gradient-safe scalar energy from joint DN histograms.

    Same value as :func:`linearity_energy` on feasible curves (masked
    entries are excluded via explicit 0/1 weights instead of NaN
    propagation, so ``jax.grad`` is finite — the where-NaN trap), plus an
    ADDITIVE graded constraint penalty (instead of the DE objective's
    where-switch) so infeasible iterates keep a descent direction.  Used
    by the post-DE gradient polish (models/calibration.py); acceptance is
    always re-checked against the exact DE objective.
    """
    icrf = pin_endpoints(icrf_curve)
    lo = icrf[lower_dn]
    hi = icrf[upper_dn]
    valid = (icrf >= lo) & (icrf <= hi)                       # (bits,)
    gsafe = jnp.where(valid, icrf, 1.0)
    r_all = (exposures[ii] / exposures[jj]).astype(icrf.dtype)
    hists_f = hists.astype(icrf.dtype)

    def per_pair(h_k, r_k):
        ok = (valid[:, None] & valid[None, :]).astype(icrf.dtype)
        gj = gsafe[None, :] * r_k
        diff = gsafe[:, None] - gj
        if use_relative:
            diff = diff / gj
        d = jnp.abs(diff)
        w = ok * h_k
        num = jnp.sum(d * w)
        den = jnp.sum(w)
        return num / jnp.maximum(den, 1.0), (den > 0).astype(icrf.dtype)

    per, alive = jax.lax.map(lambda args: per_pair(*args),
                             (hists_f, r_all))
    base = jnp.sum(per * alive) / jnp.maximum(jnp.sum(alive), 1.0)
    return base + penalty_weight * constraint_violation(icrf)


def linearity_energy_chunked(icrf_curve: Array, stack_dn: Array,
                             stack_std: Optional[Array], exposures: Array,
                             lower_dn: int, upper_dn: int,
                             ii: Array, jj: Array,
                             use_relative: bool = True,
                             penalty: str = "hard",
                             chunk: int = 65536) -> Array:
    """Pixel-streamed variant of :func:`linearity_energy`.

    The plain energy materializes a (P, K) pairwise tensor; at full
    resolution (no subsampling) that explodes under a vmapped population.
    Here a ``lax.scan`` walks pixel chunks accumulating per-pair weighted
    sums and weights (or sums and counts), so peak memory is O(chunk * K)
    regardless of P — the streamed objective SURVEY.md §5 calls for.
    Results match :func:`linearity_energy` to float tolerance.
    """
    icrf = pin_endpoints(icrf_curve)
    invalid = monotonicity_penalty_mask(icrf)
    lo_t = icrf[lower_dn]
    hi_t = icrf[upper_dn]

    p = stack_dn.shape[0]
    k = ii.shape[0]
    n_chunks = -(-p // chunk)
    pad = n_chunks * chunk - p

    dn = jnp.pad(stack_dn, ((0, pad), (0, 0)))
    dn = dn.reshape(n_chunks, chunk, -1)
    if stack_std is not None:
        sstd = jnp.pad(stack_std, ((0, pad), (0, 0)))
        sstd = sstd.reshape(n_chunks, chunk, -1)
    # mask for the padded tail
    live = (jnp.arange(n_chunks * chunk).reshape(n_chunks, chunk) < p)

    def body(carry, inputs):
        num, den = carry
        if stack_std is None:
            dn_c, live_c = inputs
            std_c = None
        else:
            dn_c, std_c, live_c = inputs
        g = lut_lookup(dn_c.astype(jnp.int32)[..., None],
                       icrf[:, None])[..., 0]
        g = jnp.where((g < lo_t) | (g > hi_t), jnp.nan, g)
        abs_diff, pair_std = pairwise_linearity(g, std_c, exposures, ii, jj,
                                                use_relative)
        if stack_std is not None:
            finite = jnp.isfinite(abs_diff) & (pair_std != 0) & \
                live_c[:, None]
            wgt = jnp.where(finite, 1.0 / pair_std, 0.0)
            num = num + jnp.sum(jnp.where(finite, abs_diff * wgt, 0.0),
                                axis=0)
            den = den + jnp.sum(wgt, axis=0)
        else:
            finite = jnp.isfinite(abs_diff) & live_c[:, None]
            num = num + jnp.sum(jnp.where(finite, abs_diff, 0.0), axis=0)
            den = den + jnp.sum(finite, axis=0)
        return (num, den), None

    zero = jnp.zeros((k,), icrf.dtype)
    inputs = (dn, sstd, live) if stack_std is not None else (dn, live)
    (num, den), _ = jax.lax.scan(body, (zero, zero), inputs)
    per_pair = jnp.where(den == 0, jnp.nan, num / den)
    energy = jnp.nanmean(per_pair)
    energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
    if penalty == "soft":
        soft = 1e3 * (1.0 + constraint_violation(icrf))
        return jnp.where(invalid, soft, energy)
    return jnp.where(invalid, jnp.inf, energy)

"""ICRF parameterization over a PCA basis.

The candidate inverse camera response function is ``mean_icrf + PCA @ params``
or, without a mean curve, ``linspace(0,1)**p0 + PCA @ params[1:]``
(reference: modules/ICRF_calibration_exposure.py:20-44).
"""
from __future__ import annotations

from typing import Optional

import jax.lax
import jax.numpy as jnp

Array = jnp.ndarray

__all__ = ["icrf_from_params"]


def icrf_from_params(params: Array, pca_basis: Array,
                     mean_icrf: Optional[Array] = None,
                     datapoints: Optional[int] = None) -> Array:
    """Candidate ICRF curve from PCA coefficients.

    ``params``: (K,) with mean curve, or (K+1,) without (params[0] is the
    exponent of the power-law base curve); ``pca_basis``: (datapoints, K).
    vmap over a leading population axis of ``params`` for batched candidates.

    The K-dim matvec is pinned to HIGHEST precision: at DEFAULT a GPU may
    run a float32 matmul in TF32 (a 10-bit mantissa), putting ~1e-3 noise
    on every candidate curve; a (datapoints, K<=8) matvec gains nothing
    from reduced precision.
    """
    if mean_icrf is None:
        if datapoints is None:
            datapoints = pca_basis.shape[0]
        base = jnp.linspace(0.0, 1.0, datapoints) ** params[0]
        return base + jnp.matmul(pca_basis, params[1:],
                                 precision=jax.lax.Precision.HIGHEST)
    return mean_icrf + jnp.matmul(pca_basis, params,
                                  precision=jax.lax.Precision.HIGHEST)

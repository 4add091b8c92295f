"""Multivariate-normal math, Cholesky-parameterised.

Capability parity with `_primitives/math/mvn/base.py` (logpdf:15-58, rvs:61-75,
get_optimal_covariance:78-105, tril_log_det:108-128) — independent
implementation with dtype-aware saturation so it is correct under f32 (the
reference clips at 1e500, which only makes sense in f64).

Semantics kept from the reference because they are load-bearing for
missing-data handling upstream: non-finite rows of `chol` are treated as
"infinite-variance" dimensions and contribute nothing to the logpdf; the
effective dimension counts only finite diagonal entries.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_LOG_2PI = math.log(2.0 * math.pi)


def tril_log_det(chol):
    """Log-determinant of a lower-triangular factor, ignoring non-finite
    diagonal entries (they correspond to infinite-variance dims)."""
    if jnp.ndim(chol) >= 2:
        diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    else:
        diag = chol
    diag = jnp.nan_to_num(diag, nan=1.0, posinf=1.0, neginf=1.0)
    return jnp.nansum(jnp.log(jnp.abs(diag)), axis=-1)


def logpdf(x, m, chol):
    """Gaussian log-density N(x; m, chol chol^T), broadcast over leading dims.

    Non-finite entries in `chol` are saturated to a large finite value of the
    working dtype, so those dimensions effectively drop out; the 2-pi
    normalisation counts only finite-variance dimensions.
    """
    x, m = jnp.broadcast_arrays(jnp.asarray(x), jnp.asarray(m))
    chol = jnp.asarray(chol)

    if chol.ndim == 2 and x.ndim >= 2:
        # Unbatched factor, batched points: ONE triangular solve against the
        # stacked right-hand sides. Broadcasting the factor to the batch
        # instead would re-factor the SAME (d, d) triangle once per batch
        # element — O(N d^3) work per logpdf instead of O(d^3).
        diag = jnp.diagonal(chol)
        finite = jnp.isfinite(diag)
        dim = jnp.sum(finite, axis=-1)
        big = jnp.sqrt(jnp.finfo(chol.dtype).max)
        chol_sat = jnp.nan_to_num(chol, nan=big, posinf=big, neginf=-big)
        diff = x - m
        flat = diff.reshape(-1, diff.shape[-1])
        y = solve_triangular(chol_sat, flat.T, lower=True).T.reshape(diff.shape)
        log_norm = tril_log_det(chol) + 0.5 * dim * _LOG_2PI
        quad = jnp.sum(jnp.where(finite, y * y, 0.0), axis=-1)
        out = -0.5 * quad - log_norm
        cap = jnp.finfo(chol.dtype).max
        return jnp.clip(out, -cap, cap)

    batch = jnp.broadcast_shapes(x.shape[:-1], chol.shape[:-2])
    x = jnp.broadcast_to(x, batch + x.shape[-1:])
    m = jnp.broadcast_to(m, batch + m.shape[-1:])
    chol = jnp.broadcast_to(chol, batch + chol.shape[-2:])

    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    finite = jnp.isfinite(diag)
    dim = jnp.sum(finite, axis=-1)

    big = jnp.sqrt(jnp.finfo(chol.dtype).max)
    chol_sat = jnp.nan_to_num(chol, nan=big, posinf=big, neginf=-big)
    y = solve_triangular(chol_sat, (x - m)[..., None], lower=True)[..., 0]

    log_norm = tril_log_det(chol) + 0.5 * dim * _LOG_2PI
    quad = jnp.sum(jnp.where(finite, y * y, 0.0), axis=-1)

    out = -0.5 * quad - log_norm
    cap = jnp.finfo(chol.dtype).max
    return jnp.clip(out, -cap, cap)


def rvs(key, m, chol):
    """Draw one sample from N(m, chol chol^T) (broadcasts over leading dims)."""
    eps = jax.random.normal(key, shape=m.shape, dtype=m.dtype)
    return m + jnp.einsum("...ij,...j->...i", chol, eps)


def get_optimal_covariance(chol_P, chol_Sig):
    """Smallest covariance (in the sense of Corenflos et al., Sec. 3)
    dominating both `chol_P chol_P^T` and `chol_Sig chol_Sig^T`.

    Returns the Cholesky factor of the dominating matrix.
    """
    if (jnp.ndim(chol_P) < 2 and jnp.ndim(chol_Sig) < 2) or chol_P.shape[-1] == 1:
        return jnp.maximum(chol_P, chol_Sig)

    # Whiten Sig by P, clamp eigenvalues below 1 from above, unwhiten.
    right = solve_triangular(chol_P, chol_Sig, lower=True)
    w, v = jnp.linalg.eigh(right.T @ right)
    w = jnp.minimum(w, 1.0)
    left = chol_Sig @ (v / jnp.sqrt(w)[None, :])
    return jnp.linalg.cholesky(left @ left.T)

"""Multivariate Student-t with banded grid precision, applied as a stencil.

Capability parity with `examples/spatial/t_distribution.py:10-104` —
independent implementation. The reference stores the precision as a sparse
BCOO and multiplies sparsely; here the banded
precision of the d x d grid is applied as a dense 2-D convolution with the
equivalent stencil (fully batched). A dense-matrix path is
kept for generic precisions.
"""
from functools import partial

import jax
import jax.numpy as jnp


def apply_precision_stencil(v, stencil, d):
    """y = P v for grid-shaped fields: v (..., d*d) -> (..., d*d) via conv2d
    with the precision stencil (zero padding = grid clipping)."""
    batch_shape = v.shape[:-1]
    grid = v.reshape((-1, 1, d, d))
    k = stencil.shape[0]
    kernel = stencil.reshape((1, 1, k, k)).astype(v.dtype)
    out = jax.lax.conv_general_dilated(
        grid, kernel, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out.reshape(batch_shape + (d * d,))


def quad_form_stencil(x, mu, stencil, d):
    """(x-mu)^T P (x-mu) with the stencil apply; batched over leading dims."""
    diff = x - mu
    return jnp.sum(diff * apply_precision_stencil(diff, stencil, d), axis=-1)


def logpdf(x, mu, nu, prec=None, stencil=None, d=None):
    """Unnormalised multivariate-t log-density
    -(nu + dim)/2 * log(1 + (x-mu)^T P (x-mu)/nu).

    Pass either a dense `prec` matrix, or a grid `stencil` + grid side `d`.
    Batched over leading dims of x/mu.
    """
    x, mu = jnp.broadcast_arrays(x, mu)
    dim = x.shape[-1]
    diff = x - mu
    if stencil is not None:
        norm = quad_form_stencil(x, mu, jnp.asarray(stencil), d)
    else:
        norm = jnp.einsum("...i,ij,...j->...", diff, prec, diff)
    return -0.5 * (nu + dim) * jnp.log1p(norm / nu)


def sample(key, mu, nu, chol_prec):
    """Draw from the multivariate t with the given upper Cholesky of the
    precision (scale-mixture construction). `key` may be a single typed key
    or an array of keys (one draw per key, broadcast against `mu`)."""
    def one(k, m):
        k1, k2 = jax.random.split(k)
        eps = jax.random.normal(k1, m.shape)
        y = jax.scipy.linalg.solve_triangular(chol_prec, eps, lower=False)
        u = 2.0 * jax.random.gamma(k2, 0.5 * nu) / nu
        return m + y / jnp.sqrt(u)

    if jnp.ndim(key) == 0:
        return one(key, mu)
    mu_b = jnp.broadcast_to(mu, key.shape + mu.shape[-1:]) if mu.ndim == 1 else mu
    return jax.vmap(one)(key, mu_b)

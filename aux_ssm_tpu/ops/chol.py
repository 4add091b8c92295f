"""Robust Cholesky factorization.

The reference guards its Cholesky by projecting onto the PSD cone with an SVD
(`_primitives/math/utils.py:42-66`). Here the SVD is avoided; instead we
symmetrize and add a relative jitter on the diagonal, which is the standard production approach and keeps the op fully
batched/fusable.
"""
import jax.numpy as jnp


def safe_cholesky(P, rel_jitter=None):
    """Cholesky of a (supposedly) PSD matrix, robust to slight asymmetry or
    tiny negative eigenvalues.

    Parameters
    ----------
    P : Array (d, d)
        Matrix to factor. Batched via gufunc vectorization.
    rel_jitter : float, optional
        Relative diagonal jitter. Defaults to 32 * eps for the dtype.

    Returns
    -------
    L : Array (d, d)
        Lower-triangular factor. NaN columns are replaced by 0 so that a
        zero-uncertainty (rank-deficient) covariance yields a usable factor,
        mirroring the reference's `nan_to_num` guards
        (`_primitives/kalman/sampling.py:103-104`).
    """
    P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
    if rel_jitter is None:
        rel_jitter = 32.0 * float(jnp.finfo(P.dtype).eps)
    d = P.shape[-1]
    scale = jnp.einsum("...ii->...", P)[..., None, None] / d
    P = P + (rel_jitter * scale) * jnp.eye(d, dtype=P.dtype)
    L = jnp.linalg.cholesky(P)
    return jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)

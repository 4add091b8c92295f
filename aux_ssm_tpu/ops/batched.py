"""Tiny helpers for explicitly-batched small-matrix algebra.

All hot-path operators use these instead of `jnp.vectorize` gufunc wrappers,
so XLA sees plain batched algebra on (..., d, d) arrays inside
`associative_scan`. Plain broadcasting ops keep the same (T, ...) / (T, B, ...) shape-polymorphism the reference gets
from gufunc signatures (`filtering.py:83,163`), at native XLA speed.
"""
import jax.numpy as jnp


def mT(M):
    """Batched matrix transpose."""
    return jnp.swapaxes(M, -1, -2)


def mv(M, v):
    """Batched matrix-vector product (..., i, j), (..., j) -> (..., i)."""
    return jnp.einsum("...ij,...j->...i", M, v)


def sym(M):
    """Symmetrize."""
    return 0.5 * (M + mT(M))


def bdiag(M):
    """Batched diagonal (..., d, d) -> (..., d)."""
    return jnp.diagonal(M, axis1=-2, axis2=-1)

"""Feynman–Kac model interface for cSMC samplers.

Capability parity with `_primitives/csmc/base.py:18-71` — independent
implementation. Four small pytree-dataclass ABCs describe the model:

  M0 : Distribution          — initial proposal/model distribution
  G0 : UnivariatePotential   — initial potential (weight at t=0)
  Mt : Dynamics              — proposal/model transition kernels
  Gt : Potential             — transition potentials (weights at t>=1)

`Dynamics`/`Potential` carry a pytree `params` whose leading axis is time;
the cSMC scan slices one time step per iteration. All classes are chex
dataclasses so instances are pytrees and can cross jit/vmap/shard_map
boundaries as data.
"""
import abc
import math
from typing import Optional

import chex
import jax.numpy as jnp

from .base import SamplerState

_NOT_IMPLEMENTED_MSG = (
    "logpdf is not implemented for {} but was called; backward-sampling "
    "variants require a valid logpdf — implement it or use backward=False."
)


@chex.dataclass
class CSMCState(SamplerState):
    """State of a cSMC chain: reference trajectory and per-time-step update
    indicator (ancestor != 0)."""
    x: chex.ArrayTree
    updated: chex.Array


@chex.dataclass
class UnivariatePotential(abc.ABC):
    """Potential x -> log G_0(x); batched over the particle axis."""

    def __call__(self, x):
        raise NotImplementedError


@chex.dataclass
class Distribution(abc.ABC):
    """A sampleable distribution with optional logpdf."""

    def sample(self, key, N):
        raise NotImplementedError

    def logpdf(self, x):
        raise NotImplementedError(_NOT_IMPLEMENTED_MSG.format(type(self).__name__))


@chex.dataclass
class Dynamics(abc.ABC):
    """Conditional distribution x_{t+1} | x_t with per-time-step params.

    Implementations may additionally provide

        sample_from_noise(eps, x_t, params)

    mapping standard-normal noise `eps` (same shape as `x_t`) to a sample —
    any location-scale family can. When present, the cSMC forward pass
    hoists all proposal RNG out of its `lax.scan` (one batched (T, N, d)
    normal draw instead of a per-step threefry chain), which would otherwise
    dominate the step cost at small N.
    """
    params: Optional[chex.ArrayTree] = None

    def sample(self, key, x_t, params):
        raise NotImplementedError

    def logpdf(self, x_t_p_1, x_t, params):
        raise NotImplementedError(_NOT_IMPLEMENTED_MSG.format(type(self).__name__))

    # Optional protocol:
    #
    #   logpdf_factors(x_prev, x_next, params)
    #       -> (row_feat (N,k), col_feat (N,k), row_bias (N,), col_bias (N,))
    #
    # factorising logpdf(x_next[j] | x_prev[i]) over ALL (i, j) pairs as
    # row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j]. Every Gaussian
    # transition has this form (the quadratic cross-term is rank-d); it lets
    # the parallel-in-time stitching step run as blockwise matmuls
    # instead of an N^2 nested vmap (see `ops/stitching.py`). Use
    # `diag_gaussian_pair_factors` for diagonal-covariance dynamics.


def diag_gaussian_pair_factors(mean_prev, x_next, sig):
    """Pair-factorise N(x_next[j]; mean_prev[i], diag(sig^2)) log-densities.

    mean_prev (N, d): per-row conditional means; x_next (N, d); sig scalar or
    (d,). Returns (row_feat, col_feat, row_bias, col_bias) with
    row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j] == logpdf(j | i).
    """
    d = x_next.shape[-1]
    sig = jnp.broadcast_to(jnp.asarray(sig, x_next.dtype), (d,))
    row_feat = mean_prev / sig
    col_feat = x_next / sig
    row_bias = -0.5 * jnp.sum(row_feat ** 2, axis=-1)
    col_bias = (-0.5 * jnp.sum(col_feat ** 2, axis=-1)
                - jnp.sum(jnp.log(sig)) - 0.5 * d * math.log(2.0 * math.pi))
    return row_feat, col_feat, row_bias, col_bias


def chol_gaussian_pair_factors(mean_prev, x_next, chol):
    """Pair-factorise N(x_next[j]; mean_prev[i], chol chol^T) log-densities
    (full covariance: whiten both sides by chol^{-1})."""
    import jax.scipy.linalg as jsl

    d = x_next.shape[-1]
    row_feat = jsl.solve_triangular(chol, mean_prev.T, lower=True).T
    col_feat = jsl.solve_triangular(chol, x_next.T, lower=True).T
    row_bias = -0.5 * jnp.sum(row_feat ** 2, axis=-1)
    col_bias = (-0.5 * jnp.sum(col_feat ** 2, axis=-1)
                - jnp.sum(jnp.log(jnp.diag(chol)))
                - 0.5 * d * math.log(2.0 * math.pi))
    return row_feat, col_feat, row_bias, col_bias


@chex.dataclass
class Potential(abc.ABC):
    """Potential (x_{t+1}, x_t) -> log G_t with per-time-step params.

    Set the class attribute `prev_dependent = False` on implementations whose
    value depends only on x_{t+1} (true for every observation-density
    potential in the reference's examples): the PIT stitching step can then
    absorb the potential into a per-column bias and run fully fused.
    """
    params: Optional[chex.ArrayTree] = None
    prev_dependent = True

    def __call__(self, x_t_p_1, x_t, params):
        raise NotImplementedError

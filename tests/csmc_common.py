"""Shared Feynman–Kac toy models for cSMC tests: a linear-Gaussian SSM whose
exact smoothing distribution is available from the Kalman oracle, expressed
through the cSMC model interface."""
import chex
import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.stats import norm

from aux_ssm_tpu.kernels.csmc_base import (
    Distribution, UnivariatePotential, Dynamics, Potential,
    diag_gaussian_pair_factors,
)


@chex.dataclass
class GaussianM0(Distribution):
    m0: chex.Array
    sig0: chex.Array

    def sample(self, key, N):
        return self.m0[None] + self.sig0[None] * jax.random.normal(
            key, (N, self.m0.shape[0]), dtype=self.m0.dtype)

    def logpdf(self, x):
        return jnp.sum(norm.logpdf(x, self.m0, self.sig0), axis=-1)


@chex.dataclass
class FlatG0(UnivariatePotential):
    def __call__(self, x):
        return jnp.zeros(x.shape[0], dtype=x.dtype)


@chex.dataclass
class GaussianObsG0(UnivariatePotential):
    y: chex.Array
    sig: chex.Array

    def __call__(self, x):
        return jnp.sum(norm.logpdf(self.y, x, self.sig), axis=-1)


@chex.dataclass
class ARDynamics(Dynamics):
    """x_{t+1} = phi * x_t + sig * eps; params = (phi_t, sig_t) per step."""

    def sample(self, key, x_t, params):
        return self.sample_from_noise(
            jax.random.normal(key, x_t.shape, dtype=x_t.dtype), x_t, params)

    def sample_from_noise(self, eps, x_t, params):
        phi, sig = params
        return phi * x_t + sig * eps

    def logpdf(self, x_t_p_1, x_t, params):
        phi, sig = params
        return jnp.sum(norm.logpdf(x_t_p_1, phi * x_t, sig), axis=-1)

    def logpdf_factors(self, x_prev, x_next, params):
        phi, sig = params
        return diag_gaussian_pair_factors(phi * x_prev, x_next, sig)


@chex.dataclass
class FlatGt(Potential):
    def __call__(self, x_t_p_1, x_t, params):
        return jnp.zeros(x_t_p_1.shape[0], dtype=x_t_p_1.dtype)


@chex.dataclass
class GaussianObsGt(Potential):
    """params = (y_t, sig_t): potential log N(y_t; x_t, sig_t^2)."""

    def __call__(self, x_t_p_1, x_t, params):
        y, sig = params
        return jnp.sum(norm.logpdf(y, x_t_p_1, sig), axis=-1)


def force_generic_sweeps(monkeypatch):
    """Route every cSMC sweep through the generic `lax.scan` passes (as for
    a model without the specialised protocols), for comparisons against the
    specialised sweeps the same model takes by default."""
    from aux_ssm_tpu.kernels import csmc
    for name in ("_use_factor_forward", "_use_lane_forward",
                 "_use_block_lane_forward", "_use_factor_backward"):
        monkeypatch.setattr(csmc, name, lambda *a: False)


def ar1_lgssm_arrays(T, d, phi, sig_x, sig_y, m0=0.0, sig0=1.0):
    """The same model as explicit LGSSM arrays for the Kalman oracle."""
    eye = np.eye(d)
    return (
        np.full(d, m0), sig0 ** 2 * eye,
        np.tile(phi * eye, (T - 1, 1, 1)), np.tile(sig_x ** 2 * eye, (T - 1, 1, 1)),
        np.zeros((T - 1, d)),
        np.tile(eye, (T, 1, 1)), np.tile(sig_y ** 2 * eye, (T, 1, 1)), np.zeros((T, d)),
    )

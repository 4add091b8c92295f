"""Theta-logistic population model (BASELINE config #3): particle Gibbs with
ancestor sampling on the classic nonlinear population SSM.

Model (log-abundance x):
    x_0 ~ N(m0, sig0^2)
    x_{t+1} = x_t + tau0 - tau1 * exp(tau2 * x_t) + sig_x eps
    y_t = x_t + sig_y eta

No reference counterpart (the reference has four other examples); included to
cover the benchmark configuration and to exercise PGAS ancestor sampling.
"""
import chex
import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from ..kernels import csmc
from ..kernels.csmc_base import (
    Distribution, UnivariatePotential, Dynamics, Potential,
    diag_gaussian_pair_factors,
)


DEFAULTS = dict(tau0=0.15, tau1=0.12, tau2=0.10, sig_x=0.3, sig_y=0.1,
                m0=1.0, sig0=0.5)


def drift(x, tau0, tau1, tau2):
    return x + tau0 - tau1 * jnp.exp(tau2 * x)


def get_data(key, T, **params):
    p = {**DEFAULTS, **params}
    k0, kx, ky = jax.random.split(key, 3)
    x0 = p["m0"] + p["sig0"] * jax.random.normal(k0)

    def body(x, k):
        x_next = drift(x, p["tau0"], p["tau1"], p["tau2"]) + p["sig_x"] * jax.random.normal(k)
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0, jax.random.split(kx, T - 1))
    xs = jnp.concatenate([x0[None], xs])[:, None]
    ys = xs + p["sig_y"] * jax.random.normal(ky, xs.shape)
    return xs, ys


def get_feynman_kac(ys, **params):
    """Bootstrap Feynman–Kac decomposition: proposals = model dynamics,
    potentials = observation densities."""
    p = {**DEFAULTS, **params}
    T = ys.shape[0]

    @chex.dataclass
    class M0(Distribution):
        def sample(self, key, N):
            return p["m0"] + p["sig0"] * jax.random.normal(key, (N, 1))

        def logpdf(self, x):
            return jnp.sum(norm.logpdf(x, p["m0"], p["sig0"]), -1)

    @chex.dataclass
    class Mt(Dynamics):
        def sample(self, key, x_t, _p):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, _p)

        def sample_from_noise(self, eps, x_t, _p):
            mu = drift(x_t, p["tau0"], p["tau1"], p["tau2"])
            return mu + p["sig_x"] * eps

        def logpdf(self, x_next, x_t, _p):
            mu = drift(x_t, p["tau0"], p["tau1"], p["tau2"])
            return jnp.sum(norm.logpdf(x_next, mu, p["sig_x"]), -1)

        def logpdf_factors(self, x_prev, x_next, _p):
            mu = drift(x_prev, p["tau0"], p["tau1"], p["tau2"])
            return diag_gaussian_pair_factors(mu, x_next, p["sig_x"])

        # (1, N) lane-row callables for the bootstrap forward sweep
        # (`ops/csmc_sweeps.lane_scan`).
        def lane_propagate(self, eps, x_prev, _p):
            return drift(x_prev, p["tau0"], p["tau1"], p["tau2"]) \
                + p["sig_x"] * eps

        def lane_logpdf(self, x_next, x_prev, _p):
            mu = drift(x_prev, p["tau0"], p["tau1"], p["tau2"])
            return norm.logpdf(x_next, mu, p["sig_x"])

    @chex.dataclass
    class G0(UnivariatePotential):
        def __call__(self, x):
            return jnp.sum(norm.logpdf(ys[0], x, p["sig_y"]), -1)

    @chex.dataclass
    class Gt(Potential):
        prev_dependent = False

        def __call__(self, x_next, _x_t, y):
            return jnp.sum(norm.logpdf(y, x_next, p["sig_y"]), -1)

        def lane_logw(self, x_next, _x_prev, y):
            return norm.logpdf(y, x_next, p["sig_y"])

    return M0(), G0(), Mt(params=jnp.zeros((T - 1, 0))), Gt(params=ys[1:])


def get_pgas_kernel(ys, n_particles, backward=False, ancestor_sampling=True,
                    resampling="multinomial", **params):
    """Particle Gibbs with ancestor sampling (bootstrap proposals).

    Note the returned kernel has signature kernel(key, state) — no delta
    (bootstrap cSMC needs no auxiliary step size)."""
    M0, G0, Mt, Gt = get_feynman_kac(ys, **params)
    return csmc.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
        resampling=resampling, ancestor_sampling=ancestor_sampling,
    )

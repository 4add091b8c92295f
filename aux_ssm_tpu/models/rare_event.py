"""Rare-event model: stationary 1-D AR(1) bridge conditioned on a single
near-unreachable observation at the final step.

Capability parity with `examples/rare_event/` (auxiliary_kalman.py,
auxiliary_csmc.py, auxiliary_guided_csmc.py, closed-form conditionals at
experiment.py:228-233) — independent implementation.

Model:  x_0 ~ N(0, 1),   x_{t+1} = rho x_t + sqrt(1-rho^2) eps,
        single observation  y ~ N(x_{T-1}, r^2)  at the last step.

The conditional moments of x_0 and x_{T-1} given y are available in closed
form (`conditional_moments`) — this model doubles as an exact MCMC oracle.
"""
import chex
import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (
    Distribution, UnivariatePotential, Dynamics, Potential,
    diag_gaussian_pair_factors,
)
from ..kernels.kalman import get_kernel as get_kalman_generic
from ..ops.lgssm import LGSSM
from ..ops.filtering import filtering
from ..ops.sampling import sampling


def conditional_moments(y, rho, r2, T):
    """Closed-form posterior moments of x_{T-1} and x_0 given y
    (reference experiment.py:228-233)."""
    rho_0T = rho ** (T - 1)
    mean_T = y / (1.0 + r2)
    var_T = r2 / (1.0 + r2)
    mean_0 = rho_0T * mean_T
    var_0 = rho_0T ** 2 * var_T + 1.0 - rho_0T ** 2
    return (mean_0, var_0), (mean_T, var_T)


def _ar_params(rho, T):
    m0 = jnp.zeros((1,))
    P0 = jnp.eye(1)
    Fs = rho * jnp.ones((T - 1, 1, 1))
    Qs = (1.0 - rho ** 2) * jnp.ones((T - 1, 1, 1))
    bs = jnp.zeros((T - 1, 1))
    return m0, P0, Fs, Qs, bs


def init_x(key, y, rho, r2, T, parallel=True):
    """Exact posterior draw (the model is an LGSSM): used to initialise."""
    m0, P0, Fs, Qs, bs = _ar_params(rho, T)
    Hs = jnp.zeros((T, 1, 1)).at[-1].set(1.0)
    Rs = r2 * jnp.ones((T, 1, 1))
    cs = jnp.zeros((T, 1))
    ys = jnp.full((T, 1), jnp.nan).at[-1, 0].set(y)
    lgssm = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
    fms, fPs, _ = filtering(ys, lgssm, parallel)
    return sampling(key, fms, fPs, lgssm, parallel)


def get_kalman_kernel(y, rho, r2, T, parallel, gradient=False):
    """Auxiliary Kalman kernel; the potential only acts at the final step, so
    the gradient shift is non-zero only there."""
    m0, P0, Fs, Qs, bs = _ar_params(rho, T)
    sig_x = jnp.sqrt(1.0 - rho ** 2)
    r = jnp.sqrt(r2)
    Hs = jnp.ones((T, 1, 1))
    cs = jnp.zeros((T, 1))

    def dynamics_factory(_x):
        return m0, P0, Fs, Qs, bs

    def observations_factory(x, u, delta):
        shift = jnp.zeros((T, 1))
        if gradient:
            shift = shift.at[-1].set((y - x[-1]) / r2)
        aux_ys = u + 0.5 * delta * shift
        return aux_ys, Hs, 0.5 * delta * jnp.ones((T, 1, 1)), cs

    def log_likelihood_fn(x):
        out = jnp.sum(norm.logpdf(x[0, 0], 0.0, 1.0))
        out += jnp.sum(norm.logpdf(x[1:, 0], rho * x[:-1, 0], sig_x))
        return out + norm.logpdf(y, x[-1, 0], r)

    init_, kernel = get_kalman_generic(dynamics_factory, observations_factory,
                                       log_likelihood_fn, parallel)

    def init(xs):
        return init_(xs[:, None] if jnp.ndim(xs) == 1 else xs)

    return init, kernel


def get_feynman_kac(y, rho, r2, T):
    """The model through the cSMC interface: indicator potentials acting only
    at the final step."""
    sig_x = jnp.sqrt(1.0 - rho ** 2)
    r = jnp.sqrt(r2)

    @chex.dataclass
    class M0(Distribution, UnivariatePotential):
        def sample(self, key, N):
            return jax.random.normal(key, (N, 1))

        def logpdf(self, x):
            return norm.logpdf(x[..., 0], 0.0, 1.0)

        def __call__(self, x):
            return (T == 1) * norm.logpdf(x[..., 0], y, r)

    @chex.dataclass
    class Mt(Dynamics):
        def sample(self, key, x_t, _t):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, _t)

        def sample_from_noise(self, eps, x_t, _t):
            return rho * x_t + sig_x * eps

        def logpdf(self, x_next, x_t, _t):
            return norm.logpdf(x_next[..., 0], rho * x_t[..., 0], sig_x)

        def logpdf_factors(self, x_prev, x_next, _t):
            return diag_gaussian_pair_factors(rho * x_prev, x_next, sig_x)

        # (1, N) lane-row callables for the forward sweep
        # (`ops/csmc_sweeps.lane_scan`). rho/sig ride the per-step params
        # (the rare-event grid driver builds this model under a vmap over
        # (rho, r2) cells).
        def lane_propagate(self, eps, x_prev, p):
            return p["rho"] * x_prev + p["sig"] * eps

        def lane_logpdf(self, x_next, x_prev, p):
            return norm.logpdf(x_next, p["rho"] * x_prev, p["sig"])

    @chex.dataclass
    class G0(UnivariatePotential):
        def __call__(self, x):
            return (T == 1) * norm.logpdf(x[..., 0], y, r)

    @chex.dataclass
    class Gt(Potential):
        prev_dependent = False

        def __call__(self, x_next, _x_t, p):
            return (p["t"] == T - 1) * norm.logpdf(y, x_next[..., 0], p["r"])

        def lane_logw(self, x_next, _x_prev, p):
            return (p["t"] == T - 1) * norm.logpdf(p["y"], x_next, p["r"])

    bcast = lambda z: jnp.broadcast_to(jnp.asarray(z), (T - 1,))
    mt_params = dict(rho=bcast(rho), sig=bcast(sig_x))
    gt_params = dict(t=jnp.arange(1, T), y=bcast(y), r=bcast(r))
    return M0(), G0(), Mt(params=mt_params), Gt(params=gt_params)


def get_csmc_kernel(y, rho, r2, T, n_particles, backward=True, parallel=False,
                    gradient=False, resampling="multinomial"):
    M0, G0, Mt, Gt = get_feynman_kac(y, rho, r2, T)
    return csmc_independent.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
        gradient=gradient, parallel=parallel, resampling=resampling,
    )


def get_guided_csmc_kernel(y, rho, r2, T, n_particles, backward=True,
                           gradient=False, resampling="multinomial"):
    """Guided proposals with closed-form scalar Kalman gains
    K = sig^2 / (sig^2 + delta/2) recentring each step on the auxiliary
    observation (gradient-shifted at the final step when requested)."""
    _, _, Pt, _ = get_feynman_kac(y, rho, r2, T)
    sig_x = jnp.sqrt(1.0 - rho ** 2)
    r = jnp.sqrt(r2)

    def factory(u, scale):
        dt = u.dtype                                   # keep the chain dtype
        sig0s = jnp.ones((T,), dt).at[1:].set(sig_x)   # prior scale per step
        Ks = sig0s ** 2 / (sig0s ** 2 + scale ** 2)    # scalar gains
        sig_props = sig0s * jnp.sqrt(1.0 - Ks)         # proposal scales

        def shifted_u(u_t, scale_t, x_pred, t):
            g = (t == T - 1) * (y - x_pred) / r2
            return u_t + gradient * scale_t ** 2 * g

        @chex.dataclass
        class GuidedM0(Distribution, UnivariatePotential):
            def _mu(self):
                return Ks[0] * shifted_u(u[0, 0], scale[0], 0.0, 0)

            def sample(self, key, N):
                return self._mu() + sig_props[0] * jax.random.normal(key, (N, 1))

            def logpdf(self, x):
                return norm.logpdf(x[..., 0], self._mu(), sig_props[0])

            def __call__(self, x):
                return self.logpdf(x)

        @chex.dataclass
        class GuidedG0(UnivariatePotential):
            def __call__(self, x):
                mu = Ks[0] * shifted_u(u[0, 0], scale[0], 0.0, 0)
                out = norm.logpdf(x[..., 0], 0.0, 1.0)
                out += norm.logpdf(x[..., 0], u[0, 0], scale[0])
                out -= norm.logpdf(x[..., 0], mu, sig_props[0])
                out += (T == 1) * norm.logpdf(x[..., 0], y, r)
                return out

        def guided_mu(x_pred, p):
            """Proposal mean from per-step params ONLY (no closure values):
            shared by the generic methods and the lane callables — the grid
            driver builds this model under a vmap over (rho, r2) cells."""
            g = (p["t"] == T - 1) * (p["y"] - x_pred) / p["r2"]
            su = p["u"] + gradient * p["scale"] ** 2 * g
            return x_pred + p["K"] * (su - x_pred)

        @chex.dataclass
        class GuidedMt(Dynamics):
            def sample(self, key, x_t, params):
                return self.sample_from_noise(
                    jax.random.normal(key, x_t.shape), x_t, params)

            def sample_from_noise(self, eps, x_t, p):
                return guided_mu(p["rho"] * x_t, p) + p["sig_p"] * eps

            def logpdf(self, x_next, x_t, p):
                mu = guided_mu(p["rho"] * x_t[..., 0], p)
                return norm.logpdf(x_next[..., 0], mu, p["sig_p"])

            # (1, N) lane-row callables (`ops/csmc_sweeps.lane_scan`).
            def lane_propagate(self, eps, x_prev, p):
                return guided_mu(p["rho"] * x_prev, p) + p["sig_p"] * eps

            def lane_logpdf(self, x_next, x_prev, p):
                mu = guided_mu(p["rho"] * x_prev, p)
                return norm.logpdf(x_next, mu, p["sig_p"])

        @chex.dataclass
        class GuidedGt(Potential):
            def __call__(self, x_next, x_t, p):
                return self.lane_logw(x_next[..., 0], x_t[..., 0], p)

            def lane_logw(self, x_next, x_prev, p):
                x_pred = p["rho"] * x_prev
                mu = guided_mu(x_pred, p)
                out = norm.logpdf(x_next, x_pred, p["sig"])
                out += norm.logpdf(x_next, p["u"], p["scale"])
                out -= norm.logpdf(x_next, mu, p["sig_p"])
                out += (p["t"] == T - 1) * norm.logpdf(p["y"], x_next, p["r"])
                return out

        bcast = lambda z: jnp.broadcast_to(jnp.asarray(z).astype(dt), (T - 1,))
        params = dict(K=Ks[1:], sig_p=sig_props[1:], u=u[1:, 0],
                      scale=scale[1:], t=jnp.arange(1, T).astype(dt),
                      rho=bcast(rho), sig=bcast(sig_x), y=bcast(y),
                      r=bcast(r), r2=bcast(r2))
        return GuidedM0(), GuidedG0(), GuidedMt(params=params), GuidedGt(params=params)

    return csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling)

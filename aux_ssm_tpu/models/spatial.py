"""Spatio-temporal model: d^2 independent 1-D random walks observed through a
multivariate Student-t with banded spatial precision.

Capability parity with `examples/spatial/` (model.py, auxiliary_kalman.py,
auxiliary_csmc.py, auxiliary_guided_csmc.py) — independent implementation.

Model:  x_t in R^{d^2},  x_0 ~ N(0, sigma_x^2 I),
        x_{t+1} = x_t + sigma_x eps  (independent per component)
        y_t ~ t_nu(x_t, P^{-1}) with P the banded grid precision.

The dynamics are expressed in the *batched scalar* LGSSM layout
(T, B=d^2, 1, 1) so the Kalman machinery runs d^2 independent scalar filters
in one vectorized pass (reference `spatial/model.py:103-112`). The Student-t
precision is applied as a 2-D convolution stencil (see `t_distribution`),
not a sparse matmul.
"""
import chex
import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.stats import norm

from . import t_distribution as tdist
from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (
    Distribution, UnivariatePotential, Dynamics, Potential,
    diag_gaussian_pair_factors,
)
from ..kernels.kalman import get_kernel as get_kalman_generic
from ..native.precision import make_precision_dense, precision_stencil


def get_dynamics(sigma_x, d):
    """Batched scalar dynamics: (B=d^2) independent random walks."""
    B = d * d
    F = jnp.ones((B, 1, 1))
    Q = sigma_x ** 2 * jnp.ones((B, 1, 1))
    b = jnp.zeros((B, 1))
    return b, Q, F, Q, b  # m0 = 0, P0 = Q


def get_data(rng, sigma_x, r_y, tau, nu, d, T):
    """Simulate (xs, ys): random-walk field + Student-t noise."""
    B = d * d
    prec = make_precision_dense(tau, r_y, d)
    cov = np.linalg.inv(prec)
    chol_cov = np.linalg.cholesky(cov)
    xs = np.cumsum(sigma_x * rng.standard_normal((T, B)), axis=0)
    g = rng.standard_normal((T, B)) @ chol_cov.T
    u = rng.chisquare(nu, size=(T, 1)) / nu
    ys = xs + g / np.sqrt(u)
    return xs, ys


def log_potential_one(x, y, nu, stencil, d):
    """Per-time-step t potential; batched over leading axes of x."""
    return jnp.nan_to_num(tdist.logpdf(y, x, nu, stencil=stencil, d=d))


def log_potential(xs, ys, nu, stencil, d):
    return jnp.sum(jax.vmap(lambda x, y: log_potential_one(x, y, nu, stencil, d))(xs, ys))


def init_x_fn(key, ys, sigma_x, nu, stencil, d, N):
    """Bootstrap PF + backward sampling initialisation
    (reference model.py:127-160 behaviour)."""
    T, B = ys.shape
    init_key, fwd_key, bwd_key = jax.random.split(key, 3)
    x0 = sigma_x * jax.random.normal(init_key, (N, B))

    def fwd(x, inp):
        y, k = inp
        k1, k2 = jax.random.split(k)
        log_w = log_potential_one(x, y, nu, stencil, d)
        log_w = log_w - jax.scipy.special.logsumexp(log_w)
        u = jax.random.uniform(k1)
        grid = (u + jnp.arange(N)) / N
        anc = jnp.searchsorted(jnp.cumsum(jnp.exp(log_w)), grid)
        x_next = x[anc] + sigma_x * jax.random.normal(k2, (N, B))
        return x_next, (log_w, x)

    _, (log_ws, xs) = jax.lax.scan(fwd, x0, (ys, jax.random.split(fwd_key, T)))

    def bwd(x, inp):
        log_w, x_prev, k = inp
        lw = log_w + jnp.sum(norm.logpdf(x, x_prev, sigma_x), -1)
        w = jnp.exp(lw - jax.scipy.special.logsumexp(lw))
        x_new = jax.random.choice(k, x_prev, p=w)
        return x_new, x_new

    k_init, k_loop = jax.random.split(bwd_key)
    x_T = jax.random.choice(k_init, xs[-1], p=jnp.exp(log_ws[-1]))
    _, traj = jax.lax.scan(bwd, x_T, (log_ws[:-1], xs[:-1], jax.random.split(k_loop, T - 1)),
                           reverse=True)
    return jnp.concatenate([traj, x_T[None]], axis=0)


# --------------------------------------------------------------------------
# Auxiliary Kalman (batched scalar filters)
# --------------------------------------------------------------------------

def get_kalman_kernel(ys, sigma_x, nu, tau, r_y, d, parallel, order=1):
    """Auxiliary Kalman kernel in the batched (T, B, 1, 1) layout. `order` 2
    uses the diagonal approximation hess ~ -nu * diag(P)/(nu-2)
    (reference auxiliary_kalman.py:40-48)."""
    T, B = ys.shape
    assert B == d * d
    stencil = jnp.asarray(precision_stencil(tau, r_y))
    prec_diag = jnp.full((B,), 1.0)  # stencil centre = tau^0 = 1

    m0, P0, F, Q, b = get_dynamics(sigma_x, d)
    Fs = jnp.tile(F[None], (T - 1, 1, 1, 1))
    Qs = jnp.tile(Q[None], (T - 1, 1, 1, 1))
    bs = jnp.tile(b[None], (T - 1, 1, 1))

    eyes = jnp.ones((T, B, 1, 1))
    zeros = jnp.zeros((T, B, 1))

    def dynamics_factory(_x):
        return m0, P0, Fs, Qs, bs

    def grad_flat(x):
        return jnp.nan_to_num(
            jax.grad(lambda z: log_potential(z, ys, nu, stencil, d))(x)
        )

    def first_order_factory(x, u, delta):
        g = grad_flat(x[..., 0]).reshape(T, B, 1)
        aux_ys = u + 0.5 * delta * g
        return aux_ys, eyes, 0.5 * delta * eyes, zeros

    def second_order_factory(x, u, delta):
        g = grad_flat(x[..., 0]).reshape(T, B, 1)
        hess_diag = -nu * prec_diag / (nu - 2.0)          # (B,)
        omega_inv = -hess_diag[None, :, None, None] + 2.0 * eyes / delta
        omega = 1.0 / omega_inv
        aux_ys = omega[..., 0] * (2.0 * u / delta + g - hess_diag[None, :, None] * x)
        return aux_ys, eyes, omega, zeros

    def log_likelihood_fn(x):
        flat = x[..., 0]
        out = jnp.sum(norm.logpdf(flat[0], 0.0, sigma_x))
        out += jnp.sum(norm.logpdf(flat[1:], flat[:-1], sigma_x))
        return out + log_potential(flat, ys, nu, stencil, d)

    factory = first_order_factory if order == 1 else second_order_factory
    init_, kernel = get_kalman_generic(dynamics_factory, factory, log_likelihood_fn, parallel)

    def init(xs):
        return init_(xs[..., None] if jnp.ndim(xs) == 2 else xs)

    return init, kernel


# --------------------------------------------------------------------------
# cSMC styles
# --------------------------------------------------------------------------

def get_feynman_kac(ys, sigma_x, nu, tau, r_y, d):
    B = ys.shape[-1]
    stencil = jnp.asarray(precision_stencil(tau, r_y))

    @chex.dataclass
    class M0(Distribution, UnivariatePotential):
        def sample(self, key, N):
            return sigma_x * jax.random.normal(key, (N, B))

        def logpdf(self, x):
            return jnp.sum(norm.logpdf(x, 0.0, sigma_x), -1)

        def __call__(self, x):
            return self.logpdf(x)

    @chex.dataclass
    class Mt(Dynamics):
        def sample(self, key, x_t, _p):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, _p)

        def sample_from_noise(self, eps, x_t, _p):
            return x_t + sigma_x * eps

        def logpdf(self, x_next, x_t, _p):
            return jnp.sum(norm.logpdf(x_next, x_t, sigma_x), -1)

        def logpdf_factors(self, x_prev, x_next, _p):
            return diag_gaussian_pair_factors(x_prev, x_next, sigma_x)

    @chex.dataclass
    class G0(UnivariatePotential):
        def __call__(self, x):
            return log_potential_one(x, ys[0], nu, stencil, d)

    @chex.dataclass
    class Gt(Potential):
        prev_dependent = False

        def __call__(self, x_next, _x_t, y):
            return log_potential_one(x_next, y, nu, stencil, d)

    T = ys.shape[0]
    return M0(), G0(), Mt(params=jnp.zeros((T - 1, 0))), Gt(params=ys[1:])


def get_csmc_kernel(ys, sigma_x, nu, tau, r_y, d, n_particles, backward=False,
                    parallel=False, gradient=False, resampling="multinomial"):
    M0, G0, Mt, Gt = get_feynman_kac(ys, sigma_x, nu, tau, r_y, d)
    return csmc_independent.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
        gradient=gradient, parallel=parallel, resampling=resampling,
    )


def get_guided_csmc_kernel(ys, sigma_x, nu, tau, r_y, d, n_particles,
                           backward=False, gradient=False, resampling="multinomial"):
    """Scalar-gain guided proposals: K = sigma_x^2/(sigma_x^2 + delta/2)
    recentring the random walk on the (optionally gradient-shifted) auxiliary
    observation (reference auxiliary_guided_csmc.py:118-135)."""
    T, B = ys.shape
    stencil = jnp.asarray(precision_stencil(tau, r_y))
    _, _, Pt, _ = get_feynman_kac(ys, sigma_x, nu, tau, r_y, d)

    def moments(x_pred, u, scale, y):
        K = sigma_x ** 2 / (sigma_x ** 2 + scale ** 2)
        lam = jnp.sqrt(sigma_x ** 2 * (1.0 - K))
        if gradient:
            u = u + scale ** 2 * jax.grad(
                lambda z: jnp.sum(log_potential_one(z, y, nu, stencil, d)))(x_pred)
        return x_pred + K * (u - x_pred), lam

    @chex.dataclass
    class GuidedM0(Distribution):
        u: chex.Array
        scale: chex.Array
        y: chex.Array

        def sample(self, key, N):
            mu, lam = moments(jnp.zeros((B,)), self.u, self.scale, self.y)
            return mu[None] + lam * jax.random.normal(key, (N, B))

    @chex.dataclass
    class GuidedG0(UnivariatePotential):
        u: chex.Array
        scale: chex.Array
        y: chex.Array

        def __call__(self, x):
            mu, lam = moments(jnp.zeros((B,)), self.u, self.scale, self.y)
            out = log_potential_one(x, self.y, nu, stencil, d)
            out += jnp.sum(norm.logpdf(x, 0.0, sigma_x), -1)
            out += jnp.sum(norm.logpdf(x, self.u, self.scale), -1)
            out -= jnp.sum(norm.logpdf(x, mu, lam), -1)
            return out

    # (B, N)-block forms for the block-lane sweep: everything elementwise
    # except the t-potential quad form, applied via the DENSE precision (a
    # (B, B) matmul on the (B, N) block).
    prec_dense = jnp.asarray(make_precision_dense(tau, r_y, d), jnp.float32)

    def _block_moments(x_prev, u, scale, y, P):
        K = sigma_x ** 2 / (sigma_x ** 2 + scale ** 2)        # (1, N)
        lam = jnp.sqrt(sigma_x ** 2 * (1.0 - K))
        if gradient:
            # Analytic d/dx of the unnormalised t logpdf at x_prev:
            # (nu + B) P (y - x) / (nu + (y-x)^T P (y-x)).
            diff = y - x_prev
            Pv = jax.lax.dot_general(P, diff, (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32,
                                     precision=jax.lax.Precision.HIGHEST)
            q = jnp.sum(diff * Pv, axis=0, keepdims=True)
            u = u + scale ** 2 * (nu + B) * Pv / (nu + q)
        return x_prev + K * (u - x_prev), lam

    def _block_tpot(x, y, P):
        diff = y - x
        Pv = jax.lax.dot_general(P, diff, (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32,
                                 precision=jax.lax.Precision.HIGHEST)
        q = jnp.sum(diff * Pv, axis=0, keepdims=True)
        return jnp.nan_to_num(-0.5 * (nu + B) * jnp.log1p(q / nu))

    @chex.dataclass
    class GuidedMt(Dynamics):
        def sample(self, key, x_t, params):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, params)

        def sample_from_noise(self, eps, x_t, params):
            u, scale, y = params
            mu, lam = moments(x_t, u, scale, y)  # broadcasts (N,B) vs (B,)
            return mu + lam * eps

        def block_propagate(self, eps, x_prev, params, consts):
            u, scale, y = params
            mu, lam = _block_moments(x_prev, u, scale, y, consts["P"])
            return mu + lam * eps

    @chex.dataclass
    class GuidedGt(Potential):
        def __call__(self, x_next, x_t, params):
            u, scale, y = params
            mu, lam = moments(x_t, u, scale, y)
            out = log_potential_one(x_next, y, nu, stencil, d)
            out += jnp.sum(norm.logpdf(x_next, x_t, sigma_x), -1)
            out += jnp.sum(norm.logpdf(x_next, u, scale), -1)
            out -= jnp.sum(norm.logpdf(x_next, mu, lam), -1)
            return out

        def block_logw(self, x_next, x_prev, params, consts):
            u, scale, y = params
            mu, lam = _block_moments(x_prev, u, scale, y, consts["P"])
            out = _block_tpot(x_next, y, consts["P"])
            out += jnp.sum(norm.logpdf(x_next, x_prev, sigma_x), axis=0,
                           keepdims=True)
            out += jnp.sum(norm.logpdf(x_next, u, scale), axis=0,
                           keepdims=True)
            out -= jnp.sum(norm.logpdf(x_next, mu, lam), axis=0,
                           keepdims=True)
            return out

    GuidedMt.block_consts = {"P": prec_dense}
    GuidedGt.block_consts = {"P": prec_dense}

    def factory(u, scale):
        return (
            GuidedM0(u=u[0], scale=scale[0], y=ys[0]),
            GuidedG0(u=u[0], scale=scale[0], y=ys[0]),
            GuidedMt(params=(u[1:], scale[1:], ys[1:])),
            GuidedGt(params=(u[1:], scale[1:], ys[1:])),
        )

    return csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling)

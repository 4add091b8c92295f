"""Multivariate stochastic-volatility model (Finke & Thiery 2021 setup).

Capability parity with `examples/stochastic_volatility/` (model.py,
auxiliary_kalman.py, auxiliary_csmc.py, auxiliary_guided_csmc.py) —
independent implementation.

Model: D-dimensional log-volatility AR(1)
    x_0 ~ N(mu, Q_inf),   x_{t+1} = mu + phi (x_t - mu) + eps,  eps ~ N(0, Q)
    y_t | x_t ~ N(0, diag(exp(x_t)))
with Q the stationary covariance tau * ((1-rho) I + rho 11^T) / (1 - phi^2).

Sampler styles provided (reference experiment.py:141-154):
    kalman-1      first-order auxiliary Kalman
    kalman-2      second-order auxiliary Kalman (diagonal Hessian)
    csmc          auxiliary PG with independent proposals (optionally
                  gradient-shifted, optionally parallel-in-time)
    csmc-guided   Kalman-gain guided auxiliary PG
"""
import math
from functools import partial

import chex
import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (
    Distribution, UnivariatePotential, Dynamics, Potential,
    chol_gaussian_pair_factors,
)
from ..kernels.kalman import get_kernel as get_kalman_generic
from ..ops import mvn


# --------------------------------------------------------------------------
# Model definition
# --------------------------------------------------------------------------

def stationary_covariance(phi, tau, rho, dim):
    """Stationary covariance of the AR(1): tau*((1-rho) I + rho 11')/(1-phi^2)."""
    U = tau * (rho * jnp.ones((dim, dim)) + (1.0 - rho) * jnp.eye(dim))
    return U / (1.0 - phi ** 2)


def get_dynamics(nu, phi, tau, rho, dim):
    """LGSSM dynamics (m0, P0, F, Q, b) of the log-volatility chain."""
    F = phi * jnp.eye(dim)
    Q = stationary_covariance(phi, tau, rho, dim)
    mu = nu * jnp.ones((dim,))
    b = mu - phi * mu
    return mu, Q, F, Q, b


@partial(jax.jit, static_argnums=(5, 6))
def get_data(key, nu, phi, tau, rho, dim, T):
    """Simulate (xs, ys) from the model."""
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, dim)
    chol_P0 = jnp.linalg.cholesky(P0)
    chol_Q = jnp.linalg.cholesky(Q)
    init_key, scan_key = jax.random.split(key)
    x0 = m0 + chol_P0 @ jax.random.normal(init_key, (dim,))

    def body(x, k):
        k_state, k_obs = jax.random.split(k)
        y = jnp.exp(0.5 * x) * jax.random.normal(k_obs, (dim,))
        x_next = F @ x + b + chol_Q @ jax.random.normal(k_state, (dim,))
        return x_next, (x, y)

    _, (xs, ys) = jax.lax.scan(body, x0, jax.random.split(scan_key, T))
    return xs, ys


def _log_potential_one(x, y):
    val = norm.logpdf(y, scale=jnp.exp(0.5 * x))
    return jnp.nan_to_num(val)  # infinite scale -> 0 contribution


def log_potential(xs, ys):
    """log p(y_{0:T} | x_{0:T}) = sum_t sum_d log N(y; 0, exp(x))."""
    return jnp.sum(jax.vmap(_log_potential_one)(xs, ys))


def hess_log_potential_diag(xs, ys):
    """Diagonal of the potential Hessian, elementwise (separable model):
    d²/dx² log N(y; 0, exp(x)) = -y² exp(-x) / 2 (reference
    stochastic_volatility/model.py:56-82 second-order information)."""
    d2 = jax.grad(jax.grad(
        lambda x, y: jnp.nan_to_num(norm.logpdf(y, scale=jnp.exp(0.5 * x)))))
    return jax.vmap(jax.vmap(d2))(xs, ys)


def init_x_fn(key, ys, nu, phi, tau, rho, N):
    """Bootstrap particle filter + backward sampling initial trajectory
    (reference model.py:85-121 behaviour)."""
    T, d = ys.shape
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, d)
    chol_P0 = jnp.linalg.cholesky(P0)
    chol_Q = jnp.linalg.cholesky(Q)
    init_key, fwd_key, bwd_key = jax.random.split(key, 3)
    x0 = m0 + jax.random.normal(init_key, (N, d)) @ chol_P0.T

    def fwd(x, inp):
        y, k = inp
        k1, k2 = jax.random.split(k)
        log_w = jax.vmap(lambda xi: jnp.sum(_log_potential_one(xi, y)))(x)
        log_w = log_w - jax.scipy.special.logsumexp(log_w)
        u = jax.random.uniform(k1)
        grid = (u + jnp.arange(N)) / N
        anc = jnp.searchsorted(jnp.cumsum(jnp.exp(log_w)), grid)
        x_next = b[None] + x[anc] @ F.T + jax.random.normal(k2, (N, d)) @ chol_Q.T
        return x_next, (log_w, x)

    _, (log_ws, xs) = jax.lax.scan(fwd, x0, (ys, jax.random.split(fwd_key, T)))

    def bwd(x, inp):
        log_w, x_prev, k = inp
        x_pred = b[None] + x_prev @ F.T
        lw = log_w + mvn.logpdf(x, x_pred, chol_Q)
        w = jnp.exp(lw - jax.scipy.special.logsumexp(lw))
        x_new = jax.random.choice(k, x_prev, p=w)
        return x_new, x_new

    k_init, k_loop = jax.random.split(bwd_key)
    x_T = jax.random.choice(k_init, xs[-1], p=jnp.exp(log_ws[-1]))
    _, traj = jax.lax.scan(bwd, x_T, (log_ws[:-1], xs[:-1], jax.random.split(k_loop, T - 1)),
                           reverse=True)
    return jnp.concatenate([traj, x_T[None]], axis=0)


# --------------------------------------------------------------------------
# Auxiliary Kalman samplers (styles kalman-1 / kalman-2)
# --------------------------------------------------------------------------

def get_kalman_kernel(ys, nu, phi, tau, rho, parallel, order=1):
    """Auxiliary Kalman kernel; `order` 1 = gradient shift, 2 = diagonal
    second-order expansion Omega = (-H + 2I/delta)^{-1}
    (reference auxiliary_kalman.py:28-48)."""
    T, d = ys.shape
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, d)
    eye = jnp.eye(d)
    eyes = jnp.tile(eye[None], (T, 1, 1))
    chol_P0 = jnp.linalg.cholesky(P0)
    chol_Q = jnp.linalg.cholesky(Q)

    Fs = jnp.tile(F[None], (T - 1, 1, 1))
    Qs = jnp.tile(Q[None], (T - 1, 1, 1))
    bs = jnp.tile(b[None], (T - 1, 1))

    def dynamics_factory(_x):
        return m0, P0, Fs, Qs, bs

    def first_order_factory(x, u, delta):
        grad = jnp.nan_to_num(jax.grad(log_potential)(x, ys))
        aux_ys = u + 0.5 * delta * grad
        return aux_ys, eyes, 0.5 * delta * eyes, jnp.zeros((T, d))

    def second_order_factory(x, u, delta):
        grad = jnp.nan_to_num(jax.grad(log_potential)(x, ys))
        hess = jnp.nan_to_num(hess_log_potential_diag(x, ys))  # (T, d)
        omega_inv_diag = -hess + 2.0 / delta                    # diagonal (T, d)
        omega_diag = 1.0 / omega_inv_diag
        aux_ys = omega_diag * (2.0 * u / delta + grad - hess * x)
        Rs = omega_diag[..., None] * eyes
        return aux_ys, eyes, Rs, jnp.zeros((T, d))

    def log_likelihood_fn(x):
        out = mvn.logpdf(x[0], m0, chol_P0)
        pred = jnp.einsum("ij,tj->ti", F, x[:-1]) + b
        out += jnp.sum(mvn.logpdf(x[1:], pred, chol_Q))
        return out + log_potential(x, ys)

    obs_factory = first_order_factory if order == 1 else second_order_factory
    return get_kalman_generic(dynamics_factory, obs_factory, log_likelihood_fn, parallel)


# --------------------------------------------------------------------------
# Feynman–Kac components (cSMC styles)
# --------------------------------------------------------------------------

def get_feynman_kac(ys, nu, phi, tau, rho):
    """The model expressed through the cSMC interface."""
    T, d = ys.shape
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, d)
    chol_P0 = jnp.linalg.cholesky(P0)
    chol_Q = jnp.linalg.cholesky(Q)

    @chex.dataclass
    class M0(Distribution, UnivariatePotential):
        def sample(self, key, N):
            return m0[None] + jax.random.normal(key, (N, d)) @ chol_P0.T

        def logpdf(self, x):
            return mvn.logpdf(x, m0, chol_P0)

        def __call__(self, x):
            return self.logpdf(x)

    @chex.dataclass
    class Mt(Dynamics):
        def sample(self, key, x_t, _params):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, _params)

        def sample_from_noise(self, eps, x_t, _params):
            return x_t @ F.T + b + eps @ chol_Q.T

        def logpdf(self, x_next, x_t, _params):
            return mvn.logpdf(x_next, jnp.einsum("ij,...j->...i", F, x_t) + b, chol_Q)

        def logpdf_factors(self, x_prev, x_next, _params):
            return chol_gaussian_pair_factors(x_prev @ F.T + b, x_next, chol_Q)

    @chex.dataclass
    class G0(UnivariatePotential):
        def __call__(self, x):
            return jnp.sum(norm.logpdf(ys[0], loc=0.0, scale=jnp.exp(0.5 * x)), -1)

    @chex.dataclass
    class Gt(Potential):
        prev_dependent = False

        def __call__(self, x_next, _x_t, y):
            return jnp.sum(norm.logpdf(y, loc=0.0, scale=jnp.exp(0.5 * x_next)), -1)

    return M0(), G0(), Mt(params=jnp.zeros((T - 1, 0))), Gt(params=ys[1:])


def get_csmc_kernel(ys, nu, phi, tau, rho, n_particles, backward=False,
                    parallel=False, gradient=False, resampling="multinomial"):
    """Auxiliary PG with independent proposals (style `csmc`)."""
    M0, G0, Mt, Gt = get_feynman_kac(ys, nu, phi, tau, rho)
    return csmc_independent.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
        gradient=gradient, parallel=parallel, resampling=resampling,
    )


# --------------------------------------------------------------------------
# Guided cSMC (style csmc-guided): Kalman-gain recentred proposals
# --------------------------------------------------------------------------

def _obs_logpdf(x, y):
    return jnp.sum(jnp.nan_to_num(norm.logpdf(y, 0.0, jnp.exp(0.5 * x))), -1)


def get_guided_csmc_kernel(ys, nu, phi, tau, rho, n_particles, backward=False,
                           gradient=False, resampling="multinomial"):
    """Guided auxiliary PG: each proposal is the exact Gaussian combination of
    the prior step N(x_pred, Q) with the pseudo-observation u ~ N(x, delta/2):
    gain K = Q (Q + delta/2 I)^{-1}, mean x_pred + K (u' - x_pred),
    covariance Q - K Q, with u' optionally gradient-shifted
    (reference auxiliary_guided_csmc.py:143-156)."""
    factory, Pt = make_guided_factory(ys, nu, phi, tau, rho, gradient)
    return csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling)


def make_guided_factory(ys, nu, phi, tau, rho, gradient=False):
    """(factory, Pt) for the guided style; exposed so the proposal/weight law
    can be oracle-tested directly (see tests/test_models_sv.py)."""
    T, d = ys.shape
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, d)
    _, _, Pt, _ = get_feynman_kac(ys, nu, phi, tau, rho)

    # Eigendecompositions of the (constant) covariances, computed EAGERLY at
    # kernel-build time. Every per-step quantity of the guided proposal is a
    # function of Q commuting with Q, so in Q's eigenbasis the gain and the
    # proposal covariance are elementwise eigenvalue transforms:
    #     K_t   = V diag(lam / (lam + s_t^2)) V^T
    #     Lam_t = V diag(lam s_t^2 / (lam + s_t^2)) V^T
    # This keeps the MCMC while-body free of linalg custom calls (Cholesky /
    # triangular inversion), which XLA cannot hoist out of loops even when
    # their inputs are loop-invariant
    # (reference auxiliary_guided_csmc.py:143-156 runs the solves per step).
    # Sampling uses the symmetric square root V diag(sqrt) V^T: same law as
    # a Cholesky factor, matmul-only.
    lamQ, VQ = jnp.linalg.eigh(Q)
    lam0, V0 = jnp.linalg.eigh(P0)
    inv_sqrt_lamQ = 1.0 / jnp.sqrt(lamQ)
    half_logdet_Q = float(0.5 * jnp.sum(jnp.log(lamQ)))
    _HALF_D_LOG2PI = 0.5 * d * math.log(2.0 * math.pi)

    def shift(u, scale, y):
        if gradient:
            return u + scale ** 2 * jax.grad(_obs_logpdf)(u, y)
        return u

    def _eigen_factors(lam, scale):
        """(gain, sqrt(Lam), 1/sqrt(Lam), 0.5 log det Lam) eigenvalues for
        proposal scale(s) `scale`; broadcasts (T,) scales against (d,) lam."""
        s2 = jnp.asarray(scale) ** 2
        g = lam / (lam + s2)
        lamL = lam * s2 / (lam + s2)
        sqrtL = jnp.sqrt(lamL)
        return g, sqrtL, 1.0 / sqrtL, 0.5 * jnp.sum(jnp.log(lamL), axis=-1)

    def _rot(x, V):
        return jnp.einsum("...j,jk->...k", x, V)

    def _unrot(x, V):
        return jnp.einsum("...k,jk->...j", x, V)

    @chex.dataclass
    class GuidedM0(Distribution):
        u: chex.Array
        scale: chex.Array
        y: chex.Array

        def _moments(self):
            g, sqrtL, inv_sqrtL, hld = _eigen_factors(lam0, self.scale)
            resid = shift(self.u, self.scale, self.y) - m0
            mu = m0 + _unrot(_rot(resid, V0) * g, V0)
            return mu, sqrtL, inv_sqrtL, hld

        def sample(self, key, N):
            mu, sqrtL, _, _ = self._moments()
            eps = jax.random.normal(key, (N, d))
            return mu[None] + _unrot(_rot(eps, V0) * sqrtL, V0)

        def logpdf(self, x):
            mu, _, inv_sqrtL, hld = self._moments()
            w = _rot(x - mu, V0) * inv_sqrtL
            return -0.5 * jnp.sum(w * w, -1) - hld - _HALF_D_LOG2PI

    @chex.dataclass
    class GuidedG0(UnivariatePotential):
        u: chex.Array
        scale: chex.Array
        y: chex.Array

        def __call__(self, x):
            prop = GuidedM0(u=self.u, scale=self.scale, y=self.y)
            w0 = _rot(x - m0, V0) / jnp.sqrt(lam0)
            out = _obs_logpdf(x, self.y)
            out += -0.5 * jnp.sum(w0 * w0, -1) \
                - 0.5 * jnp.sum(jnp.log(lam0)) - _HALF_D_LOG2PI
            out += jnp.sum(norm.logpdf(x, self.u, self.scale), -1)
            return out - prop.logpdf(x)

    # Transition algebra carried entirely in Q's eigenbasis (z = V^T x):
    #   rot(x_pred) = x_t @ FR + bR with FR = F^T V precomputed, and the
    #   (rotated, possibly gradient-shifted) auxiliary observation is a
    #   factory-time batch — the scan body is then 2 matmuls for Mt, 2 for
    #   Gt, everything else elementwise. The proposal noise `eps` is consumed
    #   directly as eigenbasis noise (a rotation of iid normals is iid).
    FR = F.T @ VQ
    bR = b @ VQ

    # Column-layout constants for the (d, N)-block sweep
    # (`ops/csmc_sweeps.block_lane_scan`): state as (d, N).
    FRT = FR.T
    VQT = VQ.T
    bR_col = bR[:, None]
    isl_col = inv_sqrt_lamQ[:, None]

    def _mm(A, X):
        # Exact-f32 (d, d) @ (d, N).
        return jax.lax.dot_general(A, X, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)

    @chex.dataclass
    class GuidedMt(Dynamics):
        def sample(self, key, x_t, params):
            return self.sample_from_noise(jax.random.normal(key, x_t.shape), x_t, params)

        def sample_from_noise(self, eps, x_t, params):
            _u, _scale, _y, rotS, g, sqrtL, _inv, _hld = params
            zp = x_t @ FR + bR
            zn = zp + g * (rotS[None] - zp) + sqrtL * eps
            return _unrot(zn, VQ)

        def block_propagate(self, eps, x_prev, params, consts):
            """(d, N)-block form of sample_from_noise for the block-lane
            sweep; params arrive as (L, N) lane-broadcast blocks, constants
            through the `consts` pytree."""
            _u, _scale, _y, rotS, g, sqrtL, _inv, _hld = params
            zp = _mm(consts["FRT"], x_prev) + consts["bR"]
            zn = zp + g * (rotS - zp) + sqrtL * eps
            return _mm(consts["VQ"], zn)

    @chex.dataclass
    class GuidedGt(Potential):
        def __call__(self, x_next, x_t, params):
            u, scale, y, rotS, g, _sqrtL, inv_sqrtL, hld = params
            zp = jnp.einsum("...j,jk->...k", x_t, FR) + bR
            zn = _rot(x_next, VQ)
            zmu = zp + g * (rotS - zp)
            out = _obs_logpdf(x_next, y)
            wq = (zn - zp) * inv_sqrt_lamQ
            out += -0.5 * jnp.sum(wq * wq, -1) - half_logdet_Q - _HALF_D_LOG2PI
            out += jnp.sum(norm.logpdf(x_next, u, scale), -1)
            wl = (zn - zmu) * inv_sqrtL
            out -= -0.5 * jnp.sum(wl * wl, -1) - hld - _HALF_D_LOG2PI
            return out

        def block_logw(self, x_next, x_prev, params, consts):
            """(d, N)-block form of __call__ for the block-lane sweep;
            returns a (1, N) log-weight row."""
            u, scale, y, rotS, g, _sqrtL, inv_sqrtL, hld = params
            zp = _mm(consts["FRT"], x_prev) + consts["bR"]
            zn = _mm(consts["VQT"], x_next)
            zmu = zp + g * (rotS - zp)
            obs = jnp.sum(jnp.nan_to_num(
                norm.logpdf(y, 0.0, jnp.exp(0.5 * x_next))),
                axis=0, keepdims=True)
            wq = (zn - zp) * consts["isl"]
            out = obs - 0.5 * jnp.sum(wq * wq, axis=0, keepdims=True) \
                - half_logdet_Q - _HALF_D_LOG2PI
            out += jnp.sum(norm.logpdf(x_next, u, scale), axis=0,
                           keepdims=True)
            wl = (zn - zmu) * inv_sqrtL
            out -= -0.5 * jnp.sum(wl * wl, axis=0, keepdims=True) \
                - hld - _HALF_D_LOG2PI
            return out

    GuidedMt.block_consts = {"FRT": FRT, "VQ": VQ, "bR": bR_col}
    GuidedGt.block_consts = {"FRT": FRT, "VQT": VQT, "bR": bR_col,
                             "isl": isl_col}

    def factory(u, scale):
        g, sqrtL, inv_sqrtL, hld = _eigen_factors(lamQ, scale[1:, None])
        shifts = (jax.vmap(shift)(u[1:], scale[1:], ys[1:])
                  if gradient else u[1:])
        rotS = _rot(shifts, VQ)
        return (
            GuidedM0(u=u[0], scale=scale[0], y=ys[0]),
            GuidedG0(u=u[0], scale=scale[0], y=ys[0]),
            GuidedMt(params=(u[1:], scale[1:], ys[1:], rotS, g, sqrtL,
                             inv_sqrtL, hld)),
            GuidedGt(params=(u[1:], scale[1:], ys[1:], rotS, g, sqrtL,
                             inv_sqrtL, hld)),
        )

    return factory, Pt

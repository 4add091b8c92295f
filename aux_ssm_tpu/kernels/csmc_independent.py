"""Auxiliary particle Gibbs with independent per-time-step Gaussian proposals.

Capability parity with reference ``csmc/independent.py:18-268`` (Finke &
Thiery-style independent-proposal auxiliary PG, with optional Langevin
gradient shifts and a parallel-in-time execution path) — clean-room design.

Construction
------------
Given a Feynman–Kac model (M0, G0, Mt, Gt) and auxiliary observations
``u_t = x_t + s_t eps`` with ``s_t = sqrt(delta_t / 2)``, the kernel targets

    pi(x | u) ∝ [p0(x_0) G0(x_0) prod_t p_t(x_t|x_{t-1}) Gt(x_t, x_{t-1})]
                 · prod_t N(x_t; u_t, s_t^2 I)

by running an inner cSMC whose *proposal* at step t is the independent
Gaussian ``N(u_t + shift_t, s_t^2 I)`` (``shift_t = s_t^2 ∇_t log pi(u)``
when ``gradient=True``, else 0) and whose *potentials* absorb the full model
density plus the proposal-vs-auxiliary importance ratio.

Design notes (differences from the reference by construction):

- One diagonal-Gaussian building block (`DiagonalGaussian` /
  `IndependentDynamics`) serves every proposal role — initial, transition,
  and time-batched parallel — instead of a class per role.
- The importance ratio ``log N(x; u, s) − log N(x; u + shift, s)`` is
  evaluated in closed form,

      corr(x) = sum_d shift_d (shift_d − 2 (x_d − u_d)) / (2 s^2),

  which costs one fused elementwise pass (no density evaluations) and is
  identically zero when ``shift = 0`` — so a single pair of absorbed
  potentials (`AbsorbedG0`, `AbsorbedGt`) covers the plain and
  gradient-shifted samplers alike.
"""
import math

import chex
import jax
import jax.numpy as jnp

from .base import f32_matmuls
from .csmc_aux import get_kernel as get_aux_kernel
from .csmc_base import CSMCState, Distribution, UnivariatePotential, Dynamics, Potential
from .pit import get_kernel as get_pit_kernel

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def get_kernel(M0: Distribution, G0: UnivariatePotential, Mt: Dynamics, Gt: Potential,
               N: int, backward: bool = False, Pt: Dynamics = None,
               gradient: bool = False, parallel: bool = False,
               resampling="multinomial"):
    """Auxiliary PG kernel with independent per-step proposals.

    ``gradient`` enables the Langevin shift; ``parallel`` runs the inner
    sweep through the divide-and-conquer PIT kernel instead of the
    sequential cSMC. Returns ``(init, kernel)`` with
    ``kernel(key, state, delta) -> CSMCState``; ``delta`` may be a scalar or
    a (T,) vector.
    """
    if parallel:
        return _pit_path(M0, G0, Mt, Gt, N, gradient)
    return _sequential_path(M0, G0, Mt, Gt, N, backward, Pt, gradient, resampling)


def trajectory_logpdf(u, M0, G0, Mt, Gt):
    """log of the unnormalised Feynman–Kac density along one trajectory.

    Differentiable in ``u``; its gradient supplies the per-step Langevin
    shifts (capability of reference ``independent.py:121-134``).
    """
    head = M0.logpdf(u[0]) + G0(u[0])
    pair_terms = jax.vmap(
        lambda nxt, cur, mp, gp: Mt.logpdf(nxt, cur, mp) + Gt(nxt, cur, gp)
    )(u[1:], u[:-1], Mt.params, Gt.params)
    return head + jnp.sum(pair_terms)


def _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient):
    """Per-step proposal means/shifts: loc_t = u_t + shift_t with
    shift_t = scale_t^2 * ∇_t log pi(u) (zero when gradient is off)."""
    if gradient:
        g = jax.grad(trajectory_logpdf)(u, M0, G0, Mt, Gt)
        shift = (scale ** 2)[:, None] * g
    else:
        shift = jnp.zeros_like(u)
    return u + shift, shift


def _sequential_path(M0, G0, Mt, Gt, N, backward, Pt, gradient, resampling):
    def factory(u, scale):
        loc, shift = _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient)
        prop0 = DiagonalGaussian(loc=loc[0], scale=scale[0])
        propt = IndependentDynamics(params=(loc[1:], scale[1:]))
        g0 = AbsorbedG0(prior=M0, pot=G0, u=u[0], shift=shift[0], scale=scale[0])
        gt = AbsorbedGt(
            trans=Mt, pot=Gt,
            params=(Mt.params, Gt.params, (u[1:], shift[1:], scale[1:])),
        )
        return prop0, g0, propt, gt

    return get_aux_kernel(factory, N, backward, Pt, resampling)


def _pit_path(M0, G0, Mt, Gt, N, gradient):
    """Parallel-in-time execution: proposals become time-batched independent
    Distributions; the gradient correction enters through the importance
    distribution Qt = N(u, s^2 I) rather than through the potentials."""

    @f32_matmuls
    def kernel(key, state, delta):
        x = state.x
        T = x.shape[0]
        scale = jnp.sqrt(0.5 * delta)
        if jnp.ndim(scale) == 0:
            scale = jnp.full((T,), scale, dtype=x.dtype)
        key_u, key_inner = jax.random.split(key)
        u = x + scale[:, None] * jax.random.normal(key_u, x.shape, dtype=x.dtype)

        loc, _ = _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient)
        proposals = DiagonalGaussian(loc=loc, scale=scale)
        qt = DiagonalGaussian(loc=u, scale=scale) if gradient else None
        zeros_d = jnp.zeros_like(u[0])
        g0 = AbsorbedG0(prior=M0, pot=G0,
                        u=zeros_d, shift=zeros_d, scale=jnp.ones_like(scale[0]))
        gt = AbsorbedGt(
            trans=Mt, pot=Gt,
            params=(Mt.params, Gt.params,
                    (jnp.zeros_like(u[1:]), jnp.zeros_like(u[1:]),
                     jnp.ones_like(scale[1:]))),
        )
        _, pit_kernel = get_pit_kernel(proposals, g0, gt, N, qt)
        return pit_kernel(key_inner, state)

    def init(x):
        return CSMCState(x=x, updated=jnp.zeros((x.shape[0],), dtype=bool))

    return init, kernel


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------

def _diag_gauss_logpdf(x, loc, scale):
    """Isotropic Gaussian log-density, reduced over the state dimension.
    ``scale`` is the scalar standard deviation of every component."""
    z = (x - loc) / scale
    d = x.shape[-1]
    return -0.5 * jnp.sum(z * z, axis=-1) - d * (jnp.log(scale) + _HALF_LOG_2PI)


def _shift_correction(x, u, shift, scale):
    """Closed form of log N(x; u, s^2 I) − log N(x; u + shift, s^2 I)."""
    num = shift * (shift - 2.0 * (x - u))
    return jnp.sum(num, axis=-1) / (2.0 * scale ** 2)


@chex.dataclass
class DiagonalGaussian(Distribution):
    """N(loc, scale^2 I) over one time step; ``loc`` is (d,), ``scale`` a
    scalar. With (T, d)/(T,)-shaped fields and an outer vmap it doubles as
    the time-batched proposal stack for the PIT kernel."""
    loc: chex.Array
    scale: chex.Array

    def sample(self, key, N):
        eps = jax.random.normal(key, (N,) + self.loc.shape, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def logpdf(self, x):
        return _diag_gauss_logpdf(x, self.loc, self.scale)


@chex.dataclass
class IndependentDynamics(Dynamics):
    """Time-indexed independent Gaussian proposals behind the Dynamics
    interface (the previous state is ignored); params = (loc_t, scale_t).

    `independent = True` advertises the x_prev-independence that lets the
    cSMC forward pass run as the index/weight recursion
    (`ops/csmc_sweeps.factor_scan`): particle values are then invariant to
    resampling, so the whole sweep needs no model evaluation in the loop."""
    independent = True

    def sample(self, key, x_t, params):
        return self.sample_from_noise(
            jax.random.normal(key, x_t.shape, dtype=x_t.dtype), x_t, params)

    def sample_from_noise(self, eps, x_t, params):
        loc, scale = params
        return loc + scale * eps

    def logpdf(self, x_next, x_t, params):
        loc, scale = params
        return _diag_gauss_logpdf(x_next, loc, scale)


@chex.dataclass
class AbsorbedG0(UnivariatePotential):
    """Initial-step target weight: model density p0 · G0 times the
    auxiliary-vs-proposal ratio (zero when ``shift`` is zero)."""
    prior: Distribution
    pot: UnivariatePotential
    u: chex.Array
    shift: chex.Array
    scale: chex.Array

    def __call__(self, x):
        base = self.pot(x) + self.prior.logpdf(x)
        return base + _shift_correction(x, self.u, self.shift, self.scale)


@chex.dataclass
class AbsorbedGt(Potential):
    """Transition-step target weight: model transition density · Gt times
    the auxiliary-vs-proposal ratio. params = (trans_params, pot_params,
    (u_t, shift_t, scale_t))."""
    trans: Dynamics = None
    pot: Potential = None

    def __call__(self, x_next, x_t, params):
        trans_params, pot_params, (u, shift, scale) = params
        base = self.trans.logpdf(x_next, x_t, trans_params)
        base = base + self.pot(x_next, x_t, pot_params)
        return base + _shift_correction(x_next, u, shift, scale)

    @property
    def supports_pairwise_factors(self):
        """Fused PIT stitching is available when the transition factorises
        (Gaussian) and the potential only reads x_{t+1}."""
        return (hasattr(self.trans, "logpdf_factors")
                and not getattr(self.pot, "prev_dependent", True))

    def pairwise_factors(self, x_left, x_right, params):
        """Factorise self(x_right[j], x_left[i], params) over all pairs as
        row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j] (see
        `csmc_base.Dynamics.logpdf_factors`)."""
        trans_params, pot_params, (u, shift, scale) = params
        rf, cf, rb, cb = self.trans.logpdf_factors(x_left, x_right, trans_params)
        cb = cb + self.pot(x_right, x_right, pot_params)
        cb = cb + _shift_correction(x_right, u, shift, scale)
        return rf, cf, rb, cb

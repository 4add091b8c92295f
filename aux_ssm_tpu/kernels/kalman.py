"""Auxiliary Kalman MCMC kernel — the paper's flagship algorithm.

Capability parity with reference `kalman/generic.py:19-106` — independent
implementation.

One step at state x:
  1. draw auxiliary observation  u = x + sqrt(delta/2) * eps;
  2. build a local LGSSM proposal around x from the user factories and draw a
     full trajectory x' from its exact Gaussian smoothing distribution
     (Kalman filter + backward sampling, parallel-in-time when requested);
  3. accept/reject with the exact MH ratio, which includes the pi(x|u)
     auxiliary correction -sum[(x'-u)^2 - (x-u)^2]/delta.

The kernel is a pure function of (key, state, delta) and is vmappable over a
chain axis — that is how multi-chip chain parallelism is expressed (shard the
chain axis of the vmapped kernel with NamedSharding; see `parallel/`).
"""
import chex
import jax
import jax.numpy as jnp

from .base import SamplerState
from ..ops.filtering import filtering
from ..ops.sampling import sampling
from ..ops.lgssm import LGSSM, posterior_logpdf


@chex.dataclass
class KalmanSampler(SamplerState):
    """State of the auxiliary Kalman sampler: trajectory and whether the last
    proposal was accepted. `log_target` caches log_likelihood_fn(x) so the
    reverse-move branch of the next step does not re-evaluate the target at
    the current trajectory (it is None when the state was constructed by
    hand, in which case the kernel recomputes it — same law either way)."""
    x: chex.Array
    updated: chex.Array
    log_target: chex.Array = None


def get_kernel(dynamics_factory, observations_factory, log_likelihood_fn, parallel,
               matmul_precision="highest"):
    """Build the auxiliary Kalman sampler.

    Parameters
    ----------
    dynamics_factory : Callable
        x -> (m0, P0, Fs, Qs, bs): prior part of the proposal LGSSM,
        linearised at the current trajectory.
    observations_factory : Callable
        (x, u, delta) -> (ys, Hs, Rs, cs): observation part of the proposal
        LGSSM, built from the auxiliary variable.
    log_likelihood_fn : Callable
        x -> unnormalised log-density of the FULL target at trajectory x,
        i.e. prior dynamics log-density PLUS potential log g(x) (as in the
        reference models, e.g. stochastic_volatility/auxiliary_kalman.py:50-54
        — omitting the prior breaks detailed balance).
    parallel : bool
        Use parallel-in-time filtering/sampling (O(log T) depth) or
        sequential scans.
    matmul_precision : str | None
        Matmul precision forced inside the kernel step (default "highest").
        On the GPU, f32 matmuls run in TF32 by default, which keeps about
        three decimal digits. The rounding enters the forward and reverse
        proposal log-densities separately, so it does NOT cancel in the MH
        ratio; "highest" keeps the products in f32. None leaves the ambient
        precision.

    Returns
    -------
    (init, kernel) following the universal kernel contract.
    """

    def propose(delta, key, u, x, x_eval=None, log_target=None):
        """Build the proposal LGSSM at x; sample from it unless `x_eval` is
        given (reverse-move density evaluation). Returns the proposal logpdf,
        the target log-density at `x_eval` (reusing `log_target` if the
        caller already knows it), and the (sampled or given) trajectory."""
        m0, P0, Fs, Qs, bs = dynamics_factory(x)[:5]
        ys, Hs, Rs, cs = observations_factory(x, u, delta)[:4]
        lgssm = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
        ms, Ps, ell = filtering(ys, lgssm, parallel)
        if x_eval is None:
            x_eval = sampling(key, ms, Ps, lgssm, parallel)
        log_prop = posterior_logpdf(ys, x_eval, ell, lgssm)
        if log_target is None:
            log_target = log_likelihood_fn(x_eval)
        return log_prop, log_target, x_eval

    def kernel(key, state, delta):
        if matmul_precision is not None:
            with jax.default_matmul_precision(matmul_precision):
                return _step(key, state, delta)
        return _step(key, state, delta)

    def _step(key, state, delta):
        x = state.x
        sqrt_delta = jnp.sqrt(delta)
        sqrt_half_delta = jnp.sqrt(0.5 * delta)
        aux_key, sample_key, accept_key = jax.random.split(key, 3)

        u = x + sqrt_half_delta * jax.random.normal(aux_key, x.shape, dtype=x.dtype)

        log_prop_fwd, log_target_prop, x_prop = propose(delta, sample_key, u, x)
        log_prop_rev, log_target_rev, _ = propose(
            delta, sample_key, u, x_prop, x, log_target=state.log_target)

        alpha = _acceptance_probability(
            log_prop_fwd, log_prop_rev, log_target_prop, log_target_rev,
            sqrt_delta, u, x, x_prop,
        )
        accept = jax.random.bernoulli(accept_key, alpha)
        x_new = jax.lax.select(accept, x_prop, x)
        lt_new = (None if state.log_target is None
                  else jnp.where(accept, log_target_prop, log_target_rev))
        return KalmanSampler(x=x_new, updated=accept, log_target=lt_new)

    def init(x):
        return KalmanSampler(x=x, updated=jnp.asarray(True),
                             log_target=log_likelihood_fn(x))

    return init, kernel


def _acceptance_probability(log_prop_fwd, log_prop_rev, log_target_prop,
                            log_target_rev, sqrt_delta, u, x, x_prop):
    """Exact MH ratio for the auxiliary move, including the Gaussian pi(x|u)
    correction (reference `kalman/generic.py:98-106`)."""
    log_alpha = log_target_prop - log_target_rev
    log_alpha += log_prop_rev - log_prop_fwd
    diff_prop = (x_prop - u) / sqrt_delta
    diff = (x - u) / sqrt_delta
    log_alpha -= jnp.sum(diff_prop ** 2 - diff ** 2)
    return jnp.exp(jnp.minimum(0.0, log_alpha))

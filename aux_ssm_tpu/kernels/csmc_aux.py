"""Auxiliary particle-Gibbs kernel with generic (user-factory) proposals.

Capability parity with reference `csmc/generic.py:14-79` — independent
implementation. Each step draws per-time-step auxiliary observations
u_t = x_t + sqrt(delta_t/2) * eps_t (delta may be a scalar or a (T,) vector
for time-local adaptivity) and hands them to a user factory that builds the
Feynman–Kac model (M0, G0, Mt, Gt) targeted by the inner cSMC sweep.
"""
import jax
import jax.numpy as jnp

from .base import f32_matmuls
from .csmc import get_kernel as get_csmc_kernel
from .csmc_base import CSMCState, Dynamics


def get_kernel(factory, N: int, backward: bool = False, Pt: Dynamics = None,
               resampling="multinomial"):
    """Build an auxiliary PG kernel from a model factory.

    Parameters
    ----------
    factory : Callable
        (u, sqrt_half_delta) -> (M0, G0, Mt, Gt); `u` has the trajectory
        shape (T, d), `sqrt_half_delta` is a (T,) vector.
    N : int
        Number of particles.
    backward : bool
        Backward sampling (requires `Pt`).
    Pt : Dynamics
        True-model dynamics, required when backward=True.
    resampling : str or Callable
        Conditional resampling scheme for the inner cSMC.

    Returns
    -------
    (init, kernel); kernel(key, state, delta) -> CSMCState.
    """
    if backward and Pt is None:
        raise ValueError("backward=True requires the true dynamics `Pt`.")
    if backward and not hasattr(Pt, "logpdf"):
        raise ValueError("`Pt` must implement a valid logpdf method.")
    if isinstance(resampling, str):
        # Resolve eagerly so typos fail at construction, not first kernel call.
        from ..ops import resampling as resampling_mod
        resampling = resampling_mod.get(resampling)

    @f32_matmuls
    def kernel(key, state, delta):
        x = state.x
        T = x.shape[0]
        sqrt_half_delta = jnp.sqrt(0.5 * delta)
        if jnp.ndim(sqrt_half_delta) == 0:
            sqrt_half_delta = jnp.full((T,), sqrt_half_delta, dtype=x.dtype)
        aux_key, inner_key = jax.random.split(key)

        u = x + sqrt_half_delta[:, None] * jax.random.normal(aux_key, x.shape, dtype=x.dtype)
        M0, G0, Mt, Gt = factory(u, sqrt_half_delta)

        _, csmc_kernel = get_csmc_kernel(
            M0, G0, Mt, Gt, N, backward=backward, Pt=Pt, resampling=resampling
        )
        return csmc_kernel(inner_key, state)

    def init(x):
        T = x.shape[0]
        return CSMCState(x=x, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel

"""Pathwise backward sampling from the smoothing distribution of an LGSSM.

Capability parity with `_primitives/kalman/sampling.py` (entry :11-40,
affine operator :44-55, init :60-136) — independent implementation.

Given filtered moments (ms, Ps), one joint smoothing draw x_{0:T} is obtained
by composing affine-Gaussian backward maps x_t = G_t x_{t+1} + e_t, where e_t
already contains the sampled noise. Composition of affine maps is associative,
so the whole trajectory is a reverse associative scan (O(log T) depth) or a
reverse sequential scan. All ops are explicit batched algebra (see
`batched.py`) — no gufunc wrappers on the hot path.
"""
import jax
import jax.numpy as jnp

from .batched import mT, mv, sym
from .chol import safe_cholesky
from .lgssm import LGSSM


def sampling(key, ms, Ps, lgssm: LGSSM, parallel: bool):
    """Sample one trajectory from p(x_{0:T} | y_{0:T}).

    Parameters
    ----------
    key : PRNG key
    ms, Ps : filtered means/covariances from `filtering`
    lgssm : LGSSM
    parallel : bool
        Reverse associative scan (True) or reverse sequential scan.

    Returns
    -------
    xs : Array with the same shape as `ms`.
    """
    gains, incs = _backward_maps(key, ms, Ps, lgssm.Fs, lgssm.Qs, lgssm.bs)
    if parallel:
        _, xs = jax.lax.associative_scan(sampling_operator, (gains, incs),
                                         reverse=True)
    else:
        def body(carry, inp):
            carry = sampling_operator(carry, inp)
            return carry, carry

        _, (_, xs) = jax.lax.scan(
            body, (gains[-1], incs[-1]), (gains[:-1], incs[:-1]), reverse=True
        )
        xs = jnp.concatenate([xs, incs[None, -1]], axis=0)
    return xs


def sampling_operator(elem1, elem2):
    """Composition of affine maps: (G1,e1) then (G2,e2) -> (G2 G1, G2 e1 + e2)."""
    G1, e1 = elem1
    G2, e2 = elem2
    if G1.shape[-1] == 1:  # scalar fast path (see filtering_operator)
        g1, g2 = G1[..., 0, 0], G2[..., 0, 0]
        return (g2 * g1)[..., None, None], (g2 * e1[..., 0])[..., None] + e2
    return G2 @ G1, mv(G2, e1) + e2


def backward_map_moments(F, Q, b, m, P):
    """Moments of the backward conditional x_t | x_{t+1} at filtered (m, P):
    mean = inc_m + gain @ x_{t+1}, covariance = L L^T. Batched over leading
    dims."""
    dx = m.shape[-1]
    S = sym(F @ P @ mT(F) + Q)

    if dx == 1:
        gain = P * F / S
        L = jnp.sqrt(jnp.maximum(P - gain @ S @ mT(gain), 0.0))
    else:
        chol_S = safe_cholesky(S)
        gain = mT(jax.scipy.linalg.cho_solve((chol_S, True), F @ P))
        # Zero-uncertainty steps give a singular cov; safe_cholesky returns a
        # usable (zeroed) factor there, matching the reference's nan_to_num
        # guard (`sampling.py:103-104`).
        L = safe_cholesky(P - gain @ S @ mT(gain))

    inc_m = m - mv(gain, mv(F, m) + b)
    return inc_m, L, gain


def _backward_maps(key, ms, Ps, Fs, Qs, bs):
    eps = jax.random.normal(key, shape=ms.shape, dtype=ms.dtype)

    inc_m, L, gains = backward_map_moments(Fs, Qs, bs, ms[:-1], Ps[:-1])
    incs = inc_m + mv(L, eps[:-1])

    dx = ms.shape[-1]
    P_last = Ps[-1]
    L_last = jnp.sqrt(jnp.maximum(P_last, 0.0)) if dx == 1 else safe_cholesky(P_last)
    last_inc = ms[-1] + mv(L_last, eps[-1])
    last_gain = jnp.zeros_like(P_last)

    gains = jnp.concatenate([gains, last_gain[None]], axis=0)
    incs = jnp.concatenate([incs, last_inc[None]], axis=0)
    return gains, incs

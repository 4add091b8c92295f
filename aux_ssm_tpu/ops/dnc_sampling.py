"""Divide-and-conquer Gaussian-bridge trajectory sampler (pedagogical).

Capability parity with `_primitives/kalman/dnc_sampling.py:17-187` —
independent implementation. Kept, as in the reference, as a proof-of-concept
alternative to the associative-scan sampler (`ops/sampling.py`), which is the
production path.

Idea: the backward conditionals x_t | x_{t+1} of an LGSSM are affine-Gaussian
maps (E, g, L) with  x_t | x_{t+1} ~ N(E x_{t+1} + g, L). Composing two maps
spanning [l, m] and [m, r] yields (a) the composed map for [l, r] and (b) the
*bridge* law of the midpoint x_m | (x_l, x_r) ~ N(G x_l + Gamma x_r + w, V)
(here "x_l" is the left-to-right conditioning variable x_r of the right
segment — see `_combine`). Sampling then proceeds root-down: endpoints first,
midpoints level by level.
"""
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve

from .chol import safe_cholesky
from .lgssm import LGSSM
from .mvn import rvs


def sampling(key, ms, Ps, lgssm: LGSSM):
    """Draw one trajectory from p(x_{0:T} | y_{0:T}) via the D&C tree.

    Unbatched only (use `ops.sampling.sampling` for batched / production).
    """
    warnings.warn(
        "dnc_sampling is a pedagogical proof-of-concept; use "
        "ops.sampling.sampling(parallel=True) for production.",
        UserWarning,
    )
    if jnp.ndim(ms) > 2:
        raise ValueError("Batched sampling is not supported here; use ops.sampling.")

    key, key_0, key_T = jax.random.split(key, 3)

    xs = jnp.zeros_like(ms)
    x_T = rvs(key_T, ms[-1], safe_cholesky(Ps[-1]))
    xs = xs.at[-1].set(x_T)

    (root, bridges, lefts, mids, rights) = _build_tree(ms, Ps, lgssm)

    # x_0 | x_T from the root composed map.
    E, g, L = root
    x0 = rvs(key_0, E[0] @ x_T + g[0], safe_cholesky(L[0]))
    xs = xs.at[0].set(x0)

    for bridge, i_l, i_m, i_r in zip(bridges, lefts, mids, rights):
        key, subkey = jax.random.split(key)
        keys = jax.random.split(subkey, i_m.shape[0])
        draws = jax.vmap(_sample_bridge)(keys, xs[i_l], xs[i_r], bridge)
        xs = xs.at[i_m].set(draws)
    return xs


def _sample_bridge(key, x_left, x_right, bridge):
    G, Gamma, w, V = bridge
    mean = G @ x_left + Gamma @ x_right + w
    return rvs(key, mean, safe_cholesky(V))


_MAP_SIG = "(dx,dx),(dx),(dx,dx)"


@partial(jnp.vectorize, signature=f"{_MAP_SIG},{_MAP_SIG}->{_MAP_SIG},(dx,dx),{_MAP_SIG}")
def _compose(E1, g1, L1, E2, g2, L2):
    """Compose backward maps (left segment: map 1; right: map 2) and derive
    the midpoint bridge parameters."""
    E = E1 @ E2
    g = g1 + E1 @ g2
    L = L1 + E1 @ L2 @ E1.T

    if L.shape[-1] == 1:
        G = L2 * E1.T / L
    else:
        G = solve(L, E1 @ L2, assume_a="pos").T
    Gamma = E2 - G @ E
    w = g2 - G @ g
    V = L2 - G @ L @ G.T
    return E, g, L, G, Gamma, w, V


def _combine(pair_a, pair_b):
    E1, g1, L1 = pair_a
    E2, g2, L2 = pair_b
    E, g, L, G, Gamma, w, V = _compose(E1, g1, L1, E2, g2, L2)
    return (E, g, L), (G, Gamma, w, V)


@partial(jnp.vectorize, signature="(dx),(dx,dx),(dx,dx),(dx,dx),(dx)->" + _MAP_SIG)
def _leaf_maps(m, P, F, Q, b):
    """Backward conditional x_t | x_{t+1} at filtered (m, P)."""
    S = F @ P @ F.T + Q
    if m.shape[-1] == 1:
        E = F * P / S
    else:
        E = solve(S, F @ P, assume_a="pos").T
    g = m - E @ (F @ m + b)
    L = P - E @ F @ P
    return E, g, L


def _build_tree(ms, Ps, lgssm):
    Fs, Qs, bs = lgssm.Fs, lgssm.Qs, lgssm.bs
    T = len(ms) - 1

    elems = _leaf_maps(ms[:-1], Ps[:-1], Fs, Qs, bs)
    spans = np.stack([np.arange(T), np.arange(1, T + 1)], axis=1)

    bridges, lefts, mids, rights = [], [], [], []
    n = T
    while n > 1:
        even = jax.tree.map(lambda z: z[0:2 * (n // 2):2], elems)
        odd = jax.tree.map(lambda z: z[1::2], elems)
        even_spans, odd_spans = spans[0:2 * (n // 2):2], spans[1::2]

        leftover = None
        if n % 2:
            leftover = jax.tree.map(lambda z: z[-1][None], elems)
            leftover_span = spans[-1][None]

        combined, bridge = jax.vmap(_combine)(even, odd)

        lefts.append(even_spans[:, 0])
        mids.append(even_spans[:, 1])
        rights.append(odd_spans[:, 1])
        bridges.append(bridge)

        new_spans = np.stack([even_spans[:, 0], odd_spans[:, 1]], axis=1)
        if leftover is not None:
            combined = jax.tree.map(lambda a, b: jnp.concatenate([a, b], 0), combined, leftover)
            new_spans = np.concatenate([new_spans, leftover_span], axis=0)

        elems, spans, n = combined, new_spans, (n + 1) // 2

    return elems, bridges[::-1], lefts[::-1], mids[::-1], rights[::-1]

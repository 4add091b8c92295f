"""Conditional resampling schemes for cSMC.

Capability parity with `_primitives/csmc/resamplings.py` (multinomial :14-37,
systematic :40-86) — independent implementation. Both keep index 0 pinned to
0 (the conditional/reference particle), which is the property particle-Gibbs
correctness rests on.

`sharded_multinomial` is the multi-device variant: weights live sharded
over a `particles` mesh axis; the categorical draw happens on replicated
all-gathered weights (N floats — tiny) so every shard computes identical
indices from the same key, then gathers are resolved collectively by the
caller (see `parallel/resampling.py`).
"""
import jax
import jax.numpy as jnp


def multinomial(key, weights, N=None):
    """Conditional multinomial resampling; weights assumed normalised.
    Index 0 of the output is always 0."""
    M = weights.shape[0]
    N = M if N is None else N
    indices = jax.random.choice(key, M, p=weights, shape=(N,), replace=True)
    return indices.at[0].set(0)


def multinomial_from_uniforms(u, weights):
    """Conditional multinomial resampling from precomputed iid uniforms
    `u` (N,) — same law as `multinomial` (iid categorical at positions
    1..N-1, index 0 pinned). Lets callers hoist all RNG out of a scan: the
    per-step work is just a cumsum + searchsorted."""
    M = weights.shape[0]
    idx = jnp.searchsorted(jnp.cumsum(weights), u).astype(jnp.int32)
    idx = jnp.clip(idx, 0, M - 1)
    return idx.at[0].set(0)


def categorical_from_uniform(u, weights):
    """One categorical draw by inverse CDF from a precomputed uniform `u`.
    Robust to slightly-unnormalised weights (inverts u * total_mass)."""
    cdf = jnp.cumsum(weights)
    idx = jnp.searchsorted(cdf, u * cdf[-1]).astype(jnp.int32)
    return jnp.clip(idx, 0, weights.shape[0] - 1)


def systematic_from_uniforms(u, weights, N=None):
    """Conditional systematic resampling from three precomputed iid uniforms
    `u` (3,) — same law as `systematic`; lets callers hoist all RNG out of a
    scan."""
    return _systematic_core(u[0], u[1], u[2], weights, N)


def _systematic_core(u_mix, u_off, u_rot, weights, N=None):
    M = weights.shape[0]
    N = M if N is None else N

    copies = N * weights[0]
    whole = jnp.floor(copies)
    part = copies - whole

    pick_low = u_mix * copies < part * (whole + 1.0)
    offset = jnp.where(pick_low, part * u_off, part + (1.0 - part) * u_off)
    # Degenerate conditioning: if w_0 underflowed to exactly 0 (reference
    # particle ~88 nats below the max in f32), the event "at least one copy
    # of particle 0" has numerical probability 0 and the mixture above keeps
    # the pin only with offset 0 — force it so slot 0 still maps to index 0.
    offset = jnp.where(copies > 0.0, offset, 0.0)

    positions = (offset + jnp.arange(N, dtype=weights.dtype)) / N
    idx = jnp.searchsorted(jnp.cumsum(weights), positions).astype(jnp.int32)

    n0 = jnp.sum(idx == 0)
    chosen = jnp.floor(n0 * u_rot).astype(jnp.int32)
    idx = jnp.clip(jnp.roll(idx, -chosen), 0, M - 1)
    return idx.at[0].set(0)      # invariant, belt-and-braces for fp edges


def systematic(key, weights, N=None):
    """Conditional systematic resampling (law of Chopin & Singh 2015, Alg. 4).

    Derivation: under plain systematic resampling with offset
    ``o ~ Uniform(0, 1)``, particle 0 receives ``ceil(c - o)`` copies, where
    ``c = N * w_0``, and — because the output of systematic resampling is
    nondecreasing — those copies always occupy the *leading* slots.
    Conditioning on at least one copy tilts the offset density to
    ``f(o) ∝ ceil(c - o)``: a two-component mixture of ``Uniform(0, frac(c))``
    (probability ``frac(c)·(floor(c)+1)/c``) and ``Uniform(frac(c), 1)``.
    (The ``c < 1`` case collapses into the first component, whose probability
    is then exactly 1 — no special case needed.) A uniformly chosen copy is
    then rotated into slot 0. Weights assumed normalised.
    """
    key_mix, key_off, key_rot = jax.random.split(key, 3)
    return _systematic_core(
        jax.random.uniform(key_mix), jax.random.uniform(key_off),
        jax.random.uniform(key_rot), weights, N,
    )


def get(name):
    """Look up a resampling scheme by name ('multinomial' | 'systematic')."""
    try:
        return {"multinomial": multinomial, "systematic": systematic}[name]
    except KeyError:
        raise ValueError(f"unknown resampling scheme: {name!r}") from None

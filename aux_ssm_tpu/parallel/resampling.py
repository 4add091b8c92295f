"""Collective conditional resampling over a sharded particle axis.

SURVEY hard-part 2: multinomial/systematic resampling over particles sharded
across chips must preserve the pinned-index-0 conditional property and exact
key reproducibility. Strategy: the categorical draw happens on *replicated*
all-gathered weights (N floats — bytes on the wire), so every shard computes
the identical index vector from the identical key; the particle gather is
resolved by all-gathering particles and slicing the local output range.
All-gather of weights+particles is cheap next to the per-step
model math at the N this framework targets (<= 64k particles).
"""
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .mesh import PARTICLES
from ..ops.resampling import multinomial


def sharded_conditional_resample(mesh, key, weights, particles, scheme=multinomial,
                                 axis=PARTICLES):
    """Resample `particles` (N, ...) sharded over `axis` according to global
    `weights` (N,), keeping global index 0 pinned at global position 0.

    Returns resampled particles with the same sharding. Bitwise identical to
    the single-chip `scheme(key, weights)` + take.
    """

    def body(w_local, p_local):
        w = jax.lax.all_gather(w_local, axis, tiled=True)
        idx = scheme(key, w)                      # identical on every shard
        shard = jax.lax.axis_index(axis)
        local_n = w_local.shape[0]
        my_idx = jax.lax.dynamic_slice_in_dim(idx, shard * local_n, local_n)
        p = jax.lax.all_gather(p_local, axis, tiled=True)
        return jnp.take(p, my_idx, axis=0)

    spec = P(axis)
    return shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
    )(weights, particles)


def sharded_conditional_resample_streaming(mesh, key, weights, particles,
                                           scheme=multinomial, axis=PARTICLES):
    """Memory-bounded variant of `sharded_conditional_resample`: instead of
    all-gathering the full (N, ...) particle array to every shard (O(N)
    memory per chip — the blocker past N≈64k), the local particle block
    rotates around the ring with `ppermute` and each shard picks the rows it
    needs as they stream past. Peak per-chip footprint is two local blocks
    (O(N/S)); total wire traffic is the same (S-1)·N/S rows the all-gather
    moves, but never materialised at once.

    Weights are still all-gathered (N floats — bytes on the wire) so the
    categorical indices are computed identically on every shard from the
    same key: the result is bitwise identical to the all-gather variant and
    to the single-chip `scheme(key, w)` + take.
    """
    n_shards = mesh.shape[axis]
    perm = [(j, (j + 1) % n_shards) for j in range(n_shards)]

    def body(w_local, p_local):
        w = jax.lax.all_gather(w_local, axis, tiled=True)
        idx = scheme(key, w)                      # identical on every shard
        shard = jax.lax.axis_index(axis)
        local_n = w_local.shape[0]
        my_idx = jax.lax.dynamic_slice_in_dim(idx, shard * local_n, local_n)
        need_owner = my_idx // local_n            # source shard of each row
        need_pos = my_idx % local_n               # row within that shard

        out = jnp.zeros((local_n,) + p_local.shape[1:], p_local.dtype)
        buf = p_local
        for r in range(n_shards):
            owner = (shard - r) % n_shards        # whose block we hold now
            rows = jnp.take(buf, need_pos, axis=0)
            mask = (need_owner == owner).reshape((-1,) + (1,) * (p_local.ndim - 1))
            out = jnp.where(mask, rows, out)
            if r + 1 < n_shards:
                buf = jax.lax.ppermute(buf, axis, perm)
        return out

    spec = P(axis)
    return shard_map(body, mesh=mesh, in_specs=(spec, spec),
                     out_specs=spec)(weights, particles)


def sharded_normalize(mesh, log_weights, axis=PARTICLES):
    """Exp-normalise log-weights sharded over `axis` (global logsumexp via
    pmax + psum)."""

    def body(lw):
        m = jax.lax.pmax(jnp.max(lw), axis)
        s = jax.lax.psum(jnp.sum(jnp.exp(lw - m)), axis)
        return jnp.exp(lw - m) / s

    return shard_map(body, mesh=mesh, in_specs=P(axis), out_specs=P(axis))(log_weights)

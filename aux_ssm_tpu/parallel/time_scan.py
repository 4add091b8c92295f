"""Time-axis sharding: distributed associative scans over a `time` mesh axis.

SURVEY §2.4 P1/P2: the domain's "sequence parallelism". The temporal Kalman
filter/sampler are associative scans over T; to scale T beyond one device
the scan runs as a two-level block scan over the mesh:

  1. each shard runs the inclusive scan of its local T/S block
     (hitting the single-chip fast path);
  2. the S block totals (one element each — KBs) are all-gathered
     and every shard combines its own prefix redundantly with a tiny
     replicated scan (S is small; replicated compute beats a sequential
     ppermute chain);
  3. the prefix element is combined into every local element.

Operator convention (as in ops/filtering and ops/sampling): op(e1, e2)
composes e2 *after* e1; for forward scans e1 is earlier in time, for
reverse scans jax feeds (accumulated-later, current-earlier), so in both
cases the cross-block combine is op(prefix, local).
"""
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

TIME = "time"


def sharded_associative_scan(mesh, operator, elems, reverse=False, axis=TIME):
    """Inclusive associative scan of `elems` (leading axis T, sharded over
    mesh axis `axis`). Matches `jax.lax.associative_scan(operator, elems,
    reverse=...)` up to floating-point reassociation.

    T need not divide the shard count: the tail (head, for reverse scans) is
    padded with copies of the edge element — an inclusive scan's first T
    forward results (last T reverse results) never read past-the-end
    elements, and edge copies keep every lane finite for any operator."""
    n_shards = mesh.shape[axis]
    T = jax.tree.leaves(elems)[0].shape[0]
    pad = (-T) % n_shards
    if pad:
        def _pad(z):
            edge = z[-1:] if not reverse else z[:1]
            reps = jnp.repeat(edge, pad, axis=0)
            parts = [z, reps] if not reverse else [reps, z]
            return jnp.concatenate(parts, axis=0)

        out = sharded_associative_scan(mesh, operator,
                                       jax.tree.map(_pad, elems),
                                       reverse=reverse, axis=axis)
        crop = (lambda z: z[:T]) if not reverse else (lambda z: z[pad:])
        return jax.tree.map(crop, out)

    def body(local):
        scanned = jax.lax.associative_scan(operator, local, reverse=reverse)

        # Block total: the fully-combined element of this block.
        take = 0 if reverse else -1
        total = jax.tree.map(lambda z: z[take], scanned)
        totals = jax.tree.map(lambda z: jax.lax.all_gather(z, axis, axis=0), total)
        idx = jax.lax.axis_index(axis)

        # Inclusive scan of the S block totals, replicated on every shard;
        # this shard's cross-block prefix is the neighbour's entry.
        incl = jax.lax.associative_scan(operator, totals, reverse=reverse)
        if reverse:
            prefix_idx = jnp.minimum(idx + 1, n_shards - 1)
            has_prefix = idx < n_shards - 1
        else:
            prefix_idx = jnp.maximum(idx - 1, 0)
            has_prefix = idx > 0
        prefix = jax.tree.map(lambda z: jnp.take(z, prefix_idx, axis=0), incl)

        with_prefix = operator(_bcast(prefix, scanned), scanned)
        return jax.tree.map(
            lambda w, s: jnp.where(has_prefix, w, s), with_prefix, scanned
        )

    spec = jax.tree.map(lambda _: P(axis), elems)
    return shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec)(elems)


def _bcast(prefix, like):
    """Broadcast a single element against the local block's leading axis."""
    return jax.tree.map(
        lambda p, l: jnp.broadcast_to(p[None], l.shape), prefix, like
    )


def sharded_filtering_scan(mesh, elems, axis=TIME):
    """Distributed scan of Kalman filtering elements (see ops/filtering)."""
    from ..ops.filtering import filtering_operator
    return sharded_associative_scan(mesh, filtering_operator, elems, axis=axis)


def sharded_sampling_scan(mesh, gains_incs, axis=TIME):
    """Distributed reverse scan of backward-sampling affine maps."""
    from ..ops.sampling import sampling_operator
    return sharded_associative_scan(mesh, sampling_operator, gains_incs,
                                    reverse=True, axis=axis)

"""Cross-chip parallel-in-time cSMC: the dSMC tree sharded over a `time`
mesh axis.

SURVEY §2.4 P3 (reference `pit/dc_map.py:108-121` is single-device): lower
tree levels run device-local under `shard_map`; upper-level stitching
crosses devices through collectives.

Decomposition (enabled by the index-composition engine in `pit.py`):

  1. *Local phase* (`shard_map`, zero communication): each chip runs all
     stitching levels interior to its T/C time chunk and emits (a) the
     per-level selection maps and (b) its two boundary particle sets,
     reordered by the chunk-local composition — the ONLY state upper levels
     ever need.
  2. *Upper phase* (replicated, tiny): the C chunk-boundary particle sets
     (C x N x d floats — KBs) form a C-step super-tree; `run_stitch_tree`
     runs it verbatim with chunk-start keys/params. GSPMD turns the
     boundary reads into an all-gather.
  3. *Resolution*: the root pair resolves through the upper selections to
     one index per chunk (replicated, O(C log C)), then each chip resolves
     its chunk genealogy locally and gathers its trajectory slice.

Because boundary values are gathered (not recomputed) and every level
processes arrays of the same global shape with the same per-step keys, the
sharded kernel draws are bit-identical to the single-device engine.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from .base import f32_matmuls
from .csmc_base import CSMCState
from .pit import (run_stitch_tree, resolve_genealogy, _root_init,
                  _pit_csmc as _pit_csmc_single)
from ..parallel.mesh import PARTICLES
from ..parallel.time_scan import TIME


def get_particle_sharded_kernel(Mt, G0, Gt, N, mesh, Qt=None, axis=PARTICLES):
    """PIT-cSMC kernel with the N^2 stitching score work sharded over a
    `particles` mesh axis (SURVEY hard-part 3: N=4096 is 16M weights per
    node; reference single-device law `pit/operator.py:72-81`).

    Decomposition: each chip computes the per-128-column block log-masses
    for its own whole-block column slice of every node (`block_masses` —
    the O(N^2) hot pass), the (N, nb) masses are all-gathered (O(N) floats
    per node), and the two-stage categorical draws run replicated
    with the single-device seed/pair_offset counter stream. Because each
    block's mass depends only on that block's columns, the sharded kernel is
    BIT-IDENTICAL to the single-device engine with blocked stitching
    (`AUX_SSM_STITCH=blocked`).

    Requires `Gt.supports_pairwise_factors` and N/S a multiple of 128
    (S = mesh.shape[axis]). Composable with per-chain vmap on an outer axis.
    """
    if not getattr(Gt, "supports_pairwise_factors", False):
        raise ValueError("particle-sharded PIT needs a pair-factorisable Gt "
                         "(supports_pairwise_factors)")
    S = mesh.shape[axis]
    if N % (128 * S):
        raise ValueError(f"particle-sharded PIT needs N/S a multiple of 128 "
                         f"(N={N}, S={S})")

    score_mesh = None if S == 1 else mesh

    @f32_matmuls
    def kernel(key, state):
        x, picked = _pit_csmc_single(key, state.x, Mt, G0, Gt, N, Qt,
                                     score_mesh=score_mesh, score_axis=axis)
        return CSMCState(x=x, updated=picked != 0)

    def init(x_star):
        T = x_star.shape[0]
        return CSMCState(x=x_star, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel


def get_sharded_kernel(Mt, G0, Gt, N, mesh, Qt=None, axis=TIME):
    """PIT-cSMC kernel with the time axis sharded over `mesh[axis]`.

    Same contract as `pit.get_kernel` (independent time-batched proposals
    `Mt`, optional importance correction `Qt`). Requires T = C * Tc with the
    chunk length Tc = T/C a power of two >= 2 (C = mesh.shape[axis] may be
    any count >= 1, pow2 or not): chunk-interior levels need full pow2
    chunks, while the C-leaf boundary super-tree reuses `run_stitch_tree`'s
    prefix-active padding — exactly the global tree's upper levels scaled by
    Tc, so draws stay bit-identical to the single-device kernel.
    """
    C = mesh.shape[axis]
    if C == 1:
        # Degenerate mesh: the boundary super-tree would be empty (no
        # C-step root pair is ever drawn locally) — the single-device
        # kernel IS this case.
        from .pit import get_kernel as _single_kernel
        return _single_kernel(Mt, G0, Gt, N, Qt=Qt)
    spec_t = P(axis)

    @f32_matmuls
    def kernel(key, state):
        x, picked = _sharded_pit(key, state.x, Mt, G0, Gt, N, Qt, mesh, axis, C)
        return CSMCState(x=x, updated=picked != 0)

    def init(x_star):
        T = x_star.shape[0]
        _check_shapes(T, C)
        return CSMCState(x=x_star, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel


def _check_shapes(T, C):
    if T % C or (T // C) < 2:
        raise ValueError(f"time-sharded PIT needs C | T and T/C >= 2 "
                         f"(T={T}, C={C})")
    Tc = T // C
    if Tc & (Tc - 1):
        raise ValueError(f"time-sharded PIT needs the chunk length T/C to be "
                         f"a power of two (got {Tc}); C itself may be any "
                         f"device count")


def _sharded_pit(key, x_star, Mt, G0, Gt, N, Qt, mesh, axis, C):
    T = x_star.shape[0]
    Tc = T // C
    Kl = int(math.log2(Tc))
    shard_t = NamedSharding(mesh, P(axis))

    sample_key, resample_key = jax.random.split(key)
    sample_keys = jax.random.split(sample_key, T)
    resample_keys = jax.random.split(resample_key, T)

    # Proposals + initial weights: embarrassingly time-parallel; a sharding
    # constraint lets GSPMD run them chunk-local.
    xs = jax.vmap(lambda m, k: m.sample(k, N))(Mt, sample_keys)
    xs = xs.at[:, 0].set(x_star)
    xs = jax.lax.with_sharding_constraint(xs, shard_t)

    if Qt is not None:
        log_wts = jax.vmap(lambda q, x: q.logpdf(x))(Qt, xs)
        log_wts -= jax.vmap(lambda m, x: m.logpdf(x))(Mt, xs)
    else:
        log_wts = jnp.zeros((T, N), dtype=x_star.dtype)
    log_wts = log_wts.at[0].add(G0(xs[0]))
    log_wts -= logsumexp(log_wts, axis=1, keepdims=True)
    log_wts = jax.lax.with_sharding_constraint(log_wts, shard_t)

    # Right-shift Gt params: params[t] weighs the (t-1, t) boundary.
    params = Gt.params
    fake = jax.tree.map(lambda z: jnp.full_like(z[:1], jnp.nan), params)
    params = jax.tree.map(lambda f, z: jnp.concatenate([f, z], axis=0), fake,
                          params)

    # Per-level stage-2 seeds: the single-device engine derives level k's
    # seed from the key at the level's FIRST node (row 2^k — inside chunk 0);
    # precompute them replicated so every chunk uses the global seed, and
    # offset the pair counters by the chunk's node range. With these, the
    # fused draws are bit-identical to the single-device kernel.
    if Kl > 0:
        seed_rows = jnp.asarray([1 << k for k in range(Kl)])
        level_seeds = jax.vmap(
            lambda r: jax.random.randint(resample_keys[r], (), 0,
                                         jnp.iinfo(jnp.int32).max,
                                         dtype=jnp.int32))(seed_rows)
    else:  # pragma: no cover
        level_seeds = jnp.zeros((0,), jnp.int32)
    n_act_chunk = np.asarray([Tc // (2 << k) for k in range(Kl)], np.int32)

    # ---- local phase: chunk-interior levels, no communication ----
    def local_fn(xs_c, lw_c, keys_c, params_c, seeds_c):
        chunk = jax.lax.axis_index(axis)
        offsets = chunk * jnp.asarray(n_act_chunk)
        sels, _, (first, last) = run_stitch_tree(
            xs_c, xs_c, lw_c, keys_c, params_c, Gt, N,
            include_root=False, level_seeds=seeds_c,
            pair_offsets=offsets, return_bounds=True)
        flat = []
        for (L, R, _n) in sels:
            flat += [L, R]
        return tuple(flat) + (first[None], last[None])

    n_sel_arrays = 2 * Kl
    out_specs = tuple([P(axis)] * n_sel_arrays) + (P(axis), P(axis))
    spec_t = P(axis)
    outs = shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec_t, spec_t, spec_t,
                  jax.tree.map(lambda _: spec_t, params), P()),
        out_specs=out_specs,
    )(xs, log_wts, resample_keys, params, level_seeds)
    sel_flat, firsts, lasts = outs[:n_sel_arrays], outs[-2], outs[-1]
    n_act_local = [Tc // (2 << k) for k in range(Kl)]       # per-chunk counts

    # ---- upper phase: super-tree over the C chunk boundaries ----
    keys_super = resample_keys[::Tc]
    params_super = jax.tree.map(lambda z: z[::Tc], params)
    sels_up, root = run_stitch_tree(lasts, firsts, None, keys_super,
                                    params_super, Gt, N, include_root=True)
    idx_c = _root_init(root, C, N)
    j_chunk = resolve_genealogy(sels_up, idx_c, C, N)        # (C,)

    # ---- local resolution + trajectory gather ----
    def resolve_fn(j_c, xs_c, *sel_flat_c):
        sels_c = [(sel_flat_c[2 * k], sel_flat_c[2 * k + 1], n_act_local[k])
                  for k in range(Kl)]
        idx0 = jnp.full((Tc,), j_c[0], dtype=jnp.int32)
        idx = resolve_genealogy(sels_c, idx0, Tc, N)
        x_out = jnp.take_along_axis(xs_c, idx[:, None, None], axis=1)[:, 0]
        return x_out, idx

    x_out, picked = shard_map(
        resolve_fn, mesh=mesh,
        in_specs=(spec_t, spec_t) + tuple([spec_t] * n_sel_arrays),
        out_specs=(spec_t, spec_t),
    )(j_chunk, xs, *sel_flat)
    return x_out, picked

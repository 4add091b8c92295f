"""Parallel-in-time conditional SMC (divide-and-conquer particle Gibbs).

Capability parity with `_primitives/csmc/pit/` (dc_map.py:37-159,
operator.py:38-149, csmc.py:16-114) — independent implementation.

Structure
---------
- `dc_map`: a log2(T)-level binary tree reduction. T is padded to the next
  power of two; at every level the number of "active" pairs is a *Python*
  constant, so the active/passthrough split is a static slice (the reference
  uses NumPy boolean masks, `pit/dc_map.py:91-121`; static slices express the
  same thing with zero gather traffic and keep every level fully jittable and
  shardable).
- `stitching_operator`: combines two partial smoothers by drawing N index
  pairs from the N^2 boundary-weight categorical (conditional multinomial,
  pair 0 pinned), then gathering and concatenating the trajectory blocks.
- `get_kernel`: the PIT-cSMC kernel over independent per-time proposals.

The N^2 weight matrix is the hot spot at scale (N=4096 -> 16M weights per
node, 32 GB per tree level if materialised). When the boundary potential
factorises (`Gt.supports_pairwise_factors` — every Gaussian-transition model
does, see `csmc_base.Dynamics.logpdf_factors`), the stitching draw runs
through `ops/stitching.py`: blockwise pairwise scores + per-row (block)
log-masses + an exact two-stage categorical, never materialising N^2.
The generic nested-vmap path remains for arbitrary user potentials.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp

from .base import f32_matmuls
from .csmc_base import CSMCState, Distribution, UnivariatePotential, Potential
from ..ops.resampling import multinomial
from ..ops.take import take_rows, categorical_from_uniforms
from ..ops import stitching as _stitch


# --------------------------------------------------------------------------
# Generic divide-and-conquer tree map
# --------------------------------------------------------------------------

def _next_pow2(n):
    return 1 << (n - 1).bit_length()


def _pad_leaf(z, pow2, T):
    pad = [(0, pow2 - T)] + [(0, 0)] * (z.ndim - 1)
    if jnp.issubdtype(z.dtype, jnp.integer) or jnp.issubdtype(z.dtype, jnp.bool_):
        return jnp.pad(z, pad, constant_values=0)
    if jnp.issubdtype(z.dtype, jax.dtypes.prng_key):
        return jnp.pad(z, pad, mode="edge")  # never consumed
    return jnp.pad(z, pad, constant_values=jnp.nan)


def dc_map(elems, operator, last_operator=None):
    """Binary-tree reduction of `elems` (leading axis T) with `operator`.

    `operator(pair_a, pair_b)` receives pytrees whose leaves have shape
    (n_pairs, block, ...) and must return leaves of shape
    (n_pairs, 2*block, ...) — i.e. it is already vmapped over the pair axis
    (wrap with `jax.vmap` as the reference does, `pit/csmc.py:112`).
    `last_operator` (optional) is used for the root combination.
    """
    if last_operator is None:
        last_operator = operator

    leaves, treedef = jax.tree.flatten(elems)
    T = leaves[0].shape[0]
    if T <= 1:
        return elems  # nothing to combine
    pow2 = _next_pow2(T)
    K = int(math.log2(pow2))

    padded = jax.tree.map(lambda z: _pad_leaf(z, pow2, T), elems)

    tree = jax.tree.map(lambda z: z.reshape((pow2, 1) + z.shape[1:]), padded)

    for k in range(K):
        block = 1 << k
        n_pairs = pow2 // (2 * block)
        even = jax.tree.map(lambda z: z[0::2], tree)
        odd = jax.tree.map(lambda z: z[1::2], tree)

        # A pair is active iff its odd block contains at least one real index,
        # i.e. its start (2p+1)*2^k < T. Active pairs are a prefix.
        n_active = sum(1 for p in range(n_pairs) if (2 * p + 1) * block < T)

        if k == K - 1:
            tree = last_operator(even, odd)
        elif n_active == n_pairs:
            tree = operator(even, odd)
        else:
            act = operator(
                jax.tree.map(lambda z: z[:n_active], even),
                jax.tree.map(lambda z: z[:n_active], odd),
            )
            rest = jax.tree.map(
                lambda a, b: jnp.concatenate([a[n_active:], b[n_active:]], axis=1),
                even, odd,
            )
            tree = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0), act, rest)

    return jax.tree.map(lambda z: z.reshape((pow2,) + z.shape[2:])[:T], tree)


# --------------------------------------------------------------------------
# Stitching operator
# --------------------------------------------------------------------------

def stitching_weights(x_left, log_w_left, x_right, log_w_right, params_right,
                      log_weight_fn):
    """Normalised (N, N) stitching weights across a block boundary:
    w_ij ∝ exp(G(x_right_j, x_left_i) + log_w_left_i + log_w_right_j)."""
    pairwise = jax.vmap(
        jax.vmap(log_weight_fn, in_axes=(None, 0, None)),
        in_axes=(0, None, None),
    )(x_left, x_right, params_right)
    log_w = pairwise + log_w_left[:, None] + log_w_right[None, :]
    return jnp.exp(log_w - logsumexp(log_w))


def stitching_operator(inputs_a, inputs_b, log_weight_fn, n_samples, last_step):
    """Combine two partial conditional smoothers (one tree node).

    `inputs_* = ((trajectories, log_weights, origins), keys, params)` with
    trajectories (t_block, N, d). Draws N boundary index pairs — conditional
    multinomial with pair 0 pinned so the reference trajectory survives — or a
    single unconditional pair at the root when `last_step`.
    """
    (traj_a, log_w_a, orig_a), keys_a, params_a = inputs_a
    (traj_b, log_w_b, orig_b), keys_b, params_b = inputs_b

    weights = stitching_weights(
        jax.tree.map(lambda z: z[-1], traj_a), log_w_a[-1],
        jax.tree.map(lambda z: z[0], traj_b), log_w_b[0],
        jax.tree.map(lambda z: z[0], params_b),
        log_weight_fn,
    )

    if last_step:
        idx = jax.random.choice(keys_b[0], n_samples * n_samples, p=weights.ravel())
        l_idx, r_idx = jnp.unravel_index(idx, (n_samples, n_samples))
    else:
        idx = multinomial(keys_b[0], weights.ravel(), n_samples)
        l_idx, r_idx = jax.vmap(jnp.unravel_index, in_axes=(0, None))(
            idx, (n_samples, n_samples)
        )

    traj_a = jax.tree.map(lambda z: jnp.take(z, l_idx, axis=1), traj_a)
    traj_b = jax.tree.map(lambda z: jnp.take(z, r_idx, axis=1), traj_b)
    orig_a = jnp.take(orig_a, l_idx, axis=1)
    orig_b = jnp.take(orig_b, r_idx, axis=1)

    cat = lambda a, b: jnp.concatenate([a, b], axis=0)
    traj = jax.tree.map(cat, traj_a, traj_b)
    origins = cat(orig_a, orig_b)
    keys = cat(keys_a, keys_b)
    params = jax.tree.map(cat, params_a, params_b)
    log_w = jnp.full_like(cat(log_w_a, log_w_b), -math.log(n_samples))
    return (traj, log_w, origins), keys, params


# --------------------------------------------------------------------------
# Fused (factorised) stitching operator
# --------------------------------------------------------------------------

# At and above this N the single block-mass pass + joint flat draw runs;
# below it, the two-pass row-LSE + column-sample path. On the H100 the
# blocked path was the faster at both N measured (T=1024: 21.5 vs 26.3 ms
# per PIT step at N=2048, 69.6 vs 88.9 ms at N=4096; PERF.md).
_BLOCKED_MIN_N = 2048


def _use_blocked_stitch(N):
    """Single-pass block-mass stitching: one N^2 score pass total.
    `AUX_SSM_STITCH`: 'blocked' forces it, '2pass' disables, 'auto' (default)
    switches on for large multiples of 128."""
    mode = os.environ.get("AUX_SSM_STITCH", "auto")
    if mode == "2pass" or N % 128 != 0:
        return False
    return mode == "blocked" or N >= _BLOCKED_MIN_N


def _draws_mode():
    """How the stage-1/2 draws run on the blocked path
    (`AUX_SSM_STITCH_DRAWS`).

    'joint' (default): one flat inverse-CDF draw over the (N * nb)
    (row, block) categorical + within-block Gumbel columns
    (`stitching.joint_rowblock_draws`). 'unfused': stage-wise row draw +
    `blocked_col_sample`. Same joint law, different uniform-to-index
    mapping.
    """
    mode = os.environ.get("AUX_SSM_STITCH_DRAWS", "joint")
    if mode not in ("joint", "unfused"):
        raise ValueError(f"AUX_SSM_STITCH_DRAWS={mode!r}: joint | unfused")
    return mode


_SUPER = 512          # column-super width of the aggregated stage-1 draw


def _super_group(N):
    """Column-group width for the joint draw's stage 1. At large N the flat
    (row, block) categorical has N * (N/128) cells, and its final per-draw
    tile select costs (cells / 128) * tile_width MAC per draw; aggregating
    128-blocks into 512-supers for stage 1 shrinks that 4x, and the exact
    column draw then runs one 512-wide within-super pass instead of a
    128-wide within-block pass (law unchanged: P(row, super) by flat
    inverse-CDF over LSE-aggregated masses, P(col | row, super) by
    Gumbel-argmax over the recomputed exact scores).

    Default off (G = 128); `AUX_SSM_COL_SUPER=512` (or any 128-multiple
    dividing N) turns it on."""
    env = os.environ.get("AUX_SSM_COL_SUPER", "")
    if env and env != "0":
        G = int(env)
        if G % _stitch._COL_BLOCK == 0 and N % G == 0:
            return G
    return _stitch._COL_BLOCK


def _fused_gather_concat(inputs_a, inputs_b, l_idx, r_idx, n_samples):
    """Batched trajectory gather + concat; l_idx/r_idx (P, n)."""
    (traj_a, log_w_a, orig_a), keys_a, params_a = inputs_a
    (traj_b, log_w_b, orig_b), keys_b, params_b = inputs_b

    def take(z, idx):
        # z: (P, block, N, ...) -> gather along the particle axis.
        expand = idx.reshape(idx.shape[0], 1, idx.shape[1],
                             *([1] * (z.ndim - 3)))
        return jnp.take_along_axis(z, jnp.broadcast_to(
            expand, z.shape[:2] + (idx.shape[1],) + z.shape[3:]), axis=2)

    traj_a = jax.tree.map(lambda z: take(z, l_idx), traj_a)
    traj_b = jax.tree.map(lambda z: take(z, r_idx), traj_b)
    orig_a = take(orig_a, l_idx)
    orig_b = take(orig_b, r_idx)

    cat = lambda a, b: jnp.concatenate([a, b], axis=1)
    traj = jax.tree.map(cat, traj_a, traj_b)
    origins = cat(orig_a, orig_b)
    keys = cat(keys_a, keys_b)
    params = jax.tree.map(cat, params_a, params_b)
    log_w = jnp.full_like(cat(log_w_a, log_w_b), -math.log(n_samples))
    return (traj, log_w, origins), keys, params


def fused_stitching_operator(inputs_a, inputs_b, Gt, n_samples, last_step):
    """Factorised stitching for one tree level; natively batched over the
    pair axis (leaves (P, block, N, ...)), drop-in for the vmapped generic
    `stitching_operator`. Same law: N iid pairs from the flat N^2 softmax
    with pair 0 pinned to (0, 0) (or one unconditional pair at the root).
    The two-stage draw itself lives in `_fused_node_draw` (shared with the
    index-composition engine)."""
    (traj_a, log_w_a, _), _, _ = inputs_a
    (traj_b, log_w_b, _), keys_b, params_b = inputs_b

    xl = traj_a[:, -1]                                  # (P, N, d)
    xr = traj_b[:, 0]
    pb = jax.tree.map(lambda z: z[:, 0], params_b)
    node_keys = keys_b[:, 0]

    rows, cols = _fused_node_draw(xl, xr, log_w_a[:, -1], log_w_b[:, 0], pb,
                                  node_keys, Gt, n_samples, last_step)
    out = _fused_gather_concat(inputs_a, inputs_b, rows, cols, n_samples)
    if last_step:
        # Match the generic root semantics: squeeze the particle axis.
        (traj, log_w, origins), keys, params = out
        traj = jax.tree.map(lambda z: z[:, :, 0], traj)
        origins = origins[:, :, 0]
        return (traj, log_w, origins), keys, params
    return out


# --------------------------------------------------------------------------
# PIT-cSMC kernel
# --------------------------------------------------------------------------

def get_kernel(Mt: Distribution, G0: UnivariatePotential, Gt: Potential, N: int,
               Qt: Distribution = None):
    """Parallel-in-time cSMC kernel over independent per-time proposals.

    Targets (up to proportionality) prod_t Mt[t](x_t) G0(x_0) prod Gt — or,
    with `Qt` given, uses Mt as proposal for the Qt-weighted model (importance
    correction), as in reference `pit/csmc.py:16-54`.

    `Mt`/`Qt` are time-batched Distributions: `jax.vmap(lambda m, k:
    m.sample(k, N))(Mt, keys)` must yield (T, N, d).
    """

    @f32_matmuls
    def kernel(key, state):
        x, picked = _pit_csmc(key, state.x, Mt, G0, Gt, N, Qt)
        return CSMCState(x=x, updated=picked != 0)

    def init(x_star):
        T = x_star.shape[0]
        return CSMCState(x=x_star, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel


def _pit_csmc(key, x_star, Mt, G0, Gt, N, Qt, score_mesh=None,
              score_axis=None):
    """Index-composition PIT engine.

    Redesign of the dSMC tree (reference `pit/dc_map.py:37-123` +
    `pit/operator.py:38-149`, and of an earlier tree that carried gathered
    trajectory/origin/key/param blocks through every level): trajectories are
    proposed once and NEVER gathered during the tree. Each level only

      1. carries the node-boundary particle VALUES forward (two gathers per
         merge — see `run_stitch_tree`),
      2. computes the N^2 boundary weights on those two rows (fused
         factorised matmul or generic nested-vmap), and
      3. records the drawn index pairs (L_k, R_k).

    The single output genealogy is resolved at the end by one O(T log T)
    top-down pass through the recorded selections, followed by one gather of
    the final trajectory. This removes the O(T N d log T) gather/concat
    traffic that dominated the tree implementation at large N.
    """
    T = x_star.shape[0]
    sample_key, resample_key = jax.random.split(key)
    sample_keys = jax.random.split(sample_key, T)
    resample_keys = jax.random.split(resample_key, T)

    # Propose all T x N particles at once — the fully time-parallel step.
    xs = jax.vmap(lambda m, k: m.sample(k, N))(Mt, sample_keys)
    xs = xs.at[:, 0].set(x_star)

    if Qt is not None:
        log_wts = jax.vmap(lambda q, x: q.logpdf(x))(Qt, xs)
        log_wts -= jax.vmap(lambda m, x: m.logpdf(x))(Mt, xs)
    else:
        log_wts = jnp.zeros((T, N), dtype=x_star.dtype)

    log_wts = log_wts.at[0].add(G0(xs[0]))
    log_wts -= logsumexp(log_wts, axis=1, keepdims=True)

    if T == 1:
        u = jax.random.uniform(resample_keys[0])
        j = categorical_from_uniforms(log_wts[0], u[None])[0]
        return xs[:, j], j[None]

    # Shift Gt params one step right: params[t] weighs the (t-1, t) boundary.
    params = Gt.params
    # The t=0 slot is a pure placeholder (no (t-1, t) boundary exists);
    # poison float leaves with NaN so accidental use is loud, but fill
    # integer leaves with 0 — casting NaN to int is UB and warns.
    fake = jax.tree.map(
        lambda z: jnp.full_like(
            z[:1], jnp.nan if jnp.issubdtype(z.dtype, jnp.floating) else 0),
        params)
    params = jax.tree.map(lambda f, z: jnp.concatenate([f, z], axis=0), fake, params)

    sels, root = run_stitch_tree(xs, xs, log_wts, resample_keys, params, Gt, N,
                                 include_root=True, score_mesh=score_mesh,
                                 score_axis=score_axis)
    idx0 = _root_init(root, T, N)
    idx = resolve_genealogy(sels, idx0, T, N)
    x_out = jnp.take_along_axis(xs, idx[:, None, None], axis=1)[:, 0]
    return x_out, idx


def _sharded_block_masses(score_mesh, score_axis, rf, cf, cb):
    """Column-sharded block-mass pass: each device scores the full row set
    against its LOCAL whole-128-column blocks, then the (P, N, nb) masses are
    all-gathered for the replicated stage-1/2 draws. Each block's log-mass
    depends only on that block's columns, so whole-block sharding is
    bit-identical to the single-chip pass (SURVEY hard-part 3; reference
    single-device law `pit/operator.py:72-81`)."""
    from jax.sharding import PartitionSpec as _P
    from jax import shard_map as _shard_map

    S = score_mesh.shape[score_axis]
    if cf.shape[1] % (128 * S):
        raise ValueError(
            f"particle-sharded stitching needs N/S a multiple of 128 "
            f"(N={cf.shape[1]}, S={S})")

    def body(rf_full, cf_loc, cb_loc):
        # per_block_max: each block's log-mass must depend only on that
        # block's columns so the sharded pass matches any shard count.
        Lb_loc = _stitch.block_masses(rf_full, cf_loc, cb_loc,
                                      per_block_max=True)
        return jax.lax.all_gather(Lb_loc, score_axis, axis=2, tiled=True)

    # check_vma off: the all-gathered masses ARE replicated (identical block
    # order on every chip) but the varying-axes analysis cannot infer it.
    return _shard_map(
        body, mesh=score_mesh,
        in_specs=(_P(), _P(None, score_axis), _P(None, score_axis)),
        out_specs=_P(), check_vma=False,
    )(rf, cf, cb)


def run_stitch_tree(left_vals, right_vals, log_wts, step_keys, params, Gt, N,
                    include_root, level_seeds=None, pair_offsets=None,
                    score_mesh=None, score_axis=None, return_bounds=False):
    """Run the dSMC stitching levels over S "steps", recording selections.

    left_vals / right_vals : (S, N, d) particle sets serving as a node's
        left/right boundary values (both = the proposals `xs` for the
        single-device tree; chunk-boundary particle sets for the upper tree
        of the cross-chip kernel).
    log_wts : (S, N) initial importance weights, or None for uniform (after
        any stitching, weights are uniform — a constant logit shift).
    step_keys / params : per-step PRNG keys and (right-shifted) Gt params.
    include_root : draw one unconditional pair at the top level instead of N.

    Boundary orderings are maintained FORWARD as per-node boundary VALUE
    arrays (`x_first[i]` / `x_last[i]` = the level's node i's first/last-step
    particle values, updated by one gather per drawn selection) instead of
    recomposing each boundary's selection chain from scratch per level
    (O(level) width-1 gathers per boundary vs exactly two per merge here,
    with identical values bit-for-bit).

    Returns (sels, root): `sels` is a list over recorded levels of
    (L, R, n_act) selection arrays (L/R (n_act, N) int32), `root` the single
    (l*, r*) pair (or None). With `return_bounds`, returns
    (sels, root, (x_first, x_last)) — the final top node's boundary values
    (each (N, d); the cross-chip kernel's chunk boundary sets). The
    genealogy is NOT resolved here — compose with `resolve_genealogy`.
    """
    S = left_vals.shape[0]
    fused = getattr(Gt, "supports_pairwise_factors", False)

    pow2 = _next_pow2(S)
    K = int(math.log2(pow2))

    sels = []                       # per level: (L, R, n_act) with L/R (n_act, N)
    root = None
    # Per-node boundary values at the current level (node i covers steps
    # [i*2^k, (i+1)*2^k) intersected with [0, S)). At level 0 every node is
    # one step: first = right_vals, last = left_vals (they are the same
    # array in the single-device tree; the cross-chip upper tree feeds the
    # chunk-last sets as left_vals and chunk-first sets as right_vals).
    x_first = right_vals
    x_last = left_vals
    # A step's initial importance weights enter the pair weights at the FIRST
    # level where it serves as a node boundary (for every step but the last
    # of an odd S that is level 0; the odd tail step only joins at the unique
    # level where S-1 = odd * 2^k). After a step has been stitched once its
    # weights are uniform. Static host-side bookkeeping: mids are NumPy.
    consumed = np.zeros(S, dtype=bool)
    for k in range(K):
        block = 1 << k
        n_nodes = -(-S // block)               # real nodes at this level
        mids_all = (2 * np.arange(pow2 // (2 * block)) + 1) * block
        mids = mids_all[mids_all < S]          # active nodes are a prefix
        n_act = len(mids)
        assert n_act == n_nodes // 2
        if n_act == 0:
            sels.append(None)
            continue
        lefts, rights = mids - 1, mids

        xf_even, xf_odd = x_first[0::2], x_first[1::2]
        xl_even, xl_odd = x_last[0::2], x_last[1::2]
        xl = xl_even[:n_act]                   # left child's last step
        xr = xf_odd[:n_act]                    # right child's first step
        if log_wts is not None:
            fresh_l = jnp.asarray(~consumed[lefts])[:, None]
            fresh_r = jnp.asarray(~consumed[rights])[:, None]
            lw_l = jnp.where(fresh_l, log_wts[lefts], 0.0)
            lw_r = jnp.where(fresh_r, log_wts[rights], 0.0)
        else:
            lw_l = jnp.zeros((n_act, N), left_vals.dtype)
            lw_r = jnp.zeros((n_act, N), left_vals.dtype)
        consumed[lefts] = consumed[rights] = True
        node_keys = step_keys[rights]
        params_r = jax.tree.map(lambda z: z[rights], params)
        last = include_root and k == K - 1

        new_first = new_last = None
        if fused:
            seed_k = None if level_seeds is None else level_seeds[k]
            off_k = 0 if pair_offsets is None else pair_offsets[k]
            out = _fused_node_draw(xl, xr, lw_l, lw_r, params_r,
                                   node_keys, Gt, N, last,
                                   seed=seed_k, pair_offset=off_k,
                                   score_mesh=score_mesh,
                                   score_axis=score_axis,
                                   row_payload=None if last else xf_even[:n_act],
                                   col_payload=None if last else xl_odd[:n_act])
            if last:
                rows, cols = out
            else:
                rows, cols, new_first, new_last = out
        else:
            rows, cols = _generic_node_draw(xl, xr, lw_l, lw_r, params_r,
                                            node_keys, Gt, N, last)
        if last:
            root = (rows[:, 0], cols[:, 0])    # single node, single pair
        else:
            sels.append((rows, cols, n_act))
            # Merged node p: first values = left child's firsts reordered by
            # the drawn rows, last values = right child's lasts by the drawn
            # columns. A trailing even node without a sibling passes
            # through.
            if new_first is None:
                new_first = take_rows(xf_even[:n_act], rows)
                new_last = take_rows(xl_odd[:n_act], cols)
            x_first = jnp.concatenate([new_first, xf_even[n_act:]], axis=0)
            x_last = jnp.concatenate([new_last, xl_even[n_act:]], axis=0) \
                if n_nodes % 2 else jnp.concatenate(
                    [new_last, xl_odd[n_act:]], axis=0)

    if return_bounds:
        return sels, root, (x_first[0], x_last[0])
    return sels, root


def _root_init(root, S, N):
    """Initial per-step index from the root's single (l*, r*) pair."""
    half = _next_pow2(S) // 2
    l_star, r_star = root
    return jnp.where(jnp.asarray(np.arange(S) < half), l_star[0], r_star[0])


def _level_selection_rows(ts_np, j, sel, N):
    """Identity-padded per-time selection rows for level `j`: row t holds the
    level's L (left side) or R (right side) index map when t's node at that
    level is active, else the identity. The static p/side bit arithmetic
    (p = t >> (j+1), side = (t >> j) & 1, identity row at slot n_act) is the
    single source of truth for both the boundary-ordering composition and the
    final genealogy resolution. Returns None when no row is active."""
    L, R, n_act = sel
    p = ts_np >> (j + 1)
    side = (ts_np >> j) & 1
    act = p < n_act
    if not np.any(act):
        return None
    ident = jnp.arange(N, dtype=L.dtype)[None]
    Lp = jnp.concatenate([L, ident], axis=0)
    Rp = jnp.concatenate([R, ident], axis=0)
    li = np.where(act & (side == 0), p, n_act)
    ri = np.where(act & (side == 1), p, n_act)
    return jnp.where(jnp.asarray(side & act, dtype=bool)[:, None],
                     Rp[ri], Lp[li])


def resolve_genealogy(sels, idx_init, S, N):
    """Top-down resolution idx[t] = s_0(t)[s_1(t)[... [idx_init[t]] ...]] of
    the recorded selections; O(S) work per level."""
    ts = np.arange(S)
    idx = idx_init
    for k in range(len(sels) - 1, -1, -1):
        if sels[k] is None:
            continue
        maps = _level_selection_rows(ts, k, sels[k], N)
        if maps is None:
            continue
        idx = jnp.take_along_axis(maps, idx[:, None], axis=1)[:, 0]
    return idx


def _fused_node_draw(xl, xr, lw_l, lw_r, params_r, node_keys, Gt, N, last,
                     seed=None, pair_offset=0, score_mesh=None,
                     score_axis=None, row_payload=None, col_payload=None):
    """Two-stage factorised draw for one level's nodes — the law of
    `fused_stitching_operator` on boundary rows only. Returns (rows, cols),
    each (n_act, N) (or (n_act, 1) at the root). `seed`/`pair_offset`
    override the stage-2 counter base so a launch over a slice of a level's
    nodes (cross-chip sharding) draws bit-identically to the full launch.
    With `score_mesh`, the O(N^2) block-mass pass is column-sharded over
    `score_mesh[score_axis]` (the root stays replicated — its law uses the
    streaming row-LSE, and it is 1/(T-1) of the tree's score work).

    `row_payload`/`col_payload` (n_act, N, e): per-row/per-column values to
    return gathered by the drawn rows/cols (the stitch tree's boundary
    particle values). Returns (rows, cols, rpay, cpay) when BOTH are given;
    pair 0's payloads are index 0's values."""
    with_payload = row_payload is not None
    assert with_payload == (col_payload is not None)
    def finish(rows, cols):
        if not with_payload:
            return rows, cols
        return (rows, cols, take_rows(row_payload, rows),
                take_rows(col_payload, cols))

    rf, cf, rb, cb = jax.vmap(Gt.pairwise_factors)(xl, xr, params_r)
    rb = rb + lw_l
    cb = cb + lw_r

    blocked = (_use_blocked_stitch(N) or score_mesh is not None) and not last
    mode = _draws_mode() if blocked else None
    if blocked:
        if score_mesh is not None:
            Lb = _sharded_block_masses(score_mesh, score_axis, rf, cf,
                                       cb)                 # (n_act, N, nb)
        else:
            Lb = _stitch.block_masses(rf, cf, cb)          # (n_act, N, nb)
        # The joint draw never needs the row marginals (they are implicit in
        # the flat (row, block) categorical) — skip the full-Lb logsumexp.
        row_logits = None if mode == "joint" else rb + logsumexp(Lb, axis=-1)
    else:
        lse = _stitch.row_lse(rf, cf, cb)                  # (n_act, N)
        row_logits = rb + lse
    key_rows = jax.vmap(lambda k: jax.random.fold_in(k, 0))(node_keys)

    if last:
        u = jax.vmap(lambda k: jax.random.uniform(k, ()))(key_rows)
        row = jax.vmap(categorical_from_uniforms)(row_logits, u[:, None])[:, 0]
        rf_sel = jnp.take_along_axis(rf, row[:, None, None], axis=1)[:, 0]
        s = jnp.einsum("pk,pjk->pj", rf_sel, cf) + cb
        u2 = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), ()))(
            node_keys)
        col = jax.vmap(categorical_from_uniforms)(s, u2[:, None])[:, 0]
        return finish(row[:, None], col[:, None])

    u_rows = jax.vmap(lambda k: jax.random.uniform(k, (N,)))(key_rows)
    if seed is None:
        seed = jax.random.randint(node_keys[0], (), 0,
                                  jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    if blocked and mode == "joint":
        # Draw 0's entries are don't-care because pair 0 is re-pinned to
        # (0, 0) afterwards (payloads re-pinned to index 0's values).
        G = _super_group(N)
        fold = G // _stitch._COL_BLOCK
        if fold > 1:
            # Aggregate per-128-block masses into G-wide supers for stage 1
            # (exact: LSE over each group of `fold` block masses); stage 2
            # resolves the column within the chosen super in one G-wide
            # Gumbel pass.
            P_, N_, nb_ = Lb.shape
            L1 = logsumexp(Lb.reshape(P_, N_, nb_ // fold, fold), axis=-1)
        else:
            L1 = Lb
        if with_payload:
            rows, blocks, rf_sel, rpay = _stitch.joint_rowblock_draws(
                u_rows, rb, L1, row_feat=rf, row_extra=row_payload)
            cols, cpay = _stitch.within_block_cols(
                seed, blocks, rf_sel, cf, cb, pair_offset=pair_offset,
                col_extra=col_payload, group=G)
            return (rows.at[:, 0].set(0), cols.at[:, 0].set(0),
                    rpay.at[:, 0].set(row_payload[:, 0]),
                    cpay.at[:, 0].set(col_payload[:, 0]))
        rows, blocks, rf_sel = _stitch.joint_rowblock_draws(u_rows, rb, L1,
                                                            row_feat=rf)
        cols = _stitch.within_block_cols(seed, blocks, rf_sel, cf, cb,
                                         pair_offset=pair_offset, group=G)
        return rows.at[:, 0].set(0), cols.at[:, 0].set(0)
    rows = categorical_from_uniforms(row_logits, u_rows)
    rows = rows.at[:, 0].set(0)
    rf_sel = take_rows(rf, rows)
    if blocked:
        cols = _stitch.blocked_col_sample(seed, rows, Lb, rf_sel, cf, cb,
                                          pair_offset=pair_offset)
    else:
        cols = _stitch.col_sample(seed, rf_sel, cf, cb, pair_offset)
    cols = cols.at[:, 0].set(0)
    return finish(rows, cols)


def _generic_node_draw(xl, xr, lw_l, lw_r, params_r, node_keys, Gt, N, last):
    """Arbitrary-potential draw: materialise the (n_act, N, N) boundary
    weights via nested vmap (the law of `stitching_operator`, boundary rows
    only)."""
    def log_weight_fn(x_left, x_right, params_t):
        return Gt(x_right, x_left, params_t)

    def one(xl_n, lw_l_n, xr_n, lw_r_n, p_n):
        return stitching_weights(xl_n, lw_l_n, xr_n, lw_r_n, p_n, log_weight_fn)

    w = jax.vmap(one)(xl, lw_l, xr, lw_r, params_r)       # (n_act, N, N)

    if last:
        idx = jax.vmap(
            lambda k, wn: jax.random.choice(k, N * N, p=wn.ravel())
        )(node_keys, w)
        l_idx, r_idx = jnp.unravel_index(idx, (N, N))
        return l_idx[:, None], r_idx[:, None]

    idx = jax.vmap(lambda k, wn: multinomial(k, wn.ravel(), N))(node_keys, w)
    l_idx, r_idx = jax.vmap(jnp.unravel_index, in_axes=(0, None))(idx, (N, N))
    return l_idx.astype(jnp.int32), r_idx.astype(jnp.int32)

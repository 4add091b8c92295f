"""Factorised N^2 stitching for parallel-in-time cSMC (dSMC tree nodes).

Capability: the stitching step of reference
`_primitives/csmc/pit/operator.py:133-149` builds an (N, N) matrix of
boundary weights w_ij = Gt(x_right_j, x_left_i) + log_w_i + log_w_j with a
nested vmap over a user callable, materialising P x N^2 floats per tree
level (32 GB at the BASELINE T=1024, N=4096 config). This module draws from
the same law for *factorisable* potentials without materialising N^2.

Factorised form
---------------
When the boundary potential decomposes over all pairs as

    Gt(x_j, x_i) = row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j]

(exactly the case for Gaussian transition densities — the quadratic
cross-term is a rank-d matmul — with any previous-state-independent
observation potential absorbed into col_bias), the flat N^2 categorical
factorises exactly as P(i, j) = P(i) P(j | i). Two formulations:

  two-pass  `row_lse` gives each row's marginal mass (blocked scores, never
            all N^2 at once); rows are drawn by inverse CDF; `col_sample`
            recomputes the sampled rows' scores and draws the column by
            Gumbel-argmax with a counter-based hash (exact categorical).
  blocked   `block_masses` makes ONE score pass that keeps per-row
            128-column block log-masses; (row, block) pairs are drawn from
            the flat (N * nb) categorical (`joint_rowblock_draws`) and the
            column within the block by Gumbel-argmax over one recomputed
            128-wide slice (`within_block_cols`).

Pair 0 is pinned to (0, 0) by the caller for the conditional
(reference-preserving) version. Every function carries a leading `pairs`
axis so one call serves every node of a tree level.
"""
import os

import jax
import jax.numpy as jnp

from .take import categorical_from_uniforms, take_rows

_ROW_BLOCK = 128
# Finite stand-in for -inf log-masses: far below any real score, yet
# 0 * _NEG_FLOOR = 0 (not NaN), and exp(_NEG_FLOOR - m) underflows to
# exactly 0 for any finite m.
_NEG_FLOOR = -1e30
_COL_BLOCK = 128


def _mix32(h):
    """murmur3 finalizer round (uint32)."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def counter_uniform(seed, pair, block, rows, cols):
    """Counter-based uniform in (0, 1): a double murmur3-finalizer hash of
    (seed, pair, block, row, col). Plain integer ops only, so the draws of
    a node do not depend on how the level is split into calls or over
    devices. Quality is ample for Gumbel-argmax draws (distinct counters,
    two full avalanche rounds)."""
    seed = seed.astype(jnp.uint32)
    h = seed * jnp.uint32(0x9E3779B1)
    h = h ^ (pair.astype(jnp.uint32) * jnp.uint32(0x85EBCA77))
    h = h ^ (block.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D))
    h = _mix32(h ^ (rows.astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)
                    + cols.astype(jnp.uint32) * jnp.uint32(0x165667B1)))
    h = _mix32(h + jnp.uint32(0x9E3779B9))
    # The top-23-bit value fits in int32, so the int32 detour is exact.
    # 23 bits (not 24): every lattice value h23 * 2^-23 + 2^-24 is exactly
    # representable in f32, so the result lies in [2^-24, 1 - 2^-24] with NO
    # rounding. A 24-bit lattice's top value 1 - 2^-25 rounds (ties-to-even)
    # to exactly 1.0, and -log(-log(1.0)) = +inf then makes that element win
    # any Gumbel-argmax draw unconditionally — a silent once-in-2^24 wrong
    # sample (observed: a -inf-weight column drawn through `blocked_col_sample`).
    h23 = (h >> jnp.uint32(9)).astype(jnp.int32)
    return h23.astype(jnp.float32) * (1.0 / (1 << 23)) + jnp.float32(2 ** -24)


def _scores(row_feat, col_feat, col_bias):
    """s[p, i, j] = row_feat[p, i] . col_feat[p, j] + col_bias[p, j], with
    f32 products (never TF32): the scores are log-weights, so their
    absolute error is the error of the law."""
    return jnp.einsum("pik,pjk->pij", row_feat, col_feat,
                      precision=jax.lax.Precision.HIGHEST) \
        + col_bias[:, None, :]


def _gumbel_argmax_scores(s, seed, pair, block):
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    u = counter_uniform(seed, pair, block, rows, cols)
    score = s - jnp.log(-jnp.log(u))
    m = jnp.max(score, axis=1, keepdims=True)
    n_cols = score.shape[1]
    col_ids = jax.lax.broadcasted_iota(jnp.int32, score.shape, 1)
    return jnp.min(jnp.where(score >= m, col_ids, n_cols), axis=1, keepdims=True)


# --------------------------------------------------------------------------
# Single-pass blocked path (large N): one score pass emits per-row
# column-block log-masses; the column draw then needs only an nb-way block
# draw plus one 128-wide within-block pass — no second N^2 sweep and no
# per-element hash/Gumbel over the full row.
# --------------------------------------------------------------------------

def _env_per_block_max():
    """`AUX_SSM_BLOCK_MAX=block` forces the per-block stabiliser on the
    unsharded paths (used by the particle-sharded bit-identity tests);
    default 'row' keeps the cheaper row max on one device."""
    return os.environ.get("AUX_SSM_BLOCK_MAX", "row") == "block"


def block_masses(row_feat, col_feat, col_bias, per_block_max=None):
    """Per-row column-block log-masses of the factorised pairwise scores.

    row_feat (P, Nr, k); col_feat (P, Nc, k); col_bias (P, Nc) ->
    (P, Nr, nb) with nb = Nc // 128 (Nc must be a multiple of 128; Nc may
    differ from Nr — the particle-sharded stitching scores the full row set
    against a local column slice). The full row-LSE is
    `logsumexp(out, axis=-1)`. Rows are scored 128 at a time, so no
    (Nr, Nc) block is ever whole.

    Stabiliser: the row max by default (one reduction). With
    `per_block_max`, the per-block max instead: each block's mass then
    depends only on that block's columns bit-for-bit, which is what makes
    the column-sharded stitching identical across shard counts."""
    P, Nr, k = row_feat.shape
    Nc = col_feat.shape[1]
    assert Nc % _COL_BLOCK == 0, Nc
    if per_block_max is None:
        per_block_max = _env_per_block_max()
    nb = Nc // _COL_BLOCK
    rbs = -(-Nr // _ROW_BLOCK)
    pad_r = rbs * _ROW_BLOCK - Nr
    if pad_r:
        row_feat = jnp.pad(row_feat, ((0, 0), (0, pad_r), (0, 0)))
    rf = row_feat.reshape(P, rbs, _ROW_BLOCK, k).transpose(1, 0, 2, 3)

    def one(rf_blk):
        s = _scores(rf_blk, col_feat, col_bias)
        s4 = s.reshape(P, _ROW_BLOCK, nb, _COL_BLOCK)
        # Per-block max: each block's mass depends only on that block's
        # columns — the invariant the column-sharded stitching relies on.
        m = jnp.max(s4 if per_block_max else s[:, :, None, :], axis=-1,
                    keepdims=True)
        m = jnp.where(jnp.isfinite(m), m, 0.0)   # all--inf block -> -inf
        mass = jnp.sum(jnp.exp(s4 - m), axis=-1)
        return jnp.log(mass) + m[..., 0]         # (P, ROW_BLOCK, nb)

    out = jax.lax.map(one, rf)                   # (rbs, P, ROW_BLOCK, nb)
    return out.transpose(1, 0, 2, 3).reshape(P, rbs * _ROW_BLOCK, nb)[:, :Nr]


def blocked_col_sample(seed, rows, Lb, row_feat_sel, col_feat, col_bias,
                       pair_offset=0):
    """Column draws from the exact conditional categorical using block masses.

    Exact two-stage factorisation P(j | i) = P(block | i) P(j | i, block):
    the block is drawn by inverse CDF over the nb log-masses, the
    within-block column by Gumbel-argmax over one recomputed 128-wide score
    slice — the per-draw work is O(nb + 128), not O(N).

    seed: int32 scalar; rows (P, n) sampled row ids; Lb (P, N, nb) from
    `block_masses`; row_feat_sel (P, n, k); col_feat (P, N, k);
    col_bias (P, N) -> (P, n) int32.
    """
    P, n, k = row_feat_sel.shape
    N = col_feat.shape[1]
    nb = N // _COL_BLOCK
    seed = jnp.asarray(seed, jnp.int32)
    Lb = jnp.maximum(Lb, _NEG_FLOOR)   # -inf (empty block) -> finite floor
    pair_ids = (jnp.arange(P, dtype=jnp.int32)
                + jnp.asarray(pair_offset, jnp.int32))[:, None]   # (P, 1)
    draw_ids = jnp.arange(n, dtype=jnp.int32)[None, :]            # (1, n)

    # Stage 2a: block ~ Cat(exp(Lb[row])). Separate counter stream from the
    # within-block stage via a mixed seed.
    seed_blk = _mix32(seed.astype(jnp.uint32) ^ jnp.uint32(0x5BD1E995))
    u_blk = counter_uniform(seed_blk, pair_ids, jnp.int32(nb), draw_ids,
                            jnp.zeros_like(draw_ids))             # (P, n)
    Lb_sel = jnp.take_along_axis(Lb, rows[:, :, None], axis=1)    # (P, n, nb)
    m = jnp.max(Lb_sel, axis=-1, keepdims=True)
    w = jnp.exp(Lb_sel - m)
    cdf = jnp.cumsum(w, axis=-1)
    target = (u_blk * cdf[..., -1])[..., None]
    blocks = jnp.sum((cdf < target).astype(jnp.int32), axis=-1)
    blocks = jnp.clip(blocks, 0, nb - 1).astype(jnp.int32)        # (P, n)

    return within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias,
                             pair_offset=pair_offset)


def _stage2_mode():
    """Uniform-to-index mapping of the within-group column draw.

    'gumbel' (default): per-lane Gumbel-argmax — one counter hash + two
    logs per recomputed score lane. 'icdf': ONE uniform per draw + inverse
    CDF over the G lanes — the same exact conditional categorical law with
    G-fold fewer transcendentals, at the cost of materialised (P, n, G)
    exp/cumsum passes."""
    return os.environ.get("AUX_SSM_STAGE2", "gumbel")


def within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias,
                      pair_offset=0, col_extra=None, group=_COL_BLOCK):
    """Given each draw's column group, draw the within-group column by
    Gumbel-argmax over the recomputed `group`-wide score slice. Counter
    stream (seed, pair, draw, group_id, j_loc) — identical to the
    within-block stage of `blocked_col_sample` at the default group width
    128.

    blocks (P, n) int32 group ids; row_feat_sel (P, n, k); col_feat
    (P, N, k); col_bias (P, N) -> (P, n) int32 column ids. `group` is the
    column-group width (a multiple of 128): the super-block stage-1 draws
    over (row, 512-column super) and resolves the column here in one
    512-wide pass — see `kernels/pit._fused_node_draw`. With `col_extra`
    (P, N, e), returns (cols, extra_sel (P, n, e)) with
    extra_sel[p, i] = col_extra[p, cols[p, i]].
    """
    P, n, k = row_feat_sel.shape
    N = col_feat.shape[1]
    G = group
    ng = N // G
    seed = jnp.asarray(seed, jnp.int32)
    # The floor keeps -inf biases (indicator potentials, zero weights) out
    # of the Gumbel arithmetic; exp still underflows to exactly 0 there.
    col_bias = jnp.maximum(col_bias, _NEG_FLOOR)
    pair_ids = (jnp.arange(P, dtype=jnp.int32)
                + jnp.asarray(pair_offset, jnp.int32))[:, None]   # (P, 1)
    draw_ids = jnp.arange(n, dtype=jnp.int32)[None, :]            # (1, n)

    # Each draw's column group: (P, n, G, k) features, (P, n, G) biases.
    grp = blocks[:, :, None]
    cf_sel = jnp.take_along_axis(col_feat.reshape(P, ng, G * k), grp,
                                 axis=1).reshape(P, n, G, k)
    cb_sel = jnp.take_along_axis(col_bias.reshape(P, ng, G), grp, axis=1)
    s2 = jnp.einsum("pnk,pnjk->pnj", row_feat_sel, cf_sel,
                    precision=jax.lax.Precision.HIGHEST) + cb_sel
    j_loc = jax.lax.broadcasted_iota(jnp.int32, s2.shape, 2)
    if _stage2_mode() == "icdf":
        # Counter j = G sits outside the Gumbel stream's j_loc range, so the
        # two modes never share a uniform.
        u1 = counter_uniform(seed, pair_ids[..., None], draw_ids[..., None],
                             blocks[:, :, None],
                             jnp.full_like(blocks[:, :, None], G))  # (P, n, 1)
        m2 = jnp.max(s2, axis=-1, keepdims=True)
        cdf = jnp.cumsum(jnp.exp(s2 - m2), axis=-1)
        tgt = u1 * cdf[..., -1:]
        j_star = jnp.clip(jnp.sum((cdf < tgt).astype(jnp.int32), axis=-1),
                          0, G - 1)
    else:
        u_in = counter_uniform(seed, pair_ids[..., None], draw_ids[..., None],
                               blocks[:, :, None], j_loc)         # (P, n, G)
        g = s2 - jnp.log(-jnp.log(u_in))
        j_star = jnp.argmax(g, axis=-1).astype(jnp.int32)
    cols = blocks * G + j_star
    if col_extra is None:
        return cols
    return cols, take_rows(col_extra, cols)


def joint_rowblock_draws(u, row_bias, Lb, row_feat=None, row_extra=None):
    """Joint (row, column-block) draws from P(i, b) ∝ exp(row_bias_i + Lb_ib).

    Because P(i, b) = P(i) P(b | i) with P(i) ∝ exp(row_bias_i + lse_i), one
    flat inverse-CDF draw over the (N * nb) categorical replaces the
    separate row draw *and* the per-draw Lb-row gather of
    `blocked_col_sample`'s block stage.

    u (P, n) uniforms; row_bias (P, N); Lb (P, N, nb) -> (rows, blocks),
    each (P, n) int32; with `row_feat` (P, N, k) also the drawn rows'
    features (P, n, k), and with `row_extra` (P, N, e) their extra values
    (P, n, e).
    """
    P, N, nb = Lb.shape
    # Floor -inf cells (empty blocks / zero-weight rows): exactly-zero mass
    # either way, but a finite floor keeps the max/exp algebra NaN-free.
    flat = jnp.maximum((Lb + row_bias[:, :, None]).reshape(P, N * nb),
                       _NEG_FLOOR)
    idx = categorical_from_uniforms(flat, u)
    rows = (idx // nb).astype(jnp.int32)
    blocks = (idx - rows * nb).astype(jnp.int32)
    if row_feat is None:
        assert row_extra is None
        return rows, blocks
    if row_extra is None:
        return rows, blocks, take_rows(row_feat, rows)
    return rows, blocks, take_rows(row_feat, rows), take_rows(row_extra, rows)


def row_lse(row_feat, col_feat, col_bias, block=512):
    """Per-row logsumexp_j(row_feat_i . col_feat_j + col_bias_j), scored
    `block` rows at a time (never materialises P x N^2).

    row_feat (P, N, k); col_feat (P, N, k); col_bias (P, N) -> (P, N)."""
    P, N, k = row_feat.shape
    nb = -(-N // block)
    pad = nb * block - N
    rf = jnp.pad(row_feat, ((0, 0), (0, pad), (0, 0)))
    rf = rf.reshape(P, nb, block, k).transpose(1, 0, 2, 3)

    def one(rf_blk):
        s = _scores(rf_blk, col_feat, col_bias)
        m = jnp.max(s, axis=-1, keepdims=True)
        return (m + jnp.log(jnp.sum(jnp.exp(s - m), axis=-1, keepdims=True)))[..., 0]

    out = jax.lax.map(one, rf)                       # (nb, P, block)
    return out.transpose(1, 0, 2).reshape(P, nb * block)[:, :N]


def col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset=0):
    """Draw one column per sampled row from the exact conditional
    categorical softmax(row_feat_sel_i . col_feat + col_bias), by
    Gumbel-argmax with counter-based uniforms keyed by (pair, 128-row
    block). `pair_offset` shifts the pair counter, so a call over a slice
    of a level's nodes draws bit-identically to the full call.

    seed (int32 scalar); row_feat_sel (P, n, k); col_feat (P, N, k);
    col_bias (P, N) -> (P, n) int32."""
    P, n, k = row_feat_sel.shape
    nb = -(-n // _ROW_BLOCK)
    pad = nb * _ROW_BLOCK - n
    rf = jnp.pad(row_feat_sel, ((0, 0), (0, pad), (0, 0)))
    rf = rf.reshape(P, nb, _ROW_BLOCK, k)
    pair_ids = jnp.arange(P, dtype=jnp.int32) + jnp.asarray(pair_offset, jnp.int32)
    block_ids = jnp.arange(nb, dtype=jnp.int32)

    def one_block(r, rf_blk):
        # rf_blk: (P, ROW_BLOCK, k)
        s = _scores(rf_blk, col_feat, col_bias)
        idx = jax.vmap(
            lambda s_p, p: _gumbel_argmax_scores(s_p, seed, p, r)
        )(s, pair_ids)
        return idx[..., 0]                           # (P, ROW_BLOCK)

    out = jax.lax.map(lambda args: one_block(args[0], args[1]),
                      (block_ids, rf.transpose(1, 0, 2, 3)))
    return out.transpose(1, 0, 2).reshape(P, nb * _ROW_BLOCK)[:, :n].astype(jnp.int32)

"""Unit tests for the factorised PIT stitching path (`ops/stitching.py`).

Covers, bottom-up:
- pair-factorisation helpers reproduce the dense pairwise Gaussian logpdf
  matrix exactly (diagonal and full-covariance forms);
- `row_lse` and `block_masses` match a dense (f64) logsumexp;
- the column draws follow the exact conditional categorical law, and are
  deterministic in (seed, pair counter) however a level is split;
- every node-draw engine's pair law matches the dense N^2 softmax
  (empirical frequencies over many seeds vs exact joint probabilities).
"""
import chex
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.kernels.csmc_base import (
    diag_gaussian_pair_factors, chol_gaussian_pair_factors,
)
from aux_ssm_tpu.ops import stitching as st


def _dense_scores(rf, cf, cb):
    return rf @ cf.T + cb[None, :]


def test_diag_pair_factors_match_dense():
    rng = np.random.default_rng(0)
    N, d = 7, 3
    mean_prev = jnp.asarray(rng.standard_normal((N, d)))
    x_next = jnp.asarray(rng.standard_normal((N, d)))
    sig = jnp.asarray(rng.uniform(0.5, 1.5, d))

    rf, cf, rb, cb = diag_gaussian_pair_factors(mean_prev, x_next, sig)
    got = rb[:, None] + cb[None, :] + rf @ cf.T

    from jax.scipy.stats import norm
    want = jax.vmap(
        jax.vmap(lambda m, x: jnp.sum(norm.logpdf(x, m, sig)), in_axes=(None, 0)),
        in_axes=(0, None),
    )(mean_prev, x_next)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10)


def test_chol_pair_factors_match_dense():
    rng = np.random.default_rng(1)
    N, d = 6, 3
    mean_prev = jnp.asarray(rng.standard_normal((N, d)))
    x_next = jnp.asarray(rng.standard_normal((N, d)))
    A = rng.standard_normal((d, d))
    chol = jnp.asarray(np.linalg.cholesky(A @ A.T + d * np.eye(d)))

    rf, cf, rb, cb = chol_gaussian_pair_factors(mean_prev, x_next, chol)
    got = rb[:, None] + cb[None, :] + rf @ cf.T

    from aux_ssm_tpu.ops import mvn
    want = jax.vmap(
        jax.vmap(lambda m, x: mvn.logpdf(x, m, chol), in_axes=(None, 0)),
        in_axes=(0, None),
    )(mean_prev, x_next)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9)


@pytest.mark.parametrize("N", [5, 130, 256])
def test_row_lse_xla_matches_dense(N):
    rng = np.random.default_rng(2)
    P, k = 3, 4
    rf = jnp.asarray(rng.standard_normal((P, N, k)))
    cf = jnp.asarray(rng.standard_normal((P, N, k)))
    cb = jnp.asarray(rng.standard_normal((P, N)))

    want = np.stack([
        np.asarray(jax.scipy.special.logsumexp(_dense_scores(rf[p], cf[p], cb[p]), axis=1))
        for p in range(P)
    ])
    got = st.row_lse(rf, cf, cb, block=64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)


def test_row_lse_f32_matches_f64_dense():
    """f32 scores at N=256 against the f64 dense logsumexp: the score
    products run in f32 (not TF32), so the log-masses stay at f32 round-off."""
    rng = np.random.default_rng(3)
    P, N, k = 2, 256, 4
    rf = rng.standard_normal((P, N, k))
    cf = rng.standard_normal((P, N, k))
    cb = rng.standard_normal((P, N))
    want = np.stack([
        np.log(np.exp(_dense_scores(rf[p], cf[p], cb[p])
                      - _dense_scores(rf[p], cf[p], cb[p]).max(1, keepdims=True)
                      ).sum(1))
        + _dense_scores(rf[p], cf[p], cb[p]).max(1) for p in range(P)])
    got = st.row_lse(*(jnp.asarray(z, jnp.float32) for z in (rf, cf, cb)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6, atol=2e-5)


def test_col_sample_pair_offset_matches_full_call():
    """A call over a slice of a level's nodes with `pair_offset` draws
    bit-identically to the same nodes of the full call — the property the
    device-sharded stitching relies on."""
    rng = np.random.default_rng(4)
    P, n, N, k = 4, 128, 256, 3
    rf = jnp.asarray(rng.standard_normal((P, n, k)), dtype=jnp.float32)
    cf = jnp.asarray(rng.standard_normal((P, N, k)), dtype=jnp.float32)
    cb = jnp.asarray(rng.standard_normal((P, N)), dtype=jnp.float32)
    seed = jnp.asarray(1234, dtype=jnp.int32)

    full = np.asarray(st.col_sample(seed, rf, cf, cb))
    part = np.asarray(st.col_sample(seed, rf[2:], cf[2:], cb[2:],
                                    pair_offset=2))
    np.testing.assert_array_equal(part, full[2:])
    assert full.min() >= 0 and full.max() < N


def test_col_sample_law():
    """Empirical frequencies of the Gumbel-argmax column draws must match the
    exact conditional categorical softmax(rf_i . cf + cb)."""
    rng = np.random.default_rng(5)
    N, k = 8, 2
    n_seeds = 4000
    rf = jnp.asarray(rng.standard_normal((1, 1, k)), dtype=jnp.float32)
    cf = jnp.asarray(rng.standard_normal((1, N, k)), dtype=jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), dtype=jnp.float32)

    s = _dense_scores(np.asarray(rf[0]), np.asarray(cf[0]), np.asarray(cb[0]))[0]
    p = np.exp(s - s.max())
    p /= p.sum()

    draw = jax.jit(lambda sd: st.col_sample(sd, rf, cf, cb)[0, 0])
    seeds = jnp.arange(n_seeds, dtype=jnp.int32)
    idx = np.asarray(jax.vmap(draw)(seeds))
    freq = np.bincount(idx, minlength=N) / n_seeds
    # 4000 draws: MC-SE of each frequency <= 0.5/sqrt(4000) ~ 0.008.
    np.testing.assert_allclose(freq, p, atol=4 * 0.008)


@pytest.mark.parametrize("N", [128, 256])
def test_block_masses_xla_matches_dense(N):
    rng = np.random.default_rng(8)
    P, k = 2, 3
    rf = jnp.asarray(rng.standard_normal((P, N, k)), dtype=jnp.float32)
    cf = jnp.asarray(rng.standard_normal((P, N, k)), dtype=jnp.float32)
    cb = jnp.asarray(rng.standard_normal((P, N)), dtype=jnp.float32)

    got = st.block_masses(rf, cf, cb)
    nb = N // 128
    for p in range(P):
        s = _dense_scores(np.asarray(rf[p], np.float64),
                          np.asarray(cf[p], np.float64),
                          np.asarray(cb[p], np.float64))
        want = np.stack([
            np.log(np.exp(s[:, b * 128:(b + 1) * 128]
                          - s.max(1, keepdims=True)).sum(1))
            + s.max(1) for b in range(nb)
        ], axis=1)
        np.testing.assert_allclose(np.asarray(got[p]), want,
                                   rtol=1e-4, atol=1e-5)
    # Row-LSE consistency with the two-pass kernel's law.
    lse = jax.scipy.special.logsumexp(got, axis=-1)
    want_lse = st.row_lse(rf, cf, cb)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


def test_block_masses_per_block_max_matches_row_max():
    """The two stabilisers (row max, per-block max) give the same
    log-masses up to f32 round-off."""
    rng = np.random.default_rng(9)
    P, N, k = 2, 256, 2
    rf = jnp.asarray(rng.standard_normal((P, N, k)), dtype=jnp.float32)
    cf = jnp.asarray(rng.standard_normal((P, N, k)), dtype=jnp.float32)
    cb = jnp.asarray(rng.standard_normal((P, N)), dtype=jnp.float32)

    got = st.block_masses(rf, cf, cb, per_block_max=True)
    want = st.block_masses(rf, cf, cb, per_block_max=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=5e-6, atol=5e-6)


def test_block_masses_suppressed_block_flushes_to_neg_inf():
    """A strongly suppressed column block (every column ~88+ log-units under
    the row max): e = exp(s - m) is f32-subnormal (below ~2^-126 from gap
    ~87.3). Where the arithmetic flushes subnormals (GPU) the block's
    log-mass is exactly -inf; where it keeps them (CPU) it is a tiny finite
    value. Pin the contract both ways: the suppressed block's mass is
    <= -(gap - log(128)) or -inf, the row LSE is unaffected, and blocked
    draws never select the block."""
    N, k = 256, 1
    rf = jnp.ones((1, N, k), jnp.float32)
    cf = jnp.zeros((1, N, k), jnp.float32)

    def masses(gap):
        cb = jnp.concatenate(
            [jnp.zeros((1, 128)), jnp.full((1, 128), -float(gap))],
            axis=1).astype(jnp.float32)
        return st.block_masses(rf, cf, cb), st.row_lse(rf, cf, cb)

    # gap 87: e ~ 1.6e-38 is f32-normal — finite and exact.
    got87, _ = masses(87)
    np.testing.assert_allclose(np.asarray(got87[..., 1]),
                               -87.0 + np.log(128.0), rtol=1e-6)

    # gap 95: e ~ 5.5e-42 is f32-subnormal — -inf or tiny-finite; either
    # carries probability 0.
    got95, lse95 = masses(95)
    assert np.all(np.asarray(got95[..., 1]) <= -88.0)
    np.testing.assert_allclose(np.asarray(got95[..., 0]), np.log(128.0),
                               rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jax.scipy.special.logsumexp(got95, axis=-1)),
        np.asarray(lse95), rtol=5e-6)

    # Downstream joint (row, block) draws never pick that block.
    rb = jnp.zeros((1, N), jnp.float32)
    u = jax.random.uniform(jax.random.key(0), (1, 64))
    _, blocks = st.joint_rowblock_draws(u, rb, got95)
    assert np.all(np.asarray(blocks) == 0)


@pytest.mark.parametrize("stage2", ["icdf", "gumbel"])
def test_blocked_col_sample_law(monkeypatch, stage2):
    """Block-then-within-block draws must follow the exact conditional
    categorical softmax(rf_i . cf + cb) — same law as `col_sample` — under
    BOTH within-group mappings (icdf default, legacy gumbel)."""
    monkeypatch.setenv("AUX_SSM_STAGE2", stage2)
    rng = np.random.default_rng(10)
    N, k = 256, 2
    n_seeds = 4000
    rf = jnp.asarray(rng.standard_normal((1, 1, k)), dtype=jnp.float32)
    cf = jnp.asarray(0.3 * rng.standard_normal((1, N, k)), dtype=jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), dtype=jnp.float32)
    rows = jnp.zeros((1, 1), jnp.int32)
    rf_full = jnp.broadcast_to(rf, (1, N, k))

    s = _dense_scores(np.asarray(rf[0]), np.asarray(cf[0]), np.asarray(cb[0]))[0]
    p = np.exp(s - s.max())
    p /= p.sum()

    Lb = st.block_masses(rf_full, cf, cb)

    draw = jax.jit(lambda sd: st.blocked_col_sample(sd, rows, Lb, rf, cf, cb)[0, 0])
    idx = np.asarray(jax.vmap(draw)(jnp.arange(n_seeds, dtype=jnp.int32)))
    freq = np.bincount(idx, minlength=N) / n_seeds
    # Aggregate into 8 coarse bins to keep per-bin MC-SE meaningful.
    fb = freq.reshape(8, -1).sum(1)
    pb = p.reshape(8, -1).sum(1)
    np.testing.assert_allclose(fb, pb, atol=5 * 0.5 / np.sqrt(n_seeds))


def test_within_group_cols_512_law():
    """`within_block_cols(group=512)` (the within-super column stage of the
    super-aggregated joint draw) must follow the exact conditional
    categorical softmax(rf_row . cf + cb) over the 512 columns of the
    chosen super."""
    rng = np.random.default_rng(40)
    N, k = 512, 2
    rf_row = jnp.asarray(rng.standard_normal((1, 1, k)), jnp.float32)
    cf = jnp.asarray(0.3 * rng.standard_normal((1, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    groups = jnp.zeros((1, 1), jnp.int32)      # single 512-super

    s = _dense_scores(np.asarray(rf_row[0]), np.asarray(cf[0]),
                      np.asarray(cb[0]))[0]
    p = np.exp(s - s.max())
    p /= p.sum()

    draw = jax.jit(lambda sd: st.within_block_cols(
        sd, groups, rf_row, cf, cb, group=512)[0, 0])
    n_seeds = 4000
    idx = np.asarray(jax.vmap(draw)(jnp.arange(n_seeds, dtype=jnp.int32)))
    freq = np.bincount(idx, minlength=N) / n_seeds
    fb = freq.reshape(8, -1).sum(1)
    pb = p.reshape(8, -1).sum(1)
    np.testing.assert_allclose(fb, pb, atol=5 * 0.5 / np.sqrt(n_seeds))


def test_super_node_draw_law_matches_dense_joint(monkeypatch):
    """`_fused_node_draw` with the super-aggregated stage 1 forced
    (AUX_SSM_COL_SUPER=512 at N=512) must follow the same flat N^2 softmax
    law as every other engine."""
    from aux_ssm_tpu.kernels import pit as pit_mod
    from aux_ssm_tpu.kernels.csmc_base import Potential

    monkeypatch.setenv("AUX_SSM_STITCH", "blocked")
    monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", "joint")
    monkeypatch.setenv("AUX_SSM_COL_SUPER", "512")

    rng = np.random.default_rng(41)
    N, d = 512, 1
    sig, phi = 0.9, 0.7

    @chex.dataclass
    class PairGt(Potential):
        prev_dependent = False
        supports_pairwise_factors = True

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(phi * x_left, x_right, sig)

    xl = jnp.asarray(rng.standard_normal((1, N, d)), dtype=jnp.float32)
    xr = jnp.asarray(rng.standard_normal((1, N, d)), dtype=jnp.float32)
    lw = jnp.zeros((1, N), jnp.float32)
    gt = PairGt(params=None)

    rf, cf, rb, cb = diag_gaussian_pair_factors(
        phi * np.asarray(xl[0], np.float64), np.asarray(xr[0], np.float64),
        sig)
    logw = np.asarray(rb)[:, None] + np.asarray(cb)[None, :] \
        + np.asarray(rf @ cf.T)
    pj = np.exp(logw - logw.max())
    pj /= pj.sum()
    pjb = pj.reshape(8, N // 8, 8, N // 8).sum((1, 3))

    def draw(seed):
        keys = jax.random.split(jax.random.key(seed), 1)
        rows, cols = pit_mod._fused_node_draw(
            xl, xr, lw, lw, None, keys, gt, N, False)
        return rows[0, 1], cols[0, 1]

    draw_j = jax.jit(draw)
    n_seeds = 3000
    counts = np.zeros((8, 8))
    for seed in range(n_seeds):
        li, ri = draw_j(seed)
        counts[int(li) * 8 // N, int(ri) * 8 // N] += 1.0
    np.testing.assert_allclose(counts / n_seeds, pjb,
                               atol=5 * 0.5 / np.sqrt(n_seeds))


def test_joint_rowblock_draws_law():
    """`joint_rowblock_draws` must follow P(i, b) ∝ exp(rb_i + Lb_ib)."""
    rng = np.random.default_rng(30)
    N, k = 256, 2
    rf = jnp.asarray(0.4 * rng.standard_normal((1, N, k)), jnp.float32)
    cf = jnp.asarray(0.4 * rng.standard_normal((1, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    rb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    Lb = st.block_masses(rf, cf, cb)                    # (1, N, 2)
    nb = Lb.shape[-1]

    M = np.asarray(Lb[0], np.float64) + np.asarray(rb[0], np.float64)[:, None]
    pj = np.exp(M - M.max())
    pj /= pj.sum()                                           # (N, nb)
    # Coarse row bins x exact block for the frequency check.
    pjb = pj.reshape(8, N // 8, nb).sum(1)                   # (8, nb)

    n_draws = 40_000
    u = jax.random.uniform(jax.random.key(0), (1, n_draws))
    rows, blocks = st.joint_rowblock_draws(u, rb, Lb)
    rows, blocks = np.asarray(rows[0]), np.asarray(blocks[0])
    counts = np.zeros((8, nb))
    np.add.at(counts, (rows * 8 // N, blocks), 1.0)
    np.testing.assert_allclose(counts / n_draws, pjb,
                               atol=5 * 0.5 / np.sqrt(n_draws))


@pytest.mark.parametrize("draws_mode", ["joint", "2pass", "unfused"])
def test_blocked_node_draw_law_matches_dense_joint(monkeypatch, draws_mode):
    """`_fused_node_draw` must follow the flat N^2 softmax law (non-pinned
    slots) whichever engine runs: blocked with the joint or unfused draws,
    or the two-pass row-LSE + column-sample path."""
    from aux_ssm_tpu.kernels import pit as pit_mod
    from aux_ssm_tpu.kernels.csmc_base import Potential

    if draws_mode == "2pass":
        monkeypatch.setenv("AUX_SSM_STITCH", "2pass")
    else:
        monkeypatch.setenv("AUX_SSM_STITCH", "blocked")
        monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", draws_mode)

    rng = np.random.default_rng(11)
    N, d = 128, 1
    sig, phi = 0.9, 0.7

    @chex.dataclass
    class PairGt(Potential):
        prev_dependent = False
        supports_pairwise_factors = True

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(phi * x_left, x_right, sig)

    xl = jnp.asarray(rng.standard_normal((1, N, d)), dtype=jnp.float32)
    xr = jnp.asarray(rng.standard_normal((1, N, d)), dtype=jnp.float32)
    lw = jnp.zeros((1, N), jnp.float32)
    params = jnp.zeros((1,))
    gt = PairGt(params=None)

    rf, cf, rb, cb = diag_gaussian_pair_factors(
        phi * np.asarray(xl[0], np.float64), np.asarray(xr[0], np.float64),
        sig)
    logw = np.asarray(rb)[:, None] + np.asarray(cb)[None, :] \
        + np.asarray(rf @ cf.T)
    pj = np.exp(logw - logw.max())
    pj /= pj.sum()
    # Coarse 8x8 block marginals for the frequency test.
    pjb = pj.reshape(8, N // 8, 8, N // 8).sum((1, 3))

    def draw(seed):
        keys = jax.random.split(jax.random.key(seed), 1)
        rows, cols = pit_mod._fused_node_draw(
            xl, xr, lw, lw, params, keys, gt, N, False)
        return rows[0, 1], cols[0, 1]      # slot 1: first unpinned pair

    draw_j = jax.jit(draw)
    n_seeds = 3000
    counts = np.zeros((8, 8))
    for seed in range(n_seeds):
        li, ri = draw_j(seed)
        counts[int(li) * 8 // N, int(ri) * 8 // N] += 1.0
    np.testing.assert_allclose(counts / n_seeds, pjb,
                               atol=5 * 0.5 / np.sqrt(n_seeds))


def test_fused_operator_law_matches_dense_joint():
    """The fused two-stage draw over one tree node must follow the exact flat
    N^2 softmax of w_ij = rb_i + cb_j + rf_i . cf_j (for non-pinned slots)."""
    from aux_ssm_tpu.kernels.pit import fused_stitching_operator
    from aux_ssm_tpu.kernels.csmc_base import Potential

    rng = np.random.default_rng(6)
    N, d, block = 4, 1, 1
    sig = 0.9
    phi = 0.7

    @chex.dataclass
    class PairGt(Potential):
        prev_dependent = False
        supports_pairwise_factors = True

        def __call__(self, x_next, x_t, params):
            from jax.scipy.stats import norm
            return jnp.sum(norm.logpdf(x_next, phi * x_t, sig), -1)

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(phi * x_left, x_right, sig)

    xl = jnp.asarray(rng.standard_normal((1, block, N, d)))
    xr = jnp.asarray(rng.standard_normal((1, block, N, d)))
    lw_a = jnp.asarray(np.log(rng.uniform(0.5, 1.0, (1, block, N))))
    lw_b = jnp.asarray(np.log(rng.uniform(0.5, 1.0, (1, block, N))))
    orig = jnp.tile(jnp.arange(N), (1, block, 1))
    params = jnp.zeros((1, block))

    # Exact joint law.
    rf, cf, rb, cb = diag_gaussian_pair_factors(
        phi * xl[0, -1], xr[0, 0], sig)
    logw = (rb + np.asarray(lw_a[0, -1]))[:, None] \
        + (cb + np.asarray(lw_b[0, 0]))[None, :] + np.asarray(rf @ cf.T)
    pj = np.exp(logw - logw.max())
    pj /= pj.sum()

    gt = PairGt(params=None)

    counts = np.zeros((N, N))
    n_seeds = 3000
    def draw(seed):
        keys_a = jax.random.split(jax.random.key(seed), block)[None]
        keys_b = jax.random.split(jax.random.key(seed + 10 ** 6), block)[None]
        ia = ((xl, lw_a, orig), keys_a, params)
        ib = ((xr, lw_b, orig), keys_b, params)
        (traj, _, origins), _, _ = fused_stitching_operator(
            ia, ib, gt, N, False)
        # slot 1..N-1 are iid joint draws; read back the chosen indices from
        # the origins bookkeeping.
        return origins[0, 0], origins[0, 1]

    draw_j = jax.jit(draw)
    for seed in range(n_seeds):
        li, ri = draw_j(seed)
        li, ri = np.asarray(li), np.asarray(ri)
        counts[li[1], ri[1]] += 1.0  # slot 1: first unpinned iid pair

    freq = counts / n_seeds
    np.testing.assert_allclose(freq, pj, atol=5 * 0.5 / np.sqrt(n_seeds))


def test_fused_operator_pins_reference_pair():
    """Slot 0 must always select pair (0, 0) — the conditional property that
    keeps the reference trajectory alive."""
    from aux_ssm_tpu.kernels.pit import fused_stitching_operator
    from aux_ssm_tpu.kernels.csmc_base import Potential

    rng = np.random.default_rng(7)
    N, d, block = 6, 2, 2

    @chex.dataclass
    class PairGt(Potential):
        prev_dependent = False
        supports_pairwise_factors = True

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(x_left, x_right, 1.0)

    xl = jnp.asarray(rng.standard_normal((1, block, N, d)))
    xr = jnp.asarray(rng.standard_normal((1, block, N, d)))
    lw = jnp.full((1, block, N), -np.log(N))
    orig = jnp.tile(jnp.arange(N), (1, block, 1))
    params = jnp.zeros((1, block))
    gt = PairGt(params=None)

    for seed in range(10):
        keys_a = jax.random.split(jax.random.key(seed), block)[None]
        keys_b = jax.random.split(jax.random.key(seed + 99), block)[None]
        ia = ((xl, lw, orig), keys_a, params)
        ib = ((xr, lw, orig), keys_b, params)
        (_, _, origins), _, _ = fused_stitching_operator(
            ia, ib, gt, N, False)
        assert int(origins[0, 0, 0]) == 0 and int(origins[0, block, 0]) == 0


# --------------------------------------------------------------------------
# Blocked draws: edge shapes, stage laws, split invariance
# --------------------------------------------------------------------------

def _draws_inputs(N, k, P=2, seed=20):
    rng = np.random.default_rng(seed)
    rf = jnp.asarray(0.4 * rng.standard_normal((P, N, k)), jnp.float32)
    cf = jnp.asarray(0.4 * rng.standard_normal((P, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((P, N)), jnp.float32)
    rb = jnp.asarray(rng.standard_normal((P, N)), jnp.float32)
    Lb = st.block_masses(rf, cf, cb)
    return rf, cf, cb, rb, Lb


def test_node_draws_split_over_pairs_match_full_call(monkeypatch):
    """`_fused_node_draw` over a slice of a level's nodes, given the full
    call's seed and the slice's pair offset, draws bit-identically to the
    full call — how the time-sharded tree splits a level across devices."""
    from aux_ssm_tpu.kernels import pit as pit_mod
    from aux_ssm_tpu.kernels.csmc_base import Potential

    monkeypatch.setenv("AUX_SSM_STITCH", "blocked")

    @chex.dataclass
    class PairGt(Potential):
        supports_pairwise_factors = True

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(0.7 * x_left, x_right, 0.9)

    rng = np.random.default_rng(12)
    P, N = 4, 256
    xl = jnp.asarray(rng.standard_normal((P, N, 1)), jnp.float32)
    xr = jnp.asarray(rng.standard_normal((P, N, 1)), jnp.float32)
    lw = jnp.zeros((P, N), jnp.float32)
    keys = jax.random.split(jax.random.key(3), P)
    seed = jnp.int32(77)
    gt = PairGt(params=None)
    full = pit_mod._fused_node_draw(xl, xr, lw, lw, None, keys, gt, N, False,
                                    seed=seed)
    part = pit_mod._fused_node_draw(xl[2:], xr[2:], lw[2:], lw[2:], None,
                                    keys[2:], gt, N, False, seed=seed,
                                    pair_offset=2)
    for f, q in zip(full, part):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(f)[2:])


def test_blocked_draws_nb1_edge():
    """N = 128 (a single column block): every block draw is block 0 and
    the columns are valid, for the joint and the unfused draws."""
    N, k = 128, 1
    rf, cf, cb, rb, Lb = _draws_inputs(N, k, seed=21)
    assert Lb.shape == (2, N, 1)
    u = jax.random.uniform(jax.random.key(5), (2, N))
    rows, blocks, rf_sel = st.joint_rowblock_draws(u, rb, Lb, row_feat=rf)
    cols = st.within_block_cols(jnp.int32(5), blocks, rf_sel, cf, cb)
    assert np.all(np.asarray(blocks) == 0)
    cols_u = st.blocked_col_sample(jnp.int32(5), rows, Lb, rf_sel, cf, cb)
    for c in (cols, cols_u):
        c = np.asarray(c)
        assert c.min() >= 0 and c.max() < N


def test_joint_draw_rows_law():
    """The rows of the joint (row, block) draw follow the row marginal
    Cat(softmax(rb + logsumexp_b Lb))."""
    N, k = 256, 1
    rf, cf, cb, rb, Lb = _draws_inputs(N, k, P=1, seed=22)
    p = np.asarray(jax.nn.softmax(rb[0] + jax.scipy.special.logsumexp(
        Lb[0], axis=-1)))
    n_draws = 40_000
    u = jax.random.uniform(jax.random.key(0), (1, n_draws))
    rows, _ = st.joint_rowblock_draws(u, rb, Lb)
    freq = np.bincount(np.asarray(rows[0]), minlength=N) / n_draws
    np.testing.assert_allclose(freq.reshape(8, -1).sum(1),
                               p.reshape(8, -1).sum(1),
                               atol=5 * 0.5 / np.sqrt(n_draws))


def test_within_block_cols_law_matches_conditional():
    """Given a pinned row and its block, the 128-wide within-block column
    draw follows softmax(rf_row . cf + cb) restricted to that block."""
    N, k = 256, 2
    rng = np.random.default_rng(23)
    rf_row = jnp.asarray(rng.standard_normal((1, 1, k)), jnp.float32)
    cf = jnp.asarray(0.3 * rng.standard_normal((1, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    blocks = jnp.ones((1, 1), jnp.int32)               # columns 128..255

    s = _dense_scores(np.asarray(rf_row[0]), np.asarray(cf[0]),
                      np.asarray(cb[0]))[0][128:]
    p = np.exp(s - s.max())
    p /= p.sum()
    draw = jax.jit(lambda sd: st.within_block_cols(
        sd, blocks, rf_row, cf, cb)[0, 0])
    n_seeds = 4000
    cols = np.asarray(jax.vmap(draw)(jnp.arange(n_seeds, dtype=jnp.int32)))
    assert cols.min() >= 128
    freq = np.bincount(cols - 128, minlength=128) / n_seeds
    np.testing.assert_allclose(freq.reshape(8, -1).sum(1),
                               p.reshape(8, -1).sum(1),
                               atol=5 * 0.5 / np.sqrt(n_seeds))


def test_blocked_paths_tolerate_neg_inf_biases():
    """-inf column/row biases (indicator potentials, zero log-weights) must
    not NaN-poison the blocked draw paths: the one-hot payload matmuls see a
    finite floor, excluded columns are never drawn, and the law over the
    remaining columns is untouched. Regression: before the clamp, any -inf
    in cb made `within_block_cols`' selection matmul emit NaN scores."""
    rng = np.random.default_rng(77)
    N, k, n = 256, 2, 64
    rf = jnp.asarray(0.3 * rng.standard_normal((1, N, k)), jnp.float32)
    cf = jnp.asarray(0.3 * rng.standard_normal((1, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    # Kill a scattered set of columns AND one whole 128-column block, so Lb
    # itself contains a -inf block mass.
    dead = np.zeros(N, bool)
    dead[5] = dead[17] = dead[99] = True
    dead[128:] = True
    cb = cb.at[0, jnp.asarray(np.flatnonzero(dead))].set(-jnp.inf)
    rb = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)

    Lb = st.block_masses(rf, cf, cb)
    assert bool(jnp.isinf(Lb[0, 0, 1]))          # whole block 1 is empty

    # joint (row, block) draw + within-block columns — the default large-N
    # path (kernels/pit.py mode 'joint').
    u = jax.random.uniform(jax.random.key(0), (1, n))
    rows, blocks, rf_sel = st.joint_rowblock_draws(u, rb, Lb, row_feat=rf)
    cols_joint = st.within_block_cols(jnp.int32(3), blocks, rf_sel, cf, cb)
    assert np.all(np.asarray(blocks) == 0)
    assert not np.any(dead[np.asarray(cols_joint).ravel()])
    assert np.all(np.isfinite(np.asarray(rf_sel)))

    # unfused path: independent row draw + blocked_col_sample.
    rows_u = jnp.asarray(rng.integers(0, N, (1, n)), jnp.int32)
    rf_row = jnp.take_along_axis(rf, rows_u[:, :, None], axis=1)
    cols_b = st.blocked_col_sample(jnp.int32(5), rows_u, Lb, rf_row, cf, cb)
    assert not np.any(dead[np.asarray(cols_b).ravel()])

    # Law on the live columns is unchanged by the clamp: compare frequencies
    # against a dense softmax with the dead columns removed.
    rf1 = jnp.broadcast_to(rf[:, 0:1], (1, N, k))
    Lb1 = st.block_masses(rf1, cf, cb)
    draw = jax.jit(lambda sd: st.blocked_col_sample(
        sd, jnp.zeros((1, 1), jnp.int32), Lb1, rf1[:, 0:1], cf, cb)[0, 0])
    n_seeds = 4000
    idx = np.asarray(jax.vmap(draw)(jnp.arange(n_seeds, dtype=jnp.int32)))
    assert not np.any(dead[idx])
    s = _dense_scores(np.asarray(rf1[0, 0:1]), np.asarray(cf[0]),
                      np.nan_to_num(np.asarray(cb[0]), neginf=-1e30))[0]
    p = np.exp(s - s.max())
    p /= p.sum()
    freq = np.bincount(idx, minlength=N) / n_seeds
    fb = freq[:128].reshape(8, -1).sum(1)
    pb = p[:128].reshape(8, -1).sum(1)
    np.testing.assert_allclose(fb, pb, atol=5 * 0.5 / np.sqrt(n_seeds))


@pytest.mark.parametrize("e", [1, 2])
def test_payload_riding_matches_take_rows(e):
    """`joint_rowblock_draws(row_extra=...)` / `within_block_cols(col_extra=
    ...)` must return exactly take_along_axis(extra, rows/cols) — the
    boundary values the stitch tree carries — without changing the draws
    themselves."""
    rng = np.random.default_rng(5)
    P, N, k, n = 2, 2048, 1, 256
    rf = jnp.asarray(0.3 * rng.standard_normal((P, N, k)), jnp.float32)
    cf = jnp.asarray(0.3 * rng.standard_normal((P, N, k)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((P, N)), jnp.float32)
    rb = jnp.asarray(rng.standard_normal((P, N)), jnp.float32)
    rex = jnp.asarray(rng.standard_normal((P, N, e)), jnp.float32)
    cex = jnp.asarray(rng.standard_normal((P, N, e)), jnp.float32)
    Lb = st.block_masses(rf, cf, cb)
    u = jax.random.uniform(jax.random.key(1), (P, n))

    base = jax.jit(lambda: st.joint_rowblock_draws(u, rb, Lb, row_feat=rf))()
    rows0, blocks0, rf_sel0 = base
    rows, blocks, rf_sel, rpay = jax.jit(lambda: st.joint_rowblock_draws(
        u, rb, Lb, row_feat=rf, row_extra=rex))()
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(rows0))
    np.testing.assert_array_equal(np.asarray(blocks), np.asarray(blocks0))
    np.testing.assert_array_equal(np.asarray(rf_sel), np.asarray(rf_sel0))
    want_r = np.take_along_axis(np.asarray(rex),
                                np.asarray(rows)[:, :, None], axis=1)
    np.testing.assert_array_equal(np.asarray(rpay), want_r)

    cols0 = jax.jit(lambda: st.within_block_cols(
        jnp.int32(7), blocks, rf_sel, cf, cb))()
    cols, cpay = jax.jit(lambda: st.within_block_cols(
        jnp.int32(7), blocks, rf_sel, cf, cb, col_extra=cex))()
    np.testing.assert_array_equal(np.asarray(cols), np.asarray(cols0))
    want_c = np.take_along_axis(np.asarray(cex),
                                np.asarray(cols)[:, :, None], axis=1)
    np.testing.assert_array_equal(np.asarray(cpay), want_c)


def test_node_draw_payload_pinning(monkeypatch):
    """`_fused_node_draw` with payloads re-pins slot 0's values to index 0
    on every engine (joint rides the matmuls; fused/unfused take_rows)."""
    from aux_ssm_tpu.kernels import pit as pit_mod
    from aux_ssm_tpu.kernels.csmc_base import Potential

    monkeypatch.setenv("AUX_SSM_STITCH", "blocked")
    rng = np.random.default_rng(3)
    N, d = 128, 1
    sig, phi = 0.9, 0.7

    @chex.dataclass
    class PairGt(Potential):
        prev_dependent = False
        supports_pairwise_factors = True

        def pairwise_factors(self, x_left, x_right, params):
            return diag_gaussian_pair_factors(phi * x_left, x_right, sig)

    xl = jnp.asarray(rng.standard_normal((2, N, d)), dtype=jnp.float32)
    xr = jnp.asarray(rng.standard_normal((2, N, d)), dtype=jnp.float32)
    lw = jnp.zeros((2, N), jnp.float32)
    keys = jax.random.split(jax.random.key(0), 2)
    gt = PairGt(params=None)
    rex = jnp.asarray(rng.standard_normal((2, N, d)), jnp.float32)
    cex = jnp.asarray(rng.standard_normal((2, N, d)), jnp.float32)

    for mode in ["joint", "unfused"]:
        monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", mode)
        rows0, cols0 = jax.jit(lambda: pit_mod._fused_node_draw(
            xl, xr, lw, lw, None, keys, gt, N, False))()
        rows, cols, rpay, cpay = jax.jit(lambda: pit_mod._fused_node_draw(
            xl, xr, lw, lw, None, keys, gt, N, False,
            row_payload=rex, col_payload=cex))()
        np.testing.assert_array_equal(np.asarray(rows), np.asarray(rows0)), mode
        np.testing.assert_array_equal(np.asarray(cols), np.asarray(cols0)), mode
        want_r = np.take_along_axis(np.asarray(rex),
                                    np.asarray(rows)[:, :, None], axis=1)
        want_c = np.take_along_axis(np.asarray(cex),
                                    np.asarray(cols)[:, :, None], axis=1)
        np.testing.assert_array_equal(np.asarray(rpay), want_r), mode
        np.testing.assert_array_equal(np.asarray(cpay), want_c), mode
        assert np.all(np.asarray(rows)[:, 0] == 0)
        np.testing.assert_array_equal(np.asarray(rpay)[:, 0],
                                      np.asarray(rex)[:, 0])
        np.testing.assert_array_equal(np.asarray(cpay)[:, 0],
                                      np.asarray(cex)[:, 0])

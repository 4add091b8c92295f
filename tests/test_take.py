"""Gather and inverse-CDF draw primitives (`ops/take.py`) against NumPy:
fancy indexing for `take_rows`, a float64 cumulative-sum + searchsorted
inverse CDF and the softmax law for `categorical_from_uniforms`."""
import numpy as np
import jax.numpy as jnp

from aux_ssm_tpu.ops import take as tk


def _np_inverse_cdf(logits, u):
    """Float64 inverse CDF, row by row."""
    logits, u = np.asarray(logits, np.float64), np.asarray(u, np.float64)
    lead = logits.shape[:-1]
    out = np.empty(u.shape, np.int64)
    for i in np.ndindex(*lead):
        w = np.exp(logits[i] - logits[i].max())
        cdf = np.cumsum(w)
        out[i] = np.clip(np.searchsorted(cdf, u[i] * cdf[-1]), 0, len(w) - 1)
    return out


def test_take_rows_scalar_valued_exact():
    rng = np.random.default_rng(0)
    P, N, n = 3, 256, 100
    vals = rng.standard_normal((P, N)).astype(np.float32)
    idx = rng.integers(0, N, (P, n))
    got = tk.take_rows(jnp.asarray(vals), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  vals[np.arange(P)[:, None], idx])


def test_take_rows_vector_valued_exact():
    rng = np.random.default_rng(1)
    P, N, n, d = 2, 384, 50, 3
    vals = rng.standard_normal((P, N, d)).astype(np.float32)
    idx = rng.integers(0, N, (P, n))
    got = tk.take_rows(jnp.asarray(vals), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  vals[np.arange(P)[:, None], idx])


def test_take_rows_int_dtype():
    rng = np.random.default_rng(2)
    P, N = 4, 128
    vals = rng.integers(0, 1000, (P, N)).astype(np.int32)
    idx = rng.integers(0, N, (P, N))
    got = tk.take_rows(jnp.asarray(vals), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  vals[np.arange(P)[:, None], idx])


def test_take_rows_large_int_values_exact():
    """int32 payloads with values past 2^24 (not exactly representable in
    f32) come through exactly."""
    rng = np.random.default_rng(9)
    P, N = 2, 128
    vals = rng.integers(2 ** 24, 2 ** 30, (P, N)).astype(np.int32)
    vals[0, 0] = 16_777_217
    idx = rng.integers(0, N, (P, N))
    idx[0, 0] = 0
    got = tk.take_rows(jnp.asarray(vals), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  vals[np.arange(P)[:, None], idx])
    assert int(got[0, 0]) == 16_777_217


def test_take_rows_unbatched_any_n():
    """No batch axis and an N that is no multiple of anything."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((100, 2)).astype(np.float32)
    idx = rng.integers(0, 100, (10,))
    got = tk.take_rows(jnp.asarray(vals), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got), vals[idx])


def test_categorical_matches_f64_inverse_cdf():
    """Same draws as a float64 inverse CDF on the same uniforms; the f32
    CDF can flip a draw only on a boundary, which random logits ~never
    hit."""
    rng = np.random.default_rng(4)
    P, N, n = 5, 512, 300
    logits = rng.standard_normal((P, N)).astype(np.float32)
    u = rng.uniform(size=(P, n)).astype(np.float32)
    got = tk.categorical_from_uniforms(jnp.asarray(logits), jnp.asarray(u))
    assert float((np.asarray(got) == _np_inverse_cdf(logits, u)).mean()) > 0.999


def test_categorical_law():
    """Empirical frequencies match softmax probabilities."""
    rng = np.random.default_rng(5)
    N, n = 128, 200_000
    logits = jnp.asarray(rng.standard_normal(N), jnp.float32)
    u = jnp.asarray(rng.uniform(size=(n,)), jnp.float32)
    idx = np.asarray(tk.categorical_from_uniforms(logits, u))
    p = np.exp(np.asarray(logits) - np.asarray(logits).max())
    p /= p.sum()
    freq = np.bincount(idx, minlength=N) / n
    np.testing.assert_allclose(freq.reshape(8, -1).sum(1),
                               p.reshape(8, -1).sum(1),
                               atol=5 * 0.5 / np.sqrt(n))


def test_categorical_large_n_matches_f64_inverse_cdf():
    """The flat (row, block) categorical of the PIT joint draw is this
    large (N * N/128 cells); the f32 CDF still places draws like f64."""
    rng = np.random.default_rng(6)
    P, N, n = 2, 128 * 128 * 2, 500
    logits = rng.standard_normal((P, N)).astype(np.float32)
    u = rng.uniform(size=(P, n)).astype(np.float32)
    got = tk.categorical_from_uniforms(jnp.asarray(logits), jnp.asarray(u))
    assert float((np.asarray(got) == _np_inverse_cdf(logits, u)).mean()) > 0.995


def test_categorical_zero_mass_entries_never_drawn():
    """Entries at the finite floor used for -inf masses carry exactly zero
    probability, even for u at the ends of (0, 1)."""
    rng = np.random.default_rng(7)
    N = 128 * 130
    logits = rng.standard_normal((N,)).astype(np.float32)
    dead = rng.uniform(size=N) < 0.3
    dead[-1] = True
    logits[dead] = -1e30
    u = jnp.asarray(np.concatenate([[1e-7, 0.5, 1.0 - 1e-7],
                                    rng.uniform(size=997)]), jnp.float32)
    idx = np.asarray(tk.categorical_from_uniforms(jnp.asarray(logits), u))
    assert (idx >= 0).all() and (idx < N).all()
    assert not dead[idx].any()


def test_categorical_large_n_law():
    """Empirical coarse-bin frequencies match softmax over N = 3 * 128^2."""
    rng = np.random.default_rng(8)
    N, n = 128 * 128 * 3, 100_000
    logits = jnp.asarray(rng.standard_normal(N), jnp.float32)
    u = jnp.asarray(rng.uniform(size=(n,)), jnp.float32)
    idx = np.asarray(tk.categorical_from_uniforms(logits, u))
    p = np.exp(np.asarray(logits, np.float64))
    p /= p.sum()
    freq = np.bincount(idx, minlength=N) / n
    np.testing.assert_allclose(freq.reshape(8, -1).sum(1),
                               p.reshape(8, -1).sum(1),
                               atol=5 * 0.5 / np.sqrt(n))


def test_categorical_1d():
    logits = jnp.asarray(np.log([0.1, 0.2, 0.3, 0.4] * 32), jnp.float32)
    u = jnp.asarray([0.0001, 0.5, 0.9999], jnp.float32)
    idx = tk.categorical_from_uniforms(logits, u)
    assert idx.shape == (3,)
    assert int(idx[0]) == 0 and int(idx[2]) == 127


def test_categorical_batched_leading_dims():
    """Arbitrary leading batch dims: each row draws from its own logits."""
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((2, 3, 64)).astype(np.float32)
    u = rng.uniform(size=(2, 3, 40)).astype(np.float32)
    got = np.asarray(tk.categorical_from_uniforms(jnp.asarray(logits),
                                                  jnp.asarray(u)))
    assert got.shape == (2, 3, 40)
    assert float((got == _np_inverse_cdf(logits, u)).mean()) > 0.999

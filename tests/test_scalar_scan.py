"""The batched scalar layout ((T, B, 1, 1): B independent 1-D models, e.g.
the spatial grid) against a per-component NumPy scalar Kalman filter and a
loop composition of scalar affine maps; and the scalar fast paths of the
combine operators against the generic matrix algebra."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.ops.filtering import filtering_operator
from aux_ssm_tpu.ops.lgssm import LGSSM
from aux_ssm_tpu.ops.sampling import sampling_operator

F = importlib.import_module("aux_ssm_tpu.ops.filtering")


def _rand_filter_elems(rng, T, B):
    A = jnp.asarray(rng.uniform(0.5, 1.0, (T, B)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((T, B)), jnp.float32)
    C = jnp.asarray(rng.uniform(0.1, 1.0, (T, B)), jnp.float32)
    e = jnp.asarray(rng.standard_normal((T, B)), jnp.float32)
    J = jnp.asarray(rng.uniform(0.0, 0.5, (T, B)), jnp.float32)
    return A, b, C, e, J


def _as_mat(elems):
    A, b, C, e, J = elems
    return (A[..., None, None], b[..., None], C[..., None, None],
            e[..., None], J[..., None, None])


def _scalar_model(rng, T, B, nan_frac=0.1):
    """B independent scalar LGSSMs (per-component parameters) and data."""
    m0 = rng.standard_normal(B)
    p0 = rng.uniform(0.5, 2.0, B)
    f = rng.uniform(-0.95, 0.95, (T - 1, B))
    q = rng.uniform(0.1, 1.0, (T - 1, B))
    b = 0.1 * rng.standard_normal((T - 1, B))
    h = rng.uniform(0.5, 1.5, (T, B))
    r = rng.uniform(0.2, 1.0, (T, B))
    c = 0.1 * rng.standard_normal((T, B))
    ys = rng.standard_normal((T, B))
    ys[rng.uniform(size=(T, B)) < nan_frac] = np.nan
    return (m0, p0, f, q, b, h, r, c), ys


def _np_scalar_filter(ys, m0, p0, f, q, b, h, r, c):
    """Per-component scalar Kalman filter, vectorised over B; NaN
    observations skip the update."""
    T, B = ys.shape
    ms, Ps = np.zeros((T, B)), np.zeros((T, B))
    m, P = m0.copy(), p0.copy()
    ell = 0.0
    for t in range(T):
        if t > 0:
            m = f[t - 1] * m + b[t - 1]
            P = f[t - 1] ** 2 * P + q[t - 1]
        obs = np.isfinite(ys[t])
        S = h[t] ** 2 * P + r[t]
        innov = np.where(obs, ys[t] - h[t] * m - c[t], 0.0)
        K = np.where(obs, P * h[t] / S, 0.0)
        m = m + K * innov
        P = P - K * S * K
        ell += np.sum(np.where(
            obs, -0.5 * (innov ** 2 / S + np.log(S) + np.log(2 * np.pi)), 0.0))
        ms[t], Ps[t] = m, P
    return ms, Ps, ell


def _as_lgssm(m0, p0, f, q, b, h, r, c):
    col = lambda z: jnp.asarray(z)[..., None]
    mat = lambda z: jnp.asarray(z)[..., None, None]
    return LGSSM(col(m0), mat(p0), mat(f), mat(q), col(b), mat(h), mat(r),
                 col(c))


@pytest.mark.parametrize("T,B", [(64, 16), (100, 36), (1024, 64), (513, 130)])
def test_batched_scalar_parallel_filter_matches_numpy(T, B):
    rng = np.random.default_rng(T + B)
    params, ys = _scalar_model(rng, T, B)
    ms, Ps, ell = F.filtering(jnp.asarray(ys)[..., None], _as_lgssm(*params),
                              parallel=True)
    want_m, want_P, want_ell = _np_scalar_filter(ys, *params)
    np.testing.assert_allclose(np.asarray(ms)[..., 0], want_m, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(Ps)[..., 0, 0], want_P, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(float(ell), want_ell, rtol=1e-10)


@pytest.mark.parametrize("T,B", [(64, 16), (100, 36), (513, 130)])
@pytest.mark.parametrize("reverse", [False, True])
def test_batched_scalar_affine_scan_matches_loop(T, B, reverse):
    rng = np.random.default_rng(3 * T + B)
    g = rng.uniform(-0.9, 0.9, (T, B))
    e = rng.standard_normal((T, B))
    og, oe = jax.lax.associative_scan(
        sampling_operator, (jnp.asarray(g)[..., None, None],
                            jnp.asarray(e)[..., None]), reverse=reverse)
    want_g, want_e = np.zeros_like(g), np.zeros_like(e)
    acc_g, acc_e = np.ones(B), np.zeros(B)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        acc_g, acc_e = g[t] * acc_g, g[t] * acc_e + e[t]
        want_g[t], want_e[t] = acc_g, acc_e
    np.testing.assert_allclose(np.asarray(og)[..., 0, 0], want_g, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(oe)[..., 0], want_e, rtol=1e-9,
                               atol=1e-12)


def test_scalar_operator_fast_path_matches_generic():
    """The dx==1 elementwise branch must agree with the generic matrix
    algebra (run by building 1x1 elements and comparing against a 2x2
    block-diagonal embedding collapsed back to scalars)."""
    rng = np.random.default_rng(0)
    T, B = 17, 5
    e1 = _as_mat(_rand_filter_elems(rng, T, B))
    e2 = _as_mat(_rand_filter_elems(rng, T, B))

    got = filtering_operator(e1, e2)

    def embed(z):
        if z.shape[-1] == 1 and z.ndim >= 2 and z.shape[-2] == 1:
            out = jnp.zeros(z.shape[:-2] + (2, 2), z.dtype)
            out = out.at[..., 0, 0].set(z[..., 0, 0])
            out = out.at[..., 1, 1].set(z[..., 0, 0])
            return out
        out = jnp.zeros(z.shape[:-1] + (2,), z.dtype)
        return out.at[..., 0].set(z[..., 0])

    big = filtering_operator(tuple(map(embed, e1)), tuple(map(embed, e2)))
    for g, w in zip(got, big):
        if g.shape[-1] == 1 and g.ndim >= 2 and g.shape[-2] == 1:
            np.testing.assert_allclose(np.asarray(g[..., 0, 0]),
                                       np.asarray(w[..., 0, 0]), rtol=1e-5)
        else:
            np.testing.assert_allclose(np.asarray(g[..., 0]),
                                       np.asarray(w[..., 0]), rtol=1e-5)


def test_batched_scalar_sequential_filter_matches_numpy():
    """The sequential scan on the same layout, on small and odd shapes."""
    rng = np.random.default_rng(7)
    for (T, B) in [(30, 5), (100, 36), (513, 130)]:
        params, ys = _scalar_model(rng, T, B, nan_frac=0.2)
        ms, Ps, ell = F.filtering(jnp.asarray(ys)[..., None],
                                  _as_lgssm(*params), parallel=False)
        want_m, want_P, want_ell = _np_scalar_filter(ys, *params)
        np.testing.assert_allclose(np.asarray(ms)[..., 0], want_m,
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(Ps)[..., 0, 0], want_P,
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(ell), want_ell, rtol=1e-10)

"""Rare-event model: the closed-form conditional moments make this an exact
oracle for all three sampler styles (reference experiment.py:228-233)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.models import rare_event as re_model

Y, RHO, R2, T = 5.0, 0.8, 0.5, 2


def _run(kernel, state, delta, n_iter, seed=0):
    def body(st, k):
        st = kernel(k, st, delta)
        return st, st.x

    keys = jax.random.split(jax.random.key(seed), n_iter)
    _, xs = jax.lax.scan(jax.jit(body), state, keys)
    return np.asarray(xs)


def test_conditional_moments_match_lgssm_oracle():
    """The closed form must agree with the generic Kalman machinery."""
    from aux_ssm_tpu.ops.lgssm import LGSSM
    from aux_ssm_tpu.ops.filtering import filtering
    from oracles import explicit_smoother

    (m0c, v0c), (mTc, vTc) = re_model.conditional_moments(Y, RHO, R2, T)

    m0 = np.zeros(1); P0 = np.eye(1)
    Fs = RHO * np.ones((T - 1, 1, 1)); Qs = (1 - RHO ** 2) * np.ones((T - 1, 1, 1))
    bs = np.zeros((T - 1, 1))
    Hs = np.zeros((T, 1, 1)); Hs[-1] = 1.0
    Rs = R2 * np.ones((T, 1, 1)); cs = np.zeros((T, 1))
    ys = np.full((T, 1), np.nan); ys[-1] = Y

    lg = LGSSM(*map(jnp.asarray, (m0, P0, Fs, Qs, bs, Hs, Rs, cs)))
    ms, Ps, _ = filtering(jnp.asarray(ys), lg, False)
    msm, Psm = explicit_smoother(np.asarray(ms), np.asarray(Ps), Fs, Qs, bs)

    np.testing.assert_allclose(msm[-1, 0], mTc, rtol=1e-9)
    np.testing.assert_allclose(Psm[-1, 0, 0], vTc, rtol=1e-9)
    np.testing.assert_allclose(msm[0, 0], m0c, rtol=1e-9)
    np.testing.assert_allclose(Psm[0, 0, 0], v0c, rtol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("style", ["kalman", "kalman-grad", "csmc", "csmc-guided"])
def test_posterior_moments(style):
    n_iter = 30_000
    x0 = re_model.init_x(jax.random.key(1), Y, RHO, R2, T)

    if style in ("kalman", "kalman-grad"):
        init, kernel = re_model.get_kalman_kernel(Y, RHO, R2, T, parallel=True,
                                                  gradient="grad" in style)
        delta = 1.0
    elif style == "csmc":
        init, kernel = re_model.get_csmc_kernel(Y, RHO, R2, T, 32, backward=True)
        delta = jnp.full((T,), 1.0)
    else:
        init, kernel = re_model.get_guided_csmc_kernel(Y, RHO, R2, T, 32, backward=True)
        delta = jnp.full((T,), 2.0)

    xs = _run(kernel, init(x0), delta, n_iter)[n_iter // 5:]

    (m0c, v0c), (mTc, vTc) = re_model.conditional_moments(Y, RHO, R2, T)

    # MCSE-scaled tolerance with a conservative autocorrelation factor.
    tol0 = 6 * np.sqrt(v0c) / np.sqrt(len(xs) / 50)
    tolT = 6 * np.sqrt(vTc) / np.sqrt(len(xs) / 50)
    np.testing.assert_allclose(xs[:, 0, 0].mean(), m0c, atol=tol0)
    np.testing.assert_allclose(xs[:, -1, 0].mean(), mTc, atol=tolT)
    np.testing.assert_allclose(xs[:, 0, 0].std(), np.sqrt(v0c), rtol=0.1)
    np.testing.assert_allclose(xs[:, -1, 0].std(), np.sqrt(vTc), rtol=0.1)


@pytest.mark.parametrize("guided", [False, True])
def test_lane_path_under_grid_vmap_matches_generic(guided, monkeypatch):
    """The lane sweep must produce the same chain as the generic scan when
    the model is built under a vmap over traced (rho, r2) grid cells — the
    rare-event grid driver's exact pattern. Every model quantity the lane
    callables read rides the per-step params; this pins that down."""
    T, N, n_iter = 8, 16, 4
    rhos = jnp.asarray([0.2, 0.8], jnp.float32)
    r2s = jnp.asarray([0.5, 0.05], jnp.float32)

    def chain(key, rho, r2):
        if guided:
            init, kern = re_model.get_guided_csmc_kernel(
                Y, rho, r2, T, N, backward=True, gradient=True)
        else:
            init, kern = re_model.get_csmc_kernel(
                Y, rho, r2, T, N, backward=True)
        # Ambient default dtype (f64 under the test conftest's x64): the
        # model samples with default-dtype normals, so an f32 carry would
        # be promoted mid-scan.
        st = init(jnp.zeros((T, 1)))
        delta = 0.3 * jnp.ones((T,))

        def body(s, k):
            s = kern(k, s, delta)
            return s, s.x[:, 0]

        keys = jax.random.split(key, n_iter)
        _, xs = jax.lax.scan(body, st, keys)
        return xs

    keys = jax.random.split(jax.random.key(3), 2)
    fused = np.asarray(jax.jit(jax.vmap(chain))(keys, rhos, r2s))
    from csmc_common import force_generic_sweeps
    force_generic_sweeps(monkeypatch)
    gen = np.asarray(jax.jit(jax.vmap(chain))(keys, rhos, r2s))
    np.testing.assert_allclose(fused, gen, rtol=1e-5, atol=1e-5)

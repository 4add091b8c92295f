"""Stochastic-volatility model family: all four sampler styles run, adapt,
and move; statistical correctness is covered by the cross-style agreement
test (every style must target the same posterior)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.models import stochastic_volatility as sv
from aux_ssm_tpu.experiments.runner import RunConfig, run_chain

NU, PHI, TAU, RHO = 0.0, 0.9, 2.0, 0.25
T, D = 32, 3


@pytest.fixture(scope="module")
def data():
    xs, ys = sv.get_data(jax.random.key(0), NU, PHI, TAU, RHO, D, T)
    return np.asarray(xs), jnp.asarray(ys)


def test_dynamics_and_data(data):
    xs, ys = data
    assert xs.shape == (T, D) and ys.shape == (T, D)
    m0, P0, F, Q, b = sv.get_dynamics(NU, PHI, TAU, RHO, D)
    w = np.linalg.eigvalsh(np.asarray(Q))
    assert w.min() > 0
    # Stationarity: P0 solves P = F P F' + Q_innov where Q is stationary cov
    assert np.allclose(np.asarray(P0), np.asarray(Q))


def test_hess_log_potential_diag_closed_form(data):
    # d²/dx² log N(y; 0, exp(x)) = -y² exp(-x) / 2; regression for the
    # earlier bug where the function returned the first derivative.
    _, ys = data
    xs = 0.1 * jnp.arange(T * D, dtype=jnp.float64).reshape(T, D) / (T * D) - 0.05
    got = sv.hess_log_potential_diag(xs, ys)
    want = -0.5 * ys ** 2 * jnp.exp(-xs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    assert (np.asarray(got) <= 0).all()  # log-concave likelihood


def test_init_x_fn(data):
    _, ys = data
    x0 = sv.init_x_fn(jax.random.key(1), ys, NU, PHI, TAU, RHO, 64)
    assert x0.shape == (T, D)
    assert np.isfinite(np.asarray(x0)).all()


@pytest.mark.parametrize("order,parallel", [(1, False), (1, True), (2, True)])
def test_kalman_styles_move_and_adapt(data, order, parallel):
    _, ys = data
    init, kernel = sv.get_kalman_kernel(ys, NU, PHI, TAU, RHO, parallel, order=order)
    x0 = sv.init_x_fn(jax.random.key(2), ys, NU, PHI, TAU, RHO, 32)
    cfg = RunConfig(n_samples=300, burnin=300, target_alpha=0.5, delta_init=1e-2,
                    learning_rate=0.3)
    res = run_chain(jax.random.key(3), kernel, init(x0), cfg)
    acc = float(res.stats.accept_cum)
    assert 0.15 < acc < 0.95, acc
    assert float(jnp.max(res.stats.ejsd)) > 0


@pytest.mark.parametrize("style", ["csmc", "csmc-grad", "csmc-guided", "csmc-parallel"])
def test_csmc_styles_move(data, style):
    _, ys = data
    N = 16
    if style == "csmc":
        init, kernel = sv.get_csmc_kernel(ys, NU, PHI, TAU, RHO, N, backward=True)
    elif style == "csmc-grad":
        init, kernel = sv.get_csmc_kernel(ys, NU, PHI, TAU, RHO, N, gradient=True)
    elif style == "csmc-guided":
        init, kernel = sv.get_guided_csmc_kernel(ys, NU, PHI, TAU, RHO, N, backward=True)
    else:
        init, kernel = sv.get_csmc_kernel(ys, NU, PHI, TAU, RHO, N, parallel=True)

    x0 = sv.init_x_fn(jax.random.key(4), ys, NU, PHI, TAU, RHO, 32)
    state = init(x0)

    def body(st, k):
        st = kernel(k, st, jnp.full((T,), 0.5))
        return st, st.updated

    keys = jax.random.split(jax.random.key(5), 200)
    state, upd = jax.lax.scan(jax.jit(body), state, keys)
    rate = float(jnp.mean(upd.astype(jnp.float64)))
    assert rate > 0.05, rate
    assert np.isfinite(np.asarray(state.x)).all()


def test_guided_factory_matches_solve_oracle(data):
    """The eigenbasis guided proposal/weight algebra must reproduce the
    solve/Cholesky definition exactly: K = Q (Q + s^2 I)^{-1},
    Lam = Q - K Q, Gt = obs + N(x'; x_pred, Q) + N(x'; u, s) - N(x'; mu, Lam)
    (reference auxiliary_guided_csmc.py:143-156). Also pins the sampling
    covariance of Mt (symmetric-sqrt noise map: S S^T = Lam)."""
    from scipy.stats import multivariate_normal, norm as snorm

    _, ys = data
    N = 6
    factory, _Pt = sv.make_guided_factory(ys, NU, PHI, TAU, RHO)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((T, D)))
    scale = jnp.asarray(rng.uniform(0.2, 0.6, size=T))
    M0, G0, Mt, Gt = factory(u, scale)

    m0, P0, F, Q, b = map(np.asarray, sv.get_dynamics(NU, PHI, TAU, RHO, D))
    x_t = rng.standard_normal((N, D))
    x_n = rng.standard_normal((N, D))

    for t in (1, T // 2, T - 1):
        s2 = float(scale[t]) ** 2
        K = Q @ np.linalg.inv(Q + s2 * np.eye(D))
        Lam = Q - K @ Q
        x_pred = x_t @ F.T + b
        mu = x_pred + (np.asarray(u[t]) - x_pred) @ K.T

        # Weight law.
        params_t = jax.tree.map(lambda z: z[t - 1], Gt.params)
        got = np.asarray(Gt(jnp.asarray(x_n), jnp.asarray(x_t), params_t))
        want = np.zeros(N)
        for i in range(N):
            want[i] = (snorm.logpdf(np.asarray(ys[t]), 0.0,
                                    np.exp(0.5 * x_n[i])).sum()
                       + multivariate_normal.logpdf(x_n[i], x_pred[i], Q)
                       + snorm.logpdf(x_n[i], np.asarray(u[t]),
                                      float(scale[t])).sum()
                       - multivariate_normal.logpdf(x_n[i], mu[i], Lam))
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)

        # Proposal law: mean at eps=0, covariance of the noise map.
        params_m = jax.tree.map(lambda z: z[t - 1], Mt.params)
        mean_got = np.asarray(Mt.sample_from_noise(
            jnp.zeros((N, D)), jnp.asarray(x_t), params_m))
        np.testing.assert_allclose(mean_got, mu, rtol=1e-8, atol=1e-8)
        eye_eps = jnp.eye(D)
        cols = np.asarray(Mt.sample_from_noise(
            eye_eps, jnp.zeros((D, D)), params_m))  # rows: mu0 + S e_k
        mu0 = np.asarray(Mt.sample_from_noise(
            jnp.zeros((1, D)), jnp.zeros((1, D)), params_m))[0]
        S = (cols - mu0).T
        np.testing.assert_allclose(S @ S.T, Lam, rtol=1e-7, atol=1e-9)

    # M0 law.
    K0 = P0 @ np.linalg.inv(P0 + float(scale[0]) ** 2 * np.eye(D))
    Lam0 = P0 - K0 @ P0
    mu0_want = m0 + K0 @ (np.asarray(u[0]) - m0)
    lp = np.asarray(M0.logpdf(jnp.asarray(x_t)))
    want0 = np.array([multivariate_normal.logpdf(x_t[i], mu0_want, Lam0)
                      for i in range(N)])
    np.testing.assert_allclose(lp, want0, rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_styles_agree_on_posterior(data):
    """kalman-1 and guided cSMC must target the same posterior: their
    long-chain means must agree within MC error."""
    _, ys = data
    x0 = sv.init_x_fn(jax.random.key(6), ys, NU, PHI, TAU, RHO, 32)

    init_k, kernel_k = sv.get_kalman_kernel(ys, NU, PHI, TAU, RHO, True, order=1)
    cfg = RunConfig(n_samples=6000, burnin=2000, target_alpha=0.5, delta_init=1e-2,
                    learning_rate=0.3)
    res_k = run_chain(jax.random.key(7), kernel_k, init_k(x0), cfg, collect_samples=True)
    mean_k = np.asarray(res_k.samples).mean(0)

    init_c, kernel_c = sv.get_guided_csmc_kernel(ys, NU, PHI, TAU, RHO, 32, backward=True)
    cfg_c = RunConfig(n_samples=6000, burnin=2000, target_alpha=0.75, delta_init=0.5,
                      learning_rate=0.3)
    res_c = run_chain(jax.random.key(8), kernel_c, init_c(x0), cfg_c, collect_samples=True)
    mean_c = np.asarray(res_c.samples).mean(0)

    # Tolerance: generous MC bound for two autocorrelated 6k-sample chains
    # (worst single coordinate fluctuates ~0.6-0.7 across RNG streams; exact
    # per-style correctness is pinned by the oracle invariance tests).
    diff = np.abs(mean_k - mean_c)
    assert diff.max() < 0.8, diff.max()
    assert diff.mean() < 0.2, diff.mean()

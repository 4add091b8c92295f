"""Statistical MCMC-invariance tests for the cSMC kernels: long chains driven
by `lax.scan`, empirical moments compared to the exact smoothing law from the
Kalman oracle (assertion-based — no eyeballing, upgrading the reference's
plot-based smoke tests, SURVEY §4.3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.kernels.csmc import get_kernel
from csmc_common import (
    GaussianM0, FlatG0, GaussianObsGt, ARDynamics, FlatGt, ar1_lgssm_arrays,
)
from oracles import explicit_filter, explicit_smoother


def run_chain(kernel, state, key, n_iter):
    def body(carry, k):
        s = kernel(k, carry)
        return s, (s.x, s.updated)

    keys = jax.random.split(key, n_iter)
    _, (xs, upd) = jax.lax.scan(body, state, keys)
    return np.asarray(xs), np.asarray(upd)


T, D = 5, 1
PHI, SIG_X, SIG_Y = 0.9, 0.5, 0.4
N_PART = 32
N_ITER = 40_000


def _model(flat):
    rng = np.random.default_rng(0)
    ys = rng.standard_normal((T, D)) * 0.5
    M0 = GaussianM0(m0=jnp.zeros(D), sig0=jnp.ones(D))
    G0 = FlatG0()
    Mt = ARDynamics(params=(jnp.full((T - 1, D), PHI), jnp.full((T - 1, D), SIG_X)))
    if flat:
        Gt = FlatGt(params=jnp.zeros((T - 1,)))
        ys_oracle = np.full((T, D), np.nan)
    else:
        Gt = GaussianObsGt(params=(jnp.asarray(ys[1:]), jnp.full((T - 1, D), SIG_Y)))
        ys_oracle = ys.copy()
        ys_oracle[0] = np.nan  # flat G0: no observation at t=0
    return M0, G0, Mt, Gt, ys_oracle


def _oracle_moments(ys_oracle):
    params = ar1_lgssm_arrays(T, D, PHI, SIG_X, SIG_Y)
    ms, Ps, _ = explicit_filter(ys_oracle, *params)
    return explicit_smoother(ms, Ps, params[2], params[3], params[4])


@pytest.mark.slow
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_csmc_invariance(flat, backward):
    M0, G0, Mt, Gt, ys_oracle = _model(flat)
    init, kernel = get_kernel(M0, G0, Mt, Gt, N_PART, backward=backward)
    state = init(jnp.zeros((T, D)))

    xs, upd = run_chain(jax.jit(kernel), state, jax.random.key(0), N_ITER)
    xs = xs[N_ITER // 4:]

    msm, Psm = _oracle_moments(ys_oracle)
    std = np.sqrt(np.einsum("tii->ti", Psm))

    # Update rate should be substantial for an N=32 sampler on T=5.
    assert upd.mean() > 0.5

    # MCMC standard-error-scaled tolerances (generous: chains autocorrelate).
    np.testing.assert_allclose(xs.mean(0), msm, atol=6 * std.max() / np.sqrt(len(xs) / 20))
    np.testing.assert_allclose(xs.std(0), std, rtol=0.1)


@pytest.mark.slow
@pytest.mark.parametrize("resampling", ["multinomial", "systematic"])
def test_csmc_resampling_selectable(resampling):
    M0, G0, Mt, Gt, ys_oracle = _model(flat=False)
    init, kernel = get_kernel(M0, G0, Mt, Gt, N_PART, resampling=resampling)
    state = init(jnp.zeros((T, D)))
    xs, upd = run_chain(jax.jit(kernel), state, jax.random.key(1), 10_000)
    msm, Psm = _oracle_moments(ys_oracle)
    std = np.sqrt(np.einsum("tii->ti", Psm))
    assert upd.mean() > 0.5
    np.testing.assert_allclose(xs[2500:].mean(0), msm, atol=6 * std.max() / np.sqrt(7500 / 20))


def test_backward_requires_logpdf():
    M0, G0, Mt, Gt, _ = _model(flat=True)
    with pytest.raises(ValueError):
        get_kernel(M0, G0, Mt, FlatGt(), N_PART, backward=True, Pt=FlatGt())


def test_backward_scanning_matches_sequential_trace():
    """The O(log T)-depth pointer-doubling genealogy trace must agree
    index-for-index with a sequential Python pointer chase."""
    from aux_ssm_tpu.kernels.csmc import backward_scanning_pass

    rng = np.random.default_rng(3)
    T_, N_, d_ = 9, 6, 2
    ancestors = jnp.asarray(rng.integers(0, N_, (T_ - 1, N_)), dtype=jnp.int32)
    xs = jnp.asarray(rng.standard_normal((T_, N_, d_)))
    w_T = jnp.asarray(np.full(N_, 1.0 / N_))

    for s in range(5):
        key = jax.random.key(s)
        B_T = int(jax.random.choice(key, N_, p=w_T))
        picked_ref = [B_T]
        for t in range(T_ - 2, -1, -1):
            picked_ref.append(int(ancestors[t, picked_ref[-1]]))
        picked_ref = picked_ref[::-1]

        traj, picked = backward_scanning_pass(key, w_T, xs, ancestors)
        np.testing.assert_array_equal(np.asarray(picked), picked_ref)
        np.testing.assert_allclose(
            np.asarray(traj),
            np.stack([np.asarray(xs[t, picked_ref[t]]) for t in range(T_)]),
        )


def test_csmc_T1_final_weight_respects_G0(monkeypatch):
    """Regression: T==1 must not take a specialised sweep (whose w_T would
    come from an empty log-weight stack) — the final draw must follow
    normalize(G0(x0)), not a uniform. G0 here puts all mass near x=4."""
    import chex
    from jax.scipy.stats import norm
    from aux_ssm_tpu.kernels.csmc_base import UnivariatePotential

    @chex.dataclass
    class PeakedG0(UnivariatePotential):
        def __call__(self, x):
            return jnp.sum(norm.logpdf(x, 4.0, 0.1), axis=-1)

    D = 1
    M0 = GaussianM0(m0=jnp.zeros(D), sig0=jnp.full(D, 2.0))
    Mt = ARDynamics(params=(jnp.zeros((0, D)), jnp.ones((0, D))))
    Gt = GaussianObsGt(params=(jnp.zeros((0, D)), jnp.ones((0, D))))
    init, kernel = get_kernel(M0, PeakedG0(), Mt, Gt, N=256)
    st = init(jnp.zeros((1, D)))

    def body(s, k):
        s = kernel(k, s)
        return s, s.x[0, 0]

    keys = jax.random.split(jax.random.key(0), 400)
    _, xs = jax.jit(lambda s, k: jax.lax.scan(body, s, k))(st, keys)
    xs = np.asarray(xs)[100:]
    # Posterior = N(0,4) prior x N(4, .01) likelihood => mean ~3.99
    assert abs(xs.mean() - 4.0) < 0.3, xs.mean()

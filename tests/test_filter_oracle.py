"""The XLA filtering, log-density and backward-map paths against independent
float64 NumPy oracles: the loop Kalman filter of `oracles.py` (with missing
rows deleted), an explicit per-step Gaussian log-density, the closed-form
backward conditionals, and a loop composition of affine maps."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.ops.lgssm import LGSSM, trajectory_logdensity
from aux_ssm_tpu.ops.sampling import backward_map_moments, sampling_operator

from oracles import explicit_filter, random_lgssm, simulate

F = importlib.import_module("aux_ssm_tpu.ops.filtering")


def _model(T, dx, dy, seed=0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    params = random_lgssm(rng, T, dx, dy)
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    return params, ys


def _filter(params, ys, parallel, dtype=jnp.float64):
    lg = LGSSM(*(jnp.asarray(z, dtype) for z in params))
    ms, Ps, ell = F.filtering(jnp.asarray(ys, dtype), lg, parallel)
    return np.asarray(ms, np.float64), np.asarray(Ps, np.float64), float(ell)


def _norm_rel(got, want):
    """Per-step max-abs error over the step's max-abs value."""
    T = want.shape[0]
    err = np.abs(got - want).reshape(T, -1).max(1)
    return float((err / (np.abs(want).reshape(T, -1).max(1) + 1e-30)).max())


@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (64, 4, 3), (129, 3, 1),
                                     (300, 3, 2)])
def test_parallel_filter_matches_f64_oracle(T, dx, dy):
    params, ys = _model(T, dx, dy)
    ms, Ps, ell = _filter(params, ys, parallel=True)
    want_m, want_P, want_ell = explicit_filter(ys, *params)
    np.testing.assert_allclose(ms, want_m, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(Ps, want_P, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ell, want_ell, rtol=1e-10)


@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (64, 4, 3), (129, 3, 1)])
def test_sequential_filter_matches_f64_oracle(T, dx, dy):
    params, ys = _model(T, dx, dy, seed=1)
    ms, Ps, ell = _filter(params, ys, parallel=False)
    want_m, want_P, want_ell = explicit_filter(ys, *params)
    np.testing.assert_allclose(ms, want_m, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(Ps, want_P, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ell, want_ell, rtol=1e-10)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [
    (23, 2, 2, 0.0), (64, 4, 3, 0.3), (140, 3, 1, 0.0),
])
def test_parallel_filter_elements_and_ell_with_missing(T, dx, dy, nan_frac):
    """The associative elements, their masked missing-data projection and
    the per-step ell recovery together reproduce the row-deleting oracle."""
    params, ys = _model(T, dx, dy, seed=4, nan_frac=nan_frac)
    ms, Ps, ell = _filter(params, ys, parallel=True)
    want_m, want_P, want_ell = explicit_filter(ys, *params)
    np.testing.assert_allclose(ms, want_m, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(Ps, want_P, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ell, want_ell, rtol=1e-10)


@pytest.mark.parametrize("parallel", [True, False])
def test_f32_filter_accuracy(parallel):
    params, ys = _model(40, 3, 2, seed=3)
    ms, Ps, ell = _filter(params, ys, parallel, dtype=jnp.float32)
    want_m, want_P, want_ell = explicit_filter(ys, *params)
    assert _norm_rel(ms, want_m) < 1e-4
    assert _norm_rel(Ps, want_P) < 1e-4
    np.testing.assert_allclose(ell, want_ell, rtol=1e-5)


@pytest.mark.parametrize("parallel", [True, False])
def test_f32_filter_accuracy_headline_T1024_d16(parallel):
    """The headline model (T=1024, d=16) in f32 with "highest" matmuls
    against the f64 oracle: means and covariances within 1e-3
    norm-relative, ell within 1e-3 relative — the bounds the chip smoke
    test holds the GPU run to."""
    import __graft_entry__ as graft
    params, ys = graft._lgssm_arrays(1024, 16)
    with jax.default_matmul_precision("highest"):
        ms, Ps, ell = _filter(params, ys, parallel, dtype=jnp.float32)
    want_m, want_P, want_ell = explicit_filter(ys, *params)
    assert _norm_rel(ms, want_m) < 1e-3
    assert _norm_rel(Ps, want_P) < 1e-3
    assert abs(ell - want_ell) < 1e-3 * abs(want_ell)


def _np_logdensity(ys, xs, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    """log p(x) + log p(y | x), deleting missing observation rows."""
    def gauss(r, S):
        _, logdet = np.linalg.slogdet(S)
        return -0.5 * (r @ np.linalg.solve(S, r) + logdet
                       + r.size * np.log(2 * np.pi))
    out = gauss(xs[0] - m0, P0)
    for t in range(1, len(xs)):
        out += gauss(xs[t] - Fs[t - 1] @ xs[t - 1] - bs[t - 1], Qs[t - 1])
    for t in range(len(xs)):
        obs = np.isfinite(ys[t])
        if obs.any():
            r = ys[t][obs] - (Hs[t] @ xs[t] + cs[t])[obs]
            out += gauss(r, Rs[t][np.ix_(obs, obs)])
    return out


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(30, 2, 2, 0.0), (70, 3, 2, 0.4)])
def test_trajectory_logdensity_matches_numpy(T, dx, dy, nan_frac):
    params, ys = _model(T, dx, dy, seed=2, nan_frac=nan_frac)
    xs = np.random.default_rng(3).standard_normal((T, dx))
    lg = LGSSM(*map(jnp.asarray, params))
    got = float(trajectory_logdensity(jnp.asarray(ys), jnp.asarray(xs), lg))
    np.testing.assert_allclose(got, _np_logdensity(ys, xs, *params),
                               rtol=1e-10)


@pytest.mark.parametrize("T,dx", [(40, 2), (100, 4)])
def test_backward_map_moments_match_numpy(T, dx):
    """x_t | x_{t+1} ~ N(inc_m + gain x_{t+1}, L L^T) against the closed
    form gain = P F^T S^{-1}, cov = P - gain S gain^T, S = F P F^T + Q."""
    params, ys = _model(T, dx, 2, seed=5)
    m0, P0, Fs, Qs, bs, *_ = params
    ms, Ps, _ = explicit_filter(ys, *params)
    inc_m, L, gain = backward_map_moments(*map(jnp.asarray, (
        Fs, Qs, bs, ms[:-1], Ps[:-1])))
    for t in range(T - 1):
        S = Fs[t] @ Ps[t] @ Fs[t].T + Qs[t]
        g = Ps[t] @ Fs[t].T @ np.linalg.inv(S)
        np.testing.assert_allclose(np.asarray(gain[t]), g, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(inc_m[t]),
                                   ms[t] - g @ (Fs[t] @ ms[t] + bs[t]),
                                   rtol=1e-8, atol=1e-10)
        Lt = np.asarray(L[t])
        np.testing.assert_allclose(Lt @ Lt.T, Ps[t] - g @ S @ g.T,
                                   rtol=1e-7, atol=1e-9)


def _np_compose(gains, incs, reverse):
    """Loop prefix (or suffix) composition of the affine maps x -> G x + e,
    applying earlier elements of the scan order first."""
    T = len(gains)
    order = range(T - 1, -1, -1) if reverse else range(T)
    G_acc, e_acc = None, None
    out_G, out_e = np.zeros_like(gains), np.zeros_like(incs)
    for t in order:
        if G_acc is None:
            G_acc, e_acc = gains[t], incs[t]
        else:
            G_acc, e_acc = gains[t] @ G_acc, gains[t] @ e_acc + incs[t]
        out_G[t], out_e[t] = G_acc, e_acc
    return out_G, out_e


@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (256, 2, True),
                                         (100, 4, False)])
def test_affine_scan_matches_loop_composition(T, d, reverse):
    rng = np.random.default_rng(1)
    gains = 0.4 * rng.standard_normal((T, d, d))
    incs = rng.standard_normal((T, d))
    got = jax.lax.associative_scan(
        sampling_operator, (jnp.asarray(gains), jnp.asarray(incs)),
        reverse=reverse)
    want = _np_compose(gains, incs, reverse)
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(got[1]), want[1], rtol=1e-9,
                               atol=1e-11)

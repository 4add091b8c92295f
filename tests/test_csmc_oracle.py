"""The cSMC forward sweep and backward passes against a float64 NumPy
particle recursion driven by the same pre-drawn uniforms and normals.

Only the random draws come from JAX (the kernel's own key splits,
reproduced here); every resampling, propagation, weighting and backward
step is recomputed independently in NumPy and must agree exactly on the
indices and to round-off on the values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.stats import norm

from aux_ssm_tpu.kernels import csmc as csmc_mod
from aux_ssm_tpu.kernels.csmc import backward_sampling_pass, forward_pass
from aux_ssm_tpu.ops import resampling as resampling_mod

from csmc_common import ARDynamics, GaussianM0, GaussianObsG0, GaussianObsGt


# --------------------------------------------------------------------------
# NumPy recursions
# --------------------------------------------------------------------------

def _normalize(lw):
    m = np.max(lw)
    w = np.exp(lw - m)
    return w / w.sum()


def _inverse_cdf(u, w, scale_by_total=True):
    cdf = np.cumsum(w)
    t = u * cdf[-1] if scale_by_total else u
    return np.clip(np.searchsorted(cdf, t), 0, len(w) - 1)


def np_forward(x_star, x0, log_w0, res_u, eps, anc_u, propagate, logw,
               pgas_logpdf=None):
    """Conditional multinomial SMC with particle 0 pinned to `x_star` and,
    with `pgas_logpdf`, its ancestor redrawn (PGAS)."""
    T, N = x_star.shape[0], x0.shape[0]
    w = _normalize(log_w0)
    x_prev = x0
    xs, log_ws, ancs = [x0], [log_w0], []
    for t in range(T - 1):
        a = _inverse_cdf(res_u[t], w, scale_by_total=False)
        a[0] = 0
        if pgas_logpdf is not None:
            la = np.log(w) + pgas_logpdf(x_star[t + 1], x_prev, t)
            a[0] = _inverse_cdf(anc_u[t], _normalize(la))
        xp = x_prev[a]
        xt = propagate(eps[t], xp, t)
        xt[0] = x_star[t + 1]
        lw = logw(xt, xp, t)
        w = _normalize(lw)
        x_prev = xt
        xs.append(xt)
        log_ws.append(lw)
        ancs.append(a)
    return w, np.stack(xs), np.stack(log_ws), np.stack(ancs)


def np_backward_sampling(us, w_T, xs, log_ws, logpdf):
    T = xs.shape[0]
    B = _inverse_cdf(us[-1], w_T)
    picked = [B]
    x_next = xs[-1, B]
    for t in range(T - 2, -1, -1):
        lw = logpdf(x_next, xs[t], t) + log_ws[t]
        B = _inverse_cdf(us[t], _normalize(lw))
        x_next = xs[t, B]
        picked.append(B)
    picked = np.asarray(picked[::-1])
    return xs[np.arange(T), picked], picked


def np_backward_scanning(B_T, xs, ancestors):
    T = xs.shape[0]
    picked = [B_T]
    for t in range(T - 2, -1, -1):
        picked.append(ancestors[t][picked[-1]])
    picked = np.asarray(picked[::-1])
    return xs[np.arange(T), picked], picked


# --------------------------------------------------------------------------
# Models: JAX objects for the kernel, NumPy twins for the oracle
# --------------------------------------------------------------------------

def ar_model(T, D, seed=0):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.6, 0.95, (T - 1, D))
    sig = rng.uniform(0.3, 0.8, (T - 1, D))
    ys = rng.standard_normal((T, D))
    sig_y = rng.uniform(0.4, 1.0, (T, D))
    jax_model = (GaussianM0(m0=jnp.zeros(D), sig0=jnp.ones(D)),
                 GaussianObsG0(y=jnp.asarray(ys[0]), sig=jnp.asarray(sig_y[0])),
                 ARDynamics(params=(jnp.asarray(phi), jnp.asarray(sig))),
                 GaussianObsGt(params=(jnp.asarray(ys[1:]),
                                       jnp.asarray(sig_y[1:]))))
    np_model = dict(
        G0=lambda x: norm.logpdf(ys[0], x, sig_y[0]).sum(-1),
        propagate=lambda e, x, t: phi[t] * x + sig[t] * e,
        logw=lambda xn, xp, t: norm.logpdf(ys[t + 1], xn, sig_y[t + 1]).sum(-1),
        logpdf=lambda xn, xp, t: norm.logpdf(xn, phi[t] * xp, sig[t]).sum(-1))
    return jax_model, np_model


def theta_logistic_model(T, seed=0):
    """Bootstrap theta-logistic: its lane callables route the forward pass
    through `csmc_sweeps.lane_scan`."""
    from aux_ssm_tpu.models import theta_logistic as tl
    _, ys = tl.get_data(jax.random.key(seed), T)
    ys = jnp.asarray(ys, jnp.float64)
    p = tl.DEFAULTS
    ys_np = np.asarray(ys)

    def drift(x):
        return x + p["tau0"] - p["tau1"] * np.exp(p["tau2"] * x)

    np_model = dict(
        G0=lambda x: norm.logpdf(ys_np[0], x, p["sig_y"]).sum(-1),
        propagate=lambda e, x, t: drift(x) + p["sig_x"] * e,
        logw=lambda xn, xp, t: norm.logpdf(ys_np[t + 1], xn,
                                           p["sig_y"]).sum(-1),
        logpdf=lambda xn, xp, t: norm.logpdf(xn, drift(xp),
                                             p["sig_x"]).sum(-1))
    return tl.get_feynman_kac(ys), np_model


def _forward_both(jax_model, np_model, x_star, N, pgas, key):
    """Run `forward_pass` and the NumPy recursion on the same draws."""
    M0, G0, Mt, Gt = jax_model
    out = forward_pass(key, jnp.asarray(x_star), M0, G0, Mt, Gt, N,
                       resampling_mod.multinomial,
                       ancestor_Pt=Mt if pgas else None)
    T = x_star.shape[0]
    key_init, key_res, key_prop, key_anc = jax.random.split(key, 4)
    x0 = np.array(M0.sample(key_init, N))
    x0[0] = x_star[0]
    res_u = np.asarray(jax.random.uniform(key_res, (T - 1, N),
                                          dtype=x0.dtype))
    eps = np.asarray(jax.random.normal(key_prop, (T - 1,) + x0.shape,
                                       dtype=x0.dtype))
    anc_u = np.asarray(jax.random.uniform(key_anc, (T - 1,), dtype=x0.dtype))
    want = np_forward(x_star, x0, np_model["G0"](x0), res_u, eps, anc_u,
                      np_model["propagate"], np_model["logw"],
                      np_model["logpdf"] if pgas else None)
    return out, want


def _assert_forward_equal(out, want, f32=False):
    """Indices exactly; values to f64 round-off, or to f32 round-off for
    the lane sweep (which computes in f32)."""
    w_T, xs, log_ws, ancs = (np.asarray(z) for z in out)
    tol = 2e-5 if f32 else 1e-10
    np.testing.assert_array_equal(ancs, want[3])
    np.testing.assert_allclose(xs, want[1], rtol=tol, atol=tol)
    np.testing.assert_allclose(log_ws, want[2], rtol=tol, atol=5 * tol)
    np.testing.assert_allclose(w_T, want[0], rtol=10 * tol, atol=tol)


# --------------------------------------------------------------------------
# Forward sweep
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("N", [16, 32, 200, 2048])
def test_forward_pass_matches_numpy_recursion(pgas, N):
    T, D = (6 if N > 1024 else 24), 2
    jax_model, np_model = ar_model(T, D, seed=N)
    x_star = np.random.default_rng(1).standard_normal((T, D))
    out, want = _forward_both(jax_model, np_model, x_star, N, pgas,
                              jax.random.key(N))
    _assert_forward_equal(out, want)


def test_forward_pass_theta_logistic_matches_numpy():
    T, N = 16, 48
    jax_model, np_model = theta_logistic_model(T)
    x_star = np.linspace(0.5, 1.5, T)[:, None]
    out, want = _forward_both(jax_model, np_model, x_star, N, False,
                              jax.random.key(3))
    _assert_forward_equal(out, want, f32=True)


@pytest.mark.parametrize("pgas", [False, True])
def test_theta_logistic_pgas_forward_matches_numpy(pgas):
    T, N = 24, 32
    jax_model, np_model = theta_logistic_model(T, seed=1)
    x_star = np.linspace(0.5, 1.5, T)[:, None]
    out, want = _forward_both(jax_model, np_model, x_star, N, pgas,
                              jax.random.key(5))
    _assert_forward_equal(out, want, f32=True)


@pytest.mark.parametrize("pgas,N", [(False, 24), (True, 24),
                                    (False, 2048), (True, 2048)])
def test_theta_logistic_forward_sizes_match_numpy(pgas, N):
    T = 20 if N <= 128 else 6
    jax_model, np_model = theta_logistic_model(T, seed=2)
    x_star = np.random.default_rng(3).standard_normal((T, 1))
    out, want = _forward_both(jax_model, np_model, x_star, N, pgas,
                              jax.random.key(7))
    _assert_forward_equal(out, want, f32=True)


@pytest.mark.parametrize("pgas", [False, True])
def test_forward_pass_unroll_invariant(pgas):
    """The scan's unroll factor changes the schedule, never the sweep."""
    T, N = 20, 24
    M0, G0, Mt, Gt = ar_model(T, 1, seed=5)[0]
    x_star = jnp.asarray(np.random.default_rng(7).standard_normal((T, 1)))
    kw = dict(ancestor_Pt=Mt if pgas else None)
    a = forward_pass(jax.random.key(2), x_star, M0, G0, Mt, Gt, N,
                     resampling_mod.multinomial, unroll=1, **kw)
    b = forward_pass(jax.random.key(2), x_star, M0, G0, Mt, Gt, N,
                     resampling_mod.multinomial, unroll=4, **kw)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("T", [12, 16, 20])
def test_forward_pass_d3_matches_numpy(T):
    """State-dependent proposals in d = 3."""
    N = 16
    jax_model, np_model = ar_model(T, 3, seed=T)
    x_star = np.linspace(-0.5, 0.5, T * 3).reshape(T, 3)
    out, want = _forward_both(jax_model, np_model, x_star, N, False,
                              jax.random.key(9))
    _assert_forward_equal(out, want)


# --------------------------------------------------------------------------
# Backward passes and the whole kernel
# --------------------------------------------------------------------------

def _random_sweep(T, N, D, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, N, D))
    log_ws = rng.standard_normal((T, N))
    w_T = _normalize(rng.standard_normal(N))
    return xs, log_ws, w_T


def _check_backward_sampling(Mt, np_logpdf, xs, log_ws, w_T, key):
    traj, picked = backward_sampling_pass(key, Mt, jnp.asarray(w_T),
                                          jnp.asarray(xs), jnp.asarray(log_ws))
    us = np.asarray(jax.random.uniform(key, (xs.shape[0],), dtype=xs.dtype))
    want_traj, want_picked = np_backward_sampling(us, w_T, xs, log_ws,
                                                  np_logpdf)
    np.testing.assert_array_equal(np.asarray(picked), want_picked)
    np.testing.assert_allclose(np.asarray(traj), want_traj, rtol=0, atol=0)


@pytest.mark.parametrize("N", [16, 64, 2048])
def test_backward_sampling_matches_numpy(N):
    T, D = (20, 3) if N <= 1024 else (6, 3)
    (_, _, Mt, _), np_model = ar_model(T, D, seed=N)
    xs, log_ws, w_T = _random_sweep(T, N, D, seed=N)
    _check_backward_sampling(Mt, np_model["logpdf"], xs, log_ws, w_T,
                             jax.random.key(11))


def test_backward_sampling_theta_logistic_matches_numpy():
    T, N = 14, 32
    (_, _, Mt, _), np_model = theta_logistic_model(T)
    xs, log_ws, w_T = _random_sweep(T, N, 1, seed=1)
    _check_backward_sampling(Mt, np_model["logpdf"], xs + 1.0, log_ws, w_T,
                             jax.random.key(11))


@pytest.mark.parametrize("backward", [False, True])
def test_csmc_kernel_matches_numpy(backward):
    """One whole kernel step: forward sweep, then backward sampling or the
    genealogy trace, against the NumPy recursions on the same draws."""
    T, N, D = 16, 32, 2
    jax_model, np_model = ar_model(T, D, seed=21)
    M0, G0, Mt, Gt = jax_model
    init, kernel = csmc_mod.get_kernel(M0, G0, Mt, Gt, N, backward=backward)
    x_star = np.random.default_rng(4).standard_normal((T, D))
    key = jax.random.key(13)
    out = kernel(key, init(jnp.asarray(x_star)))

    key_fwd, key_bwd = jax.random.split(key)
    _, want = _forward_both(jax_model, np_model, x_star, N, False, key_fwd)
    w_T, xs, log_ws, ancs = want
    if backward:
        us = np.asarray(jax.random.uniform(key_bwd, (T,), dtype=xs.dtype))
        traj, picked = np_backward_sampling(us, w_T, xs, log_ws,
                                            np_model["logpdf"])
    else:
        B_T = int(jax.random.choice(key_bwd, N, p=jnp.asarray(
            np.asarray(kernel_w_T(jax_model, x_star, N, key_fwd)))))
        traj, picked = np_backward_scanning(B_T, xs, ancs)
    np.testing.assert_allclose(np.asarray(out.x), traj, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.updated), picked != 0)


def kernel_w_T(jax_model, x_star, N, key):
    """The kernel's own final weights (the genealogy trace draws B_T with
    `jax.random.choice`, whose law depends on the exact f64 values)."""
    M0, G0, Mt, Gt = jax_model
    return forward_pass(key, jnp.asarray(x_star), M0, G0, Mt, Gt, N,
                        resampling_mod.multinomial)[0]

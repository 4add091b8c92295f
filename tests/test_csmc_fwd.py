"""The specialised cSMC sweeps (`ops/csmc_sweeps.py`: factor, lane and
block-lane) against the generic forward pass on the same keys, and chain
invariance through the factor path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.kernels import csmc as csmc_mod
from aux_ssm_tpu.kernels.csmc_independent import get_kernel as get_indep
from aux_ssm_tpu.models import stochastic_volatility as sv

from csmc_common import ar1_lgssm_arrays
from oracles import explicit_filter, explicit_smoother


def _sv_model(T=12, D=2, seed=0):
    xs, ys = sv.get_data(jax.random.key(seed), 0.0, 0.9, 2.0, 0.25, D, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    return xs, M0, G0, Mt, Gt


def test_factor_scan_matches_generic_forward():
    """Same keys through the factor sweep and the generic forward pass on a
    real model: particle values identical, weights equal, ancestors equal up
    to cumsum rounding."""
    T, D, N = 16, 2, 48
    xs0, M0, G0, Mt, Gt = _sv_model(T, D)

    # Build the aPG factory products (independent proposals + absorbed
    # potentials) exactly as the sequential path does.
    from aux_ssm_tpu.kernels.csmc_independent import (
        DiagonalGaussian, IndependentDynamics, AbsorbedG0, AbsorbedGt)
    from aux_ssm_tpu.ops import resampling as resampling_mod

    rng = np.random.default_rng(7)
    u = jnp.asarray(xs0 + 0.3 * rng.standard_normal(xs0.shape), jnp.float32)
    scale = jnp.full((T,), 0.4, jnp.float32)
    prop0 = DiagonalGaussian(loc=u[0], scale=scale[0])
    propt = IndependentDynamics(params=(u[1:], scale[1:]))
    g0 = AbsorbedG0(prior=M0, pot=G0, u=u[0], shift=jnp.zeros_like(u[0]),
                    scale=scale[0])
    gt = AbsorbedGt(trans=Mt, pot=Gt,
                    params=(Mt.params, Gt.params,
                            (u[1:], jnp.zeros_like(u[1:]), scale[1:])))

    key = jax.random.key(3)
    x_star = jnp.asarray(xs0, jnp.float32)

    gen = csmc_mod.generic_forward_pass(key, x_star, prop0, g0, propt, gt, N,
                                        resampling_mod.multinomial)
    assert csmc_mod._use_factor_forward(propt, gt, resampling_mod.multinomial,
                                        None)
    fus = csmc_mod.forward_pass(key, x_star, prop0, g0, propt, gt, N,
                                resampling_mod.multinomial)

    w_T_g, xs_g, lw_g, anc_g = gen
    w_T_f, xs_f, lw_f, anc_f = fus
    np.testing.assert_allclose(np.asarray(xs_g), np.asarray(xs_f),
                               rtol=1e-6, atol=1e-6)
    agree = np.asarray(anc_g) == np.asarray(anc_f)
    assert agree.mean() > 0.99, agree.mean()
    rows_ok = agree.all(axis=1)
    np.testing.assert_allclose(np.asarray(lw_g)[1:][rows_ok],
                               np.asarray(lw_f)[1:][rows_ok],
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(np.asarray(w_T_g), np.asarray(w_T_f),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.slow
def test_fused_chain_invariance():
    """The aPG chain through the factor sweep must recover the LGSSM
    smoothing posterior."""
    T, D, N = 6, 1, 32
    PHI, SIG_X, SIG_Y = 0.9, 0.5, 0.4
    rng = np.random.default_rng(0)
    ys = rng.standard_normal((T, D)) * 0.5

    import chex
    from jax.scipy.stats import norm
    from aux_ssm_tpu.kernels.csmc_base import UnivariatePotential, Potential
    from csmc_common import ARDynamics, GaussianM0

    @chex.dataclass
    class ObsG0(UnivariatePotential):
        def __call__(self, x):
            return jnp.sum(norm.logpdf(jnp.asarray(ys[0]), x, SIG_Y), axis=-1)

    @chex.dataclass
    class ObsGt(Potential):
        prev_dependent = False

        def __call__(self, x_next, x_t, y):
            return jnp.sum(norm.logpdf(y, x_next, SIG_Y), axis=-1)

    M0 = GaussianM0(m0=jnp.zeros(D), sig0=jnp.ones(D))
    Mt = ARDynamics(params=(jnp.full((T - 1, D), PHI), jnp.full((T - 1, D), SIG_X)))

    init, kernel = get_indep(M0, ObsG0(), Mt, ObsGt(params=jnp.asarray(ys[1:])),
                             N, backward=True, Pt=Mt)
    delta = 0.8
    n_iter = 30_000

    def body(st, k):
        st = kernel(k, st, delta)
        return st, (st.x, st.updated)

    keys = jax.random.split(jax.random.key(0), n_iter)
    _, (xs, upd) = jax.lax.scan(jax.jit(body), init(jnp.zeros((T, D))), keys)

    xs = np.asarray(xs)[n_iter // 4:]
    assert float(np.asarray(upd).mean()) > 0.2

    params = ar1_lgssm_arrays(T, D, PHI, SIG_X, SIG_Y)
    ms, Ps, _ = explicit_filter(ys, *params)
    msm, Psm = explicit_smoother(ms, Ps, params[2], params[3], params[4])
    std = np.sqrt(np.einsum("tii->ti", Psm))
    np.testing.assert_allclose(xs.mean(0), msm,
                               atol=6 * std.max() / np.sqrt(len(xs) / 30))
    np.testing.assert_allclose(xs.std(0), std, rtol=0.15)


def test_fused_backward_matches_generic():
    """Same keys through the generic and factor backward passes on the SV
    model: identical picks up to cumsum rounding."""
    T, D, N = 14, 2, 32
    xs0, M0, G0, Mt, Gt = _sv_model(T, D)
    rng = np.random.default_rng(1)
    xs = jnp.asarray(rng.standard_normal((T, N, D)), jnp.float32)
    log_ws = jnp.asarray(rng.standard_normal((T, N)), jnp.float32)
    w_T = jnp.asarray(np.exp(rng.standard_normal(N)), jnp.float32)
    w_T = w_T / jnp.sum(w_T)
    key = jax.random.key(11)

    from aux_ssm_tpu.kernels.csmc import (
        backward_sampling_pass, factor_backward_pass)
    traj_g, picked_g = backward_sampling_pass(key, Mt, w_T, xs, log_ws)
    traj_f, picked_f = factor_backward_pass(key, Mt, w_T, xs, log_ws)
    agree = np.asarray(picked_g) == np.asarray(picked_f)
    assert agree.mean() > 0.9, agree.mean()
    if agree.all():
        np.testing.assert_allclose(np.asarray(traj_g), np.asarray(traj_f))


# --------------------------------------------------------------------------
# Lane-callable (bootstrap) forward sweep
# --------------------------------------------------------------------------

def _tl_setup(T=24, N=32, seed=0):
    from aux_ssm_tpu.models import theta_logistic as tl
    _, ys = tl.get_data(jax.random.key(seed), T)
    M0, G0, Mt, Gt = tl.get_feynman_kac(ys)
    return ys, M0, G0, Mt, Gt


@pytest.mark.parametrize("pgas", [False, True])
def test_lane_scan_matches_generic_forward(pgas):
    """Bootstrap theta-logistic: lane sweep vs generic scan, same keys."""
    from aux_ssm_tpu.ops import resampling as resampling_mod
    T, N = 24, 32
    ys, M0, G0, Mt, Gt = _tl_setup(T, N)
    key = jax.random.key(5)
    x_star = jnp.asarray(np.linspace(0.5, 1.5, T))[:, None].astype(jnp.float32)

    kw = dict(ancestor_Pt=Mt if pgas else None)
    gen = csmc_mod.generic_forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                        resampling_mod.multinomial, **kw)
    lane = csmc_mod.forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                 resampling_mod.multinomial, **kw)

    w_T_g, xs_g, lw_g, anc_g = gen
    w_T_l, xs_l, lw_l, anc_l = lane
    agree = np.asarray(anc_g) == np.asarray(anc_l)
    assert agree.mean() > 0.99, agree.mean()
    if agree.all():
        np.testing.assert_allclose(np.asarray(xs_g), np.asarray(xs_l),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(lw_g), np.asarray(lw_l),
                                   rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# Block-lane sweep (d > 1 state-dependent proposals: SV guided eigenbasis)
# --------------------------------------------------------------------------

def _guided_setup(T, D, N, seed=0):
    _, ys = sv.get_data(jax.random.key(seed), 0.0, 0.9, 2.0, 0.25, D, T)
    factory, Pt = sv.make_guided_factory(ys, 0.0, 0.9, 2.0, 0.25)
    rng = np.random.default_rng(seed + 1)
    u = jnp.asarray(rng.standard_normal((T, D)), jnp.float32)
    scale = jnp.asarray(rng.uniform(0.3, 0.6, size=T), jnp.float32)
    M0, G0, Mt, Gt = factory(u, scale)
    return M0, G0, Mt, Gt, Pt


def test_block_lane_xla_matches_generic_forward():
    """Guided SV (d = 3): block-lane sweep vs generic scan, same keys.
    Resampling draws are identical; particle values agree to fp tolerance
    (the block path computes the same algebra in (d, N) layout)."""
    from aux_ssm_tpu.ops import resampling as resampling_mod
    T, D, N = 16, 3, 16
    M0, G0, Mt, Gt, _Pt = _guided_setup(T, D, N)
    key = jax.random.key(9)
    x_star = jnp.asarray(np.linspace(-0.5, 0.5, T * D).reshape(T, D),
                         jnp.float32)

    gen = csmc_mod.generic_forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                        resampling_mod.multinomial)
    blk = csmc_mod.forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                resampling_mod.multinomial)

    w_T_g, xs_g, lw_g, anc_g = gen
    w_T_b, xs_b, lw_b, anc_b = blk
    agree = np.asarray(anc_g) == np.asarray(anc_b)
    assert agree.mean() > 0.99, agree.mean()
    if agree.all():
        np.testing.assert_allclose(np.asarray(xs_b), np.asarray(xs_g),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(lw_b), np.asarray(lw_g),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("gradient", [False, True])
def test_block_lane_spatial_guided_matches_generic(gradient, monkeypatch):
    """Spatial guided (B = 16 grid components): the block path's dense-
    precision quad form / analytic gradient shift must agree with the
    generic path's conv-stencil + jax.grad construction."""
    from aux_ssm_tpu.models import spatial as sp
    import aux_ssm_tpu.kernels.csmc as cm

    D, T, N = 4, 12, 16
    rng = np.random.default_rng(0)
    _, ys_np = sp.get_data(rng, 0.3, 1.0, -0.25, 4.0, D, T)
    ys = jnp.asarray(ys_np, jnp.float32)

    # Drive one kernel step through each path: the block-lane sweep (the
    # default for this model), then the generic scan.
    init, kernel = sp.get_guided_csmc_kernel(ys, 0.3, 4.0, -0.25, 1.0, D, N,
                                             backward=False,
                                             gradient=gradient)
    x0 = jnp.zeros((T, D * D), jnp.float32)
    key = jax.random.key(3)
    delta = jnp.full((T,), 0.1, jnp.float32)

    out_blk = jax.jit(kernel)(key, init(x0), delta)
    monkeypatch.setattr(cm, "_use_block_lane_forward", lambda *a: False)
    out_gen = jax.jit(kernel)(key, init(x0), delta)

    agree = np.asarray(out_gen.updated) == np.asarray(out_blk.updated)
    assert agree.mean() > 0.9, agree.mean()
    match = np.isclose(np.asarray(out_gen.x), np.asarray(out_blk.x),
                       rtol=1e-4, atol=1e-4).mean()
    assert match > 0.9, match

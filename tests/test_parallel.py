"""Multi-device tests on the 8-way virtual CPU mesh: sharded execution must
be bitwise identical (or MC-equivalent) to the single-device path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.parallel.mesh import make_mesh, CHAINS, PARTICLES
from aux_ssm_tpu.parallel.resampling import sharded_conditional_resample, sharded_normalize
from aux_ssm_tpu.parallel.chains import run_sharded_chains, aggregate_chain_stats
from aux_ssm_tpu.ops.resampling import multinomial, systematic
from aux_ssm_tpu.ops.logspace import normalize


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(axis_names=(PARTICLES,))


@pytest.fixture(scope="module")
def cmesh():
    return make_mesh(axis_names=(CHAINS,))


def test_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("scheme", [multinomial, systematic])
def test_sharded_resample_bitwise(pmesh, scheme):
    rng = np.random.default_rng(0)
    N, d = 64, 3
    w = rng.uniform(size=N)
    w = jnp.asarray(w / w.sum())
    particles = jnp.asarray(rng.standard_normal((N, d)))
    key = jax.random.key(3)

    want = jnp.take(particles, scheme(key, w), axis=0)
    got = sharded_conditional_resample(pmesh, key, w, particles, scheme=scheme)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("scheme", [multinomial, systematic])
def test_sharded_resample_streaming_bitwise(pmesh, scheme):
    from aux_ssm_tpu.parallel.resampling import (
        sharded_conditional_resample_streaming)
    rng = np.random.default_rng(7)
    N, d = 64, 3
    w = rng.uniform(size=N)
    w = jnp.asarray(w / w.sum())
    particles = jnp.asarray(rng.standard_normal((N, d)))
    key = jax.random.key(5)

    want = jnp.take(particles, scheme(key, w), axis=0)
    got = sharded_conditional_resample_streaming(pmesh, key, w, particles,
                                                 scheme=scheme)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_normalize(pmesh):
    rng = np.random.default_rng(1)
    lw = jnp.asarray(rng.standard_normal(64) * 5)
    got = sharded_normalize(pmesh, lw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(normalize(lw)), rtol=1e-12)


@pytest.mark.parametrize("backward", [False, True])
def test_sharded_csmc_matches_single(pmesh, backward):
    """The GSPMD-sharded cSMC kernel (sharded forward AND sharded backward
    passes) must be bitwise identical to the single-device kernel for the
    same key."""
    import csmc_common as cc
    from aux_ssm_tpu.kernels.csmc import get_kernel
    from aux_ssm_tpu.kernels.csmc_sharded import get_sharded_kernel

    T, D, N = 6, 1, 32
    M0 = cc.GaussianM0(m0=jnp.zeros(D), sig0=jnp.ones(D))
    G0 = cc.FlatG0()
    Mt = cc.ARDynamics(params=(jnp.full((T - 1, D), 0.9), jnp.full((T - 1, D), 0.5)))
    ys = jnp.asarray(np.random.default_rng(0).standard_normal((T - 1, D)))
    Gt = cc.GaussianObsGt(params=(ys, jnp.full((T - 1, D), 0.4)))

    init, kernel = get_kernel(M0, G0, Mt, Gt, N, backward=backward)
    init_s, kernel_s = get_sharded_kernel(M0, G0, Mt, Gt, N, pmesh,
                                          backward=backward)

    state = init(jnp.zeros((T, D)))
    key = jax.random.key(9)
    out_single = jax.jit(kernel)(key, state)
    out_sharded = jax.jit(kernel_s)(key, init_s(jnp.zeros((T, D))))

    np.testing.assert_array_equal(np.asarray(out_single.x), np.asarray(out_sharded.x))
    np.testing.assert_array_equal(np.asarray(out_single.updated), np.asarray(out_sharded.updated))


@pytest.mark.slow
def test_sharded_chains_kalman(cmesh):
    """8 sharded chains of the exact-proposal auxiliary Kalman sampler: all
    chains accept at rate ~1 and pooled moments match the smoother."""
    from aux_ssm_tpu.kernels.kalman import get_kernel
    from aux_ssm_tpu.ops.lgssm import LGSSM, log_likelihood, prior_logpdf
    from aux_ssm_tpu.experiments.runner import RunConfig
    from oracles import explicit_filter, explicit_smoother, random_lgssm, simulate

    T, DX, DY = 5, 2, 2
    rng = np.random.default_rng(4)
    params_np = random_lgssm(rng, T, DX, DY)
    ys_np = simulate(rng, *params_np)
    params = tuple(map(jnp.asarray, params_np))
    ys = jnp.asarray(ys_np)
    target = LGSSM(*params)
    eye = jnp.eye(DX)

    def dynamics_factory(x):
        return params[:5]

    def observations_factory(x, u, delta):
        ys_aug = jnp.concatenate([ys, u], axis=-1)
        Hs_aug = jnp.concatenate([params[5], jnp.tile(eye[None], (T, 1, 1))], axis=-2)
        z = jnp.zeros((T, DY, DX))
        Rs_aug = jnp.concatenate([
            jnp.concatenate([params[6], z], axis=-1),
            jnp.concatenate([jnp.swapaxes(z, -1, -2),
                             0.5 * delta * jnp.tile(eye[None], (T, 1, 1))], axis=-1),
        ], axis=-2)
        cs_aug = jnp.concatenate([params[7], jnp.zeros((T, DX))], axis=-1)
        return ys_aug, Hs_aug, Rs_aug, cs_aug

    def log_likelihood_fn(x):
        return prior_logpdf(x, target) + log_likelihood(ys, x, target)

    init, kernel = get_kernel(dynamics_factory, observations_factory,
                              log_likelihood_fn, parallel=True)

    n_chains = 8
    states = jax.vmap(init)(jnp.zeros((n_chains, T, DX)))
    # Exact proposal always accepts, so adaptation grows delta until the clip;
    # cap it to keep the augmented-R LGSSM numerically sane.
    cfg = RunConfig(n_samples=1500, burnin=200, delta_init=1.0, max_delta=100.0)
    res = run_sharded_chains(
        jax.random.key(0), kernel, states, cfg, mesh=cmesh, collect_samples=True
    )
    states, stats, samples = res.state, res.stats, res.samples
    assert samples.shape == (n_chains, cfg.n_samples, T, DX)
    assert res.sampling_time > 0.0

    agg = aggregate_chain_stats(stats)
    assert float(agg.accept_cum) > 0.999

    ms_f, Ps_f, _ = explicit_filter(ys_np, *params_np)
    msm, Psm = explicit_smoother(ms_f, Ps_f, *params_np[2:5])
    std = np.sqrt(np.einsum("tii->ti", Psm))
    pooled = np.asarray(samples).reshape(-1, T, DX)
    np.testing.assert_allclose(
        pooled.mean(0), msm, atol=5 * std.max() / np.sqrt(len(pooled) / 5)
    )

    # Chains must differ (independent keys).
    assert not np.allclose(np.asarray(samples[0]), np.asarray(samples[1]))


def test_sharded_csmc_one_device_uses_fused_path(monkeypatch):
    """On a 1-device particles mesh the sharded kernel drops the sharding
    constraint so `forward_pass` may take the specialised (lane/factor)
    sweeps; the law must match the generic scan with the same key."""
    from aux_ssm_tpu.kernels.csmc import get_kernel
    from aux_ssm_tpu.kernels.csmc_sharded import get_sharded_kernel
    from aux_ssm_tpu.models import theta_logistic as tl

    T, N = 12, 16
    _, ys = tl.get_data(jax.random.key(0), T)
    M0, G0, Mt, Gt = tl.get_feynman_kac(ys)
    mesh1 = make_mesh(devices=jax.devices()[:1], axis_names=(PARTICLES,))

    # 1-device sharded kernel: the lane sweep.
    init_s, kernel_s = get_sharded_kernel(M0, G0, Mt, Gt, N, mesh1)
    out_s = jax.jit(kernel_s)(jax.random.key(4), init_s(jnp.zeros((T, 1))))

    # Generic scan (specialised sweeps off).
    from csmc_common import force_generic_sweeps
    force_generic_sweeps(monkeypatch)
    init, kernel = get_kernel(M0, G0, Mt, Gt, N)
    out_gen = jax.jit(kernel)(jax.random.key(4), init(jnp.zeros((T, 1))))

    anc_agree = np.mean(np.asarray(out_gen.x) == np.asarray(out_s.x))
    assert anc_agree > 0.95, anc_agree  # identical up to f32 cumsum ties
    np.testing.assert_array_equal(np.asarray(out_gen.updated),
                                  np.asarray(out_s.updated))

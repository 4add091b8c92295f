"""The five BASELINE.md benchmark configurations as one runnable script.

Each config prints a JSON line; configs that need hardware this host lacks
(multi-host) run in their single-host sharded form on whatever devices exist
(use XLA_FLAGS=--xla_force_host_platform_device_count=8 + CPU for a virtual
mesh). `python benchmarks/baseline_configs.py [1|2|3|4|5|all]`.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_scan(kernel_step, state, n_iter, key):
    """Single-dispatch timing of n_iter kernel steps."""
    import jax
    import jax.numpy as jnp

    def body(c, k):
        return kernel_step(k, c), None

    f = jax.jit(lambda s: jax.lax.scan(body, s, jax.random.split(key, n_iter))[0])
    out = jax.block_until_ready(f(state))
    tic = time.perf_counter()
    out = jax.block_until_ready(f(out))
    return n_iter / (time.perf_counter() - tic), out


def config1():
    """LGSSM T=128 d=2, auxiliary Kalman, single chain on CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from aux_ssm_tpu.kernels.kalman import get_kernel

    dyn, obs, tfn = graft._build_lgssm_model(128, 2)
    init, kernel = get_kernel(dyn, obs, tfn, parallel=True)
    sps, _ = _time_scan(lambda k, s: kernel(k, s, jnp.float32(0.5)),
                        init(jnp.zeros((128, 2), jnp.float32)), 200, jax.random.key(0))
    return {"config": 1, "name": "lgssm_T128_d2_cpu", "samples_per_sec": round(sps, 2)}


def config2():
    """Stochastic volatility T=512, 2nd-order Kalman, 32 chains (sharded)."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.parallel.mesh import make_mesh, CHAINS
    from aux_ssm_tpu.parallel.chains import shard_chains, chain_keys

    T, D, C = 512, 16, 32
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, D, T)
    init, kernel = sv.get_kalman_kernel(ys, 0.0, 0.9, 2.0, 0.25, True, order=2)
    states = jax.vmap(init)(jnp.tile(xs[None], (C, 1, 1)))
    mesh = make_mesh(axis_names=(CHAINS,))
    if C % len(jax.devices()) == 0:
        states = shard_chains(mesh, states)

    def step(key, ss):
        keys = chain_keys(key, C)
        return jax.vmap(lambda k, s: kernel(k, s, jnp.float32(1e-2)))(keys, ss)

    sps, _ = _time_scan(step, states, 30, jax.random.key(1))
    return {"config": 2, "name": "sv_T512_order2_32chains",
            "chain_samples_per_sec": round(sps * C, 2)}


def config3():
    """Theta-logistic particle Gibbs, N=256, ancestor sampling."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import theta_logistic as tl

    _, ys = tl.get_data(jax.random.key(0), 256)
    init, kernel = tl.get_pgas_kernel(ys, 256, ancestor_sampling=True)
    sps, out = _time_scan(lambda k, s: kernel(k, s),
                          init(jnp.zeros_like(ys)), 100, jax.random.key(1))
    return {"config": 3, "name": "theta_logistic_pgas_N256",
            "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def config4():
    """BASELINE config 4 as specified: spatio-temporal grid at d=32
    (B = d^2 = 1024 independent scalar filters — the (T, B, 1, 1) layout the
    scalar lane-scan kernel was built for), T=1024, parallel-in-time scan,
    chains sharded over the available mesh."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import spatial as sp
    from aux_ssm_tpu.parallel.mesh import make_mesh, CHAINS
    from aux_ssm_tpu.parallel.chains import shard_chains, chain_keys

    T, D = 1024, 32                       # B = 1024 scalar lanes
    n_dev = len(jax.devices())
    C = max(4, n_dev)                     # chains, sharded when they divide
    rng = np.random.default_rng(0)
    _, ys = sp.get_data(rng, 0.3, 1.0, -0.25, 4.0, D, T)
    ys = jnp.asarray(ys, jnp.float32)
    init, kernel = sp.get_kalman_kernel(ys, 0.3, 4.0, -0.25, 1.0, D,
                                        parallel=True)
    states = jax.vmap(init)(jnp.zeros((C, T, D * D), jnp.float32))
    if C % n_dev == 0:
        states = shard_chains(make_mesh(axis_names=(CHAINS,)), states)

    def step(key, ss):
        keys = chain_keys(key, C)
        return jax.vmap(lambda k, s: kernel(k, s, jnp.float32(0.05)))(keys, ss)

    sps, _ = _time_scan(step, states, 20, jax.random.key(1))
    return {"config": 4, "name": "spatial_T1024_B1024_parallel_scan_sharded",
            "n_chains": C, "n_devices": n_dev,
            "chain_samples_per_sec": round(sps * C, 2)}


def config5():
    """cSMC T=1024, N=4096 particles sharded with collective resampling.
    Runs the particle-sharded kernel over all available devices."""
    import jax
    import jax.numpy as jnp
    import chex
    from jax.scipy.stats import norm
    from aux_ssm_tpu.parallel.mesh import make_mesh, PARTICLES
    from aux_ssm_tpu.kernels.csmc_sharded import get_sharded_kernel
    from aux_ssm_tpu.kernels.csmc_base import (
        Distribution, UnivariatePotential, Dynamics, Potential)

    T, N = 1024, 4096
    mesh = make_mesh(axis_names=(PARTICLES,))

    @chex.dataclass
    class M0(Distribution):
        def sample(self, key, n):
            return jax.random.normal(key, (n, 1))

    @chex.dataclass
    class G0(UnivariatePotential):
        def __call__(self, x):
            return jnp.sum(norm.logpdf(x), -1)

    @chex.dataclass
    class Mt(Dynamics):
        def sample(self, key, x_t, p):
            return 0.9 * x_t + 0.5 * jax.random.normal(key, x_t.shape)

        def sample_from_noise(self, eps, x_t, p):
            return 0.9 * x_t + 0.5 * eps

        def logpdf(self, x_n, x_t, p):
            return jnp.sum(norm.logpdf(x_n, 0.9 * x_t, 0.5), -1)

        # (1, N) lane-row callables: on one device the bootstrap sweep runs
        # through `ops/csmc_sweeps.lane_scan`.
        def lane_propagate(self, eps, x_prev, _p):
            return 0.9 * x_prev + 0.5 * eps

        def lane_logpdf(self, x_next, x_prev, _p):
            return norm.logpdf(x_next, 0.9 * x_prev, 0.5)

    @chex.dataclass
    class Gt(Potential):
        def __call__(self, x_n, x_t, y):
            return jnp.sum(norm.logpdf(y, x_n, 0.5), -1)

        def lane_logw(self, x_next, _x_prev, y):
            return norm.logpdf(y, x_next, 0.5)

    ys = jnp.zeros((T - 1, 1))
    init, kernel = get_sharded_kernel(
        M0(), G0(), Mt(params=jnp.zeros((T - 1, 0))), Gt(params=ys), N, mesh)
    sps, out = _time_scan(lambda k, s: kernel(k, s),
                          init(jnp.zeros((T, 1))), 10, jax.random.key(1))
    return {"config": 5, "name": "csmc_T1024_N4096_sharded",
            "samples_per_sec": round(sps, 2),
            "n_devices": len(jax.devices()),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which == "all":
        # One subprocess per config, one after another, so that one process
        # holds the device at a time: config1 switches jax_platforms to CPU
        # process-globally, which would silently demote configs 2-5 to CPU
        # if they shared its process. This parent never touches the device.
        import subprocess
        failed = [i for i in CONFIGS if subprocess.run(
            [sys.executable, os.path.abspath(__file__), str(i)]).returncode]
        if failed:
            sys.exit(f"configs {failed} failed")
    else:
        print(json.dumps(CONFIGS[int(which)]()), flush=True)

"""cSMC-family throughput measurements: sequential cSMC, PGAS, and PIT with
the factorised stitching path.

Run on the GPU: `python benchmarks/csmc_speed.py [case ...]`
Cases: seq32 pgas256 sv_guided spatial_guided pit128 pit1024 pit4096
pit8192 sharded4096 spatial_ref all
Each prints one JSON line (single-dispatch timing: one lax.scan over n_iter
kernel steps, all outputs consumed).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_scan(kernel_step, state, n_iter, key):
    import jax

    def body(c, k):
        s = kernel_step(k, c)
        return s, None

    f = jax.jit(lambda s: jax.lax.scan(body, s, jax.random.split(key, n_iter))[0])
    out = jax.block_until_ready(f(state))
    tic = time.perf_counter()
    out = jax.block_until_ready(f(out))
    return n_iter / (time.perf_counter() - tic), out


def _sv_setup(T, D):
    import jax
    from aux_ssm_tpu.models import stochastic_volatility as sv
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, D, T)
    return xs, ys


def seq32():
    """Sequential auxiliary cSMC on SV, T=1024 D=1, N=32, backward sampling."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, N = 1024, 32
    xs, ys = _sv_setup(T, 1)
    init, kernel = sv.get_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, N, backward=True)
    delta = 0.05 * jnp.ones((T,), jnp.float32)
    sps, out = _time_scan(lambda k, s: kernel(k, s, delta), init(xs), 100,
                          jax.random.key(1))
    return {"case": "seq_csmc_T1024_N32_backward", "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def pgas256():
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import theta_logistic as tl

    _, ys = tl.get_data(jax.random.key(0), 256)
    init, kernel = tl.get_pgas_kernel(ys, 256, ancestor_sampling=True)
    sps, out = _time_scan(lambda k, s: kernel(k, s), init(jnp.zeros_like(ys)),
                          100, jax.random.key(1))
    return {"case": "theta_logistic_pgas_N256", "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def sv_guided():
    """SV csmc-guided at the reference config (T=250, D=30, N=25)."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, D, N = 250, 30, 25
    _, ys = _sv_setup(T, D)
    init, kernel = sv.get_guided_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, N,
                                             backward=True)
    delta = jnp.full((T,), 5e-2, jnp.float32)
    sps, out = _time_scan(lambda k, s: kernel(k, s, delta),
                          init(jnp.zeros((T, D), jnp.float32)), 100,
                          jax.random.key(1))
    return {"case": "sv_guided_T250_D30_N25", "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def spatial_guided():
    """Spatial csmc-guided at the reference config (T=1024, D=8, N=25)."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import spatial as sp

    T, D, N = 1024, 8, 25
    _, ys = sp.get_data(np.random.default_rng(0), 0.3, 1.0, -0.25, 4.0, D, T)
    init, kernel = sp.get_guided_csmc_kernel(
        jnp.asarray(ys, jnp.float32), 0.3, 4.0, -0.25, 1.0, D, N, backward=True)
    delta = jnp.full((T,), 0.05, jnp.float32)
    sps, out = _time_scan(lambda k, s: kernel(k, s, delta),
                          init(jnp.zeros((T, D * D), jnp.float32)), 50,
                          jax.random.key(1))
    return {"case": "spatial_guided_T1024_D8_N25",
            "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def _pit(N, T=1024, n_iter=20):
    """Parallel-in-time aPG on SV D=1 with the factorised stitching path."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.kernels import csmc_independent as ci

    xs, ys = _sv_setup(T, 1)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    init, kernel = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    delta = 0.05 * jnp.ones((T,), jnp.float32)
    sps, out = _time_scan(lambda k, s: kernel(k, s, delta), init(xs), n_iter,
                          jax.random.key(1))
    return {"case": f"pit_csmc_T{T}_N{N}", "samples_per_sec": round(sps, 2),
            "update_rate": round(float(jnp.mean(out.updated.astype(jnp.float32))), 3)}


def pit128():
    return _pit(128)


def pit1024():
    return _pit(1024, n_iter=10)


def pit4096():
    return _pit(4096, n_iter=5)


def pit8192():
    """Capability datapoint past the BASELINE config: 67M pair weights per
    tree node, still never materialised (block-mass + joint flat draw)."""
    return _pit(8192, n_iter=3)


def sharded4096():
    from baseline_configs import config5
    return config5()


def spatial_ref():
    """Spatial reference config T=1024 D=8 (64 batched scalar filters,
    2nd-order factory)."""
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import spatial as sp

    T, D = 1024, 8
    rng = np.random.default_rng(0)
    _, ys = sp.get_data(rng, 0.3, 1.0, -0.25, 4.0, D, T)
    ys = jnp.asarray(ys, jnp.float32)
    init, kernel = sp.get_kalman_kernel(ys, 0.3, 4.0, -0.25, 1.0, D,
                                        parallel=True, order=2)
    x0 = jnp.zeros((T, D * D), jnp.float32)
    sps, _ = _time_scan(lambda k, s: kernel(k, s, jnp.float32(0.05)),
                        init(x0), 50, jax.random.key(1))
    return {"case": "spatial_T1024_D8_order2", "samples_per_sec": round(sps, 2)}



CASES = {f.__name__: f for f in (seq32, pgas256, sv_guided, spatial_guided,
                                 pit128, pit1024, pit4096, pit8192,
                                 sharded4096, spatial_ref)}

if __name__ == "__main__":
    which = sys.argv[1:] or ["all"]
    names = list(CASES) if which == ["all"] else which
    for n in names:
        print(json.dumps(CASES[n]()), flush=True)

"""Headline benchmark: auxiliary-Kalman sampler on a T=1024, d=16 LGSSM —
BOTH BASELINE.md metrics: samples/sec/chip (parallel-in-time filtering +
backward sampling, f32, single chip) and ESS/sec (second-order factory,
adapted-then-frozen delta, via benchmarks/headline_ess.run_one).

Prints the ESS/sec JSON line first and the headline samples/sec line last;
each names the device it ran on. The reference publishes no numbers
(BASELINE.json "published": {}), so vs_baseline is null. Exits non-zero
when JAX finds no GPU or when either leg fails.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    import __graft_entry__ as graft
    from aux_ssm_tpu.kernels.kalman import get_kernel

    T, dx = 1024, 16
    dyn, obs, target_fn = graft._build_lgssm_model(T, dx)
    init, kernel = get_kernel(dyn, obs, target_fn, parallel=True)

    delta = jnp.float32(0.05)

    def run(key, x, n):
        def body(carry, k):
            st = kernel(k, carry, delta)
            return st, st.updated

        keys = jax.random.split(key, n)
        st, upd = jax.lax.scan(body, init(x), keys)
        return st.x, jnp.mean(upd.astype(jnp.float32))

    n_iter = 200
    run_jit = jax.jit(run, static_argnums=2)
    x0 = jnp.zeros((T, dx), jnp.float32)

    # Warm-up / compile.
    x_w, acc = jax.block_until_ready(run_jit(jax.random.key(0), x0, n_iter))

    # Best of k independently keyed dispatches.
    k = 5
    best = float("inf")
    for i in range(k):
        tic = time.perf_counter()
        x_w, acc = jax.block_until_ready(
            run_jit(jax.random.key(1 + i), x_w, n_iter))
        best = min(best, time.perf_counter() - tic)

    samples_per_sec = n_iter / best
    print(json.dumps({
        "metric": "aux_kalman_samples_per_sec_T1024_d16",
        "value": round(float(samples_per_sec), 3),
        "unit": "samples/s/chip",
        "vs_baseline": None,
        "device": _device(),
    }), flush=True)


def ess_line():
    """Second metric line (BASELINE: 'samples/sec/chip AND ESS/sec'):
    kalman-2 ESS/sec on the same T=1024 d=16 model, adapted-then-frozen
    delta at target alpha 0.5 (the headline_ess.py methodology)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "benchmarks"))
    from headline_ess import run_one
    r = run_one(order=2, alpha=0.5)
    print(json.dumps({
        "metric": "aux_kalman2_ess_per_sec_T1024_d16",
        "value": r["ess_per_sec"],
        "unit": "ESS/s/chip",
        "vs_baseline": None,
        "device": _device(),
    }), flush=True)


if __name__ == "__main__":
    from aux_ssm_tpu.config import enable_compile_cache
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    enable_compile_cache()
    # ESS first so the throughput line stays last (the parsed headline).
    ess_line()
    main()

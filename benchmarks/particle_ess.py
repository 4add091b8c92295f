"""ESS/sec for the particle (cSMC) sampler families — BASELINE's actual
metric ("samples/sec/chip AND ESS/sec"), previously measured only for the
Kalman family (`headline_ess.py`). Cases:

  sv_csmc          SV T=250 D=30 N=25, auxiliary cSMC, backward sampling
  sv_csmc_guided   SV T=250 D=30 N=25, guided cSMC (block-lane sweep)
  theta_pgas       theta-logistic bootstrap PGAS, T=256 N=256
  pit128 / pit1024 parallel-in-time aPG on SV D=1 T=1024

Each case: adapted burn-in (per-time-step delta for the auxiliary families),
frozen-delta timed sampling phase via `run_chain` (compile excluded), then
interior-coordinate ESS exactly as `headline_ess.py` measures the Kalman
families, so the numbers are comparable across families.

    python benchmarks/particle_ess.py [case ...]   # default: all
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _interior_ess(samples, max_coords=64):
    """Mean ESS over up to `max_coords` interior trajectory coordinates
    (same selection as headline_ess.py: middle half of time, strided)."""
    from aux_ssm_tpu.utils.ess import effective_sample_size
    s = np.asarray(samples)
    T = s.shape[1]
    stride = max(1, (T // 2) // 16)
    mid = s[:, T // 4: 3 * T // 4: stride, :]
    flat = mid.reshape(mid.shape[0], -1)
    idx = np.unique(np.linspace(0, flat.shape[1] - 1, max_coords).astype(int))
    return float(np.mean([effective_sample_size(flat[:, i]) for i in idx]))


def _run(case, kernel, state, delta0, n_samples, burnin, target_alpha=0.5,
         extra=None):
    import jax
    from aux_ssm_tpu.experiments.runner import run_chain, RunConfig

    cfg = RunConfig(n_samples=n_samples, burnin=burnin,
                    target_alpha=target_alpha, verbose=False)
    res = run_chain(jax.random.key(1), kernel, state, cfg,
                    collect_samples=True, delta_init=delta0)
    ess = _interior_ess(res.samples)
    sps = n_samples / res.sampling_time
    out = {
        "case": case,
        "samples_per_sec": round(sps, 1),
        "update_rate": round(float(np.mean(np.asarray(res.stats.accept_cum))), 3),
        "mean_interior_ess": round(ess, 1),
        "ess_per_sec": round(ess / res.sampling_time, 2),
        "n_samples": n_samples,
    }
    if extra:
        out.update(extra)
    return out


def sv_csmc(guided=False, n_samples=3000, burnin=1500):
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, D, N = 250, 30, 25
    xs0, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, D, T)
    if guided:
        init, kernel = sv.get_guided_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, N,
                                                 backward=True)
    else:
        init, kernel = sv.get_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, N,
                                          backward=True)
    x0 = sv.init_x_fn(jax.random.key(2), ys, 0.0, 0.9, 2.0, 0.25, 32)
    delta0 = 0.05 * jnp.ones((T,), jnp.float32)
    name = "sv_csmc_guided_T250_D30_N25" if guided else "sv_csmc_T250_D30_N25"
    return _run(name, kernel, init(x0), delta0, n_samples, burnin)


def theta_pgas(n_samples=3000, burnin=500):
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import theta_logistic as tl

    T, N = 256, 256
    _, ys = tl.get_data(jax.random.key(0), T)
    init, kern = tl.get_pgas_kernel(ys, N, ancestor_sampling=True)
    # Bootstrap PGAS has no step size; ignore the runner's delta.
    kernel = lambda key, state, delta: kern(key, state)
    delta0 = jnp.ones((T,), jnp.float32)
    return _run(f"theta_logistic_pgas_T{T}_N{N}", kernel,
                init(jnp.zeros_like(ys)), delta0, n_samples, burnin)


def pit(N, n_samples=1500, burnin=500):
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.kernels import csmc_independent as ci

    T = 1024
    xs0, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    init, kernel = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    delta0 = 0.05 * jnp.ones((T,), jnp.float32)
    return _run(f"pit_csmc_T{T}_N{N}", kernel, init(xs0), delta0,
                n_samples, burnin)


CASES = {
    "sv_csmc": lambda: sv_csmc(False),
    "sv_csmc_guided": lambda: sv_csmc(True),
    "theta_pgas": theta_pgas,
    "pit128": lambda: pit(128),
    "pit1024": lambda: pit(1024, n_samples=800, burnin=300),
    # BASELINE config-5 particle count (~6 samples/s: keep the chain short;
    # the ESS estimate is coarse but the N-frontier question only needs the
    # order of magnitude).
    "pit4096": lambda: pit(4096, n_samples=400, burnin=150),
}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("cases", nargs="*", default=list(CASES))
    args = p.parse_args()
    for c in args.cases:
        try:
            print(json.dumps(CASES[c]()), flush=True)
        except Exception as e:  # keep the sweep going per-case
            print(json.dumps({"case": c,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)

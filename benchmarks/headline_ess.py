"""Headline ESS/sec measurement (BASELINE's actual metric): auxiliary Kalman
on the T=1024 d=16 LGSSM, first- AND second-order observation factories,
delta adapted to a target acceptance then frozen for the timed phase.

    python benchmarks/headline_ess.py [--order 1 2] [--alpha 0.5 ...]

Prints one JSON line per (order, alpha) with samples/s, acceptance, mean
interior ESS, and ESS/sec.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_order2_factory(T, dx, dtype):
    """Second-order observation factory for the graft LGSSM model: the
    Gaussian potential's Hessian is the constant -H^T R^-1 H per step, so
    Omega = (H^T R^-1 H + 2I/delta)^-1 (reference
    sv/auxiliary_kalman.py:37-48, closed-form Hessian here)."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as graft

    dyn, obs1, target_fn = graft._build_lgssm_model(T, dx, dtype=dtype)
    (*_, Hs, Rs, _cs), _ys = graft._lgssm_arrays(T, dx)
    H, R = Hs[0], Rs[0]
    hess = -(H.T @ np.linalg.solve(R, H))          # constant per step
    hess_j = jnp.asarray(hess, dtype)
    eye_j = jnp.eye(dx, dtype=dtype)

    # Per-step gradient of the potential via the first-order factory's
    # construction: grad = d log_likelihood / dx.
    def obs2(x, u, delta):
        aux1, *_ = obs1(x, u, delta)                # u + 0.5*delta*grad
        grad = (aux1 - u) / (0.5 * delta)
        omega_inv = -hess_j + 2.0 * eye_j / delta
        chol = jnp.linalg.cholesky(omega_inv)
        omega = jax.scipy.linalg.cho_solve((chol, True), eye_j)
        rhs = 2.0 * u / delta + grad - x @ hess_j.T
        aux_ys = jnp.einsum("ij,tj->ti", omega, rhs)
        Hs = jnp.tile(eye_j[None], (T, 1, 1))
        Rs = jnp.tile(omega[None], (T, 1, 1))
        cs = jnp.zeros((T, dx), dtype)
        return aux_ys, Hs, Rs, cs

    return dyn, obs1, obs2, target_fn


def run_one(order, alpha, T=1024, dx=16, burnin=1000, n_samples=3000):
    import time
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.kernels.kalman import get_kernel
    from aux_ssm_tpu.experiments.runner import run_chain, RunConfig
    from aux_ssm_tpu.utils.ess import effective_sample_size

    dyn, obs1, obs2, target_fn = build_order2_factory(T, dx, jnp.float32)
    obs = obs1 if order == 1 else obs2
    init, kernel = get_kernel(dyn, obs, target_fn, parallel=True)

    cfg = RunConfig(n_samples=n_samples, burnin=burnin, target_alpha=alpha,
                    delta_init=0.05, verbose=False)
    res = run_chain(jax.random.key(1), kernel, init(jnp.zeros((T, dx))), cfg,
                    collect_samples=True)
    s = np.asarray(res.samples)                      # (n, T, dx)
    # Interior ESS: middle time steps, all coords.
    mid = s[:, T // 4: 3 * T // 4: 16, :]
    flat = mid.reshape(mid.shape[0], -1)
    idx = np.linspace(0, flat.shape[1] - 1, 64).astype(int)
    ess = np.asarray([effective_sample_size(flat[:, i]) for i in idx])
    sps = n_samples / res.sampling_time
    return {
        "case": f"headline_kalman{order}_T{T}_d{dx}",
        "target_alpha": alpha,
        "acceptance": round(float(np.mean(np.asarray(res.stats.accept_cum))), 3),
        "delta": round(float(np.asarray(res.delta)), 5),
        "samples_per_sec": round(sps, 1),
        "mean_interior_ess": round(float(ess.mean()), 1),
        "ess_per_sec": round(float(ess.mean()) * sps / n_samples, 2),
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--order", type=int, nargs="+", default=[1, 2])
    p.add_argument("--alpha", type=float, nargs="+", default=[0.5])
    p.add_argument("--n-samples", type=int, default=3000)
    args = p.parse_args()
    for order in args.order:
        for alpha in args.alpha:
            print(json.dumps(run_one(order, alpha,
                                     n_samples=args.n_samples)), flush=True)

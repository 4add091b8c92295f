"""A/B of the two XLA path choices that remain in the samplers, run on the GPU.

    python benchmarks/xla_paths_ab.py [csmc] [stitch] [--rounds R]

csmc    the cSMC forward sweep: the model's protocol sweep from
        `ops/csmc_sweeps.py` (what `kernels.csmc.forward_pass` takes when
        the model offers it) against the generic `lax.scan`
        (`generic_forward_pass`), as whole kernel steps, on the SV
        csmc+backward and csmc-guided chains (T=250, D=30, N=25) and
        theta-logistic PGAS (T=256, N=256).
stitch  the parallel-in-time cSMC step on SV D=1, T=1024: blocked against
        two-pass stitching (`AUX_SSM_STITCH`) at N=2048, the threshold
        `kernels.pit._BLOCKED_MIN_N`.

Each round runs A then B, the next B then A. A round times one call of a
compiled scan of kernel steps, after one warm-up call. Each (case, mode,
round) prints one JSON line with ms per step and the update rate; each case
ends with a line of the medians. The first line is the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step_ms(jax, step, state, n, key):
    """Compile a scan of `n` kernel steps, warm it up, time one call."""
    import jax.numpy as jnp

    def run(s, k):
        def body(c, kk):
            c = step(kk, c)
            return c, jnp.mean(c.updated.astype(jnp.float32))
        return jax.lax.scan(body, s, jax.random.split(k, n))

    compiled = jax.jit(run).lower(state, key).compile()
    out, _ = jax.block_until_ready(compiled(state, key))
    tic = time.perf_counter()
    out, rates = jax.block_until_ready(compiled(out, key))
    return 1e3 * (time.perf_counter() - tic) / n, float(np.mean(rates))


def csmc_cases(jax):
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.models import theta_logistic as tl

    T = 250
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 30, T)
    delta = jnp.full((T,), 0.05, jnp.float32)
    init, kern = sv.get_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, 25, backward=True)
    yield "sv_csmc_bwd_T250_D30_N25", lambda k, s: kern(k, s, delta), init(xs)
    init, kern_g = sv.get_guided_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, 25,
                                             backward=True)
    yield ("sv_guided_bwd_T250_D30_N25", lambda k, s: kern_g(k, s, delta),
           init(xs))
    _, yt = tl.get_data(jax.random.key(0), 256)
    init, kern_t = tl.get_pgas_kernel(yt, 256, ancestor_sampling=True)
    yield "theta_pgas_T256_N256", kern_t, init(jnp.zeros_like(yt))


def run_csmc(jax, rounds):
    from aux_ssm_tpu.kernels import csmc

    modes = {"protocol": mock.patch.object(csmc, "forward_pass",
                                           csmc.forward_pass),
             "generic": mock.patch.object(csmc, "forward_pass",
                                          csmc.generic_forward_pass)}
    for case, step, state in csmc_cases(jax):
        ab(jax, case, modes, step, state, 100, rounds)


def run_stitch(jax, rounds):
    import jax.numpy as jnp
    from aux_ssm_tpu.kernels import csmc_independent as ci
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T = 1024
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    delta = jnp.full((T,), 0.05, jnp.float32)
    modes = {m: mock.patch.dict(os.environ, {"AUX_SSM_STITCH": m})
             for m in ("blocked", "2pass")}
    N = 2048
    init, kern = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    ab(jax, f"pit_T{T}_N{N}", modes, lambda k, s: kern(k, s, delta),
       init(xs), 5, rounds)


def ab(jax, case, modes, step, state, n, rounds):
    """Alternate the modes over `rounds` rounds; each mode traces under its
    own patch, so the two programs differ only in the path chosen."""
    names = list(modes)
    ms = {m: [] for m in names}
    for r in range(rounds):
        for m in names if r % 2 == 0 else names[::-1]:
            with modes[m]:
                t, rate = step_ms(jax, step, state, n, jax.random.key(r))
            ms[m].append(t)
            print(json.dumps({"case": case, "mode": m, "round": r,
                              "ms_per_step": t, "rate": rate}), flush=True)
    print(json.dumps({"case": case, "rounds": rounds,
                      "median_ms_per_step": {m: float(np.median(v))
                                             for m, v in ms.items()}}),
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("groups", nargs="*", default=["csmc", "stitch"],
                   choices=["csmc", "stitch"])
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("xla_paths_ab.py times the GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    from aux_ssm_tpu.config import enable_compile_cache
    enable_compile_cache()
    if "csmc" in args.groups:
        run_csmc(jax, args.rounds)
    if "stitch" in args.groups:
        run_stitch(jax, args.rounds)


if __name__ == "__main__":
    main()

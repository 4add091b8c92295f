"""Chip smoke test: the samplers' main path, end to end on one NVIDIA GPU,
checked against the repository's plain references.

    python chip_smoke.py             # one card: phases 0-3
    python chip_smoke.py --chips 4   # only the multi-card path (four cards)

Phases (one JSON line each):
  0  the device as JAX reports it, and `nvidia-smi`'s name and power limit;
  1  the headline chain: the parallel-in-time auxiliary Kalman kernel on the
     T=1024, d=16 LGSSM through `experiments.run_chain` (burn-in with delta
     adaptation, then sampling); the f32 filters against the f64 NumPy
     filter of `tests/oracles.py`; the exact-proposal MH check;
  2  one short chain per sampler family at the stochastic-volatility
     reference size (T=250, D=30, N=25) through `experiments.sv`'s kernels,
     and the parallel-in-time cSMC step at T=1024, N=4096 with its block
     masses against the dense N^2 reference;
  3  the rare-event grid (`experiments.rare_event`, kalman and csmc styles)
     against the closed-form posterior moments.

The last line is `{"ok": true, "device": {...}}` and is printed only when
every phase passed on a GPU. The script exits non-zero, without that line,
when JAX finds no GPU, when `nvidia-smi` fails, or when any phase raises or
misses a bound.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(**fields):
    print(json.dumps(fields, default=float), flush=True)


FAILED = []


def check(ok, what):
    """Record a missed bound and carry on, so one run reports every phase;
    `main` exits non-zero, without the result line, if any was missed."""
    if not ok:
        FAILED.append(what)
        emit(check_failed=what)


def norm_rel(got, want):
    """Largest per-step max-abs error over the step's max-abs value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    T = want.shape[0]
    err = np.abs(got - want).reshape(T, -1).max(1)
    return float((err / (np.abs(want).reshape(T, -1).max(1) + 1e-30)).max())


def timed_chain(jax, step, state, n, key):
    """Compile a scan of `n` kernel steps, run it, and time both."""
    import jax.numpy as jnp

    def run(s, k):
        def body(c, kk):
            c = step(kk, c)
            return c, jnp.mean(c.updated.astype(jnp.float32))
        return jax.lax.scan(body, s, jax.random.split(k, n))

    tic = time.perf_counter()
    compiled = jax.jit(run).lower(state, key).compile()
    compile_s = time.perf_counter() - tic
    tic = time.perf_counter()
    out, rates = jax.block_until_ready(compiled(state, key))
    run_s = time.perf_counter() - tic
    return out, float(np.mean(np.asarray(rates))), compile_s, run_s


# ---------------------------------------------------------------------------
# Phase 1: the headline chain
# ---------------------------------------------------------------------------

def phase1(jax, sizes):
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from oracles import explicit_filter
    from aux_ssm_tpu.experiments import run_chain, RunConfig
    from aux_ssm_tpu.kernels.kalman import get_kernel
    from aux_ssm_tpu.ops.filtering import filtering
    from aux_ssm_tpu.ops.lgssm import LGSSM, make_target_logpdf

    T, dx = sizes.T_head, 16
    dyn, obs, target_fn = graft._build_lgssm_model(T, dx)
    init, kernel = get_kernel(dyn, obs, target_fn, parallel=True)
    x0 = jnp.zeros((T, dx), jnp.float32)

    # The compiled step and its memory footprint.
    tic = time.perf_counter()
    step = jax.jit(kernel).lower(jax.random.key(0), init(x0),
                                 jnp.float32(0.05)).compile()
    step_compile_s = time.perf_counter() - tic
    mem = step.memory_analysis()
    emit(phase=1, what="headline step memory_analysis", T=T, d=dx,
         memory_analysis=str(mem))

    # The chain through the normal entry point.
    cfg = RunConfig(n_samples=sizes.n_head, burnin=sizes.burn_head,
                    target_alpha=0.5, delta_init=0.05, verbose=False)
    tic = time.perf_counter()
    res = run_chain(jax.random.key(1), kernel, init(x0), cfg)
    chain_wall_s = time.perf_counter() - tic
    acc = float(np.mean(np.asarray(res.stats.accept_cum)))
    x_final = np.asarray(res.state.x)

    # Filters against the f64 oracle.
    arrays, ys = graft._lgssm_arrays(T, dx)
    want_m, want_P, want_ell = explicit_filter(ys, *arrays)
    lg = LGSSM(*(jnp.asarray(z, jnp.float32) for z in arrays))
    ysj = jnp.asarray(ys, jnp.float32)
    errors = {}
    for precision in ("highest", "default"):
        for parallel in (True, False):
            with jax.default_matmul_precision(precision):
                f = jax.jit(lambda y, l, p=parallel: filtering(y, l, p))
                ms, Ps, ell = jax.block_until_ready(f(ysj, lg))
            errors[f"{'parallel' if parallel else 'sequential'}_{precision}"] = {
                "means": norm_rel(ms, want_m), "covs": norm_rel(Ps, want_P),
                "ell": abs(float(ell) - want_ell) / abs(want_ell)}

    # Exact-proposal check: augment the real observations with the
    # auxiliary rows, so the proposal is the exact conditional pi(x | u)
    # and every move must be accepted.
    params = tuple(jnp.asarray(z, jnp.float32) for z in arrays)
    target = LGSSM(*params)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = params
    exact_target = make_target_logpdf(ysj, target)
    eye = jnp.eye(dx, dtype=jnp.float32)
    dy = Hs.shape[-2]

    def exact_obs(x, u, delta):
        H_aug = jnp.concatenate([Hs, jnp.broadcast_to(eye, (T, dx, dx))], -2)
        R_aug = jnp.zeros((T, dy + dx, dy + dx), jnp.float32)
        R_aug = R_aug.at[:, :dy, :dy].set(Rs).at[:, dy:, dy:].set(
            0.5 * delta * eye)
        c_aug = jnp.concatenate([cs, jnp.zeros((T, dx), jnp.float32)], -1)
        return jnp.concatenate([ysj, u], -1), H_aug, R_aug, c_aug

    init_e, kernel_e = get_kernel(lambda _x: (m0, P0, Fs, Qs, bs), exact_obs,
                                  exact_target, parallel=True)
    _, exact_acc, ex_compile_s, ex_run_s = timed_chain(
        jax, lambda k, s: kernel_e(k, s, jnp.float32(0.5)),
        init_e(jnp.asarray(x_final)), sizes.n_exact, jax.random.key(2))

    emit(phase=1, what="headline chain", T=T, d=dx, dtype="float32",
         step_compile_s=step_compile_s, chain_wall_s=chain_wall_s,
         sampling_s=res.sampling_time, n_samples=cfg.n_samples,
         burnin=cfg.burnin, acceptance=acc, delta=float(res.delta),
         finite=bool(np.isfinite(x_final).all()),
         filter_errors=errors, exact_proposal_acceptance=exact_acc,
         exact_compile_s=ex_compile_s, exact_run_s=ex_run_s)
    check(np.isfinite(x_final).all() and x_final.shape == (T, dx),
          "headline chain state is not finite (T, d)")
    check(0.2 <= acc <= 0.9, f"headline acceptance {acc} outside [0.2, 0.9]")
    for name, e in errors.items():
        if name.endswith("highest"):
            check(max(e.values()) < 1e-3,
                  f"{name} filter error {e} exceeds 1e-3")
    check(exact_acc >= 0.999, f"exact-proposal acceptance {exact_acc} < 0.999")


# ---------------------------------------------------------------------------
# Phase 2: every sampler family at the SV reference size, and PIT at N=4096
# ---------------------------------------------------------------------------

# Mean update/acceptance-rate bounds for the short chains below (the SV
# sweep's settings: delta from 1e-8, learning rate 0.1, target 0.5; 300
# burn-in, 200 samples). The same chains on CPU (f32) give kalman-1 1.000,
# kalman-2 0.955, csmc 0.960, csmc-guided 0.960, pit-csmc 0.700; a numerics
# fault (e.g. TF32 in the MH ratio) shows as a collapse of the rate.
FAMILY_BOUNDS = {
    "kalman-1": (0.8, 1.0),
    "kalman-2": (0.75, 1.0),
    "csmc": (0.8, 1.0),
    "csmc-guided": (0.8, 1.0),
    "pit-csmc": (0.5, 0.9),
}


def phase2(jax, sizes):
    import jax.numpy as jnp
    from aux_ssm_tpu.experiments import run_chain, RunConfig
    from aux_ssm_tpu.experiments.sv import NU, PHI, TAU, RHO, build_kernel
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, D, N = 250, 30, 25
    data_key, init_key, run_key = jax.random.split(jax.random.key(42), 3)
    _, ys = sv.get_data(data_key, NU, PHI, TAU, RHO, D, T)
    x0 = sv.init_x_fn(init_key, ys, NU, PHI, TAU, RHO, 32)
    families = [("kalman-1", "kalman-1", True), ("kalman-2", "kalman-2", True),
                ("csmc", "csmc", False), ("csmc-guided", "csmc-guided", False),
                ("pit-csmc", "csmc", True)]
    for name, style, parallel in families:
        args = SimpleNamespace(parallel=parallel, n_particles=N, backward=True,
                               gradient=False, resampling="multinomial")
        init, kernel = build_kernel(style, ys, args)
        is_csmc = style.startswith("csmc")
        delta0 = 1e-8 * jnp.ones(T) if is_csmc else jnp.float32(1e-8)
        cfg = RunConfig(n_samples=sizes.n_sv, burnin=sizes.burn_sv,
                        target_alpha=0.5, learning_rate=0.1, verbose=False)
        tic = time.perf_counter()
        res = run_chain(run_key, kernel, init(x0), cfg, delta_init=delta0)
        wall_s = time.perf_counter() - tic
        rate = float(np.mean(np.asarray(res.stats.accept_cum)))
        x = np.asarray(res.state.x)
        lo, hi = FAMILY_BOUNDS[name]
        emit(phase=2, family=name, T=T, D=D, N=N if is_csmc else None,
             wall_s=wall_s, sampling_s=res.sampling_time,
             samples_per_s=cfg.n_samples / res.sampling_time,
             rate=rate, bounds=[lo, hi], finite=bool(np.isfinite(x).all()))
        check(np.isfinite(x).all() and x.shape == (T, D),
              f"{name}: state not finite (T, D)")
        check(lo <= rate <= hi, f"{name}: rate {rate} outside [{lo}, {hi}]")

    pit_large(jax, sizes)


def pit_large(jax, sizes):
    """The PIT-cSMC step at T=1024, N=4096 (SV, D=1), and its O(N^2)
    block-mass pass against the dense f64 reference at that width."""
    import jax.numpy as jnp
    from aux_ssm_tpu.kernels import csmc_independent as ci
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.ops import stitching as st

    T, N = 1024, sizes.N_pit
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    init, kernel = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    delta = jnp.full((T,), 0.05, jnp.float32)
    out, rate, compile_s, run_s = timed_chain(
        jax, lambda k, s: kernel(k, s, delta), init(xs), sizes.n_pit,
        jax.random.key(1))
    x = np.asarray(out.x)

    # One tree node's block masses at full width vs the dense scores.
    rng = np.random.default_rng(0)
    xl = jnp.asarray(rng.standard_normal((1, N, 1)), jnp.float32)
    xr = jnp.asarray(rng.standard_normal((1, N, 1)), jnp.float32)
    rf, cf, rb, cb = jax.vmap(Mt.logpdf_factors)(
        xl, xr, jax.tree.map(lambda z: z[:1], Mt.params))
    Lb = np.asarray(jax.block_until_ready(jax.jit(st.block_masses)(rf, cf, cb)))
    s = (np.asarray(rf[0], np.float64) @ np.asarray(cf[0], np.float64).T
         + np.asarray(cb[0], np.float64)[None, :])
    m = s.max(1, keepdims=True)
    want = np.log(np.exp(s - m).reshape(N, N // 128, 128).sum(-1)) + m
    mass_err = float(np.abs(Lb[0] - want).max() / (np.abs(want).max()))

    emit(phase=2, family="pit-csmc", T=T, D=1, N=N, steps=sizes.n_pit,
         compile_s=compile_s, run_s=run_s, ms_per_step=1e3 * run_s / sizes.n_pit,
         rate=rate, bounds=[0.05, 1.0], finite=bool(np.isfinite(x).all()),
         block_mass_max_rel_err=mass_err)
    check(np.isfinite(x).all(), "PIT N=4096 state not finite")
    check(0.05 <= rate <= 1.0, f"PIT N=4096 rate {rate} outside [0.05, 1]")
    check(mass_err < 1e-5, f"block masses off the dense reference: {mass_err}")


# ---------------------------------------------------------------------------
# Phase 3: rare-event grid vs the closed form
# ---------------------------------------------------------------------------

def phase3(jax, sizes):
    from aux_ssm_tpu.experiments.rare_event import run_grid

    for style in ("kalman-1", "csmc"):
        args = SimpleNamespace(
            style=style, grid_size=sizes.grid, n_chains=8, T=2, y=5.0,
            parallel=style.startswith("kalman"), gradient=False, backward=True,
            n_particles=25, seed=0, n_samples=sizes.n_rare,
            burnin=sizes.burn_rare, target_alpha=0.5, lr=0.1, beta=0.05,
            delta_init=0.5, verbose=False, mesh_chains=0)
        tic = time.perf_counter()
        rows, res = run_grid(args)
        wall_s = time.perf_counter() - tic
        # |mean - m| in Monte-Carlo standard errors sqrt(v / ESS), and the
        # std's error in units of its own standard error 1 / sqrt(2 ESS).
        z_mean = max(max(np.sqrt(r["err_mean_0"] * r["ess_0"]),
                         np.sqrt(r["err_mean_T"] * r["ess_T"])) for r in rows)
        z_std = max(max(abs(r["err_std_0"]) * np.sqrt(2 * r["ess_0"]),
                        abs(r["err_std_T"]) * np.sqrt(2 * r["ess_T"]))
                    for r in rows)
        min_ess = min(min(r["ess_0"], r["ess_T"]) for r in rows)
        acc = [r["acc"] for r in rows]
        emit(phase=3, style=style, cells=len(rows), chains=8,
             wall_s=wall_s, sampling_s=res.sampling_time,
             max_mean_err_in_mcse=z_mean, max_std_err_in_se=z_std,
             min_ess=min_ess, acceptance_min=min(acc),
             acceptance_max=max(acc))
        check(z_mean < 5 and z_std < 5,
              f"rare-event {style}: moments off the closed form "
              f"({z_mean:.2f}, {z_std:.2f} standard errors)")


# ---------------------------------------------------------------------------
# --chips 4: the multi-card paths against one card
# ---------------------------------------------------------------------------

def devices_of(x):
    return sorted({d.id for d in x.sharding.device_set})


def multichip(jax, sizes):
    n_dev = len(jax.devices())
    check(n_dev >= 4, f"--chips 4 needs four devices, JAX sees {n_dev}")
    chains(jax, sizes)
    particles(jax, sizes)
    time_axis(jax)


N_CHAINS, CHAIN_MESH = 8, 4


def sv_chains_setup(jax, n):
    """The SV cSMC chain of the reference experiment (T=250, D=30, N=25,
    backward sampling): `n` burn-in steps with delta adaptation, then `n`
    collected samples, from one shared initial state."""
    import jax.numpy as jnp
    from aux_ssm_tpu.experiments import RunConfig
    from aux_ssm_tpu.experiments.sv import NU, PHI, TAU, RHO
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, D, N = 250, 30, 25
    data_key, init_key, run_key = jax.random.split(jax.random.key(42), 3)
    _, ys = sv.get_data(data_key, NU, PHI, TAU, RHO, D, T)
    x0 = sv.init_x_fn(init_key, ys, NU, PHI, TAU, RHO, 32)
    init, kernel = sv.get_csmc_kernel(ys, NU, PHI, TAU, RHO, N, backward=True)
    cfg = RunConfig(n_samples=n, burnin=n, target_alpha=0.5, delta_init=0.1,
                    verbose=False)
    return SimpleNamespace(kernel=kernel, state=init(x0), cfg=cfg,
                           key=run_key, delta=cfg.delta_init * jnp.ones(T),
                           T=T, D=D, N=N)


def one_card_chains(jax, setup, group):
    """The N_CHAINS chains on one device, `group` chains per program, each
    on its own `fold_in` key: (samples, per-chain update rates)."""
    import jax.numpy as jnp
    from aux_ssm_tpu.parallel.chains import chain_keys, run_sharded_chains

    keys = chain_keys(setup.key, N_CHAINS)
    bc = lambda z: jnp.broadcast_to(z, (group,) + jnp.shape(z))
    samples, rates = [], []
    for i in range(0, N_CHAINS, group):
        res = run_sharded_chains(keys[i:i + group], setup.kernel,
                                 jax.tree.map(bc, setup.state), setup.cfg,
                                 collect_samples=True,
                                 delta_init=bc(setup.delta))
        samples.append(np.asarray(res.samples))
        rates.append(np.asarray(res.stats.accept_cum).mean(-1))
    return np.concatenate(samples), np.concatenate(rates)


def chain_diffs(a, b):
    """Per chain: the largest |a - b| over its samples, and the first
    sample at which the two differ by more than 1e-3 (None if none)."""
    d = np.abs(a - b).reshape(a.shape[:2] + (-1,)).max(-1)
    first = [int(np.argmax(row > 1e-3)) if (row > 1e-3).any() else None
             for row in d]
    return d.max(1).tolist(), first


def chains(jax, sizes):
    """8 SV cSMC chains through `--n-chains 8 --mesh-chains 4` (two chains
    per card) against the same chains on one card, on the same keys.

    The gate compares the sharded run with the one-card run of the same
    per-card batch (the chains run two to a program): every chain and
    every sample must agree to 1e-3. Beside it, the witness: the eight
    chains in one program on one card against the same two-chain programs,
    which shows what the batch shape alone does to a chain."""
    from aux_ssm_tpu.experiments.cli import run_maybe_sharded

    setup = sv_chains_setup(jax, sizes.n_multi)
    args = SimpleNamespace(n_chains=N_CHAINS, mesh_chains=CHAIN_MESH)
    tic = time.perf_counter()
    res, _ = run_maybe_sharded(setup.key, setup.kernel, setup.state,
                               setup.cfg, args, collect_samples=True,
                               delta_init=setup.delta)
    wall_sharded = time.perf_counter() - tic
    sharded = np.asarray(res.samples)
    per_card = N_CHAINS // CHAIN_MESH
    tic = time.perf_counter()
    batched, rates_b = one_card_chains(jax, setup, per_card)
    wall_batched = time.perf_counter() - tic
    whole, rates_w = one_card_chains(jax, setup, N_CHAINS)
    gate_max, gate_first = chain_diffs(sharded, batched)
    wit_max, wit_first = chain_diffs(whole, batched)
    placed = devices_of(res.state.x)
    emit(phase="4chips", path="chains", family="csmc", n_chains=N_CHAINS,
         mesh=CHAIN_MESH, T=setup.T, D=setup.D, N=setup.N,
         burnin=setup.cfg.burnin, n_samples=setup.cfg.n_samples,
         devices=placed, wall_s_sharded=wall_sharded,
         wall_s_one_card=wall_batched,
         sharded_vs_one_card_max_abs_diff=gate_max,
         sharded_vs_one_card_first_diff=gate_first,
         update_rate_sharded=np.asarray(res.stats.accept_cum).mean(-1).tolist(),
         update_rate_one_card=rates_b.tolist(),
         witness_batch8_vs_batch2_max_abs_diff=wit_max,
         witness_batch8_vs_batch2_first_diff=wit_first,
         update_rate_batch8=rates_w.tolist())
    check(placed == sorted(d.id for d in jax.devices()[:CHAIN_MESH]),
          f"chains not spread over four cards: {placed}")
    check(all(f is None for f in gate_first),
          f"sharded chains differ from one card at samples {gate_first}")


def particles(jax, sizes):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from aux_ssm_tpu.kernels import csmc
    from aux_ssm_tpu.kernels.csmc_sharded import get_sharded_kernel
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.ops import resampling
    from aux_ssm_tpu.parallel.mesh import make_mesh, PARTICLES

    # Particle-sharded sequential cSMC (SV D=1, N=4096; BASELINE config 5)
    # vs one card. The forward sweep under the particle sharding constraint
    # against the same sweep unconstrained, on the same keys: the first
    # resampling step must agree bit for bit (up to a draw that a
    # reduction-order rounding flips); after the first flip the two
    # trajectories are different draws of the same law.
    T, N = sizes.T_particles, 4096
    xs, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    mesh = make_mesh(devices=jax.devices()[:4], axis_names=(PARTICLES,))
    shard = NamedSharding(mesh, P(PARTICLES))

    def fwd(constrain):
        return jax.jit(lambda k, x: csmc.forward_pass(
            k, x, M0, G0, Mt, Gt, N, resampling.multinomial,
            constrain=constrain))

    sharded = fwd(lambda z: jax.lax.with_sharding_constraint(z, shard))
    single = fwd(None)
    first_step, all_equal = [], []
    for seed in range(4):
        a = sharded(jax.random.key(seed), xs)
        b = single(jax.random.key(seed), xs)
        anc_a, anc_b = np.asarray(a[3]), np.asarray(b[3])
        first_step.append(float(np.mean(anc_a[0] == anc_b[0])))
        all_equal.append(bool(all(np.array_equal(np.asarray(u), np.asarray(v))
                                  for u, v in zip(a, b))))
    placed = devices_of(a[1])

    # One whole kernel step on four cards, with each backward pass.
    finite = []
    for backward in (False, True):
        init, kernel = get_sharded_kernel(M0, G0, Mt, Gt, N, mesh,
                                          backward=backward)
        st = jax.block_until_ready(jax.jit(kernel)(jax.random.key(10),
                                                   init(xs)))
        finite.append(bool(np.isfinite(np.asarray(st.x)).all()))
    emit(phase="4chips", path="particles", T=T, N=N, devices=placed,
         keys=4, forward_bitwise_identical=all_equal,
         first_step_ancestor_agreement=first_step,
         kernel_step_finite={"genealogy": finite[0], "sampling": finite[1]})
    check(placed == sorted(d.id for d in jax.devices()[:4]),
          f"particles not spread over four cards: {placed}")
    check(min(first_step) >= 0.99,
          f"sharded first resampling step disagrees: {first_step}")
    check(all(finite), "particle-sharded kernel state not finite")


def time_axis(jax):
    import importlib
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from aux_ssm_tpu.parallel.mesh import make_mesh
    from aux_ssm_tpu.parallel.time_scan import sharded_filtering_scan, TIME
    F = importlib.import_module("aux_ssm_tpu.ops.filtering")

    # The time-sharded associative filter scan vs the single-device scan,
    # on the headline model's elements.
    T, dx = 257, 16
    arrays, ys = graft._lgssm_arrays(T, dx)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = (jnp.asarray(z, jnp.float32)
                                      for z in arrays)
    ysj = jnp.asarray(ys, jnp.float32)
    with jax.default_matmul_precision("highest"):
        m0u, P0u, _ = F.kalman_update(ysj[0], m0, P0, Hs[0], cs[0], Rs[0])
        elems = F._make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:],
                                             cs[1:], ysj[1:], m0u, P0u)
        mesh = make_mesh(devices=jax.devices()[:4], axis_names=(TIME,))
        got = jax.block_until_ready(sharded_filtering_scan(mesh, elems))
        want = jax.block_until_ready(jax.jit(
            lambda e: jax.lax.associative_scan(F.filtering_operator, e))(elems))
    err = max(norm_rel(g, w) for g, w in zip(got[1:3], want[1:3]))
    placed = devices_of(got[1])
    emit(phase="4chips", path="time", T=T - 1, d=dx, devices=placed,
         means_covs_max_norm_rel_diff=err)
    check(len(placed) == 4, f"time scan not spread over four cards: {placed}")
    check(err < 1e-4, f"time-sharded scan differs from one device by {err}")


# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: run only the multi-card path on four cards")
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from aux_ssm_tpu.config import enable_compile_cache
    cache = enable_compile_cache()
    count = 4 if args.chips == 4 else 1
    emit(phase=0, platform=dev.platform, kind=dev.device_kind,
         device_count=len(jax.devices()), cards_used=count, nvidia_smi=smi,
         jax_version=jax.__version__, compile_cache=cache)

    sizes = SimpleNamespace(
        T_head=1024, n_head=300, burn_head=200, n_exact=100,
        n_sv=200, burn_sv=300,
        N_pit=4096, n_pit=3, grid=3, n_rare=2000, burn_rare=500,
        n_multi=20, T_particles=1024)
    if args.chips == 4:
        multichip(jax, sizes)
    else:
        for phase in (phase1, phase2, phase3):
            tic = time.perf_counter()
            phase(jax, sizes)
            emit(phase=phase.__name__, done=True,
                 seconds=time.perf_counter() - tic)
    emit(total_seconds=time.perf_counter() - t_start)
    if FAILED:
        sys.exit(f"{len(FAILED)} check(s) failed: {FAILED}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()

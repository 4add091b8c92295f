"""Generic MCMC experiment loop.

Capability parity with the reference drivers' `loop(...)` pattern
(`examples/stochastic_volatility/experiment.py:88-128,159-182`): burn-in with
delta adaptation (linearly decaying learning rate, acceptance-window EMA),
then a frozen-delta sampling phase with online EJSD/moment statistics.

Differences: one typed config instead of argparse; each phase is a
`lax.scan` (jit-compiled once); timing uses host-side `block_until_ready`
around the dispatched scan rather than in-graph io_callback pairs; progress
printing via `jax.debug.callback` is optional. All loop state is a pytree,
so the same loop runs vmapped over chains and sharded over a device mesh.

Checkpoint/resume (no reference counterpart — SURVEY §5 build requirement):
pass `checkpoint_dir` (+ `checkpoint_every`) to `run_chain` and the loop runs
in segments, persisting the full loop state (phase, iteration, sampler state,
delta, statistics, collected samples) after each segment as `.npz` files
(`utils/checkpoint.py`). Per-iteration keys come from
`fold_in(phase_key, global_iter)`, so a killed-and-resumed run continues the
exact key stream: segmented, resumed, and monolithic runs are bitwise
identical.
"""
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import chex
import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.adaptation import delta_adaptation
from ..utils.stats import OnlineStats, init_stats, update_stats

_BURNIN_PHASE, _SAMPLE_PHASE = 0, 1


@dataclass(frozen=True)
class RunConfig:
    """Schedule and adaptation configuration for one experiment run."""
    n_samples: int = 1000
    burnin: int = 100
    target_alpha: float = 0.5
    delta_init: float = 1e-2
    learning_rate: float = 0.1
    beta: float = 0.05          # acceptance EMA window rate
    min_delta: float = 1e-20
    max_delta: float = 1e20
    adapt_on_window: bool = True  # adapt on windowed (vs cumulative) rate
    verbose: bool = False
    print_every: int = 100


@chex.dataclass
class RunResult:
    """Outputs of `run_chain`."""
    state: Any              # final sampler state
    stats: OnlineStats      # sampling-phase online statistics
    delta: chex.Array       # final (adapted) delta
    samples: Optional[Any]  # stacked trajectories if requested
    sampling_time: float    # wall-clock seconds of the sampling phase


def _phase_segment(kernel: Callable, n_total: int, adapt: bool, collect: bool,
                   cfg: RunConfig, get_stats_x, length: int,
                   collect_fn: Callable = None):
    """Jitted scan over `length` kernel steps starting at a (traced) global
    iteration index. Keys are `fold_in(phase_key, i)` per global step, so any
    segmentation of [0, n_total) yields the same chain."""

    def seg(phase_key, state, delta, stats, start):
        idxs = start + jnp.arange(length, dtype=jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(phase_key, i))(idxs)

        def step(carry, inp):
            i, key = inp
            state, delta, stats = carry
            x_prev = get_stats_x(state)
            new_state = kernel(key, state, delta)
            stats = update_stats(stats, x_prev, get_stats_x(new_state),
                                 new_state.updated, beta=cfg.beta)
            if adapt:
                lr = cfg.learning_rate * (n_total - i.astype(jnp.float32)) / n_total
                rate = stats.accept_win if cfg.adapt_on_window else stats.accept_cum
                # A per-time-step acceptance vector adapts a (T,) delta
                # elementwise; a scalar delta adapts on the mean rate.
                if jnp.ndim(rate) > jnp.ndim(delta):
                    rate = jnp.mean(rate)
                delta = delta_adaptation(delta, cfg.target_alpha, rate, lr,
                                         cfg.min_delta, cfg.max_delta)
            if cfg.verbose:
                def _report(it, dmin, dmax, aw, ac):
                    if int(it) % cfg.print_every == 0:
                        print(f"    iter {int(it):>7d}  delta[{float(dmin):.3e},"
                              f"{float(dmax):.3e}]  acc_win {float(aw):.3f}  "
                              f"acc_cum {float(ac):.3f}", flush=True)
                jax.debug.callback(_report, i, jnp.min(delta), jnp.max(delta),
                                   jnp.mean(stats.accept_win),
                                   jnp.mean(stats.accept_cum))
            out = ((collect_fn or get_stats_x)(new_state)
                   if collect else None)
            return (new_state, delta, stats), out

        (state, delta, stats), xs = jax.lax.scan(
            step, (state, delta, stats), (idxs, keys))
        return state, delta, stats, xs

    return jax.jit(seg)


def _save(directory, payload, step):
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(directory, step, jax.tree.map(np.asarray, payload))


def run_chain(key, kernel: Callable, init_state, cfg: RunConfig,
              collect_samples: bool = False,
              get_stats_x: Callable = lambda s: s.x,
              delta_init=None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0,
              collect_fn: Callable = None) -> RunResult:
    """Burn-in with adaptation, then frozen-delta sampling.

    `kernel(key, state, delta) -> state` per the universal contract.
    `delta_init` (optional) overrides cfg.delta_init and may be a per-step
    (T,) vector (cSMC-style time-local adaptation).
    `collect_fn` (optional) overrides what `collect_samples` records per
    iteration (default `get_stats_x`, i.e. the trajectory) — e.g. a Gibbs
    chain's parameter block (`lambda s: s.theta`), whose full trace is tiny
    next to the trajectory history.

    With `checkpoint_dir` set, the loop persists its full state every
    `checkpoint_every` iterations (default: end of each phase) and resumes
    from the latest checkpoint if one exists — bitwise-identically to an
    uninterrupted run.

    Returns a `RunResult`; `sampling_time` excludes burn-in and compilation
    (each phase's program is compiled before its timer starts).
    """
    burn_key, sample_key = jax.random.split(jax.random.fold_in(key, 0))
    delta = jnp.asarray(cfg.delta_init if delta_init is None else delta_init)
    n_burn = max(cfg.burnin, 1)

    phase = _BURNIN_PHASE
    it = 0
    state = init_state
    stats = init_stats(get_stats_x(state), accept_shape=jnp.shape(state.updated))
    sample_stats = stats
    # Collected samples accumulate host-side into ONE preallocated buffer
    # (lazily sized from the first segment): appending + per-checkpoint
    # re-concatenation would copy the whole history O(n_segments) times.
    sample_buf = None
    n_collected = 0
    sampling_time = 0.0

    def _ensure_buf(first_np):
        nonlocal sample_buf
        if sample_buf is None:
            sample_buf = np.zeros((cfg.n_samples,) + first_np.shape[1:],
                                  dtype=first_np.dtype)

    # The (possibly empty) collected-sample buffer is stored padded to >=1
    # rows alongside its true row count.
    def _samples_payload():
        shape = np.shape((collect_fn or get_stats_x)(state))
        dtype = np.asarray((collect_fn or get_stats_x)(state)).dtype
        if not collect_samples:
            return np.zeros((1, 1), dtype=np.float32), 0
        if n_collected:
            return sample_buf[:n_collected], n_collected
        return np.zeros((1,) + shape, dtype=dtype), 0

    if checkpoint_dir:
        from ..utils.checkpoint import latest_step, restore_checkpoint
        if latest_step(checkpoint_dir) is not None:
            # Two-step restore: raw first (the samples buffer's leading axis
            # grows between checkpoints, so its shape isn't known up front),
            # then targeted so dataclass pytree structure comes back intact.
            step_found, raw = restore_checkpoint(checkpoint_dir)
            buf0, n0 = _samples_payload()
            example = {
                "phase": 0, "iter": 0,
                "state": jax.tree.map(np.asarray, state),
                "delta": np.asarray(delta),
                "stats": jax.tree.map(np.asarray, stats),
                "samples": np.zeros(np.shape(raw["samples"]), dtype=buf0.dtype),
                "n_collected": n0,
                "sampling_time": 0.0,
            }
            _, restored = restore_checkpoint(checkpoint_dir, step=step_found,
                                             target=example)
            phase = int(restored["phase"])
            it = int(restored["iter"])
            state = jax.tree.map(jnp.asarray, restored["state"])
            delta = jnp.asarray(restored["delta"])
            stats = jax.tree.map(jnp.asarray, restored["stats"])
            sampling_time = float(restored["sampling_time"])
            if phase == _SAMPLE_PHASE:
                sample_stats = stats
                n_prev = int(restored["n_collected"])
                if collect_samples and n_prev:
                    prev = np.asarray(restored["samples"])[:n_prev]
                    _ensure_buf(prev)
                    sample_buf[:n_prev] = prev
                    n_collected = n_prev

    def run_phase(phase_id, phase_key, n_total, adapt, collect, start, state,
                  delta, stats, timed):
        nonlocal sampling_time, n_collected
        every = checkpoint_every if (checkpoint_dir and checkpoint_every > 0) \
            else n_total
        segs = {}
        t = start
        while t < n_total:
            length = min(every, n_total - t)
            if length not in segs:
                fn = _phase_segment(kernel, n_total, adapt, collect, cfg,
                                    get_stats_x, length,
                                    collect_fn=collect_fn)
                segs[length] = fn.lower(phase_key, state, delta, stats,
                                        jnp.int32(t)).compile()
            jax.block_until_ready((state, delta, stats))
            tic = time.perf_counter()
            state, delta, stats, xs = segs[length](
                phase_key, state, delta, stats, jnp.int32(t))
            jax.block_until_ready((state, delta, stats, xs))
            if timed:
                sampling_time += time.perf_counter() - tic
            t += length
            if collect:
                xs_np = np.asarray(xs)
                _ensure_buf(xs_np)
                sample_buf[n_collected:n_collected + xs_np.shape[0]] = xs_np
                n_collected += xs_np.shape[0]
            if checkpoint_dir:
                buf, n_coll = _samples_payload()
                _save(checkpoint_dir, {
                    "phase": phase_id, "iter": t,
                    "state": state, "delta": delta, "stats": stats,
                    "samples": buf, "n_collected": n_coll,
                    "sampling_time": sampling_time,
                }, step=phase_id * 10 ** 9 + t)
        return state, delta, stats

    if phase == _BURNIN_PHASE:
        state, delta, stats = run_phase(
            _BURNIN_PHASE, burn_key, n_burn, True, False, it, state, delta,
            stats, timed=False)
        it = 0
        sample_stats = init_stats(get_stats_x(state),
                                  accept_shape=jnp.shape(state.updated))
        phase = _SAMPLE_PHASE

    state, delta, sample_stats = run_phase(
        _SAMPLE_PHASE, sample_key, cfg.n_samples, False, collect_samples, it,
        state, delta, sample_stats, timed=True)

    samples = None
    if collect_samples:
        # Host array on purpose: every consumer post-processes with NumPy;
        # shipping the full sample history back to the device would be a
        # gratuitous H2D copy of the run's largest buffer.
        samples = (sample_buf[:n_collected] if n_collected
                   else np.zeros((0,), dtype=np.float32))

    return RunResult(state=state, stats=sample_stats, delta=delta,
                     samples=samples, sampling_time=sampling_time)

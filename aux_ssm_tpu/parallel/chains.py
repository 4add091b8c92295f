"""Chain-parallel execution: many independent MCMC chains sharded over the
`chains` mesh axis.

The reference fakes this with `xla_force_host_platform_device_count` + vmap
on CPU (`examples/rare_event/experiment.py:21,189-196`). Here it is a
first-class path: the per-chain kernel is vmapped, chain-indexed PRNG keys
are derived with `fold_in` (so the key stream is independent of the mesh
layout — SURVEY hard-part 6), all chain-local state (trajectory, delta,
online stats) carries the leading chain axis sharded with NamedSharding,
and cross-chain reductions (aggregate acceptance, pooled moments) are
ordinary jnp means that GSPMD lowers to a psum.

The chain steps themselves run under `shard_map`: each device runs the
vmapped program on its own chains, with no collective. (Left to GSPMD, the
partitioner all-gathered the chain axis around the batched triangular
solves of a cSMC step, so every device solved for every chain, and on the
GPU the replicated solve rounded differently from the per-device one.)
A sharded chain is therefore the same program, bit for bit, as the same
chains run on one device at the per-device batch (`--n-chains 8
--mesh-chains 4` against two chains per program); a batch of one chain
compiles differently again.

Like the single-chain `run_chain`, the sharded runner executes in SEGMENTS:
collected samples are streamed to ONE host-side buffer per segment (device
memory is bounded by the segment length, not n_samples — a 32-chain SV
reference run would otherwise pin a ~10 GB (chains, n_samples, T, d) buffer
on device), and with `checkpoint_dir` set the full loop state persists as
`.npz` files after each segment. Per-iteration keys are `fold_in(phase_key,
global_iter)` per chain, so segmented, killed-and-resumed, and monolithic
runs are bitwise identical.
"""
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import CHAINS
from ..experiments.runner import RunConfig, RunResult, _phase_segment, \
    _BURNIN_PHASE, _SAMPLE_PHASE
from ..utils.stats import init_stats


def shard_chains(mesh, tree):
    """Place every leaf's leading (chain) axis on the `chains` mesh axis."""
    sharding = NamedSharding(mesh, P(CHAINS))
    return jax.tree.map(lambda z: jax.device_put(z, sharding), tree)


def chain_keys(key, n_chains):
    """Mesh-layout-independent per-chain keys via fold_in."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_chains))


def chains_segment(seg, mesh=None):
    """A phase segment `seg(key, state, delta, stats, start)` vmapped over
    the leading chain axis and jitted; with a mesh, under `shard_map`, so
    each device steps its own chains with no collective."""
    fn = jax.vmap(seg, in_axes=(0, 0, 0, 0, None))
    if mesh is not None:
        fn = shard_map(fn, mesh=mesh, in_specs=(P(CHAINS),) * 4 + (P(),),
                       out_specs=P(CHAINS), check_vma=False)
    return jax.jit(fn)


def _save(directory, payload, step):
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(directory, step, jax.tree.map(np.asarray, payload))


def _init_chain_stats(states, get_stats_x, n_chains):
    """Per-chain OnlineStats — identical to vmapping `init_stats` over the
    chain axis (the batched arrays already carry it; only `step` needs an
    explicit (n_chains,) broadcast)."""
    per = init_stats(get_stats_x(states), accept_shape=jnp.shape(states.updated))
    return per.replace(step=jnp.zeros((n_chains,), jnp.int32))


def run_sharded_chains(key, kernel: Callable, init_states, cfg: RunConfig,
                       mesh=None, collect_samples: bool = False,
                       get_stats_x: Callable = lambda s: s.x,
                       delta_init=None,
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_every: int = 0,
                       collect_fn: Callable = None):
    """Run `n_chains` independent chains (leading axis of `init_states`)
    through burn-in + sampling, sharded over `mesh`'s chains axis.

    `key` is one PRNG key, from which chain i draws with `fold_in(key, i)`,
    or an (n_chains,) array of such chain keys: a slice of
    `chain_keys(key, K)` reruns those chains of a K-chain ensemble.

    With `checkpoint_dir` set, the loop persists its full state (phase,
    iteration, per-chain sampler states/deltas/stats, collected samples)
    every `checkpoint_every` iterations (default: end of each phase) and
    resumes bitwise-identically from the latest checkpoint.

    Returns a `RunResult`; every output keeps the leading chain axis
    (`samples` is a HOST array of shape (n_chains, n_samples, ...)), and
    `sampling_time` excludes burn-in and compilation like `run_chain`'s.
    Aggregate the stats with `aggregate_chain_stats`.
    """
    n_chains = jax.tree.leaves(get_stats_x(init_states))[0].shape[0]
    keys = key if key.ndim else chain_keys(key, n_chains)
    burn_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    sample_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)

    if delta_init is None:
        delta_init = jnp.full((n_chains,), cfg.delta_init)
    deltas = jnp.asarray(delta_init)

    def place(tree):
        return shard_chains(mesh, tree) if mesh is not None else tree

    states = place(init_states)
    deltas = place(deltas)
    burn_keys = place(burn_keys)
    sample_keys = place(sample_keys)

    phase = _BURNIN_PHASE
    it = 0
    stats = _init_chain_stats(states, get_stats_x, n_chains)
    sample_stats = stats
    sample_buf = None          # host (n_chains, n_samples, ...) buffer
    n_collected = 0

    def _ensure_buf(first_np):
        nonlocal sample_buf
        if sample_buf is None:
            sample_buf = np.zeros(
                (n_chains, cfg.n_samples) + first_np.shape[2:], first_np.dtype)

    def _samples_payload():
        if not collect_samples:
            return np.zeros((1, 1), np.float32), 0
        if n_collected:
            return sample_buf[:, :n_collected], n_collected
        shape = np.shape((collect_fn or get_stats_x)(states))
        dtype = np.asarray(jax.tree.leaves(
            (collect_fn or get_stats_x)(states))[0]).dtype
        return np.zeros((shape[0], 1) + shape[1:], dtype), 0

    if checkpoint_dir:
        from ..utils.checkpoint import latest_step, restore_checkpoint
        if latest_step(checkpoint_dir) is not None:
            step_found, raw = restore_checkpoint(checkpoint_dir)
            buf0, _ = _samples_payload()
            example = {
                "phase": 0, "iter": 0,
                "state": jax.tree.map(np.asarray, states),
                "delta": np.asarray(deltas),
                "stats": jax.tree.map(np.asarray, stats),
                "samples": np.zeros(np.shape(raw["samples"]), buf0.dtype),
                "n_collected": 0,
            }
            _, restored = restore_checkpoint(checkpoint_dir, step=step_found,
                                             target=example)
            phase = int(restored["phase"])
            it = int(restored["iter"])
            states = place(jax.tree.map(jnp.asarray, restored["state"]))
            deltas = place(jnp.asarray(restored["delta"]))
            stats = place(jax.tree.map(jnp.asarray, restored["stats"]))
            if phase == _SAMPLE_PHASE:
                sample_stats = stats
                n_prev = int(restored["n_collected"])
                if collect_samples and n_prev:
                    prev = np.asarray(restored["samples"])[:, :n_prev]
                    _ensure_buf(prev)
                    sample_buf[:, :n_prev] = prev
                    n_collected = n_prev

    sampling_time = 0.0

    def run_phase(phase_id, phase_keys, n_total, adapt, collect, start, states,
                  deltas, stats, timed=False):
        nonlocal n_collected, sampling_time
        every = checkpoint_every if (checkpoint_dir and checkpoint_every > 0) \
            else n_total
        segs = {}
        t = start
        while t < n_total:
            length = min(every, n_total - t)
            if length not in segs:
                seg = _phase_segment(kernel, n_total, adapt, collect, cfg,
                                     get_stats_x, length,
                                     collect_fn=collect_fn)
                fn = chains_segment(seg, mesh)
                segs[length] = fn.lower(phase_keys, states, deltas, stats,
                                        jnp.int32(t)).compile()
            jax.block_until_ready((states, deltas, stats))
            tic = time.perf_counter()
            states, deltas, stats, xs = segs[length](
                phase_keys, states, deltas, stats, jnp.int32(t))
            jax.block_until_ready((states, deltas, stats, xs))
            if timed:
                sampling_time += time.perf_counter() - tic
            t += length
            if collect:
                xs_np = np.asarray(xs)          # (n_chains, length, ...)
                _ensure_buf(xs_np)
                sample_buf[:, n_collected:n_collected + xs_np.shape[1]] = xs_np
                n_collected += xs_np.shape[1]
            if checkpoint_dir:
                buf, n_coll = _samples_payload()
                _save(checkpoint_dir, {
                    "phase": phase_id, "iter": t,
                    "state": states, "delta": deltas,
                    "stats": stats, "samples": buf,
                    "n_collected": n_coll,
                }, step=phase_id * 10 ** 9 + t)
        return states, deltas, stats

    if phase == _BURNIN_PHASE:
        states, deltas, stats = run_phase(
            _BURNIN_PHASE, burn_keys, max(cfg.burnin, 1), True, False, it,
            states, deltas, stats)
        it = 0
        sample_stats = _init_chain_stats(states, get_stats_x, n_chains)
        phase = _SAMPLE_PHASE

    states, deltas, sample_stats = run_phase(
        _SAMPLE_PHASE, sample_keys, cfg.n_samples, False, collect_samples, it,
        states, deltas, sample_stats, timed=True)

    samples = None
    if collect_samples:
        samples = (sample_buf[:, :n_collected] if n_collected
                   else np.zeros((n_chains, 0), np.float32))
    return RunResult(state=states, stats=sample_stats, delta=deltas,
                     samples=samples, sampling_time=sampling_time)


def aggregate_chain_stats(stats):
    """Cross-chain means of the online statistics (GSPMD lowers the reduction
    over the sharded chain axis to a psum across chips)."""
    return jax.tree.map(lambda z: jnp.mean(z, axis=0), stats)

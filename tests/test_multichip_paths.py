"""The multi-card paths that `chip_smoke.py --chips 4` checks, run on four of
the virtual CPU devices at reduced sizes: the script's own comparisons must
pass here before they mean anything on the cards."""
import pathlib
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def failed():
    chip_smoke.FAILED.clear()
    yield chip_smoke.FAILED
    chip_smoke.FAILED.clear()


def test_sharded_chains_match_one_card_at_the_per_card_batch(failed):
    chip_smoke.chains(jax, SimpleNamespace(n_multi=3))
    assert failed == []


def test_chain_diffs_reports_first_differing_sample():
    a = np.zeros((2, 4, 3))
    b = a.copy()
    b[1, 2, 0] = 0.5
    b[1, 3, 1] = 2.0
    assert chip_smoke.chain_diffs(a, b) == ([0.0, 2.0], [None, 2])


def test_particle_sharded_csmc_matches_one_device(failed):
    chip_smoke.particles(jax, SimpleNamespace(T_particles=16))
    assert failed == []


def test_time_sharded_scan_matches_one_device(failed):
    chip_smoke.time_axis(jax)
    assert failed == []


def _small_sv_chains(n_chains):
    import jax.numpy as jnp
    from aux_ssm_tpu.experiments import RunConfig
    from aux_ssm_tpu.models import stochastic_volatility as sv

    T, D = 16, 4
    _, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, D, T)
    init, kernel = sv.get_csmc_kernel(ys, 0.0, 0.9, 2.0, 0.25, 8,
                                      backward=True)
    states = jax.tree.map(lambda z: jnp.broadcast_to(z, (n_chains,) + z.shape),
                          init(jnp.zeros((T, D))))
    cfg = RunConfig(n_samples=4, burnin=4, delta_init=0.1, verbose=False)
    return kernel, states, cfg, 0.1 * jnp.ones((n_chains, T))


def test_sharded_chain_segment_has_no_collective():
    """Each device steps its own chains: no all-gather of the chain axis
    (GSPMD, left to itself, gathered it around the batched solves)."""
    import re
    from aux_ssm_tpu.experiments.runner import _phase_segment
    from aux_ssm_tpu.parallel.chains import (chain_keys, chains_segment,
                                             shard_chains, _init_chain_stats)
    from aux_ssm_tpu.parallel.mesh import make_mesh, CHAINS

    kernel, states, cfg, deltas = _small_sv_chains(8)
    mesh = make_mesh(devices=jax.devices()[:4], axis_names=(CHAINS,))
    stats = _init_chain_stats(states, lambda s: s.x, 8)
    args = [shard_chains(mesh, t) for t in
            (chain_keys(jax.random.key(1), 8), states, deltas, stats)]
    seg = _phase_segment(kernel, 4, True, True, cfg, lambda s: s.x, 4)
    text = chains_segment(seg, mesh).lower(
        *args, jax.numpy.int32(0)).compile().as_text()
    assert not re.search(
        r"(all-gather|all-reduce|all-to-all|collective-permute)(-start)?\(",
        text)


def test_chain_key_slice_reruns_those_chains():
    from aux_ssm_tpu.parallel.chains import chain_keys, run_sharded_chains

    kernel, states, cfg, deltas = _small_sv_chains(8)
    key = jax.random.key(3)
    whole = run_sharded_chains(key, kernel, states, cfg, collect_samples=True,
                               delta_init=deltas)
    part = run_sharded_chains(chain_keys(key, 8)[2:4], kernel,
                              jax.tree.map(lambda z: z[2:4], states), cfg,
                              collect_samples=True, delta_init=deltas[2:4])
    np.testing.assert_array_equal(part.samples, whole.samples[2:4])

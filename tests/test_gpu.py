"""Checks that only mean something on the card: f32 filtering at the
headline size under the GPU's own matmul lowering. Skipped where JAX finds
no GPU (see the `gpu` fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aux_ssm_tpu.ops.filtering import filtering
from aux_ssm_tpu.ops.lgssm import LGSSM

from oracles import explicit_filter


@pytest.mark.gpu
@pytest.mark.parametrize("parallel", [True, False])
def test_f32_filter_on_gpu_matches_f64_oracle(gpu, parallel):
    import __graft_entry__ as graft
    arrays, ys = graft._lgssm_arrays(1024, 16)
    lg = LGSSM(*(jax.device_put(jnp.asarray(z, jnp.float32), gpu)
                 for z in arrays))
    with jax.default_matmul_precision("highest"):
        ms, Ps, ell = filtering(jax.device_put(jnp.asarray(ys, jnp.float32),
                                               gpu), lg, parallel)
    want_m, want_P, want_ell = explicit_filter(ys, *arrays)
    for got, want in ((ms, want_m), (Ps, want_P)):
        got = np.asarray(got, np.float64)
        err = np.abs(got - want).reshape(1024, -1).max(1)
        scale = np.abs(want).reshape(1024, -1).max(1)
        assert (err / scale).max() < 1e-3
    assert abs(float(ell) - want_ell) < 1e-3 * abs(want_ell)

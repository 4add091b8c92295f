"""Base sampler state (parity: `_primitives/base.py:8-10`) and the matmul
precision every particle kernel runs at."""
import functools

import chex
import jax


def f32_matmuls(kernel):
    """Trace `kernel` with f32 matmul products ("highest" precision). On the
    GPU, f32 matmuls default to TF32 (about three decimal digits); proposals
    and their weights go through different contractions, so that rounding
    does not cancel in the weights (measured on the H100: the SV
    csmc-guided update rate fell from 0.96 to 0.004 under the default)."""
    @functools.wraps(kernel)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return kernel(*args, **kwargs)
    return wrapped


@chex.dataclass
class SamplerState:
    """Base class for all sampler states: a pytree with the trajectory `x`."""
    x: chex.ArrayTree

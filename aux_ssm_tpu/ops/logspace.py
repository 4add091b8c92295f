"""Log-space utilities.

Capability parity with the reference's `_primitives/math/utils.py:11-39`
(logsubexp, log1mexp, normalize) — written independently.
"""
import math
from functools import partial

import jax.numpy as jnp
from jax.scipy.special import logsumexp

_LOG_HALF = math.log(0.5)


def log1mexp(x):
    """Numerically stable log(1 - exp(x)) for x <= 0.

    Uses the standard two-regime split (Maechler 2012): log1p(-exp(x)) when
    x < log(1/2), log(-expm1(x)) otherwise.
    """
    x = jnp.asarray(x)
    # Evaluate both branches on safe inputs and select — cheap, branch-free
    # (no lax.cond inside vectorized code).
    small = x < _LOG_HALF
    safe_lo = jnp.where(small, x, _LOG_HALF)
    safe_hi = jnp.where(small, _LOG_HALF, x)
    return jnp.where(small, jnp.log1p(-jnp.exp(safe_lo)), jnp.log(-jnp.expm1(safe_hi)))


@partial(jnp.vectorize, signature="(),()->()")
def logsubexp(x1, x2):
    """log|exp(x1) - exp(x2)| computed stably."""
    amax = jnp.maximum(x1, x2)
    delta = jnp.abs(x1 - x2)
    return amax + log1mexp(-delta)


def normalize(log_weights, axis=None):
    """Exponentiate-and-normalize log weights (softmax over `axis`).

    Matches the reference semantics (`math/utils.py:23-39`): returns
    probabilities summing to 1 over `axis` (default: all elements).
    """
    log_weights = log_weights - logsumexp(log_weights, axis=axis, keepdims=axis is not None)
    return jnp.exp(log_weights)

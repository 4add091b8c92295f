"""Batched gathers and inverse-CDF categorical draws, as plain XLA ops.

`take_rows` is `jnp.take_along_axis` along the particle axis and
`categorical_from_uniforms` an inverse-CDF draw by `searchsorted` over the
cumulative weights: the lowerings the GPU runs fastest at the PIT and cSMC
draw shapes (see PERF.md).
"""
import jax
import jax.numpy as jnp


def take_rows(vals, idx):
    """Batched `vals[..., idx, :]` along the second-to-last (or last) axis.

    vals (..., N) or (..., N, d); idx (..., n) int32 with matching leading
    batch dims. Returns (..., n) or (..., n, d).
    """
    if vals.ndim == idx.ndim:             # (..., N) scalar-valued case
        return jnp.take_along_axis(vals, idx, axis=-1)
    return jnp.take_along_axis(vals, idx[..., None], axis=-2)


def categorical_from_uniforms(logits, u):
    """n iid inverse-CDF categorical draws over N from unnormalised
    log-probs. logits (..., N); u (..., n) uniforms in (0, 1) -> (..., n)
    int32. Never materialises an (n, N) comparison."""
    m = jnp.max(logits, axis=-1, keepdims=True)
    cdf = jnp.cumsum(jnp.exp(logits - m), axis=-1)
    target = u * cdf[..., -1:]
    N = logits.shape[-1]
    if logits.ndim == 1:
        idx = jnp.searchsorted(cdf, target)
    else:
        flat_cdf = cdf.reshape(-1, N)
        flat_t = target.reshape(-1, target.shape[-1])
        idx = jax.vmap(jnp.searchsorted)(flat_cdf, flat_t).reshape(u.shape)
    return jnp.clip(idx, 0, N - 1).astype(jnp.int32)

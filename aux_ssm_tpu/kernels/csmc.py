"""Sequential conditional SMC (particle Gibbs) kernel.

Capability parity with `_primitives/csmc/csmc.py` (kernel factory :16-66,
forward pass :69-107, backward-scanning pass :110-124, backward-sampling pass
:127-149) — independent implementation. Unlike the reference (which hardwires
conditional multinomial, `csmc.py:54`), the resampling scheme is selectable.

The particle axis is the vectorisation axis: all model callables
(`M0.sample`, `G0`, `Mt.sample`, `Gt`) receive the full (N, d) particle
block; under a sharding constraint the same sweep runs with N sharded across
devices (see `csmc_sharded`). Models that offer a specialised protocol
(independent pair-factorised proposals, (1, N)-row or (d, N)-block
callables) run through the matching sweep of `ops/csmc_sweeps.py` instead —
same key stream, same law.
"""
import jax
import jax.numpy as jnp

from .base import f32_matmuls
from .csmc_base import CSMCState, Distribution, UnivariatePotential, Dynamics, Potential
from ..ops.logspace import normalize
from ..ops import csmc_sweeps
from ..ops import resampling as resampling_mod


def get_kernel(M0: Distribution, G0: UnivariatePotential, Mt: Dynamics, Gt: Potential,
               N: int, backward: bool = False, Pt: Dynamics = None,
               resampling="multinomial", ancestor_sampling: bool = False):
    """Build a cSMC kernel.

    Parameters
    ----------
    M0, G0, Mt, Gt : Feynman–Kac model components (see `csmc_base`).
    N : int
        Number of particles.
    backward : bool
        Use Whiteley backward *sampling* (requires `Pt.logpdf`) instead of
        ancestor *scanning*.
    Pt : Dynamics, optional
        True-model dynamics for backward/ancestor sampling; defaults to Mt.
    resampling : str or Callable
        'multinomial' (default), 'systematic', or a callable
        (key, weights) -> indices with index 0 pinned.
    ancestor_sampling : bool
        PGAS (Lindsten et al. 2014): redraw the reference particle's ancestor
        at every forward step from w_{t-1} * p(x*_t | x_{t-1}) (requires
        `Pt.logpdf`). Composes with either backward pass.

    Returns
    -------
    (init, kernel) following the universal kernel contract;
    kernel(key, state) -> CSMCState.
    """
    if (backward or ancestor_sampling) and Pt is None:
        Pt = Mt
    if (backward or ancestor_sampling) and not hasattr(Pt, "logpdf"):
        raise ValueError("backward/ancestor sampling requires `Pt` to implement logpdf.")
    resample = resampling_mod.get(resampling) if isinstance(resampling, str) else resampling

    @f32_matmuls
    def kernel(key, state):
        key_fwd, key_bwd = jax.random.split(key)
        w_T, xs, log_ws, ancestors = forward_pass(
            key_fwd, state.x, M0, G0, Mt, Gt, N, resample,
            ancestor_Pt=Pt if ancestor_sampling else None,
        )
        if backward and _use_factor_backward(Pt):
            x, picked = factor_backward_pass(key_bwd, Pt, w_T, xs, log_ws)
        elif backward:
            x, picked = backward_sampling_pass(key_bwd, Pt, w_T, xs, log_ws)
        else:
            x, picked = backward_scanning_pass(key_bwd, w_T, xs, ancestors)
        return CSMCState(x=x, updated=picked != 0)

    def init(x_star):
        T = x_star.shape[0]
        return CSMCState(x=x_star, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel


def _use_factor_forward(Mt, Gt, resample, ancestor_Pt):
    """The factor sweep applies when proposals are independent of the
    previous state (particle values are then resampling-invariant) and the
    step weight pair-factorises; PGAS additionally requires the ancestor
    transition to be the weight's own transition (so the reference scores
    come from the same factor tensors)."""
    if not (getattr(Mt, "independent", False)
            and getattr(Gt, "supports_pairwise_factors", False)
            and resample is resampling_mod.multinomial):
        return False
    return ancestor_Pt is None or ancestor_Pt is getattr(Gt, "trans", None)


def _factor_forward_pass(key, x_star, M0, G0, Mt, Gt, N, ancestor_Pt):
    """Precompute proposals + pair-factor tensors, then run the index/weight
    recursion (`csmc_sweeps.factor_scan`). Same key stream and law as the
    generic scan."""
    T = x_star.shape[0]
    key_init, key_res, key_prop, key_anc = jax.random.split(key, 4)

    x0 = M0.sample(key_init, N)
    x0 = x0.at[0].set(x_star[0])
    log_w0 = G0(x0)
    w0 = normalize(log_w0)

    res_u = jax.random.uniform(key_res, (T - 1, N), dtype=x0.dtype)
    eps = jax.random.normal(key_prop, (T - 1,) + x0.shape, dtype=x0.dtype)
    anc_u = jax.random.uniform(key_anc, (T - 1,), dtype=x0.dtype)

    # Independent proposals: values never depend on the previous state.
    xs_rest = jax.vmap(lambda e, p: Mt.sample_from_noise(e, e, p))(eps, Mt.params)
    xs_rest = xs_rest.at[:, 0].set(x_star[1:])
    xs = jnp.concatenate([x0[None], xs_rest], axis=0)

    rf, cf, rb, cb = jax.vmap(Gt.pairwise_factors)(xs[:-1], xs[1:], Gt.params)
    log_ws_rest, ancestors = csmc_sweeps.factor_scan(
        rf, cf, rb, cb, res_u, anc_u, w0, pgas=ancestor_Pt is not None)

    log_ws = jnp.concatenate([log_w0[None], log_ws_rest], axis=0)
    w_T = normalize(log_ws_rest[-1])
    return w_T, xs, log_ws, ancestors


def _use_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt):
    """Lane sweep (`csmc_sweeps.lane_scan`): scalar-state models that expose
    the (1, N)-row callables `lane_propagate` / `lane_logw` (and
    `lane_logpdf` for PGAS)."""
    if x_star.shape[-1] != 1:
        return False
    if not (hasattr(Mt, "lane_propagate") and hasattr(Gt, "lane_logw")
            and hasattr(Mt, "sample_from_noise")
            and resample is resampling_mod.multinomial):
        return False
    return ancestor_Pt is None or hasattr(ancestor_Pt, "lane_logpdf")


def _lane_forward_pass(key, x_star, M0, G0, Mt, Gt, N, ancestor_Pt):
    """Forward sweep through the model's lane callables; same key stream
    as the generic scan."""
    T = x_star.shape[0]
    key_init, key_res, key_prop, key_anc = jax.random.split(key, 4)

    x0 = M0.sample(key_init, N)
    x0 = x0.at[0].set(x_star[0])
    log_w0 = G0(x0)
    w0 = normalize(log_w0)

    res_u = jax.random.uniform(key_res, (T - 1, N), dtype=x0.dtype)
    eps = jax.random.normal(key_prop, (T - 1,) + x0.shape, dtype=x0.dtype)
    anc_u = jax.random.uniform(key_anc, (T - 1,), dtype=x0.dtype)

    pgas_fn = ancestor_Pt.lane_logpdf if ancestor_Pt is not None else None
    pt_params = ancestor_Pt.params if ancestor_Pt is not None else None

    xs_r, log_ws_r, ancestors = csmc_sweeps.lane_scan(
        Mt.lane_propagate, Gt.lane_logw, pgas_fn,
        Mt.params, Gt.params, pt_params,
        eps[:, :, 0], res_u, anc_u, x_star[1:, 0], x0[:, 0], w0)

    xs = jnp.concatenate([x0[None], xs_r[..., None]], axis=0)
    log_ws = jnp.concatenate([log_w0[None], log_ws_r], axis=0)
    w_T = normalize(log_ws_r[-1])
    return w_T, xs, log_ws, ancestors


def _use_block_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt):
    """Block-lane sweep (`csmc_sweeps.block_lane_scan`): state-dependent
    proposals for small-d models exposing the (d, N)-block callables
    `block_propagate` / `block_logw` (e.g. the SV guided proposal in Q's
    eigenbasis). No PGAS (the guided family uses backward sampling)."""
    if x_star.shape[-1] <= 1 or ancestor_Pt is not None:
        return False
    return (hasattr(Mt, "block_propagate") and hasattr(Gt, "block_logw")
            and resample is resampling_mod.multinomial)


def _block_lane_forward_pass(key, x_star, M0, G0, Mt, Gt, N):
    """Forward sweep through the model's (d, N)-block callables; same key
    stream as the generic scan (eps transposed from the generic (T-1, N, d)
    draw, so the consumed values are identical)."""
    T, d = x_star.shape
    key_init, key_res, key_prop, _key_anc = jax.random.split(key, 4)

    x0 = M0.sample(key_init, N)
    x0 = x0.at[0].set(x_star[0])
    log_w0 = G0(x0)
    w0 = normalize(log_w0)

    res_u = jax.random.uniform(key_res, (T - 1, N), dtype=x0.dtype)
    eps = jax.random.normal(key_prop, (T - 1,) + x0.shape, dtype=x0.dtype)

    xs_r, log_ws_r, ancestors = csmc_sweeps.block_lane_scan(
        Mt.block_propagate, Gt.block_logw, Mt.params, Gt.params,
        getattr(Mt, "block_consts", {}), getattr(Gt, "block_consts", {}),
        jnp.swapaxes(eps, 1, 2), res_u, x_star[1:], x0.T, w0)

    xs = jnp.concatenate([x0[None], jnp.swapaxes(xs_r, 1, 2)], axis=0)
    log_ws = jnp.concatenate([log_w0[None], log_ws_r], axis=0)
    w_T = normalize(log_ws_r[-1])
    return w_T, xs, log_ws, ancestors


def forward_pass(key, x_star, M0, G0, Mt, Gt, N, resample, constrain=None,
                 ancestor_Pt=None, unroll=4):
    """Conditional SMC forward sweep; particle 0 is pinned to `x_star`.

    `constrain` (optional) is applied to every particle-axis array — pass a
    `with_sharding_constraint` closure to run the sweep with N sharded over a
    `particles` mesh axis (GSPMD then lowers the resampling gather and weight
    normalisation to ICI collectives); see `csmc_sharded.get_sharded_kernel`.

    `ancestor_Pt` (optional Dynamics) turns on PGAS ancestor sampling: the
    reference particle's ancestor is redrawn from
    w_{t-1} * ancestor_Pt.logpdf(x*_t | x_{t-1}).

    Without a sharding constraint, models that offer a specialised protocol
    take the matching `ops/csmc_sweeps.py` sweep (factor, lane or
    block-lane), which consumes the same draws; otherwise the generic scan
    below runs.

    The per-step body of the `lax.scan` contains no PRNG work — per-step
    threefry splits would dominate the wall clock for small N (the step math
    is a handful of (N, d) elementwise ops). All randomness is therefore
    drawn in three vectorised batches up front:

      * resampling: (T-1, N) uniforms -> inverse-CDF multinomial (or
        (T-1, 3) uniforms for the systematic scheme) per step;
      * proposals: (T-1, N, d) standard normals, consumed through the
        optional ``Mt.sample_from_noise(eps, x_t, params)`` protocol
        (every location-scale Dynamics implements it; fall back to in-scan
        ``Mt.sample`` when absent);
      * PGAS ancestor draws: (T-1,) uniforms -> inverse CDF.
    """
    if x_star.shape[0] >= 2 and constrain is None:
        # (T == 1 stays generic: the specialised sweeps would take w_T from
        # an empty (0, N) log-weight stack.)
        if _use_factor_forward(Mt, Gt, resample, ancestor_Pt):
            return _factor_forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                        ancestor_Pt)
        if _use_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt):
            return _lane_forward_pass(key, x_star, M0, G0, Mt, Gt, N,
                                      ancestor_Pt)
        if _use_block_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt):
            return _block_lane_forward_pass(key, x_star, M0, G0, Mt, Gt, N)
    return generic_forward_pass(key, x_star, M0, G0, Mt, Gt, N, resample,
                                constrain, ancestor_Pt, unroll)


def generic_forward_pass(key, x_star, M0, G0, Mt, Gt, N, resample,
                         constrain=None, ancestor_Pt=None, unroll=4):
    """The cSMC forward sweep for any model: one `lax.scan` step per time
    index (see `forward_pass`)."""
    if constrain is None:
        constrain = lambda z: z
    T = x_star.shape[0]
    key_init, key_res, key_prop, key_anc = jax.random.split(key, 4)

    x0 = constrain(M0.sample(key_init, N))
    x0 = x0.at[0].set(x_star[0])
    log_w0 = G0(x0)
    w0 = normalize(log_w0)

    as_params = ancestor_Pt.params if ancestor_Pt is not None else Mt.params

    if resample is resampling_mod.multinomial:
        res_u = jax.random.uniform(key_res, (T - 1, N), dtype=x0.dtype)
        step_resample = resampling_mod.multinomial_from_uniforms
    elif resample is resampling_mod.systematic:
        res_u = jax.random.uniform(key_res, (T - 1, 3), dtype=x0.dtype)
        step_resample = resampling_mod.systematic_from_uniforms
    else:
        # Custom scheme: fall back to a per-step key.
        res_u = jax.random.split(key_res, T - 1)
        step_resample = resample

    hoist_noise = hasattr(Mt, "sample_from_noise")
    if hoist_noise:
        prop_in = jax.random.normal(key_prop, (T - 1,) + x0.shape, dtype=x0.dtype)
    else:
        prop_in = jax.random.split(key_prop, T - 1)

    anc_u = jax.random.uniform(key_anc, (T - 1,), dtype=x0.dtype)

    def body(carry, inp):
        w_prev, x_prev = carry
        Mt_params, Gt_params, Pt_params, x_star_t, r_t, p_t, ua_t = inp

        ancestors = step_resample(r_t, w_prev)
        if ancestor_Pt is not None:
            log_as = jnp.log(w_prev) + ancestor_Pt.logpdf(x_star_t, x_prev, Pt_params)
            a0 = resampling_mod.categorical_from_uniform(ua_t, normalize(log_as))
            ancestors = ancestors.at[0].set(a0)
        x_prev = constrain(jnp.take(x_prev, ancestors, axis=0))

        if hoist_noise:
            x_t = constrain(Mt.sample_from_noise(p_t, x_prev, Mt_params))
        else:
            x_t = constrain(Mt.sample(p_t, x_prev, Mt_params))
        x_t = x_t.at[0].set(x_star_t)

        log_w = Gt(x_t, x_prev, Gt_params)
        return (normalize(log_w), x_t), (x_t, log_w, ancestors)

    (w_T, _), (xs, log_ws, ancestors) = jax.lax.scan(
        body, (w0, x0),
        (Mt.params, Gt.params, as_params, x_star[1:], res_u, prop_in, anc_u),
        unroll=unroll,
    )
    xs = jnp.concatenate([x0[None], xs], axis=0)
    log_ws = jnp.concatenate([log_w0[None], log_ws], axis=0)
    return w_T, xs, log_ws, ancestors


def backward_scanning_pass(key, w_T, xs, ancestors):
    """Trace one genealogy backwards from a draw at the final step.

    The pointer chase B_t = A_t[B_{t+1}] is a suffix
    composition of index maps — an associative operation
    (f ∘ g)[i] = f[g[i]] — so the whole genealogy resolves in O(log T) depth
    via `lax.associative_scan` instead of a T-step sequential scan.
    """
    ancestors = ancestors.astype(jnp.int32)
    B_T = jax.random.choice(key, w_T.shape[0], p=w_T).astype(jnp.int32)

    if ancestors.shape[0] == 0:  # T == 1: nothing to trace
        return xs[-1, B_T][None], B_T[None]

    def compose(f, g):
        # Batched map composition matching `associative_scan(reverse=True)`'s
        # combination order: out[k] = g[k][f[k]] gives
        # suffix[t] = A_t ∘ A_{t+1} ∘ ... ∘ A_{T-2}.
        return jnp.take_along_axis(g, f, axis=-1)

    # suffix[t] = A_t ∘ A_{t+1} ∘ ... ∘ A_{T-2}; then B_t = suffix[t][B_T].
    suffix = jax.lax.associative_scan(compose, ancestors, reverse=True)
    picked = jnp.concatenate([suffix[:, B_T], B_T[None]], axis=0)
    traj = jnp.take_along_axis(
        xs, picked[:, None, None], axis=1
    )[:, 0]
    return traj, picked


def _use_factor_backward(Pt):
    """Backward sampling runs through pair factors when the true-model
    dynamics offer `logpdf_factors`."""
    return hasattr(Pt, "logpdf_factors")


def factor_backward_pass(key, Pt, w_T, xs, log_ws):
    """Whiteley backward sampling through precomputed pair factors
    (`csmc_sweeps.backward_factor_scan`); same key stream and law as
    `backward_sampling_pass`, for true-model dynamics with
    `logpdf_factors`."""
    T = xs.shape[0]
    us = jax.random.uniform(key, (T,), dtype=log_ws.dtype)
    B_T = resampling_mod.categorical_from_uniform(us[-1], w_T)

    rfP, cfP, rbP, _ = jax.vmap(Pt.logpdf_factors)(xs[:-1], xs[1:], Pt.params)
    picked_rest = csmc_sweeps.backward_factor_scan(rfP, cfP, rbP, log_ws[:-1],
                                                   us[:-1], B_T)

    picked = jnp.concatenate([picked_rest, B_T[None]], axis=0)
    traj = jnp.take_along_axis(xs, picked[:, None, None], axis=1)[:, 0]
    return traj, picked


def backward_sampling_pass(key, Pt: Dynamics, w_T, xs, log_ws, unroll=4):
    """Whiteley backward sampling: re-draw the index at every step using the
    smoothing weights log_w_t + log p(x_{t+1} | x_t).

    The index draws are inherently sequential (each depends on the chosen
    x_{t+1}), but the RNG is hoisted: one (T,) uniform batch up front,
    inverse-CDF categorical inside the scan."""
    T = xs.shape[0]
    us = jax.random.uniform(key, (T,), dtype=log_ws.dtype)

    B_T = resampling_mod.categorical_from_uniform(us[-1], w_T)
    x_T = xs[-1, B_T]

    def body(x_next, inp):
        u_t, xs_t, log_w_t, Pt_params = inp
        log_w = Pt.logpdf(x_next, xs_t, Pt_params) + log_w_t
        B_t = resampling_mod.categorical_from_uniform(u_t, normalize(log_w))
        return xs_t[B_t], (xs_t[B_t], B_t)

    inputs = (us[:-1], xs[:-1], log_ws[:-1], Pt.params)
    _, (traj, picked) = jax.lax.scan(body, x_T, inputs, reverse=True, unroll=unroll)
    traj = jnp.concatenate([traj, x_T[None]], axis=0)
    picked = jnp.concatenate([picked, B_T[None]], axis=0)
    return traj, picked

"""Specialised cSMC sweeps: `lax.scan` forms of the forward and backward
passes for model classes whose structure removes work from every step.

Each consumes the same hoisted uniforms/noise as the generic sweep in
`kernels/csmc.py` (same key stream, same law) and is chosen by
`kernels/csmc.forward_pass` whenever the model offers its protocol:

- `factor_scan` / `backward_factor_scan` — *independent* per-step proposals
  with a pair-factorising step weight. Resampling permutes particle indices
  but never changes the particle VALUES at a step (slot j at time t always
  holds the precomputed proposal xs[t, j]), and

      log_w_t[j] = col[t, j] + row_bias[t, anc[j]]
                   + row_feat[t, anc[j]] . col_feat[t, j]

  so every model evaluation is a precomputed tensor and the recursion is
  weight normalisation + categorical index draws.
- `lane_scan` — scalar-state models exposing (1, N)-row callables
  `lane_propagate` / `lane_logw` (and `lane_logpdf` for PGAS).
- `block_lane_scan` — small-d models exposing (d, N)-block callables
  `block_propagate` / `block_logw` (e.g. the SV guided proposal in Q's
  eigenbasis).
"""
import jax
import jax.numpy as jnp


def factor_scan(rf, cf, rb, cb, res_u, anc_u, w0, pgas=False):
    """Forward index/weight recursion over precomputed pair factors.

    rf, cf (T-1, N, k) row/column features; rb, cb (T-1, N) row/column
    biases; res_u (T-1, N) resampling uniforms; anc_u (T-1,) PGAS uniforms;
    w0 (N,) normalised initial weights -> (log_ws (T-1, N),
    ancestors (T-1, N) int32)."""
    N = rf.shape[1]

    def body(w, inp):
        rf_t, cf_t, rb_t, cb_t, u_t, ua_t = inp
        cw = jnp.cumsum(w)
        anc = jnp.searchsorted(cw, u_t).astype(jnp.int32)
        anc = jnp.clip(anc, 0, N - 1)
        if pgas:
            scoreA = jnp.log(jnp.maximum(w, 1e-37)) + rb_t + jnp.matmul(rf_t, cf_t[0], precision=jax.lax.Precision.HIGHEST)
            wA = jnp.exp(scoreA - jnp.max(scoreA))
            cwA = jnp.cumsum(wA)
            a0 = jnp.sum(cwA < ua_t * cwA[-1]).astype(jnp.int32)
            anc = anc.at[0].set(jnp.clip(a0, 0, N - 1))
        else:
            anc = anc.at[0].set(0)
        log_w = cb_t + rb_t[anc] + jnp.sum(rf_t[anc] * cf_t, axis=-1)
        wn = jnp.exp(log_w - jnp.max(log_w))
        return wn / jnp.sum(wn), (log_w, anc)

    _, (log_ws, anc) = jax.lax.scan(body, w0, (rf, cf, rb, cb, res_u, anc_u))
    return log_ws, anc


def backward_factor_scan(rf, cf, rb, log_ws, us, b_T):
    """Whiteley backward sampling through precomputed pair factors of the
    true-model transition: picks (T-1,) int32 given the last pick b_T."""
    def body(b_next, inp):
        rf_t, cf_t, rb_t, lw_t, u_t = inp
        score = lw_t + rb_t + jnp.matmul(rf_t, cf_t[b_next], precision=jax.lax.Precision.HIGHEST)
        w = jnp.exp(score - jnp.max(score))
        cw = jnp.cumsum(w)
        b = jnp.sum(cw < u_t * cw[-1]).astype(jnp.int32)
        b = jnp.clip(b, 0, rf_t.shape[0] - 1)
        return b, b

    _, picked = jax.lax.scan(body, b_T, (rf, cf, rb, log_ws, us), reverse=True)
    return picked


def _flatten_params(params, Tm1, N):
    leaves, treedef = jax.tree.flatten(params)
    arrays, mask = [], []
    for z in leaves:
        if z.size == 0:
            mask.append(False)
            continue
        mask.append(True)
        row = z.reshape(Tm1, -1)[:, :1]      # d = 1: one value per step
        arrays.append(jnp.broadcast_to(row[:, None, :], (Tm1, 1, N))
                      .astype(jnp.float32))
    return arrays, (treedef, mask)


def _unflatten_params(refs_or_rows, spec):
    treedef, mask = spec
    it = iter(refs_or_rows)
    leaves = [next(it) if m else jnp.zeros(()) for m in mask]
    return jax.tree.unflatten(treedef, leaves)


def lane_scan(propagate, logw, pgas_logpdf, mt_params, gt_params,
              pt_params, eps, res_u, anc_u, x_star, x0, w0):
    """Forward sweep of a scalar-state model through its (1, N)-row
    callables: `propagate(eps, x_prev, mt_p)`, `logw(x_next, x_prev, gt_p)`
    and, for PGAS, `pgas_logpdf(x_star_t, x_prev, pt_p)`. Per-step params
    arrive as (1, N) broadcast rows; zero-size leaves as () zeros.

    eps, res_u (T-1, N); anc_u (T-1,); x_star (T-1,); x0, w0 (N,) ->
    (xs (T-1, N), log_ws (T-1, N), ancestors (T-1, N) int32)."""
    Tm1, N = res_u.shape
    pgas = pgas_logpdf is not None
    m_arr, spec_m = _flatten_params(mt_params, Tm1, N)
    g_arr, spec_g = _flatten_params(gt_params, Tm1, N)
    p_arr, spec_p = _flatten_params(pt_params if pgas else None, Tm1, N)

    def body(carry, inp):
        x_prev, w = carry
        eps_t, u_t, ua_t, xst, rows = inp
        m_rows = rows[:len(m_arr)]
        g_rows = rows[len(m_arr):len(m_arr) + len(g_arr)]
        p_rows = rows[len(m_arr) + len(g_arr):]
        mt_p = _unflatten_params(list(m_rows), spec_m)
        gt_p = _unflatten_params(list(g_rows), spec_g)
        pt_p = _unflatten_params(list(p_rows), spec_p)

        cw = jnp.cumsum(w[0])
        anc = jnp.clip(jnp.searchsorted(cw, u_t[0]), 0, N - 1).astype(jnp.int32)
        if pgas:
            scoreA = jnp.log(jnp.maximum(w, 1e-37)) + pgas_logpdf(xst, x_prev, pt_p)
            wA = jnp.exp(scoreA - jnp.max(scoreA))[0]
            cwA = jnp.cumsum(wA)
            a0 = jnp.clip(jnp.sum(cwA < ua_t[0, 0] * cwA[-1]), 0, N - 1)
            anc = anc.at[0].set(a0.astype(jnp.int32))
        else:
            anc = anc.at[0].set(0)

        x_res = x_prev[:, anc]
        x_t = propagate(eps_t, x_res, mt_p)
        x_t = x_t.at[0, 0].set(xst[0, 0])
        log_w = logw(x_t, x_res, gt_p)
        wn = jnp.exp(log_w - jnp.max(log_w))
        wn = wn / jnp.sum(wn)
        return (x_t, wn), (x_t[0], log_w[0], anc.astype(jnp.int32))

    row = lambda z: z[:, None, :]
    ua = jnp.broadcast_to(anc_u[:, None, None], (Tm1, 1, N))
    xstar = jnp.broadcast_to(x_star[:, None, None], (Tm1, 1, N))
    rows_in = tuple(m_arr) + tuple(g_arr) + tuple(p_arr)
    (_, _), (xs, log_ws, anc) = jax.lax.scan(
        body, (x0[None], w0[None]),
        (row(eps), row(res_u), ua, xstar, rows_in))
    return xs, log_ws, anc


def _flatten_params_block(params, Tm1, N):
    leaves, treedef = jax.tree.flatten(params)
    arrays, mask, lens = [], [], []
    for z in leaves:
        if z.size == 0:
            mask.append(False)
            lens.append(0)
            continue
        mask.append(True)
        flat = z.reshape(Tm1, -1)
        lens.append(flat.shape[1])
        arrays.append(jnp.broadcast_to(flat[..., None],
                                       (Tm1, flat.shape[1], N))
                      .astype(jnp.float32))
    return arrays, (treedef, mask, lens)


def _unflatten_params_block(blocks, spec):
    treedef, mask, _ = spec
    it = iter(blocks)
    leaves = [next(it) if m else jnp.zeros(()) for m in mask]
    return jax.tree.unflatten(treedef, leaves)


def block_lane_scan(propagate, logw, mt_params, gt_params, mt_consts,
                    gt_consts, eps, res_u, x_star, x0, w0):
    """Forward sweep of a small-d model through its (d, N)-block callables
    `propagate(eps, x_prev, mt_p, mt_c)` / `logw(x_next, x_prev, gt_p,
    gt_c)`: (d, N) blocks in, (d, N) / (1, N) out. Per-step params arrive
    as (L, N) lane-broadcast blocks (L = the leaf's per-step length), model
    constants as f32 arrays. No PGAS.

    eps (T-1, d, N); res_u (T-1, N); x_star (T-1, d); x0 (d, N); w0 (N,)
    -> (xs (T-1, d, N), log_ws (T-1, N), ancestors (T-1, N) int32)."""
    Tm1, d, N = eps.shape
    m_arr, spec_m = _flatten_params_block(mt_params, Tm1, N)
    g_arr, spec_g = _flatten_params_block(gt_params, Tm1, N)
    f32 = lambda tree: jax.tree.map(lambda z: jnp.asarray(z, jnp.float32),
                                    tree)
    mt_c, gt_c = f32(mt_consts), f32(gt_consts)

    def body(carry, inp):
        x_prev, w = carry
        eps_t, u_t, xst, blocks = inp
        mt_p = _unflatten_params_block(list(blocks[:len(m_arr)]), spec_m)
        gt_p = _unflatten_params_block(list(blocks[len(m_arr):]), spec_g)

        cw = jnp.cumsum(w)
        anc = jnp.clip(jnp.searchsorted(cw, u_t), 0, N - 1).astype(jnp.int32)
        anc = anc.at[0].set(0)

        x_res = x_prev[:, anc]
        x_t = propagate(eps_t, x_res, mt_p, mt_c)
        x_t = jnp.where(jnp.arange(N)[None, :] == 0, xst,
                        x_t).astype(jnp.float32)
        log_w = logw(x_t, x_res, gt_p, gt_c)[0].astype(jnp.float32)
        wn = jnp.exp(log_w - jnp.max(log_w))
        wn = wn / jnp.sum(wn)
        return (x_t, wn), (x_t, log_w, anc)

    xstar = jnp.broadcast_to(x_star[..., None], (Tm1, d, N)).astype(jnp.float32)
    blocks_in = tuple(m_arr) + tuple(g_arr)
    (_, _), (xs, log_ws, anc) = jax.lax.scan(
        body, (x0.astype(jnp.float32), (w0 / jnp.sum(w0)).astype(jnp.float32)),
        (eps.astype(jnp.float32), res_u.astype(jnp.float32), xstar, blocks_in))
    return xs, log_ws, anc

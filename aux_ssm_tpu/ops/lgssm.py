"""Linear-Gaussian state-space model container and trajectory log-densities.

Capability parity with `_primitives/kalman/base.py` (LGSSM:12-69,
posterior_logpdf:72-96, prior_logpdf:100-134, log_likelihood:138-166) —
independent implementation.

Shape conventions (same as the reference, `base.py:27-49`):

  generic LGSSM                     batched (B independent LGSSMs)
  m0: (dx,)                         m0: (B, dx)
  P0: (dx, dx)                      P0: (B, dx, dx)
  Fs: (T-1, dx, dx)                 Fs: (T-1, B, dx, dx)
  Qs: (T-1, dx, dx)                 Qs: (T-1, B, dx, dx)
  bs: (T-1, dx)                     bs: (T-1, B, dx)
  Hs: (T, dy, dx)                   Hs: (T, B, dy, dx)
  Rs: (T, dy, dy)                   Rs: (T, B, dy, dy)
  cs: (T, dy)                       cs: (T, B, dy)
  ys: (T, dy)                       ys: (T, B, dy)

Missing data: NaN entries in `ys` mark unobserved components. Unlike the
reference (which encodes them as infinite observation variance,
`filtering.py:84-130`), every function here uses an exact *masked* projection
of the observation model: rows of H / entries of c are zeroed, R is restricted
to the observed block with a unit diagonal on missing components, and the
missing innovations are zeroed. This is algebraically identical to deleting
the missing rows, but keeps shapes static and all values finite — safe under
f32 and free of `lax.cond` branches.
"""
import math

from typing import NamedTuple

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .mvn import logpdf as mvn_logpdf

_LOG_2PI = math.log(2.0 * math.pi)


class LGSSM(NamedTuple):
    """Parameters of a (possibly batched) linear-Gaussian SSM."""
    m0: jnp.ndarray
    P0: jnp.ndarray
    Fs: jnp.ndarray
    Qs: jnp.ndarray
    bs: jnp.ndarray
    Hs: jnp.ndarray
    Rs: jnp.ndarray
    cs: jnp.ndarray


def mask_observation(y, H, c, R):
    """Project an observation model onto the observed components of `y`.

    Returns `(y_eff, H_eff, c_eff, R_eff, mask)` where missing rows of H/c are
    zeroed, R is zeroed outside the observed block with a unit diagonal on the
    missing block, and `y_eff` carries zeros at missing positions. With these,
    a standard Kalman update / Gaussian logpdf over the full dimension is
    *exactly* the update / logpdf over observed components only (the missing
    block decouples as an identity).
    """
    mask = jnp.isfinite(y)
    fmask = mask.astype(H.dtype)
    # `where`, not multiplication: rows of H/R/c may themselves be NaN at
    # missing steps (e.g. the lorenz observation grid pads Hs with NaN,
    # reference lorenz/model.py:49-50) and NaN * 0 = NaN.
    H_eff = jnp.where(mask[..., :, None], jnp.nan_to_num(H), 0.0)
    c_eff = jnp.where(mask, jnp.nan_to_num(c), 0.0)
    both = mask[..., :, None] & mask[..., None, :]
    R_eff = jnp.where(both, jnp.nan_to_num(R), 0.0)
    eye = jnp.eye(R.shape[-1], dtype=R.dtype)
    R_eff = R_eff + eye * (1.0 - fmask[..., :, None])
    y_eff = jnp.where(mask, jnp.nan_to_num(y), 0.0)
    return y_eff, H_eff, c_eff, R_eff, mask


def _masked_step_logpdf(y, pred, R):
    """log N(y_obs; pred_obs, R_obs) over the observed components of `y`;
    broadcasts over leading batch dims."""
    mask = jnp.isfinite(y)
    fmask = mask.astype(pred.dtype)
    n_obs = jnp.sum(fmask, axis=-1)
    both = mask[..., :, None] & mask[..., None, :]
    R_eff = jnp.where(both, jnp.nan_to_num(R), 0.0)
    R_eff = R_eff + jnp.eye(R.shape[-1], dtype=R.dtype) * (1.0 - fmask[..., :, None])
    chol = jnp.linalg.cholesky(R_eff)
    innov = jnp.where(mask, jnp.nan_to_num(y) - jnp.nan_to_num(pred), 0.0)
    w = solve_triangular(chol, innov[..., None], lower=True)[..., 0]
    log_det = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * jnp.sum(w * w, axis=-1) - log_det - 0.5 * n_obs * _LOG_2PI


def log_likelihood(ys, xs, lgssm):
    """log p(y_{0:T} | x_{0:T}) for a given trajectory.

    Missing (NaN) observation components are marginalised out exactly via the
    masked projection (the reference drops whole partially-observed steps in
    its dense branch, `base.py:164-166`; here partial steps contribute their
    observed components, consistently with the filter).
    """
    *_, Hs, Rs, cs = lgssm
    pred_ys = jnp.einsum("...ij,...j->...i", Hs, xs) + cs

    if cs.shape[-1] == 1:
        # Scalar fast path: no Cholesky needed.
        mask = jnp.isfinite(ys[..., 0])
        var = Rs[..., 0, 0]
        diff = jnp.where(mask, jnp.nan_to_num(ys[..., 0]) - pred_ys[..., 0], 0.0)
        out = -0.5 * (diff * diff / var + jnp.log(var) + _LOG_2PI)
        return jnp.sum(jnp.where(mask, out, 0.0))
    out = _masked_step_logpdf(ys, pred_ys, Rs)
    return jnp.sum(out)


def prior_logpdf(xs, lgssm):
    """log p(x_{0:T}) of a trajectory under the LGSSM dynamics."""
    m0, P0, Fs, Qs, bs, *_ = lgssm
    pred_xs = jnp.einsum("...ij,...j->...i", Fs, xs[:-1]) + bs

    if m0.shape[-1] == 1:
        var0 = P0[..., 0, 0]
        d0 = xs[0, ..., 0] - m0[..., 0]
        out = jnp.nansum(-0.5 * (d0 * d0 / var0 + jnp.log(var0) + _LOG_2PI))
        varq = Qs[..., 0, 0]
        dq = xs[1:, ..., 0] - pred_xs[..., 0]
        trans = -0.5 * (dq * dq / varq + jnp.log(varq) + _LOG_2PI)
    else:
        chol_P0 = jnp.linalg.cholesky(P0)
        chol_Qs = jnp.linalg.cholesky(Qs)
        out = jnp.nansum(mvn_logpdf(xs[0], m0, chol_P0))
        trans = mvn_logpdf(xs[1:], pred_xs, chol_Qs)
    return out + jnp.nansum(trans)


def trajectory_logdensity(ys, xs, lgssm):
    """log p(x_{0:T}) + log p(y_{0:T} | x_{0:T}) — the unnormalised joint."""
    return log_likelihood(ys, xs, lgssm) + prior_logpdf(xs, lgssm)


def posterior_logpdf(ys, xs, ell, lgssm):
    """log p(x_{0:T} | y_{0:T}) = log p(y|x) - log p(y) + log p(x)."""
    return trajectory_logdensity(ys, xs, lgssm) - ell


def make_target_logpdf(ys, lgssm):
    """Precomputed-closure form of `prior_logpdf(x) + log_likelihood(ys, x)`
    for a FIXED target LGSSM — the right way to build `log_likelihood_fn`
    for the auxiliary Kalman kernel when the target itself is an LGSSM.

    Why this exists: XLA's loop-invariant code motion does not hoist custom
    calls (Cholesky, triangular block inversion) out of `while` bodies, so a
    target density written as `prior_logpdf + log_likelihood` refactorises
    its CONSTANT covariances on every MCMC step. Here every
    trajectory-independent factor (masked-observation Cholesky, dynamics
    Cholesky, their triangular inverses, log-determinants) is computed once
    at closure-build time; the per-step work is pure matmul/elementwise.

    Whitening uses the precomputed triangular inverse (one matmul)
    instead of a per-step triangular solve; with the kernel's "highest"
    matmul precision the difference from the solve is O(cond(L) * eps) and
    far below MH-ratio resolution. Requires finite covariances (missing data
    is still handled exactly through the NaN mask of `ys`).
    """
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lgssm
    dx = m0.shape[-1]

    # ---- observation factors (constant given the ys NaN pattern) ----
    mask = jnp.isfinite(ys)
    fmask = mask.astype(Rs.dtype)
    n_obs_tot = jnp.sum(fmask)
    H_eff = jnp.where(mask[..., :, None], jnp.nan_to_num(Hs), 0.0)
    c_eff = jnp.where(mask, jnp.nan_to_num(cs), 0.0)
    y_eff = jnp.where(mask, jnp.nan_to_num(ys), 0.0)

    scalar_obs = cs.shape[-1] == 1
    if scalar_obs:
        var = Rs[..., 0, 0]
        obs_const = -jnp.sum(
            jnp.where(mask[..., 0], 0.5 * (jnp.log(var) + _LOG_2PI), 0.0))
    else:
        both = mask[..., :, None] & mask[..., None, :]
        R_eff = jnp.where(both, jnp.nan_to_num(Rs), 0.0)
        R_eff = R_eff + jnp.eye(Rs.shape[-1], dtype=Rs.dtype) \
            * (1.0 - fmask[..., :, None])
        chol_R = jnp.linalg.cholesky(R_eff)
        eye_y = jnp.broadcast_to(jnp.eye(Rs.shape[-1], dtype=Rs.dtype),
                                 chol_R.shape)
        inv_chol_R = solve_triangular(chol_R, eye_y, lower=True)
        obs_const = -jnp.sum(
            jnp.log(jnp.diagonal(chol_R, axis1=-2, axis2=-1))) \
            - 0.5 * n_obs_tot * _LOG_2PI

    # ---- dynamics factors ----
    scalar_dyn = dx == 1
    if scalar_dyn:
        var0, varq = P0[..., 0, 0], Qs[..., 0, 0]
        dyn_const = -0.5 * jnp.nansum(jnp.log(var0) + _LOG_2PI) \
            - 0.5 * jnp.nansum(jnp.log(varq) + _LOG_2PI)
    else:
        chol_P0 = jnp.linalg.cholesky(P0)
        chol_Qs = jnp.linalg.cholesky(Qs)
        eye_x = jnp.eye(dx, dtype=Qs.dtype)
        inv_chol_P0 = solve_triangular(chol_P0, jnp.broadcast_to(
            eye_x, chol_P0.shape), lower=True)
        inv_chol_Qs = solve_triangular(chol_Qs, jnp.broadcast_to(
            eye_x, chol_Qs.shape), lower=True)
        n_trans = Qs.shape[0] * (1 if Qs.ndim == 3 else Qs.shape[1])
        n0 = 1 if P0.ndim == 2 else P0.shape[0]
        dyn_const = (
            -jnp.sum(jnp.log(jnp.diagonal(chol_P0, axis1=-2, axis2=-1)))
            - 0.5 * n0 * dx * _LOG_2PI
            - jnp.sum(jnp.log(jnp.diagonal(chol_Qs, axis1=-2, axis2=-1)))
            - 0.5 * n_trans * dx * _LOG_2PI)

    def logpdf(xs):
        # log p(y | x): masked innovations whitened by the precomputed factor.
        pred_ys = jnp.einsum("...ij,...j->...i", H_eff, xs) + c_eff
        innov = jnp.where(mask, y_eff - pred_ys, 0.0)
        if scalar_obs:
            out = obs_const - 0.5 * jnp.sum(
                jnp.where(mask[..., 0], innov[..., 0] ** 2 / var, 0.0))
        else:
            w = jnp.einsum("...ij,...j->...i", inv_chol_R, innov)
            out = obs_const - 0.5 * jnp.sum(w * w)
        # log p(x): whitened transition residuals.
        pred_xs = jnp.einsum("...ij,...j->...i", Fs, xs[:-1]) + bs
        d0 = xs[0] - m0
        dq = xs[1:] - pred_xs
        if scalar_dyn:
            out += dyn_const - 0.5 * jnp.nansum(d0[..., 0] ** 2 / var0) \
                - 0.5 * jnp.nansum(dq[..., 0] ** 2 / varq)
        else:
            w0 = jnp.einsum("...ij,...j->...i", inv_chol_P0, d0)
            wq = jnp.einsum("...ij,...j->...i", inv_chol_Qs, dq)
            out += dyn_const - 0.5 * jnp.nansum(w0 * w0) \
                - 0.5 * jnp.nansum(wq * wq)
        return out

    return logpdf

"""Kalman filtering: sequential scan and parallel-in-time associative scan.

Capability parity with `_primitives/kalman/filtering.py` (entry point :18-46,
sequential :66-79, parallel prefix-sum filter :49-63 with operator :152-183
and init :188-250) — independent, mask-based implementation.

The parallel filter is the Särkkä & García-Fernández (2021) formulation: each
time step contributes a 5-tuple element (A, b, C, eta, J) such that filtering
is an associative combination of elements; `jax.lax.associative_scan` then
gives O(log T) depth.

Implementation notes:
- every operator is written as explicit batched algebra on (..., d, d)
  arrays (see `batched.py`), not gufunc-vectorised, so XLA sees plain
  batched matmuls inside `associative_scan`;
- the combine uses a single batched `inv` of I + C1 J2, exploiting
  (I + J2 C1)^T = I + C1 J2 (C, J symmetric), instead of two LU solves;
- missing data is handled by masked projection (`lgssm.mask_observation`) —
  fully finite, no `lax.cond`, identical work in every lane.

Shape polymorphism: all ops broadcast, so the same code runs the generic
(T, ...) and batched (T, B, ...) layouts.
"""
import jax
import jax.numpy as jnp

from .batched import mT, mv, sym, bdiag
from .lgssm import LGSSM, mask_observation, _LOG_2PI

def filtering(ys, lgssm: LGSSM, parallel: bool):
    """Kalman filter.

    Parameters
    ----------
    ys : Array (T, dy) or (T, B, dy)
        Observations; NaN components are treated as missing.
    lgssm : LGSSM
        Model parameters (see `lgssm.LGSSM` for shapes).
    parallel : bool
        If True, run the O(log T)-depth associative-scan filter; otherwise a
        sequential `lax.scan`.

    Returns
    -------
    ms : Array (T, [B,] dx) — filtered means
    Ps : Array (T, [B,] dx, dx) — filtered covariances
    ell : scalar — marginal log-likelihood log p(y_{0:T}) (summed over batch)
    """
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lgssm
    impl = _parallel_filtering if parallel else _sequential_filtering
    ms, Ps, ell = impl(m0, P0, ys, Fs, Qs, bs, Hs, Rs, cs)
    if jnp.ndim(ell) >= 1:
        ell = jnp.sum(ell)
    return ms, Ps, ell


def _spd_solve(S, B):
    """Batched SPD solve via Cholesky: S^{-1} B."""
    chol = jnp.linalg.cholesky(S)
    return jax.scipy.linalg.cho_solve((chol, True), B), chol


def kalman_update(y, m, P, H, c, R):
    """Masked measurement update. Missing components of `y` drop out exactly;
    a fully-missing step reduces to the identity (G = 0, ell_inc = 0).
    Broadcasts over arbitrary leading batch dims."""
    y_eff, H_eff, c_eff, R_eff, mask = mask_observation(y, H, c, R)
    n_obs = jnp.sum(mask.astype(m.dtype), axis=-1)

    y_hat = mv(H_eff, m) + c_eff
    innov = jnp.where(mask, y_eff - y_hat, 0.0)

    S = R_eff + H_eff @ P @ mT(H_eff)
    S = sym(S)

    if y.shape[-1] == 1:
        chol_S = jnp.sqrt(S)
        G = (P @ mT(H_eff)) / S[..., :1, :]
        w = innov / chol_S[..., 0]
        log_det = jnp.log(chol_S[..., 0, 0])
    else:
        HP = H_eff @ P
        SinvHP, chol_S = _spd_solve(S, HP)
        G = mT(SinvHP)
        w = jax.scipy.linalg.solve_triangular(chol_S, innov[..., None], lower=True)[..., 0]
        log_det = jnp.sum(jnp.log(bdiag(chol_S)), axis=-1)

    # Masked-block Cholesky has unit diagonal on missing components, so the
    # log-determinant and quadratic form automatically count observed dims.
    ell_inc = -0.5 * jnp.sum(w * w, axis=-1) - log_det - 0.5 * n_obs * _LOG_2PI

    m_new = m + mv(G, innov)
    P_new = sym(P - G @ S @ mT(G))
    return m_new, P_new, ell_inc


def kalman_predict(m, P, F, b, Q):
    m = mv(F, m) + b
    return m, sym(Q + F @ P @ mT(F))


def kalman_predict_update(m, P, F, b, Q, y, H, c, R):
    m, P = kalman_predict(m, P, F, b, Q)
    return kalman_update(y, m, P, H, c, R)


def _sequential_filtering(m0, P0, ys, Fs, Qs, bs, Hs, Rs, cs):
    m0, P0, ell0 = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])

    def body(carry, inp):
        m, P, ell = carry
        F, Q, b, H, R, c, y = inp
        m, P, ell_inc = kalman_predict_update(m, P, F, b, Q, y, H, c, R)
        return (m, P, ell + ell_inc), (m, P)

    (_, _, ell), (ms, Ps) = jax.lax.scan(
        body, (m0, P0, ell0), (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:])
    )
    ms = jnp.concatenate([m0[None], ms], axis=0)
    Ps = jnp.concatenate([P0[None], Ps], axis=0)
    return ms, Ps, ell


def _parallel_filtering(m0, P0, ys, Fs, Qs, bs, Hs, Rs, cs):
    m0, P0, ell0 = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])

    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:],
                                       ys[1:], m0, P0)
    _, ms, Ps, _, _ = jax.lax.associative_scan(filtering_operator, elems)

    ms = jnp.concatenate([m0[None], ms], axis=0)
    Ps = jnp.concatenate([P0[None], Ps], axis=0)

    # The scan produces the filtered means/covs; the log-likelihood increments
    # are recovered by one embarrassingly-parallel predict+update per step.
    *_, ell_incs = kalman_predict_update(
        ms[:-1], Ps[:-1], Fs, bs, Qs, ys[1:], Hs[1:], cs[1:], Rs[1:]
    )
    return ms, Ps, ell0 + jnp.sum(ell_incs, axis=0)


# --- associative elements -------------------------------------------------

def filtering_operator(elem1, elem2):
    """Associative combination of two filtering elements (SGF 2021, Lemma 8).

    One batched inverse Z = (I + C1 J2)^{-1} serves both occurrences: since
    C and J are symmetric, (I + J2 C1)^T = I + C1 J2, hence
    A2 (I+C1J2)^{-1} = A2 Z  and  solve((I+J2C1)^T, A1)^T = (Z A1)^T.
    Fully batched over arbitrary leading dims (already elementwise over T).
    """
    A1, b1, C1, eta1, J1 = elem1
    A2, b2, C2, eta2, J2 = elem2
    dx = A1.shape[-1]
    if dx == 1:
        # Scalar fast path: the inverse is a reciprocal and every matmul an
        # elementwise product — avoids lowering batched 1x1 linalg.
        a1, c1, j1 = A1[..., 0, 0], C1[..., 0, 0], J1[..., 0, 0]
        a2, c2, j2 = A2[..., 0, 0], C2[..., 0, 0], J2[..., 0, 0]
        v1, n1 = b1[..., 0], eta1[..., 0]
        v2, n2 = b2[..., 0], eta2[..., 0]
        z = 1.0 / (1.0 + c1 * j2)
        a2z = a2 * z
        za1 = z * a1
        A = a2z * a1
        b = a2z * (v1 + c1 * n2) + v2
        C = a2z * c1 * a2 + c2
        eta = za1 * (n2 - j2 * v1) + n1
        J = za1 * j2 * a1 + j1
        return (A[..., None, None], b[..., None], C[..., None, None],
                eta[..., None], J[..., None, None])
    I = jnp.eye(dx, dtype=A1.dtype)

    Z = jnp.linalg.inv(I + C1 @ J2)
    A2Z = A2 @ Z
    ZA1 = Z @ A1

    A = A2Z @ A1
    b = mv(A2Z, b1 + mv(C1, eta2)) + b2
    C = A2Z @ (C1 @ mT(A2)) + C2
    eta = mv(mT(ZA1), eta2 - mv(J2, b1)) + eta1
    J = mT(ZA1) @ (J2 @ A1) + J1
    return A, b, sym(C), eta, sym(J)


def _make_associative_elements(Fs, Qs, bs, Hs, Rs, cs, ys, m0, P0):
    """Build all T-1 associative elements in one batched pass. The first
    element carries the updated initial state; the rest use zeros (the
    generic predict+update map). Fully-missing observations reduce (exactly,
    via masking) to the pure-prediction element the reference special-cases
    with `lax.cond` (`filtering.py:239-250`)."""
    T = bs.shape[0]
    zeros_m = jnp.zeros_like(m0, shape=(T - 1,) + m0.shape)
    zeros_P = jnp.zeros_like(P0, shape=(T - 1,) + P0.shape)
    m = jnp.concatenate([m0[None], zeros_m], axis=0)
    P = jnp.concatenate([P0[None], zeros_P], axis=0)

    y_eff, H_eff, c_eff, R_eff, mask = mask_observation(ys, Hs, cs, Rs)

    m_pred = mv(Fs, m) + bs
    P_pred = Fs @ P @ mT(Fs) + Qs

    S = sym(H_eff @ P_pred @ mT(H_eff) + R_eff)
    if ys.shape[-1] == 1:
        S_invH = H_eff / S
    else:
        S_invH, _ = _spd_solve(S, H_eff)
    S_invH_T = mT(S_invH)

    K = P_pred @ S_invH_T
    A = Fs - K @ (H_eff @ Fs)

    y_diff_b = jnp.where(mask, y_eff - mv(H_eff, bs) - c_eff, 0.0)
    y_diff_m = jnp.where(mask, y_eff - mv(H_eff, m_pred) - c_eff, 0.0)

    b_el = m_pred + mv(K, y_diff_m)
    C = P_pred - K @ S @ mT(K)

    temp = mT(Fs) @ S_invH_T
    eta = mv(temp, y_diff_b)
    J = temp @ (H_eff @ Fs)
    return A, b_el, sym(C), eta, sym(J)

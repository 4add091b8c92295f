"""Hand-written NumPy oracles for Kalman filtering/smoothing, with exact
missing-data handling by *deleting* missing rows (the gold standard the
masked implementation must match). Loop-based and deliberately naive.

Modeled on the reference's test oracles (`_primitives/test_kalman/common.py`)
but written independently.
"""
import numpy as np


def explicit_filter(ys, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    """Sequential Kalman filter with row-deletion for NaN observations.

    Returns filtered means (T, dx), covariances (T, dx, dx), and ell.
    """
    T = ys.shape[0]
    dx = m0.shape[0]
    ms = np.zeros((T, dx))
    Ps = np.zeros((T, dx, dx))
    ell = 0.0

    m, P = m0.copy(), P0.copy()
    for t in range(T):
        if t > 0:
            F, Q, b = Fs[t - 1], Qs[t - 1], bs[t - 1]
            m = F @ m + b
            P = F @ P @ F.T + Q
        y, H, R, c = ys[t], Hs[t], Rs[t], cs[t]
        obs = np.isfinite(y)
        if obs.any():
            yo = y[obs]
            Ho = H[obs, :]
            Ro = R[np.ix_(obs, obs)]
            co = c[obs]
            S = Ho @ P @ Ho.T + Ro
            innov = yo - (Ho @ m + co)
            Sinv = np.linalg.inv(S)
            G = P @ Ho.T @ Sinv
            m = m + G @ innov
            P = P - G @ S @ G.T
            sign, logdet = np.linalg.slogdet(S)
            ell += -0.5 * (innov @ Sinv @ innov + logdet + obs.sum() * np.log(2 * np.pi))
        ms[t] = m
        Ps[t] = P
    return ms, Ps, ell


def explicit_smoother(ms, Ps, Fs, Qs, bs):
    """RTS smoother from filtered moments (for statistical sampling tests)."""
    T, dx = ms.shape
    msm = np.zeros_like(ms)
    Psm = np.zeros_like(Ps)
    msm[-1], Psm[-1] = ms[-1], Ps[-1]
    for t in range(T - 2, -1, -1):
        F, Q, b = Fs[t], Qs[t], bs[t]
        Pp = F @ Ps[t] @ F.T + Q
        G = Ps[t] @ F.T @ np.linalg.inv(Pp)
        msm[t] = ms[t] + G @ (msm[t + 1] - (F @ ms[t] + b))
        Psm[t] = Ps[t] + G @ (Psm[t + 1] - Pp) @ G.T
    return msm, Psm


def random_lgssm(rng, T, dx, dy, batched=False, B=None):
    """Generate a random, well-conditioned LGSSM as plain NumPy arrays."""
    def spd(d, *lead):
        A = rng.standard_normal(lead + (d, d))
        return A @ np.swapaxes(A, -1, -2) + d * np.eye(d)

    shape_b = (B,) if batched else ()
    m0 = rng.standard_normal(shape_b + (dx,))
    P0 = spd(dx, *shape_b)
    Fs = 0.5 * rng.standard_normal((T - 1,) + shape_b + (dx, dx))
    Qs = spd(dx, T - 1, *shape_b)
    bs = rng.standard_normal((T - 1,) + shape_b + (dx,))
    Hs = rng.standard_normal((T,) + shape_b + (dy, dx))
    Rs = spd(dy, T, *shape_b)
    cs = rng.standard_normal((T,) + shape_b + (dy,))
    return m0, P0, Fs, Qs, bs, Hs, Rs, cs


def simulate(rng, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    """Simulate observations from an (unbatched) LGSSM."""
    T = Hs.shape[0]
    dy = Hs.shape[-2]
    x = rng.multivariate_normal(m0, P0)
    ys = np.zeros((T, dy))
    ys[0] = rng.multivariate_normal(Hs[0] @ x + cs[0], Rs[0])
    for t in range(1, T):
        x = rng.multivariate_normal(Fs[t - 1] @ x + bs[t - 1], Qs[t - 1])
        ys[t] = rng.multivariate_normal(Hs[t] @ x + cs[t], Rs[t])
    return ys

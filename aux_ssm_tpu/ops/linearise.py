"""Gaussian linearisation rules for conditional dynamics.

Capability parity with `_primitives/linearisation.py` (extended :11-44,
gauss_hermite :47-75, cubature :78-104, sigma-point engine :107-133, NumPy
point construction :136-241) — independent implementation.

Each rule maps a conditional mean/covariance pair (mean(x, params),
cov(x, params)) and an expansion point x* (plus optionally a covariance P*)
to an affine-Gaussian approximation (F, Q, b) with
  p(x' | x) ≈ N(x'; F x + b, Q).

Sigma-point weights are built in pure NumPy so they are compile-time
constants baked into the XLA program (no runtime cost).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import cho_solve


def extended(mean, cov, params, x_star, _P_star=None):
    """First-order (Taylor) linearisation at x*.

    Chooses jacfwd/jacrev by aspect ratio of the Jacobian — both lower
    to batched matmuls, but forward mode avoids transposes for tall maps.
    """
    b = mean(x_star, params)
    d_in = x_star.shape[0]
    d_out = b.shape[0]
    jac = jax.jacrev if d_out < d_in else jax.jacfwd
    F = jac(mean, 0)(x_star, params)
    Q = cov(x_star, params)
    return F, Q, b - F @ x_star


def cubature(mean, cov, params, x_star, P_star):
    """Spherical cubature (3rd-degree) statistical linearisation."""
    return _sigma_point_linearise(mean, cov, params, x_star, P_star, _cubature_points)


def gauss_hermite(mean, cov, params, x_star, P_star, order=3):
    """Gauss–Hermite statistical linearisation of the given order."""
    return _sigma_point_linearise(
        mean, cov, params, x_star, P_star, lambda d: _gauss_hermite_points(d, order)
    )


def _sigma_point_linearise(mean, cov, params, x_star, P_star, get_points):
    chol = jnp.linalg.cholesky(P_star)
    dim = x_star.shape[0]
    w, xi = get_points(dim)
    w = jnp.asarray(w, dtype=x_star.dtype)
    xi = jnp.asarray(xi, dtype=x_star.dtype)

    points = x_star[None, :] + (chol @ xi).T

    f_pts = jax.vmap(mean, in_axes=(0, None))(points, params)
    m_f = w @ f_pts

    # Cross-covariance between x and f(x) under the sigma-point measure, then
    # the statistically-linearised slope F = Psi^T P*^{-1}.
    Psi = ((points - x_star[None, :]).T * w[None, :]) @ (f_pts - m_f[None, :])
    F = cho_solve((chol, True), Psi).T

    v_pts = jax.vmap(cov, in_axes=(0, None))(points, params)
    v_f = jnp.einsum("s,sij->ij", w, v_pts)

    Phi = ((f_pts - m_f[None, :]).T * w[None, :]) @ (f_pts - m_f[None, :])
    temp = F @ chol
    Q = Phi - temp @ temp.T + v_f
    return F, Q, m_f - F @ x_star


# --- sigma-point construction (pure NumPy: compile-time constants) ---------

def _cubature_points(n_dim):
    w = np.full((2 * n_dim,), 1.0 / (2 * n_dim))
    xi = np.concatenate([np.eye(n_dim), -np.eye(n_dim)], axis=0) * math.sqrt(n_dim)
    return w, xi.T


def _gauss_hermite_points(n_dim, order):
    """Tensor-product Gauss–Hermite points/weights for N(0, I_n), scaled for
    the probabilists' convention (points multiplied by sqrt(2))."""
    nodes, w_1d = np.polynomial.hermite.hermgauss(order)
    w_1d = w_1d / math.sqrt(math.pi)

    grids = np.meshgrid(*([nodes] * n_dim), indexing="ij")
    xi = math.sqrt(2.0) * np.stack([g.ravel() for g in grids], axis=0)

    w_grids = np.meshgrid(*([w_1d] * n_dim), indexing="ij")
    w = np.prod(np.stack([g.ravel() for g in w_grids], axis=0), axis=0)
    return w, xi

"""Closed-form small-matrix linear algebra, batched over leading dims.

The FastSLAM hot loop inverts the innovation covariance Q = H Σ Hᵀ + R per
(particle × landmark) pair. Q is 1x1 .. 3x3 depending on the measurement
model (bearing-only, range-bearing, pinhole uv, stereo uvd). Closed-form
cofactor expressions stay elementwise and fuse into the surrounding
computation, where `jnp.linalg.inv` on [..., 3, 3] would be a separate
batched solver call — no `linalg.solve` anywhere on the hot path
(SURVEY.md §8 phase 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def det2(m: jax.Array) -> jax.Array:
    """Determinant of [..., 2, 2]."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m: jax.Array, eps: float = 1e-12):
    """Inverse + determinant of [..., 2, 2]. Returns (inv, det)."""
    d = det2(m)
    d_safe = jnp.where(jnp.abs(d) < eps, eps, d)
    inv = (
        jnp.stack(
            [m[..., 1, 1], -m[..., 0, 1], -m[..., 1, 0], m[..., 0, 0]],
            axis=-1,
        ).reshape(*m.shape[:-2], 2, 2)
        / d_safe[..., None, None]
    )
    return inv, d


def det3(m: jax.Array) -> jax.Array:
    """Determinant of [..., 3, 3]."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def inv3(m: jax.Array, eps: float = 1e-12):
    """Inverse + determinant of [..., 3, 3] via cofactors. Returns (inv, det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    II = a * e - b * d
    det = a * A + b * B + c * C
    det_safe = jnp.where(jnp.abs(det) < eps, eps, det)
    inv = (
        jnp.stack([A, D, G, B, E, H, C, F, II], axis=-1).reshape(*m.shape[:-2], 3, 3)
        / det_safe[..., None, None]
    )
    return inv, det


def inv_psd(m: jax.Array, eps: float = 1e-12):
    """Closed-form inverse+det dispatch for [..., D, D], D in {1, 2, 3}.

    D is static (from the shape), so the dispatch is trace-time.
    """
    D = m.shape[-1]
    if D == 1:
        d = m[..., 0, 0]
        d_safe = jnp.where(jnp.abs(d) < eps, eps, d)
        return (1.0 / d_safe)[..., None, None], d
    if D == 2:
        return inv2(m, eps)
    if D == 3:
        return inv3(m, eps)
    raise ValueError(f"inv_psd supports D<=3, got {D}")


def solve_psd_small(m: jax.Array, b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Solve m @ x = b for [..., D, D] x [..., D] with D<=3, closed form."""
    inv, _ = inv_psd(m, eps)
    return (inv @ b[..., None])[..., 0]


def mahalanobis_and_logdet(q: jax.Array, nu: jax.Array, eps: float = 1e-12):
    """Return (νᵀ Q⁻¹ ν, log|Q|, Q⁻¹) for small PSD Q [..., D, D], ν [..., D].

    maha is clamped to >= 0: when Q drifts indefinite (EKF covariances are
    only PSD up to fp error) the clamped-det cofactor inverse can flip sign
    and a negative "distance" would turn into a huge POSITIVE log-likelihood
    that wins every association and explodes the particle weights.
    """
    inv, det = inv_psd(q, eps)
    maha = jnp.einsum("...i,...ij,...j->...", nu, inv, nu)
    maha = jnp.maximum(maha, 0.0)
    logdet = jnp.log(jnp.clip(det, eps))
    return maha, logdet, inv


def gaussian_loglik(q: jax.Array, nu: jax.Array, eps: float = 1e-12) -> jax.Array:
    """log N(ν; 0, Q) for small Q. [..., D, D], [..., D] -> [...]."""
    D = q.shape[-1]
    maha, logdet, _ = mahalanobis_and_logdet(q, nu, eps)
    return -0.5 * (maha + logdet + D * jnp.log(2.0 * jnp.pi))

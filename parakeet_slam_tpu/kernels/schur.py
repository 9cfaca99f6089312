"""Schur-complement block ops: batched 3×3 landmark-block inverse apply.

SURVEY.md §2c `kernels/schur`: per-landmark 3×3 C-block inverse feeding the
E C⁻¹ Eᵀ reduced-camera-system products. The BA solver (`backend/ba.py`)
uses an implicit-matvec PCG, so the hot op is y = C⁻¹·u for hundreds of
thousands of landmark blocks per CG iteration. The closed-form cofactor
inverse is pure elementwise work, which XLA fuses into one pass: C⁻¹
itself never reaches device memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sym_planes(C):
    """[N, 3, 3] symmetric -> tuple of 6 planes [N]."""
    return (
        C[:, 0, 0], C[:, 0, 1], C[:, 0, 2],
        C[:, 1, 1], C[:, 1, 2], C[:, 2, 2],
    )


def _cofactor_apply(xx, xy, xz, yy, yz, zz, u0, u1, u2, eps):
    """Closed-form (cofactor) symmetric 3x3 inverse applied to u."""
    A = yy * zz - yz * yz
    B = -(xy * zz - yz * xz)
    Cc = xy * yz - yy * xz
    E = xx * zz - xz * xz
    F = -(xx * yz - xy * xz)
    II = xx * yy - xy * xy
    det = xx * A + xy * B + xz * Cc
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    y0 = (A * u0 + B * u1 + Cc * u2) / det
    y1 = (B * u0 + E * u1 + F * u2) / det
    y2 = (Cc * u0 + F * u1 + II * u2) / det
    return y0, y1, y2


def cinv_apply(C: jax.Array, u: jax.Array, eps: float = 1e-12) -> jax.Array:
    """y = C⁻¹ u for symmetric C [N, 3, 3], u [N, 3] — the op
    `backend/ba.py` and `dist/dist_ba.py` call inside the PCG matvec."""
    xx, xy, xz, yy, yz, zz = _sym_planes(C)
    y0, y1, y2 = _cofactor_apply(
        xx, xy, xz, yy, yz, zz, u[:, 0], u[:, 1], u[:, 2], eps
    )
    return jnp.stack([y0, y1, y2], axis=-1)


"""Brute-force descriptor matching (Hamming + L2) in XLA.

BASELINE.json:5: "brute-force descriptor matching is a tiled Hamming/L2
distance kernel". Hamming distances are XOR + population count, which the
GPU does natively; L2 uses the matmul form ||a-b||^2 = ||a||^2 + ||b||^2 -
2 a.b. At keyframe sizes (512 x 512 descriptors) the [N, M] distance matrix
is small, and XLA fuses distance and top-2 into a few passes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 2**30  # Python int: jnp scalars would be captured as tracer consts
_BIG_F = 1e30


def hamming_distance_xla(qd: jax.Array, db: jax.Array) -> jax.Array:
    """[N, W] x [M, W] packed uint32 -> [N, M] int32 Hamming distances."""
    x = jnp.bitwise_xor(qd[:, None, :], db[None, :, :])
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def l2_distance_xla(qd: jax.Array, db: jax.Array) -> jax.Array:
    """[N, D] x [M, D] float -> [N, M] squared L2 distances (matmul form)."""
    qn = jnp.sum(qd * qd, axis=-1, keepdims=True)
    dn = jnp.sum(db * db, axis=-1, keepdims=True)
    cross = jnp.dot(qd, db.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(qn + dn.T - 2.0 * cross, 0.0)


def _top2_from_dists(dist, db_valid):
    dist = jnp.where(db_valid[None, :], dist, _BIG if dist.dtype == jnp.int32 else _BIG_F)
    best = jnp.min(dist, axis=1)
    best_idx = jnp.argmin(dist, axis=1)
    masked = jnp.where(
        jnp.arange(dist.shape[1])[None, :] == best_idx[:, None],
        _BIG if dist.dtype == jnp.int32 else _BIG_F,
        dist,
    )
    second = jnp.min(masked, axis=1)
    return best_idx, best, second


def hamming_top2(qd, db, db_valid):
    """Per-query (best_idx, best, second) Hamming distances over the
    valid database rows."""
    return _top2_from_dists(hamming_distance_xla(qd, db), db_valid)


def l2_top2(qd, db, db_valid):
    """Per-query (best_idx, best_d2, second_d2) squared L2 distances."""
    return _top2_from_dists(l2_distance_xla(qd, db), db_valid)


# ---------------------------------------------------------------------------
# Matching front door
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("ratio",))
def match(qd, q_valid, db, db_valid, ratio: float = 0.8, max_distance: int = 80):
    """Lowe-ratio-tested nearest-neighbor matches.

    Returns (match_idx [N] int32 — index into db or -1, distance [N]).
    """
    bi, b1, b2 = hamming_top2(qd, db, db_valid)
    # Strict Lowe test: rejects exact-duplicate ties (b1 == b2 == 0) too.
    good = (
        q_valid
        & (b1 <= max_distance)
        & (b1.astype(jnp.float32) < ratio * b2.astype(jnp.float32))
    )
    return jnp.where(good, bi, -1), b1


@functools.partial(jax.jit, static_argnames=("ratio",))
def match_l2(qd, q_valid, db, db_valid, ratio: float = 0.8, max_distance: float = 1e6):
    """Lowe-ratio-tested nearest-neighbor matches for float descriptors.

    Ratio test operates on squared distances (ratio is squared to match the
    conventional distance-space test). Returns (match_idx [N], d2 [N]).
    """
    bi, b1, b2 = l2_top2(qd, db, db_valid)
    good = q_valid & (b1 <= max_distance) & (b1 < (ratio * ratio) * b2)
    return jnp.where(good, bi, -1), b1

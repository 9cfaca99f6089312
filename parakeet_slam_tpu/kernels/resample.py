"""Systematic (low-variance) resampling: index computation + state gather.

SURVEY.md §3 "Resampling": one uniform draw u ~ U[0, 1/P), comb positions
u + i/P, inverse-CDF lookup, then a gather of the FULL per-particle state —
including each particle's entire landmark map, the dominant HBM-bandwidth
cost at [P, Lmax] scale (the reference deep-copies Python dicts here,
SURVEY.md §4.1 entry 4).

Index computation is cheap XLA (cumsum + searchsorted). The payload gather
is `jnp.take` per leaf: a pure copy with nothing to fuse, bound by memory
bandwidth (~1.8 GB of particle state at the KITTI preset's P=2048,
L=10240).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def systematic_resample_indices(key, log_w: jax.Array) -> jax.Array:
    """Low-variance resampling indices [P] from log-weights [P].

    Deterministic given (key, log_w); monotone non-decreasing output.
    """
    P = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / P)
    positions = u0 + jnp.arange(P, dtype=w.dtype) / P
    idx = jnp.searchsorted(cdf, positions, side="left")
    return jnp.clip(idx, 0, P - 1)


def gather_particles(state, idx: jax.Array):
    """Gather the full particle state (poses, weights, entire landmark maps)
    at `idx`, resetting weights to uniform. Works on any ParticleState-like
    pytree whose leaves have a leading particle axis."""
    gathered = jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), state)
    return gathered.replace(log_w=jnp.zeros_like(state.log_w))


def effective_sample_size(log_w: jax.Array) -> jax.Array:
    w = jax.nn.softmax(log_w)
    return 1.0 / jnp.sum(w * w)

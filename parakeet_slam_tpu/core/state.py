"""Dense batched SLAM state containers (pytrees).

The reference keeps per-particle Python dicts of landmark objects
(SURVEY.md §2a `FilterParticle`/`Feature`), which is hostile to any
accelerator. Here the whole filter state is a struct-of-dense-arrays over
fixed capacities so that propagation, association, EKF updates, and
resampling are single batched XLA/Pallas ops (BASELINE.json north_star):

- particle axis P (shardable across chips — "data parallelism"),
- landmark capacity axis Lmax with a validity mask (map growth/culling are
  masked writes, never a reshape — keeps jit shapes static).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree whose fields are all
    array leaves, with `.replace(**changes)` for functional updates."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class ParticleState:
    """FastSLAM filter state: P particles × Lmax landmark slots.

    Shapes (P = particles, L = max landmarks, Dl = landmark dim,
    Ds = appearance signature dim, W = packed descriptor words):
      pose      [P, pose_dim]  - SE(2) [x,y,th] or SE(3) [t(3), q(4)]
      log_w     [P]            - unnormalized log importance weights
      lm_mean   [P, L, Dl]     - landmark EKF means
      lm_cov    [P, L, Dl, Dl] - landmark EKF covariances
      lm_sig    [P, L, Ds]     - appearance signature (running mean)
      lm_desc   [P, L, W]      - packed binary descriptor (uint32), W may be 0
      lm_valid  [P, L]         - slot occupancy mask (bool)
      lm_count  [P, L]         - observation counter (int32) for culling
    """

    pose: jax.Array
    log_w: jax.Array
    lm_mean: jax.Array
    lm_cov: jax.Array
    lm_sig: jax.Array
    lm_desc: jax.Array
    lm_valid: jax.Array
    lm_count: jax.Array

    @property
    def num_particles(self) -> int:
        return self.pose.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_valid.shape[1]

    def normalized_weights(self) -> jax.Array:
        return jax.nn.softmax(self.log_w)

    def effective_sample_size(self) -> jax.Array:
        w = self.normalized_weights()
        return 1.0 / jnp.sum(w * w)

    def num_landmarks(self) -> jax.Array:
        """Per-particle live landmark count [P]."""
        return jnp.sum(self.lm_valid, axis=-1)


def make_particle_state(
    num_particles: int,
    max_landmarks: int,
    lm_dim: int = 2,
    sig_dim: int = 3,
    desc_words: int = 0,
    pose_dim: int = 3,
    init_pose: jax.Array | None = None,
    dtype=jnp.float32,
) -> ParticleState:
    """Allocate an empty filter state; all particles at `init_pose`."""
    P, L = num_particles, max_landmarks
    if init_pose is None:
        init_pose = jnp.zeros((pose_dim,), dtype)
        if pose_dim == 7:  # identity quaternion
            init_pose = init_pose.at[6].set(1.0)
    pose = jnp.broadcast_to(jnp.asarray(init_pose, dtype), (P, pose_dim))
    return ParticleState(
        pose=pose,
        log_w=jnp.zeros((P,), dtype),
        lm_mean=jnp.zeros((P, L, lm_dim), dtype),
        lm_cov=jnp.zeros((P, L, lm_dim, lm_dim), dtype),
        lm_sig=jnp.zeros((P, L, sig_dim), dtype),
        lm_desc=jnp.zeros((P, L, desc_words), jnp.uint32),
        lm_valid=jnp.zeros((P, L), bool),
        lm_count=jnp.zeros((P, L), jnp.int32),
    )


@pytree_dataclass
class Observation:
    """A batch of per-frame feature observations, fixed capacity Zmax.

    z     [Z, Dz] geometric measurement (e.g. range-bearing, pixel uv)
    sig   [Z, Ds] appearance signature (float; e.g. mean color)
    desc  [Z, W]  packed binary descriptor (uint32), W may be 0
    valid [Z]     which rows are real detections
    """

    z: jax.Array
    sig: jax.Array
    desc: jax.Array
    valid: jax.Array

    @property
    def capacity(self) -> int:
        return self.z.shape[0]


def make_observation(z, sig=None, desc=None, valid=None) -> Observation:
    z = jnp.asarray(z)
    Z = z.shape[0]
    if sig is None:
        sig = jnp.zeros((Z, 0), z.dtype)
    if desc is None:
        desc = jnp.zeros((Z, 0), jnp.uint32)
    if valid is None:
        valid = jnp.ones((Z,), bool)
    return Observation(z=z, sig=jnp.asarray(sig), desc=jnp.asarray(desc), valid=jnp.asarray(valid))

"""Online filter driver: scan the jitted SLAM step over a whole sequence.

SURVEY.md §4.2 `slam.run`: the per-frame step (motion + measurement +
resample) is one jit; driving a prerecorded sequence additionally wraps the
whole trajectory in a single `lax.scan`, so a 500-step corridor run is ONE
device program with zero host round-trips — the purest device formulation of
what the reference does one ROS message at a time.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core.state import Observation, ParticleState
from parakeet_slam_tpu.filter.fastslam import FastSLAM


@partial(jax.jit, static_argnums=0)
def run_sequence(
    slam: FastSLAM,
    state: ParticleState,
    odom: jax.Array,       # [T, u_dim]
    obs_z: jax.Array,      # [T, Zmax, Dz]
    obs_sig: jax.Array,    # [T, Zmax, Ds]
    obs_valid: jax.Array,  # [T, Zmax]
    key: jax.Array,
    obs_desc: jax.Array | None = None,  # [T, Zmax, W] packed descriptors
):
    """Run the filter over a full sequence; returns (final_state, est_poses
    [T, pose_dim], metrics pytree of [T] arrays)."""
    T = odom.shape[0]
    if obs_desc is None:
        obs_desc = jnp.zeros((*obs_valid.shape, 0), jnp.uint32)
    keys = jax.random.split(key, T)

    def body(state, frame):
        u, z, sig, desc, valid, k = frame
        obs = Observation(z=z, sig=sig, desc=desc, valid=valid)
        state, metrics = slam.step(state, u, obs, k)
        return state, (slam.estimate_pose(state), metrics)

    final_state, (est, metrics) = jax.lax.scan(
        body, state, (odom, obs_z, obs_sig, obs_desc, obs_valid, keys)
    )
    return final_state, est, metrics

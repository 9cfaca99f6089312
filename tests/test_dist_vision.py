"""Sharded filter x 3-D vision models: the panoramic production path
(config 5) — particle axis sharded over 8 virtual devices, the equirect
association and EKF update running in XLA under shard_map — equals the
same filter on one device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from parakeet_slam_tpu.dist.mesh import make_mesh
from parakeet_slam_tpu.dist.sharded_filter import ShardedFastSLAM
from parakeet_slam_tpu.filter import FastSLAM
from tests.test_score_kernel import _cfgs, _rand_obs, _scatter_poses


def _run(sharded: bool, frames=3):
    # zero motion noise and no resampling: the sharded step's per-shard RNG
    # fold then changes nothing, so both runs see identical poses
    fc, fe = _cfgs("equirect_3d", 2)
    fc = dataclasses.replace(
        fc, num_particles=16, max_landmarks=32, motion_noise=(0.0, 0.0),
        resample_frac=0.0,
    )
    slam = FastSLAM(fc, fe)
    runner = ShardedFastSLAM(slam, make_mesh(n_devices=8)) if sharded else slam
    state = runner.init_state() if sharded else slam.init_state()
    state = state.replace(pose=_scatter_poses(jax.random.PRNGKey(0), 16))
    u = jnp.zeros((6,))
    step = runner.step if sharded else jax.jit(slam.step)
    for f in range(frames):
        obs = _rand_obs(
            jax.random.PRNGKey(300 + f), "equirect_3d", 2, 4, 4, fc.desc_words
        )
        state, metrics = step(state, u, obs, jax.random.PRNGKey(f))
    return state, metrics


class TestShardedVisionKernel:
    def test_pallas_matches_xla_under_shard_map(self):
        st_s, m_s = _run(sharded=True)
        st_x, m_x = _run(sharded=False)
        np.testing.assert_array_equal(
            np.asarray(st_s.lm_valid), np.asarray(st_x.lm_valid)
        )
        np.testing.assert_allclose(
            np.asarray(st_s.log_w), np.asarray(st_x.log_w), rtol=1e-3,
            atol=1e-2,
        )
        vm = np.asarray(st_x.lm_valid)
        np.testing.assert_allclose(
            np.asarray(st_s.lm_mean)[vm], np.asarray(st_x.lm_mean)[vm],
            rtol=1e-3, atol=1e-3,
        )
        assert np.isfinite(float(m_s.ess))
        assert int(np.asarray(st_s.lm_valid).sum()) > 0

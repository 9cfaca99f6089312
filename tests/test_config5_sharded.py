"""Config-5 wiring: the SLAMSystem runs its filter stage sharded over a
(dcn, ici) mesh and its BA distributed over the map axis — the user-facing
path for BASELINE.json:11 (100k+ landmarks, map blocks sharded, distributed
BA), exercised here on the 8-virtual-device CPU mesh at CI scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core.config import (
    BackendConfig, DistConfig, FilterConfig, FrontendConfig, SLAMConfig,
)
from parakeet_slam_tpu.data.panoramic import make_panoramic_world
from parakeet_slam_tpu.system import SLAMSystem


def _cfg(particle_axis=4, map_axis=2):
    H, W = 96, 192
    return SLAMConfig(
        filter=FilterConfig(
            num_particles=32, max_landmarks=256, max_observations=24,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0,
            new_landmark_loglik=-14.0, max_range=45.0,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=48, fast_threshold=0.12,
            camera="equirect", image_size=(H, W),
        ),
        backend=BackendConfig(
            max_keyframes=16, max_landmarks=512,
            keyframe_translation=1.0, keyframe_rotation=0.4, gn_iters=3,
            pcg_iters=10,
        ),
        dist=DistConfig(particle_axis=particle_axis, map_axis=map_axis),
    )


@pytest.fixture(scope="module")
def world():
    return make_panoramic_world(
        num_landmarks=100, num_steps=12, image_size=(96, 192), seed=5
    )


class TestShardedSystem:
    def test_mesh_constructed_and_state_sharded(self):
        sys_ = SLAMSystem(_cfg())
        assert sys_.mesh is not None and sys_._sharded is not None
        assert sys_.mesh.shape == {"dcn": 2, "ici": 4}
        shard_counts = {len(a.sharding.device_set) for a in
                       jax.tree_util.tree_leaves(sys_.state) if a.ndim}
        assert 8 in shard_counts or 4 in shard_counts

    def test_sharded_run_tracks(self, world):
        sys_ = SLAMSystem(_cfg())
        est = [
            sys_.process_frame(world.render(t), world.odom[t])
            for t in range(len(world))
        ]
        est = np.stack(est)
        assert np.isfinite(est).all()
        sys_.flush_flags()
        assert len(sys_.keyframes) >= 1
        drift = np.linalg.norm(est[-1, :3] - world.gt_pose[-1, :3])
        assert drift < 5.0, drift

    def test_falls_back_without_enough_devices(self):
        """A mesh larger than the visible devices is an error, not a quiet
        single-device run."""
        cfg = _cfg(particle_axis=len(jax.devices()) * 2, map_axis=1)
        with pytest.raises(ValueError, match="devices"):
            SLAMSystem(cfg)

    def test_distributed_ba_matches_single_device(self, world):
        sys_ = SLAMSystem(_cfg())
        for t in range(len(world)):
            sys_.process_frame(world.render(t), world.odom[t])
        sys_.flush_flags()
        if len(sys_.keyframes) < 2:
            pytest.skip("needs >=2 keyframes")
        res_d = sys_.run_ba(iters=3, distributed=True)
        res_s = sys_.run_ba(iters=3, distributed=False)
        assert res_d is not None and res_s is not None
        assert np.isfinite(np.asarray(res_d.problem.cam_pose)).all()
        # both solvers reduce to comparable cost on the same problem
        cd = float(np.asarray(res_d.costs)[-1])
        cs = float(np.asarray(res_s.costs)[-1])
        assert cd <= 2.0 * cs + 1.0, (cd, cs)

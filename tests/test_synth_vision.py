"""Full-scale synthetic vision worlds (driver configs 2-3 analogs) and the
TUM/KITTI on-disk format writers, driven through the REAL dataset loaders
(round-1 review: the loaders had never touched data in the real formats)."""

import numpy as np

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core.config import (
    BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
)
from parakeet_slam_tpu.data.synth_vision import (
    make_desk_world, make_drive_world, write_kitti_format, write_tum_format,
)
from parakeet_slam_tpu.eval import ate_rmse



def _small_desk(n_steps=8):
    s = 160 / 640
    return make_desk_world(
        num_landmarks=200, num_steps=n_steps, image_size=(120, 160),
        intrinsics=(517.3 * s, 516.5 * s, 318.6 * s, 255.3 * s), seed=20,
    )


def _small_drive(n_steps=8):
    s = 320 / 1241
    return make_drive_world(
        num_landmarks=800, num_steps=n_steps, image_size=(96, 320),
        intrinsics=(718.856 * s, 718.856 * s, 607.19 * s, 185.22 * s),
        baseline=0.5372, seed=21,
    )


class TestWorlds:
    def test_desk_world_renders_features(self):
        w = _small_desk()
        img = w.render(0)
        assert img.shape == (120, 160) and 0.0 <= img.min() and img.max() <= 1.0
        from parakeet_slam_tpu.frontend.detect import detect

        _, _, valid = detect(jnp.asarray(img), max_features=64, threshold=0.08)
        assert int(valid.sum()) >= 20

    def test_stereo_disparity_sign_and_magnitude(self):
        from parakeet_slam_tpu.data.synth_vision import VisionWorld

        fx = 200.0
        w = VisionWorld(
            landmarks=np.array([[0.3, 0.0, 8.0]], np.float32),
            gt_pose=np.array([[0, 0, 0, 0, 0, 0, 1]], np.float32),
            odom=np.zeros((1, 6), np.float32),
            image_size=(96, 320), intrinsics=(fx, fx, 160.0, 48.0),
            baseline=0.5, max_render_range=70.0, seed=1,
        )
        left, right = w.render_stereo(0)
        ul = np.unravel_index(left.argmax(), left.shape)[1]
        ur = np.unravel_index(right.argmax(), right.shape)[1]
        # disparity = fx * baseline / z = 200 * 0.5 / 8 = 12.5 px
        assert 10 <= ul - ur <= 15, (ul, ur)

    def test_drive_circuit_closes(self):
        w = make_drive_world(num_landmarks=100, num_steps=700, seed=21)
        # circuit length = 4*(2*90-40) + 2*pi*20 = 685.7 m at 1 m/step
        d = np.linalg.norm(w.gt_pose[686, :3] - w.gt_pose[0, :3])
        assert d < 2.0

    def test_odometry_integrates_to_gt(self):
        from parakeet_slam_tpu.core import geometry

        w = _small_desk()
        # noiseless check: re-derive increments from gt and integrate
        pose = jnp.asarray(w.gt_pose[0])
        for i in range(1, len(w)):
            rel = geometry.se3_between(
                jnp.asarray(w.gt_pose[i - 1]), jnp.asarray(w.gt_pose[i])
            )
            pose = geometry.se3_compose(pose, rel)
        np.testing.assert_allclose(
            np.asarray(pose)[:3], w.gt_pose[-1, :3], atol=1e-3
        )


class TestFormatWriters:
    def test_tum_roundtrip_through_loader(self, tmp_path):
        from parakeet_slam_tpu.data.tum import load_tum

        w = _small_desk(4)
        write_tum_format(w, str(tmp_path))
        seq = load_tum(str(tmp_path))
        assert len(seq) == 4
        img = seq.image(0)
        assert img.shape == (120, 160) and img.dtype == np.float32
        np.testing.assert_allclose(
            seq.gt_pose[:, :3], w.gt_pose[:, :3], atol=1e-5
        )
        # pixels survive the 8-bit PNG roundtrip
        np.testing.assert_allclose(img, w.render(0), atol=1.0 / 255 + 1e-6)

    def test_kitti_roundtrip_through_loader(self, tmp_path):
        from parakeet_slam_tpu.data.kitti import load_kitti

        w = _small_drive(4)
        seq_dir = write_kitti_format(w, str(tmp_path), sequence="00")
        seq = load_kitti(seq_dir)
        assert len(seq) == 4
        assert abs(seq.baseline - 0.5372) < 1e-6
        assert abs(seq.fx - w.intrinsics[0]) < 1e-6
        left = seq.image(0)
        right = seq.image(0, right=True)
        assert left.shape == right.shape == (96, 320)
        np.testing.assert_allclose(
            seq.gt_positions(), w.gt_pose[:, :3], atol=1e-5
        )


class TestEndToEndMini:
    def test_desk_monocular_slam_ate(self):
        """Config-2 analog at CI scale: monocular pinhole FastSLAM on the
        desk world; Sim(3)-aligned ATE bounded (regression anchor for the
        full-scale BASELINE.md row)."""
        s = 160 / 640
        intr = (517.3 * s, 516.5 * s, 318.6 * s, 255.3 * s)
        world = make_desk_world(
            num_landmarks=300, num_steps=40, image_size=(120, 160),
            intrinsics=intr, seed=20,
        )
        cfg = SLAMConfig(
            filter=FilterConfig(
                num_particles=32, max_landmarks=512, max_observations=48,
                lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
                measurement_model="pinhole_3d", motion_model="se3_odometry",
                motion_noise=(0.01, 0.005), meas_noise=(2.0, 2.0),
                init_range_prior=2.0, init_range_sigma=1.0, max_range=8.0,
                new_landmark_loglik=-12.0,
            ),
            frontend=FrontendConfig(
                detector="fast", max_features=48, fast_threshold=0.08,
                camera="pinhole", intrinsics=intr, image_size=(120, 160),
            ),
            backend=BackendConfig(
                max_keyframes=64, keyframe_translation=0.4,
                keyframe_rotation=0.25,
            ),
        )
        from parakeet_slam_tpu.system import SLAMSystem

        sys_ = SLAMSystem(cfg)
        est = np.stack([
            sys_.process_frame(world.render(i), world.odom[i])
            for i in range(len(world))
        ])
        ate = float(
            ate_rmse(est[:, :3], world.gt_pose[:, :3], with_scale=True)
        )
        # measured 0.08-0.10 on this config; dead-reckoning-free bound
        assert ate < 0.3, ate
        assert len(sys_.keyframes) >= 5

"""Config-4 path (EuRoC MH multi-session): synthetic ASL-format sessions
through the real loader, sequential sessions with checkpoint carry-over at
the boundary, and the joint end-of-run BA (BASELINE.json:10)."""

import numpy as np

from parakeet_slam_tpu import cli
from parakeet_slam_tpu.data.euroc import load_euroc, load_multi_session
from parakeet_slam_tpu.data.synth_vision import make_hall_world, write_euroc_format



def _tiny_sessions(tmp_path, n_sessions=2, steps=10):
    s = 96 / 752
    intr = (458.654 * s, 457.296 * s, 367.215 * s, 248.375 * s)
    roots = []
    for k in range(n_sessions):
        w = make_hall_world(
            num_landmarks=400, num_steps=steps, session=k,
            image_size=(64, 96), intrinsics=intr, seed=30,
        )
        roots.append(write_euroc_format(w, str(tmp_path / f"MH{k + 1:02d}")))
    return roots, intr


class TestEuRoCFormat:
    def test_writer_roundtrips_through_loader(self, tmp_path):
        roots, _ = _tiny_sessions(tmp_path, n_sessions=2, steps=4)
        seqs = load_multi_session(roots)
        assert [len(s) for s in seqs] == [4, 4]
        img = seqs[0].image(0)
        assert img.shape == (64, 96) and img.dtype == np.float32
        # gt round-trips (writer stores qw-first; loader reorders to xyzw)
        w = make_hall_world(
            num_landmarks=400, num_steps=4, session=0,
            image_size=(64, 96), seed=30,
        )
        np.testing.assert_allclose(
            seqs[0].gt_pose, w.gt_pose[:4], atol=2e-5
        )

    def test_sessions_share_world_but_not_trajectory(self, tmp_path):
        w0 = make_hall_world(num_landmarks=300, num_steps=4, session=0, seed=30)
        w1 = make_hall_world(num_landmarks=300, num_steps=4, session=1, seed=30)
        np.testing.assert_array_equal(w0.landmarks, w1.landmarks)
        assert np.abs(w0.gt_pose[:, :3] - w1.gt_pose[:, :3]).max() > 0.5


class TestMultiSessionRunner:
    def test_runner_carries_state_and_runs_joint_ba(self, tmp_path, capsys):
        roots, intr = _tiny_sessions(tmp_path, n_sessions=2, steps=10)
        cfg_yaml = tmp_path / "cfg.yaml"
        cfg_yaml.write_text(
            f"""
name: euroc_test
data:
  dataset: euroc
  path: {tmp_path}
  odom_source: gt
  odom_noise: [0.005, 0.002]
filter:
  num_particles: 8
  max_landmarks: 128
  max_observations: 12
  lm_dim: 3
  obs_dim: 2
  pose_dim: 7
  desc_words: 8
  measurement_model: pinhole_3d
  motion_model: se3_odometry
  motion_noise: [0.02, 0.01]
  meas_noise: [2.0, 2.0]
  init_range_prior: 5.0
  init_range_sigma: 3.0
  max_range: 16.0
frontend:
  max_features: 24
  fast_threshold: 0.08
  camera: pinhole
  intrinsics: [{intr[0]}, {intr[1]}, {intr[2]}, {intr[3]}]
  image_size: [64, 96]
backend:
  max_keyframes: 32
  max_landmarks: 256
  keyframe_translation: 0.6
  gn_iters: 2
  pcg_iters: 10
  solver: pcg
checkpoint_dir: {tmp_path}/ckpt
"""
        )
        (tmp_path / "ckpt").mkdir()
        cli.main([
            "run", "--config", str(cfg_yaml), "--ba", "2",
            "--out", str(tmp_path / "traj.txt"),
        ])
        out = capsys.readouterr().out
        assert "sessions=2 frames=20" in out
        assert "BA: points=" in out and "iters/s=" in out
        # boundary checkpoint was actually written and the trajectory
        # covers both sessions
        assert (tmp_path / "ckpt" / "session_01.kf.npz").exists()
        traj = np.loadtxt(tmp_path / "traj.txt")
        assert traj.shape == (20, 8)
        assert np.isfinite(traj).all()

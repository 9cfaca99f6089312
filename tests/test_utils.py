"""Checkpoint/resume, metrics logging, config system, viz, loader tests."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core.config import SLAMConfig, apply_overrides, load_config
from parakeet_slam_tpu.core.state import make_particle_state
from parakeet_slam_tpu.utils import checkpoint as ckpt
from parakeet_slam_tpu.utils.metrics_log import export_trajectory
from parakeet_slam_tpu.utils.viz import render_map_png


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = make_particle_state(4, 8, sig_dim=2)
        state = state.replace(pose=jnp.arange(12.0).reshape(4, 3))
        p = str(tmp_path / "ckpt_1.npz")
        ckpt.save_checkpoint(p, state, step=17)
        template = make_particle_state(4, 8, sig_dim=2)
        loaded, step = ckpt.load_checkpoint(p, template)
        assert step == 17
        np.testing.assert_array_equal(np.asarray(loaded.pose), np.asarray(state.pose))
        np.testing.assert_array_equal(
            np.asarray(loaded.lm_valid), np.asarray(state.lm_valid)
        )

    def test_shape_mismatch_rejected(self, tmp_path):
        state = make_particle_state(4, 8)
        p = str(tmp_path / "ckpt_1.npz")
        ckpt.save_checkpoint(p, state, 0)
        wrong = make_particle_state(8, 8)
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(p, wrong)

    def test_latest_selection(self, tmp_path):
        state = make_particle_state(2, 4)
        for s in (1, 5, 3):
            ckpt.save_checkpoint(str(tmp_path / f"ckpt_{s:08d}.npz"), state, s)
        latest = ckpt.latest_checkpoint(str(tmp_path))
        assert latest.endswith("ckpt_00000005.npz")

    def test_resume_or_init(self, tmp_path):
        from parakeet_slam_tpu.dist.multihost import resume_or_init

        template = make_particle_state(2, 4)
        st, step = resume_or_init(str(tmp_path), template, lambda: template)
        assert step == 0
        ckpt.save_checkpoint(str(tmp_path / "ckpt_00000009.npz"), template, 9)
        st, step = resume_or_init(str(tmp_path), template, lambda: template)
        assert step == 9


class TestConfig:
    def test_load_preset_and_override(self):
        cfg = load_config(
            os.path.join(os.path.dirname(__file__), "..", "configs", "corridor.yaml"),
            {"filter.num_particles": 128},
        )
        assert cfg.filter.num_particles == 128
        assert cfg.filter.measurement_model == "range_bearing_2d"
        assert cfg.data.num_steps == 500
        # hashable (usable as static jit arg)
        hash(cfg.filter)

    def test_all_presets_parse(self):
        base = os.path.join(os.path.dirname(__file__), "..", "configs")
        for f in sorted(os.listdir(base)):
            cfg = load_config(os.path.join(base, f))
            assert isinstance(cfg, SLAMConfig)

    def test_nested_override(self):
        cfg = apply_overrides(SLAMConfig(), {"backend.pcg_iters": 7})
        assert cfg.backend.pcg_iters == 7


class TestExports:
    def test_trajectory_tum_format(self, tmp_path):
        p = str(tmp_path / "traj.txt")
        poses = np.array([[1.0, 2.0, 0.5], [2.0, 3.0, 1.0]])
        export_trajectory(p, poses)
        rows = np.loadtxt(p)
        assert rows.shape == (2, 8)
        np.testing.assert_allclose(rows[0, 1:3], [1.0, 2.0])

    def test_render_map(self, tmp_path):
        p = str(tmp_path / "map.png")
        traj = np.cumsum(np.random.default_rng(0).normal(size=(50, 2)), axis=0)
        lms = np.random.default_rng(1).normal(size=(30, 2)) * 5
        render_map_png(p, traj, lms, gt_trajectory=traj + 0.1)
        import cv2

        img = cv2.imread(p)
        assert img is not None and img.shape == (800, 800, 3)


class TestLoaders:
    def test_tum_fixture(self, tmp_path):
        from parakeet_slam_tpu.data.png import write_png
        from parakeet_slam_tpu.data.tum import load_tum

        root = tmp_path / "tum"
        (root / "rgb").mkdir(parents=True)
        img = (np.random.default_rng(0).uniform(0, 255, (24, 32))).astype(np.uint8)
        names = []
        for i in range(3):
            n = f"rgb/{i}.png"
            write_png(root / n, img)
            names.append(n)
        (root / "rgb.txt").write_text(
            "# comment\n" + "\n".join(f"{i}.10 {n}" for i, n in enumerate(names))
        )
        (root / "groundtruth.txt").write_text(
            "\n".join(
                f"{i}.11 {i} 0 0 0 0 0 1" for i in range(3)
            )
        )
        seq = load_tum(str(root))
        assert len(seq) == 3
        assert seq.image(0).shape == (24, 32)
        assert np.isfinite(seq.gt_pose).all()
        np.testing.assert_allclose(seq.gt_pose[2, 0], 2.0)

    def test_kitti_fixture(self, tmp_path):
        from parakeet_slam_tpu.data.kitti import load_kitti
        from parakeet_slam_tpu.data.png import write_png

        root = tmp_path / "sequences" / "00"
        (root / "image_0").mkdir(parents=True)
        (root / "image_1").mkdir(parents=True)
        img = np.zeros((20, 40), np.uint8)
        for i in range(2):
            write_png(root / "image_0" / f"{i:06d}.png", img)
            write_png(root / "image_1" / f"{i:06d}.png", img)
        P0 = "P0: 700.0 0 600.0 0 0 700.0 180.0 0 0 0 1 0"
        P1 = "P1: 700.0 0 600.0 -376.0 0 700.0 180.0 0 0 0 1 0"
        (root / "calib.txt").write_text(P0 + "\n" + P1 + "\n")
        (root / "times.txt").write_text("0.0\n0.1\n")
        poses_dir = tmp_path / "poses"
        poses_dir.mkdir()
        (poses_dir / "00.txt").write_text(
            "1 0 0 0 0 1 0 0 0 0 1 0\n1 0 0 1.5 0 1 0 0 0 0 1 0\n"
        )
        seq = load_kitti(str(root))
        assert len(seq) == 2
        assert abs(seq.baseline - 376.0 / 700.0) < 1e-6
        np.testing.assert_allclose(seq.gt_positions()[1], [1.5, 0, 0])

    def test_euroc_fixture(self, tmp_path):
        from parakeet_slam_tpu.data.euroc import load_euroc
        from parakeet_slam_tpu.data.png import write_png

        root = tmp_path / "MH01"
        data_dir = root / "mav0" / "cam0" / "data"
        data_dir.mkdir(parents=True)
        gt_dir = root / "mav0" / "state_groundtruth_estimate0"
        gt_dir.mkdir(parents=True)
        img = np.zeros((16, 16), np.uint8)
        write_png(data_dir / "100.png", img)
        (root / "mav0" / "cam0" / "data.csv").write_text(
            "#ts,filename\n1000000000,100.png\n"
        )
        (gt_dir / "data.csv").write_text(
            "#hdr\n1000000100,1.0,2.0,3.0,1.0,0.0,0.0,0.0\n"
        )
        seq = load_euroc(str(root))
        assert len(seq) == 1
        # qw-first input reordered to xyzw
        np.testing.assert_allclose(seq.gt_pose[0], [1, 2, 3, 0, 0, 0, 1])


class TestFrontendExtras:
    def test_pyramid_shapes(self):
        from parakeet_slam_tpu.frontend.pyramid import detect_pyramid

        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.uniform(0, 1, (64, 96)).astype(np.float32))
        xy, score, level, valid = detect_pyramid(img, levels=3, max_features=96)
        assert xy.shape == (96, 2)
        assert int(level.max()) <= 2

    def test_stereo_disparity_recovers_shift(self):
        from parakeet_slam_tpu.frontend.stereo import keypoint_disparity

        rng = np.random.default_rng(1)
        left = rng.uniform(0, 1, (48, 128)).astype(np.float32)
        true_d = 7
        right = np.roll(left, -true_d, axis=1)  # right view shifted left
        xy = jnp.array([[60.0, 20.0], [80.0, 30.0], [100.0, 10.0]])
        valid = jnp.ones((3,), bool)
        disp, ok = keypoint_disparity(
            jnp.asarray(left), jnp.asarray(right), xy, valid, max_disp=32
        )
        assert bool(ok.all())
        np.testing.assert_allclose(np.asarray(disp), true_d, atol=0.5)

"""End-to-end vision-pipeline throughput: frontend -> filter -> keyframe
backend frames/s per chip on the synthetic worlds (the online-system analog
of bench.py's filter-only corridor number; BASELINE.json configs 2/3/5).

Frames are pre-rendered so the measurement is device work (detect +
describe + disparity + fused EKF update + resampling), not the numpy
renderer. Timing fences through `profiling.device_sync` (see that module
for why block_until_ready is not sufficient here).

Run: python -m parakeet_slam_tpu.eval.bench_system [--config pano|stereo]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _pano_cfg(P=256, L=2048, Z=64, H=512, W=1024):
    from parakeet_slam_tpu.core.config import (
        BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )

    return SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0),
            new_landmark_loglik=-12.0, max_range=60.0,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.10,
            camera="equirect", image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=256, keyframe_translation=0.5),
    )


def _stereo_cfg(P=256, L=2048, Z=64, H=376, W=1241):
    from parakeet_slam_tpu.core.config import (
        BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )

    fx = 718.856
    return SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=3, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="stereo_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0, 1.5),
            new_landmark_loglik=-14.0, max_range=80.0,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.10,
            camera="stereo", baseline=0.537,
            intrinsics=(fx, fx, 607.19, 185.22), image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=256, keyframe_translation=1.0),
    )


def bench_system(kind: str = "pano", frames: int = 30, **size_kw) -> dict:
    import jax

    from parakeet_slam_tpu.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu.system import SLAMSystem

    if kind == "pano":
        cfg = _pano_cfg(**size_kw)
        H, W = cfg.frontend.image_size
        world = make_panoramic_world(
            num_landmarks=400, num_steps=frames + 5, image_size=(H, W),
            camera="equirect", seed=7,
        )
        imgs = [world.render(t) for t in range(frames + 5)]
        step = lambda s, t: s.process_frame(imgs[t], world.odom[t])
    else:
        cfg = _stereo_cfg(**size_kw)
        H, W = cfg.frontend.image_size
        world = make_panoramic_world(
            num_landmarks=400, num_steps=frames + 5, image_size=(H, W),
            camera="pinhole", radius=10.0, seed=7,
        )
        pairs = [world.render_stereo(t, cfg.frontend.baseline)
                 for t in range(frames + 5)]
        step = lambda s, t: s.process_stereo_frame(*pairs[t], world.odom[t])

    sys_ = SLAMSystem(cfg)
    for t in range(5):  # warmup: compiles frontend + filter + disparity
        step(sys_, t)
    jax.block_until_ready(sys_.state.log_w)
    t0 = time.perf_counter()
    for t in range(5, 5 + frames):
        step(sys_, t)
    jax.block_until_ready(sys_.state.log_w)
    dt = (time.perf_counter() - t0) / frames
    return {
        "pipeline": kind,
        "particles": cfg.filter.num_particles,
        "max_landmarks": cfg.filter.max_landmarks,
        "image": list(cfg.frontend.image_size),
        "fps_per_chip": round(1.0 / dt, 1),
        "ms_per_frame": round(dt * 1e3, 2),
        "keyframes": len(sys_.keyframes),
        "device": str(__import__("jax").devices()[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="pano", choices=["pano", "stereo"])
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args(argv)
    print(json.dumps(bench_system(args.config, args.frames)))


if __name__ == "__main__":
    main()

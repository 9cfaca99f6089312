"""Measurement-path calibration tests (VERDICT r4 item 1: the vision
pipeline must ADD information — these pin the properties the accuracy
work depends on).

1. Monocular landmark EKFs converge to the true 3-D position under a
   known pose (depth is unobservable per-frame; parallax must fix it).
2. A converged landmark's innovation chi^2 is ~Dz — i.e. the likelihoods
   the importance weights consume are CALIBRATED, not arbitrarily scaled
   (SURVEY.md §3 measurement-update contract).
3. The anchor-freeze path (config.freeze_min_count) is kernel/XLA parity
   -exact and actually freezes converged lanes.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu.core.state import make_observation
from parakeet_slam_tpu.filter import make_filter

FX, FY, CX, CY = 100.0, 100.0, 80.0, 60.0
H_IMG, W_IMG = 120, 160


def _scene(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(-1.0, 1.0, n),
            rng.uniform(1.5, 4.0, n),
        ],
        1,
    ).astype(np.float32)


def _cfg(**kw):
    base = dict(
        num_particles=4, max_landmarks=64, max_observations=40, lm_dim=3,
        obs_dim=2, pose_dim=7, measurement_model="pinhole_3d",
        motion_model="se3_odometry", motion_noise=(1e-6, 1e-6),
        meas_noise=(1.5, 1.5), init_range_prior=2.0, init_range_sigma=1.0,
        max_range=8.0, desc_words=0, new_landmark_loglik=-8.0,
    )
    base.update(kw)
    fc = FilterConfig(**base)
    fe = FrontendConfig(
        camera="pinhole", intrinsics=(FX, FY, CX, CY),
        image_size=(H_IMG, W_IMG),
    )
    return fc, fe


def _run_known_pose(slam, lm, frames=70, seed=3):
    """Drive the filter along a sideways+yaw orbit with EXACT odometry and
    ~1e-6 motion noise: every particle rides the true pose, isolating the
    landmark-EKF geometry from the pose-estimation problem."""
    rng = np.random.default_rng(seed)
    model = slam.model
    state = slam.init_state()
    key = jax.random.PRNGKey(0)
    p = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    u = np.array([0.02, 0, 0, 0, -0.008, 0], np.float32)
    poses = [p]
    for _ in range(frames):
        poses.append(
            np.asarray(
                geometry.se3_compose(
                    jnp.asarray(poses[-1]), geometry.se3_exp(jnp.asarray(u))
                )
            )
        )
    Z = slam.cfg.max_observations
    for t in range(frames):
        pw = jnp.asarray(poses[t + 1])
        uv = np.asarray(jax.vmap(lambda m: model.h(pw, m))(jnp.asarray(lm)))
        vis = np.asarray(
            jax.vmap(lambda m: model.in_fov(pw, m))(jnp.asarray(lm))
        )
        idx = np.where(vis)[0][:Z]
        z = np.zeros((Z, 2), np.float32)
        v = np.zeros(Z, bool)
        z[: len(idx)] = uv[idx] + rng.normal(0, 1.0, (len(idx), 2))
        v[: len(idx)] = True
        obs = make_observation(jnp.asarray(z), valid=jnp.asarray(v))
        key, k = jax.random.split(key)
        state, _ = slam.step(state, jnp.asarray(u), obs, k)
    return state, poses


class TestMonoCalibration:
    def test_mono_depth_converges(self):
        lm = _scene()
        fc, fe = _cfg()
        slam = make_filter(fc, fe)
        state, _ = _run_known_pose(slam, lm)
        means = np.asarray(state.lm_mean[0])
        valid = np.asarray(state.lm_valid[0])
        cnt = np.asarray(state.lm_count[0])
        live = np.where(valid & (cnt > 20))[0]
        assert len(live) >= 20
        err = np.linalg.norm(
            means[live][:, None, :] - lm[None, :, :], axis=-1
        ).min(1)
        # ray-prior init guesses depth at 2.0 m for true depths 1.5-4 m;
        # 70 frames of ~1.4 m baseline must pull the EKFs to the truth
        assert float(np.mean(err)) < 0.05, f"mean landmark error {err.mean()}"

    def test_innovation_chi2_calibrated(self):
        """After convergence, per-observation innovation chi^2 against the
        association covariance Q = H Sigma H^T + R must average ~Dz = 2 —
        the weights' likelihoods are statistically meaningful."""
        lm = _scene()
        fc, fe = _cfg()
        slam = make_filter(fc, fe)
        state, poses = _run_known_pose(slam, lm)
        model = slam.model
        rng = np.random.default_rng(99)
        pw = jnp.asarray(poses[-1])
        means = np.asarray(state.lm_mean[0])
        covs = np.asarray(state.lm_cov[0])
        valid = np.asarray(state.lm_valid[0])
        cnt = np.asarray(state.lm_count[0])
        live = np.where(valid & (cnt > 20))[0]
        chi2 = []
        R = np.diag(np.asarray(fc.meas_noise[:2]) ** 2)
        for j in live:
            m = jnp.asarray(means[j])
            # find the true landmark this lane converged to
            tgt = lm[np.linalg.norm(lm - means[j], axis=1).argmin()]
            zhat_true = np.asarray(model.h(pw, jnp.asarray(tgt)))
            if not (
                0 <= zhat_true[0] < W_IMG and 0 <= zhat_true[1] < H_IMG
            ):
                continue
            z = zhat_true + rng.normal(0, 1.5, 2)
            zhat = np.asarray(model.h(pw, m))
            Hj = np.asarray(model.jac(pw, m))
            Q = Hj @ covs[j] @ Hj.T + R
            nu = z - zhat
            chi2.append(float(nu @ np.linalg.solve(Q, nu)))
        chi2 = np.asarray(chi2)
        assert len(chi2) >= 15
        # E[chi2] = 2 for a calibrated 2-D innovation; allow generous band
        assert 0.8 < float(chi2.mean()) < 4.5, f"mean chi2 {chi2.mean()}"


class TestFreeze:
    def test_freeze_stops_mean_updates(self):
        lm = _scene()
        fc, fe = _cfg(freeze_min_count=12)
        slam = make_filter(fc, fe)
        state, poses = _run_known_pose(slam, lm, frames=30)
        frozen_means = np.asarray(state.lm_mean[0]).copy()
        cnt0 = np.asarray(state.lm_count[0]).copy()
        state2, _ = _run_known_pose(slam, lm, frames=30)  # sanity: runs
        # drive 10 more frames from the frozen state with SHIFTED
        # observations; frozen lanes must not move
        model = slam.model
        key = jax.random.PRNGKey(7)
        pw = jnp.asarray(poses[-1])
        Z = fc.max_observations
        uv = np.asarray(jax.vmap(lambda m: model.h(pw, m))(jnp.asarray(lm)))
        vis = np.asarray(
            jax.vmap(lambda m: model.in_fov(pw, m))(jnp.asarray(lm))
        )
        idx = np.where(vis)[0][:Z]
        z = np.zeros((Z, 2), np.float32)
        v = np.zeros(Z, bool)
        z[: len(idx)] = uv[idx] + 3.0  # systematic 3 px shift
        v[: len(idx)] = True
        obs = make_observation(jnp.asarray(z), valid=jnp.asarray(v))
        state, _ = slam.step(
            state, jnp.zeros(6), obs, key
        )
        after = np.asarray(state.lm_mean[0])
        was_frozen = (cnt0 >= 12) & np.asarray(state.lm_valid[0])
        assert was_frozen.sum() >= 10
        np.testing.assert_array_equal(
            after[was_frozen], frozen_means[was_frozen],
            err_msg="frozen lanes moved",
        )

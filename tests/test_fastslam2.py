"""FastSLAM 2.0 (optimal proposal) tests: proposal-stage posterior math
against a hand-rolled pose EKF, and corridor accuracy vs FastSLAM 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core.config import FilterConfig
from parakeet_slam_tpu.core.state import make_observation
from parakeet_slam_tpu.filter import FastSLAM, FastSLAM2, make_filter, run_sequence
from parakeet_slam_tpu.filter import models as model_zoo


def _corridor_cfg(**kw):
    base = dict(
        num_particles=32, max_landmarks=128, max_observations=16,
        sig_dim=3, motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
        sig_noise=0.5, max_range=6.5, fov_half_angle=2.5,
    )
    base.update(kw)
    return FilterConfig(**base)


def test_factory_dispatch():
    assert isinstance(make_filter(_corridor_cfg()), FastSLAM)
    f2 = make_filter(_corridor_cfg(algorithm="fastslam2"))
    assert isinstance(f2, FastSLAM2)
    with pytest.raises(ValueError):
        make_filter(_corridor_cfg(algorithm="nope"))


def test_motion_mean_cov_odometry_matches_sampler_stats():
    """Empirical mean/cov of the FS1 sampler match the FS2 Gaussian model."""
    mean_cov, retract, dt = model_zoo.get_motion_mean_cov("odometry_2d")
    pose = jnp.array([1.0, -2.0, 0.7])
    u = jnp.array([0.5, 0.1, 0.2])
    alphas = (0.2, 0.05, 0.2, 0.05)
    mean, cov = mean_cov(pose, u, alphas)

    keys = jax.random.split(jax.random.PRNGKey(0), 20000)
    samples = jax.vmap(
        lambda k: model_zoo.sample_odometry_2d(k, pose, u, alphas)
    )(keys)
    emp_mean = np.asarray(jnp.mean(samples, axis=0))
    d = np.asarray(samples - mean)
    emp_cov = d.T @ d / len(d)
    np.testing.assert_allclose(emp_mean, np.asarray(mean), atol=5e-3)
    np.testing.assert_allclose(emp_cov, np.asarray(cov), atol=5e-3)


def test_proposal_matches_hand_pose_ekf():
    """One particle, one well-localised landmark: the proposal-stage pose
    Gaussian update equals a hand-rolled EKF in the pose tangent."""
    cfg = _corridor_cfg(num_particles=1, sig_dim=0, max_observations=1,
                        algorithm="fastslam2")
    slam = FastSLAM2(cfg)
    state = slam.init_state(init_pose=jnp.array([0.0, 0.0, 0.0]))
    # Plant one confident landmark at (3, 1).
    lm = jnp.array([3.0, 1.0])
    state = state.replace(
        lm_mean=state.lm_mean.at[0, 0].set(lm),
        lm_cov=state.lm_cov.at[0, 0].set(1e-6 * jnp.eye(2)),
        lm_valid=state.lm_valid.at[0, 0].set(True),
        lm_count=state.lm_count.at[0, 0].set(10),
    )
    u = jnp.array([0.2, 0.0, 0.05])
    z_true = slam.model.h(
        model_zoo.se2_retract(state.pose[0], jnp.zeros(3)), lm
    )  # observation from the prior pose (before motion)
    # Observe from the post-motion mean pose, slightly perturbed.
    mean_cov, retract, _ = model_zoo.get_motion_mean_cov("odometry_2d")
    mean0, cov0 = mean_cov(state.pose[0], u, cfg.motion_noise)
    z = slam.model.h(mean0, lm) + jnp.array([0.05, -0.02])
    obs = make_observation(z[None, :], sig=jnp.zeros((1, 0)),
                           valid=jnp.ones((1,), bool))

    proposed, _scores = slam._propose(state, u, obs, jax.random.PRNGKey(3))

    # Hand EKF in the additive SE(2) tangent at mean0.
    R = jnp.diag(jnp.asarray(cfg.meas_noise) ** 2)
    Hm = slam.model.jac(mean0, lm)
    Hx = jax.jacfwd(
        lambda d: slam.model.h(model_zoo.se2_retract(mean0, d), lm)
    )(jnp.zeros(3))
    Q = Hm @ (1e-6 * jnp.eye(2)) @ Hm.T + R
    S = Hx @ cov0 @ Hx.T + Q
    K = cov0 @ Hx.T @ jnp.linalg.inv(S)
    nu = slam.model.residual(z, slam.model.h(mean0, lm))
    post_mean = model_zoo.se2_retract(mean0, K @ nu)

    # The sampled pose must be a draw from N(post_mean, post_cov): with
    # max covariance scale ~sqrt(S) small, it lands within a few sigma.
    post_cov = (jnp.eye(3) - K @ Hx) @ cov0
    sig = jnp.sqrt(jnp.diagonal(post_cov))
    err = jnp.abs(proposed.pose[0] - post_mean)
    assert bool(jnp.all(err < 6 * sig + 1e-4)), (err, sig)

    # And the weight must equal log N(nu; 0, S).
    from parakeet_slam_tpu.core import linalg
    expected_lw = linalg.gaussian_loglik(S, nu)
    np.testing.assert_allclose(
        float(proposed.log_w[0] - state.log_w[0]), float(expected_lw), rtol=1e-4
    )


def _run_corridor(algorithm, num_particles, seed=0):
    from parakeet_slam_tpu.data import make_corridor
    from parakeet_slam_tpu.eval import ate_rmse

    sim = make_corridor(num_landmarks=100, num_steps=300, max_obs=16, seed=7)
    cfg = _corridor_cfg(algorithm=algorithm, num_particles=num_particles,
                        seed=seed)
    slam = make_filter(cfg)
    state = slam.init_state(init_pose=jnp.asarray(sim.gt_pose[0]))
    _, est, _ = run_sequence(
        slam, state, jnp.asarray(sim.odom), jnp.asarray(sim.obs_z),
        jnp.asarray(sim.obs_sig), jnp.asarray(sim.obs_valid),
        jax.random.PRNGKey(seed),
    )
    return float(ate_rmse(est[:, :2], sim.gt_pose[:300, :2]))


def test_fastslam2_corridor_accuracy():
    """FS2 at 8 particles must be competitive with FS1 at 8 particles on
    the corridor (the point of the optimal proposal — more accuracy per
    particle). Seed-averaged: single-seed ATE variance on this sim is
    ~±0.1 m for both algorithms."""
    seeds = range(3)
    ate2 = np.mean([_run_corridor("fastslam2", 8, s) for s in seeds])
    ate1 = np.mean([_run_corridor("fastslam1", 8, s) for s in seeds])
    assert np.isfinite(ate2)
    assert ate2 < 0.6, ate2
    assert ate2 < ate1 * 1.1, (ate2, ate1)


def test_fastslam2_se3_motion_model():
    """SE(3) tangent mean/cov + retraction are consistent."""
    mean_cov, retract, dt = model_zoo.get_motion_mean_cov("se3_odometry")
    assert dt == 6
    pose = jnp.array([1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0])
    u = jnp.array([0.1, 0.0, 0.05, 0.02, 0.01, 0.0])
    mean, cov = mean_cov(pose, u, (0.05, 0.01))
    assert mean.shape == (7,) and cov.shape == (6, 6)
    # cov ≈ Jr M Jrᵀ is symmetric PSD
    evals = np.linalg.eigvalsh(np.asarray(cov))
    assert np.all(evals > 0)
    # retraction at zero is identity
    np.testing.assert_allclose(
        np.asarray(retract(pose, jnp.zeros(6))), np.asarray(pose), atol=1e-6
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_fastslam2_sharded_trajectory():
    """FastSLAM 2.0 under shard_map on the 8-device mesh: the proposal
    stage is per-particle so it shards with zero extra communication;
    trajectory accuracy must match the single-device class."""
    from parakeet_slam_tpu.core.state import make_observation
    from parakeet_slam_tpu.data import make_corridor
    from parakeet_slam_tpu.dist.mesh import make_mesh
    from parakeet_slam_tpu.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu.eval import ate_rmse

    sim = make_corridor(num_landmarks=40, num_steps=60, max_obs=8, seed=5)
    cfg = _corridor_cfg(
        algorithm="fastslam2", num_particles=16, max_landmarks=96,
        max_observations=8,
    )
    sharded = ShardedFastSLAM(make_filter(cfg), make_mesh(n_devices=8))
    state = sharded.init_state(init_pose=jnp.asarray(sim.gt_pose[0]))
    key = jax.random.PRNGKey(0)
    est = []
    for t in range(60):
        key, k = jax.random.split(key)
        obs = make_observation(
            jnp.asarray(sim.obs_z[t]), sig=jnp.asarray(sim.obs_sig[t]),
            valid=jnp.asarray(sim.obs_valid[t]),
        )
        state, _ = sharded.step(state, jnp.asarray(sim.odom[t]), obs, k)
        est.append(np.asarray(sharded.estimate_pose(state)))
    ate = float(ate_rmse(jnp.asarray(est)[:, :2], sim.gt_pose[:60, :2]))
    assert np.isfinite(ate)
    assert ate < 1.5, ate

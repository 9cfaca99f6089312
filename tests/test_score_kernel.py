"""The association score kernel (`kernels/score_3d`) against its XLA
reference `FastSLAM._score_frame`, plus the XLA filter paths of the 3-D
camera models.

On the CPU the kernel runs in Pallas interpret mode at small, odd widths;
the `gpu` tests compile it for the card at the KITTI 00 preset's widths.
Scores agree up to the order of float sums, so a tie or near-tie between
two lanes may be broken the other way: lanes are compared only where the
best and second-best log-likelihoods are more than 1e-3 apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu.core.state import make_observation
from parakeet_slam_tpu.eval import bench_kernels
from parakeet_slam_tpu.filter import FastSLAM
from parakeet_slam_tpu.kernels import score_3d

H_IMG, W_IMG = 96, 160
FX = 0.6 * W_IMG
MODELS = {"pinhole_3d": 2, "stereo_3d": 3, "equirect_3d": 2}
SMALL_BLOCK = (8, 64, 4)


def _cfgs(model, Dz, **kw):
    # desc_weight 0.5: a re-observation (few flipped bits) scores ~-2 on the
    # appearance term while a random descriptor scores ~-64, so new-vs-update
    # decisions at log_p0=-30 never sit on a float boundary.
    fc = FilterConfig(
        num_particles=8, max_landmarks=32, max_observations=4,
        lm_dim=3, obs_dim=Dz, pose_dim=7, sig_dim=0, desc_words=8,
        desc_weight=0.5,
        measurement_model=model, motion_model="se3_odometry",
        motion_noise=(0.02, 0.01),
        meas_noise=(2.0, 2.0, 1.5)[:Dz],
        new_landmark_loglik=-30.0, max_range=50.0,
    )
    fe = FrontendConfig(
        camera={"stereo_3d": "stereo", "equirect_3d": "equirect"}.get(model, "pinhole"),
        baseline=0.3, intrinsics=(FX, FX, W_IMG / 2, H_IMG / 2),
        image_size=(H_IMG, W_IMG),
    )
    return dataclasses.replace(fc, **kw), fe


def _scatter_poses(key, P, scale=1e-3):
    """Near-identical particle poses: decisions agree across particles, so
    structural (new-vs-update) outcomes are deterministic while the EKF
    math still runs on distinct values."""
    kt, kq = jax.random.split(key)
    t = jax.random.uniform(kt, (P, 3), minval=-scale, maxval=scale)
    v = jax.random.normal(kq, (P, 4)) * jnp.array([scale, scale, scale, 1.0])
    q = v / jnp.linalg.norm(v, axis=1, keepdims=True)
    return jnp.concatenate([t, q], axis=1)


def _rand_obs(key, model, Dz, n_valid, n_total, desc_words):
    ku, kv, kd, kc = jax.random.split(key, 4)
    u = jax.random.uniform(ku, (n_total,), minval=20.0, maxval=W_IMG - 20)
    v = jax.random.uniform(kv, (n_total,), minval=20.0, maxval=H_IMG - 20)
    cols = [u, v]
    if Dz == 3:
        cols.append(jax.random.uniform(kd, (n_total,), minval=2.0, maxval=12.0))
    desc = jax.random.bits(kc, (n_total, desc_words), jnp.uint32)
    valid = jnp.arange(n_total) < n_valid
    return make_observation(jnp.stack(cols, axis=1), desc=desc, valid=valid)


def _kernel_scores(slam, state, obs, block=SMALL_BLOCK, interpret=True):
    return score_3d.score_3d(
        state.pose, state.lm_mean, state.lm_cov, state.lm_desc,
        state.lm_valid, obs.z, obs.desc,
        model=slam.model.name, par=slam._vision_kernel_params(),
        r_var=slam._meas_var(assoc=True), desc_weight=float(slam.cfg.desc_weight),
        block=block, interpret=interpret,
    )


def _xla_scores(slam, state, obs):
    with jax.default_matmul_precision("highest"):
        return jax.jit(slam._score_frame)(state, obs)


def assert_scores_agree(slam, state, obs, kernel, ref):
    """The parity rule: |dll| <= 1e-4 |ll| + 1e-4 everywhere; equal lanes
    wherever the reference's top-2 gap exceeds 1e-3. Returns the max
    |dll| and the share of equal lanes."""
    (b_k, l_k), (b_x, l_x) = (tuple(map(np.asarray, s)) for s in (kernel, ref))
    err = np.abs(l_k - l_x)
    np.testing.assert_array_less(err, 1e-4 * np.abs(l_x) + 1e-4 + 1e-30)
    # gap between the reference's best and second-best lane, [P, Z]
    gap = np.asarray(jax.jit(lambda st, o: jax.lax.map(
        lambda zd: _top2_gap(slam, st, *zd), (o.z, o.desc)
    ).T)(state, obs))
    decided = gap > 1e-3
    np.testing.assert_array_equal(b_k[decided], b_x[decided])
    return float(err.max()), float((b_k == b_x).mean())


def _top2_gap(slam, state, z, desc):
    """[P] gap between the best and second-best lane of one observation,
    from the reference's own per-pair scores, masked as it masks them."""
    with jax.default_matmul_precision("highest"):
        pair = jax.vmap(jax.vmap(
            lambda p, m, c: slam._per_pair_stats(p, m, c, z, assoc=True)[3],
            in_axes=(None, 0, 0)), in_axes=(0, 0, 0))
        ll = pair(state.pose, state.lm_mean, state.lm_cov)
    ll = ll + slam._appearance_loglik(
        None, desc, state.lm_sig, state.lm_desc, state.pose.dtype
    )
    top2 = jax.lax.top_k(jnp.where(state.lm_valid & jnp.isfinite(ll), ll, -1e30), 2)[0]
    return top2[:, 0] - top2[:, 1]


def _small_filter(model, P=12, L=150, Z=12):
    Dz = MODELS[model]
    fc, fe = _cfgs(
        model, Dz, num_particles=P, max_landmarks=L, max_observations=Z,
        desc_weight=0.05, assoc_gate_px=4.0,
    )
    return FastSLAM(fc, fe)


class TestKernelInterpret:
    @pytest.mark.parametrize("model", list(MODELS))
    def test_matches_xla(self, model):
        """Odd widths: P=12 and L=150 pad to the (8, 64) block; two
        trailing observations are invalid; 10% of lanes are holes."""
        slam = _small_filter(model)
        state, obs = bench_kernels.synthetic_map_state(slam, jax.random.PRNGKey(3))
        obs = obs.replace(valid=jnp.arange(12) < 10)
        assert_scores_agree(
            slam, state, obs, _kernel_scores(slam, state, obs), _xla_scores(slam, state, obs)
        )

    @pytest.mark.parametrize("lanes", [(5, 9), (5, 70), (63, 64)])
    def test_ties_pick_smallest_lane(self, lanes):
        """An exact duplicate of a landmark, in the same chunk or the next
        one: both paths keep the smaller lane."""
        slam = _small_filter("stereo_3d")
        state, obs = bench_kernels.synthetic_map_state(slam, jax.random.PRNGKey(4))
        a, b = lanes
        dup = lambda x: x.at[:, b].set(x[:, a])  # noqa: E731
        state = state.replace(
            lm_mean=dup(state.lm_mean), lm_cov=dup(state.lm_cov),
            lm_desc=dup(state.lm_desc), lm_valid=state.lm_valid.at[:, [a, b]].set(True),
        )
        p0 = state.pose[0]
        z = slam.model.h(p0, state.lm_mean[0, a])
        obs = obs.replace(z=obs.z.at[0].set(z), desc=obs.desc.at[0].set(state.lm_desc[0, a]))
        b_k, _ = _kernel_scores(slam, state, obs)
        b_x, _ = _xla_scores(slam, state, obs)
        assert int(b_x[0, 0]) == a
        assert int(b_k[0, 0]) == a

    def test_empty_map(self):
        slam = _small_filter("pinhole_3d")
        state = slam.init_state()
        obs = _rand_obs(jax.random.PRNGKey(5), "pinhole_3d", 2, 10, 12, 8)
        (b_k, l_k), (b_x, l_x) = _kernel_scores(slam, state, obs), _xla_scores(slam, state, obs)
        np.testing.assert_array_equal(np.asarray(b_k), np.asarray(b_x))
        np.testing.assert_array_equal(np.asarray(l_k), np.asarray(l_x))
        assert float(jnp.max(l_k)) == float(np.float32(-1e30))

    def test_chunks_past_the_live_map(self):
        """Only the first chunk holds live lanes: the later chunks skip
        their work and the result still equals the reference."""
        slam = _small_filter("equirect_3d", L=256)
        state, obs = bench_kernels.synthetic_map_state(
            slam, jax.random.PRNGKey(6), live_frac=0.2
        )
        assert int(jnp.max(jnp.where(state.lm_valid, jnp.arange(256), -1))) < 64
        assert_scores_agree(
            slam, state, obs, _kernel_scores(slam, state, obs), _xla_scores(slam, state, obs)
        )


def test_reduce_chunks_keeps_first_maximum():
    ll = jnp.array([[[1.0, -1e30], [3.0, 2.0], [3.0, 5.0]]])   # [P=1, C=3, Z=2]
    ix = jnp.array([[[4, 0], [70, 90], [130, 140]]])
    best, best_ll = score_3d.reduce_chunks(ll, ix)
    np.testing.assert_array_equal(np.asarray(best), [[70, 140]])
    np.testing.assert_array_equal(np.asarray(best_ll), [[3.0, 5.0]])


@pytest.mark.parametrize("model,sig_dim,platform,expected", [
    ("stereo_3d", 0, "gpu", True),
    ("pinhole_3d", 0, "gpu", True),
    ("equirect_3d", 0, "cpu", False),
    ("pinhole_3d", 3, "gpu", False),
    ("range_bearing_2d", 0, "gpu", False),
])
def test_dispatch_by_platform(model, sig_dim, platform, expected):
    assert score_3d.applies(model, sig_dim, platform) is expected


def test_filter_uses_xla_scan_on_cpu():
    slam = _small_filter("stereo_3d")
    assert slam.score_kernel is False


@pytest.mark.parametrize("model", list(MODELS))
def test_lowers_for_the_gpu(model):
    """The kernel lowers to a Triton call for CUDA (compiling it to PTX
    needs the card)."""
    slam = _small_filter(model)
    state, obs = bench_kernels.synthetic_map_state(slam, jax.random.PRNGKey(7))
    f = jax.jit(lambda *a: _kernel_scores(slam, *a, block=score_3d._BLOCK, interpret=False))
    exported = jax.export.export(
        f, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(state, obs)
    assert "__gpu$xla.gpu.triton" in exported.mlir_module()


@pytest.mark.gpu
@pytest.mark.parametrize("model", list(MODELS))
def test_matches_xla_on_gpu_at_kitti_width(gpu, model):
    """P=2048, L=10240, Z=128, compiled for the card, every camera model."""
    slam = bench_kernels.vision_filter(model)
    state, obs = bench_kernels.synthetic_map_state(slam, jax.random.PRNGKey(0))
    slam.score_kernel = True
    kernel = jax.jit(slam._frame_scores)(state, obs)
    err, same = assert_scores_agree(slam, state, obs, kernel, _xla_scores(slam, state, obs))
    print(f"\nscore_3d parity {model} on {gpu.device_kind}: max |dll| {err:.3g}, "
          f"equal lanes {same:.6f}")


class TestVisionFilterXLA:
    def test_step_on_3d_model(self):
        fc, fe = _cfgs("stereo_3d", 3)
        slam = FastSLAM(fc, fe)
        obs = _rand_obs(jax.random.PRNGKey(1), "stereo_3d", 3, 3, 4, fc.desc_words)
        st2, _ = slam.step(slam.init_state(), jnp.zeros(6), obs, jax.random.PRNGKey(2))
        assert np.isfinite(np.asarray(st2.log_w)).all()
        assert int(np.asarray(st2.lm_valid).sum()) > 0

    @pytest.mark.parametrize("model", ["pinhole_3d", "stereo_3d"])
    def test_map_pass_leaves_weights(self, model):
        """weight_matched=False (FastSLAM 2.0 map pass) updates the maps and
        leaves the log-weights exactly as they were."""
        fc, fe = _cfgs(model, MODELS[model])
        slam = FastSLAM(fc, fe)
        st = slam.init_state().replace(pose=_scatter_poses(jax.random.PRNGKey(11), 8))
        obs0 = _rand_obs(jax.random.PRNGKey(12), model, MODELS[model], 3, 4, 8)
        st, _ = slam.measurement_core(st, obs0)
        lw = np.asarray(st.log_w)
        new, _ = slam.measurement_core(st, obs0, weight_matched=False)
        np.testing.assert_array_equal(np.asarray(new.log_w), lw)
        assert int(np.asarray(new.lm_count).sum()) > int(np.asarray(st.lm_count).sum())

    def test_decay_eviction_frees_lanes(self):
        """cull_unseen: an out-of-view landmark with a small count decays
        and frees its lane; a well-observed one survives."""
        fc, fe = _cfgs("pinhole_3d", 2, cull_unseen=True)
        slam = FastSLAM(fc, fe)
        st = slam.init_state()
        st = st.replace(
            lm_mean=st.lm_mean.at[:, 0].set(jnp.array([0.0, 0.0, -5.0]))
                     .at[:, 1].set(jnp.array([0.0, 0.0, 8.0])),
            lm_valid=st.lm_valid.at[:, :2].set(True),
            lm_count=st.lm_count.at[:, 0].set(1).at[:, 1].set(50),
        )
        obs = _rand_obs(jax.random.PRNGKey(3), "pinhole_3d", 2, 2, 4, 8)
        for _ in range(3):
            st, _ = slam.measurement_core(st, obs)
        assert not bool(st.lm_valid[:, 0].any())
        assert bool(st.lm_valid[:, 1].all())

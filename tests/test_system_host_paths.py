"""Scalable SLAMSystem host paths: batched loop closure over the stacked
keyframe store and vectorized BA-problem assembly (round-1 review item 3 —
these were serial per-keyframe / per-observation host loops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.core.config import (
    BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
)
from parakeet_slam_tpu.kernels import match as match_mod
from parakeet_slam_tpu.system import Keyframe, SLAMSystem, _assign_point_ids


def _cfg(max_landmarks=128):
    return SLAMConfig(
        filter=FilterConfig(
            num_particles=8, max_landmarks=64, max_observations=16,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
        ),
        frontend=FrontendConfig(
            max_features=32, camera="equirect", image_size=(64, 128),
        ),
        backend=BackendConfig(
            max_keyframes=32, max_landmarks=max_landmarks,
            loop_inlier_radius=0.7,
        ),
    )


def _rand_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.concatenate([rng.uniform(-3, 3, 3), q]).astype(np.float32)


def _make_kf(index, pose, world_pts, desc, valid):
    pts_kf = np.asarray(
        jax.vmap(lambda p: geometry.se3_apply_inverse(jnp.asarray(pose), p))(
            jnp.asarray(world_pts)
        )
    )
    return Keyframe(
        index=index, pose=np.asarray(pose, np.float32),
        points_kf=pts_kf.astype(np.float32),
        desc=np.asarray(desc, np.uint32), valid=np.asarray(valid, bool),
        # keyframes every 25 frames: old ones clear the loop_min_frame_gap
        # recency gate (closure eligibility is frame-based, not index-based)
        frame=index * 25,
    )


def _serial_loop_closure_reference(sys_, kf, ratio):
    """Round-1 per-keyframe serial matching loop (semantics oracle)."""
    best = None
    for old in sys_.keyframes[: max(0, kf.index - 3)]:
        idx, _ = match_mod.match(
            jnp.asarray(kf.desc), jnp.asarray(kf.valid),
            jnp.asarray(old.desc), jnp.asarray(old.valid),
            ratio=ratio,
        )
        ridx, _ = match_mod.match(
            jnp.asarray(old.desc), jnp.asarray(old.valid),
            jnp.asarray(kf.desc), jnp.asarray(kf.valid),
            ratio=ratio,
        )
        idx, ridx = np.asarray(idx), np.asarray(ridx)
        rows = np.arange(len(idx))
        mutual = (idx >= 0) & (ridx[np.clip(idx, 0, len(ridx) - 1)] == rows)
        n = int(mutual.sum())
        if n >= 12 and (best is None or n > best[0]):
            best = (n, old.index)
    return best


class TestBatchedLoopClosure:
    def test_finds_planted_closure_and_matches_serial_reference(self):
        rng = np.random.default_rng(3)
        sys_ = SLAMSystem(_cfg())
        F, W = 32, 8
        shared_world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
        shared_desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)

        # keyframes 0..4: distinct random landmarks; keyframe 1 gets the
        # planted shared set
        for i in range(5):
            pose = _rand_pose(rng)
            if i == 1:
                world, desc = shared_world, shared_desc
            else:
                world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
                desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
            kf = _make_kf(i, pose, world, desc, np.ones(F, bool))
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)

        # query keyframe 5 re-observes the shared landmarks
        pose_q = _rand_pose(rng)
        kf_q = _make_kf(5, pose_q, shared_world, shared_desc, np.ones(F, bool))
        sys_.keyframes.append(kf_q)
        sys_._kf_store_append(kf_q)

        ref = _serial_loop_closure_reference(sys_, kf_q, 0.8)
        assert ref is not None and ref[1] == 1

        n_edges0 = int(sys_.graph.n_edges)
        assert sys_._try_loop_closure(kf_q)
        assert sys_.loop_closures == [(1, 5)]
        assert int(sys_.graph.n_edges) == n_edges0 + 1
        # the accepted edge encodes Z = T_old^-1 T_kf (exact: noiseless pts)
        e = int(sys_.graph.n_edges) - 1
        rel = np.asarray(sys_.graph.edge_rel[e])
        expect = np.asarray(
            geometry.se3_between(jnp.asarray(sys_.keyframes[1].pose),
                                 jnp.asarray(pose_q))
        )
        np.testing.assert_allclose(rel[:3], expect[:3], atol=1e-3)

    def test_no_false_closure_on_distinct_maps(self):
        rng = np.random.default_rng(4)
        sys_ = SLAMSystem(_cfg())
        F, W = 32, 8
        for i in range(6):
            world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
            desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
            kf = _make_kf(i, _rand_pose(rng), world, desc, np.ones(F, bool))
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)
        assert not sys_._try_loop_closure(sys_.keyframes[-1])
        assert sys_.loop_closures == []

    def test_store_grows_past_initial_capacity(self):
        rng = np.random.default_rng(5)
        sys_ = SLAMSystem(_cfg())
        F, W = 32, 8
        for i in range(70):  # > initial 64-keyframe capacity
            world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
            desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
            kf = _make_kf(i, _rand_pose(rng), world, desc, np.ones(F, bool))
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)
        assert sys_._kf_desc_dev.shape[0] == 128
        assert not sys_._try_loop_closure(sys_.keyframes[-1])


class TestAssignPointIds:
    def test_dedup_and_allocation_order(self):
        W = 8
        rng = np.random.default_rng(9)
        d = rng.integers(0, 2**32, (4, W), dtype=np.uint32)
        desc = np.stack([
            np.stack([d[0], d[1], d[2]]),
            np.stack([d[1], d[3], d[0]]),
        ])  # [K=2, F=3, W]
        valid = np.array([[True, True, False], [True, True, True]])
        world = rng.normal(size=(2, 3, 3)).astype(np.float32)
        (sd, sv, sp, cnt, drop), pid = _assign_point_ids(
            jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(world),
            cap=16, max_ham=40,
        )
        pid = np.asarray(pid)
        # kf0: rows 0,1 new -> pids 0,1; row 2 invalid -> -1
        assert pid[0].tolist() == [0, 1, -1]
        # kf1: d1 matches pid 1; d3 new -> 2; d0 matches pid 0
        assert pid[1].tolist() == [1, 2, 0]
        assert int(cnt) == 3 and int(drop) == 0
        # stored world positions are first-seen
        np.testing.assert_allclose(np.asarray(sp)[0], world[0, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(sp)[1], world[0, 1], atol=1e-6)
        np.testing.assert_allclose(np.asarray(sp)[2], world[1, 1], atol=1e-6)

    def test_capacity_overflow_drops_new_points(self):
        rng = np.random.default_rng(10)
        desc = rng.integers(0, 2**32, (1, 6, 8), dtype=np.uint32)
        valid = np.ones((1, 6), bool)
        world = rng.normal(size=(1, 6, 3)).astype(np.float32)
        (_, _, _, cnt, drop), pid = _assign_point_ids(
            jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(world),
            cap=4, max_ham=40,
        )
        assert int(cnt) == 4 and int(drop) == 2
        assert np.asarray(pid)[0].tolist() == [0, 1, 2, 3, -1, -1]


class TestVectorizedBAAssembly:
    def test_problem_structure_and_reprojection_consistency(self):
        rng = np.random.default_rng(11)
        sys_ = SLAMSystem(_cfg())
        F, W = 32, 8
        shared_world = rng.uniform(-6, 6, (F, 3)).astype(np.float32)
        shared_desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
        for i in range(3):
            kf = _make_kf(
                i, _rand_pose(rng), shared_world, shared_desc,
                np.ones(F, bool),
            )
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)

        prob = sys_.build_ba_problem()
        assert prob is not None
        # all three keyframes see the same F landmarks -> F deduped points
        assert int(prob.pt_valid.sum()) == F
        assert int(prob.obs_valid.sum()) == 3 * F
        # every valid observation's uv is the exact projection of the
        # stored (first-seen) world point into its camera
        obs_valid = np.asarray(prob.obs_valid)
        cams = np.asarray(prob.obs_cam)[obs_valid]
        ptsi = np.asarray(prob.obs_pt)[obs_valid]
        uv = np.asarray(prob.obs_uv)[obs_valid]
        p_cam = jax.vmap(
            lambda c, p: geometry.se3_apply_inverse(
                jnp.asarray(prob.cam_pose)[c], jnp.asarray(prob.points)[p]
            )
        )(jnp.asarray(cams), jnp.asarray(ptsi))
        uv_ref = np.asarray(sys_.camera.project(p_cam))
        np.testing.assert_allclose(uv, uv_ref, atol=1e-4)
        # matched observations across keyframes share point ids
        pid_mat = ptsi.reshape(3, F)
        assert (pid_mat[0] == pid_mat[1]).all()
        assert (pid_mat[0] == pid_mat[2]).all()

    def test_runs_ba_end_to_end(self):
        rng = np.random.default_rng(12)
        sys_ = SLAMSystem(_cfg())
        F, W = 24, 8
        world = rng.uniform(-6, 6, (F, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
        for i in range(3):
            pose = np.array([0.5 * i, 0, 0, 0, 0, 0, 1], np.float32)
            kf = _make_kf(i, pose, world, desc, np.ones(F, bool))
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)
        res = sys_.run_ba(iters=2)
        assert res is not None
        assert np.isfinite(np.asarray(res.problem.cam_pose)).all()


class TestCapObsPerPoint:
    def test_even_decimation_caps_counts(self):
        import jax.numpy as jnp

        from parakeet_slam_tpu.backend import graph as graph_mod

        rng = np.random.default_rng(13)
        n_pts, n_obs = 6, 200
        obs_pt = rng.integers(0, n_pts, n_obs).astype(np.int32)
        obs_pt[:5] = 5  # ensure a small group too
        valid = rng.random(n_obs) > 0.1
        prob = graph_mod.make_ba_problem(
            jnp.zeros((2, 7)).at[:, 6].set(1.0),
            jnp.asarray(rng.normal(size=(n_pts, 3)).astype(np.float32)),
            jnp.zeros(n_obs, jnp.int32),
            jnp.asarray(obs_pt),
            jnp.asarray(rng.normal(size=(n_obs, 2)).astype(np.float32)),
            obs_valid=jnp.asarray(valid),
        )
        k = 8
        capped = graph_mod.cap_obs_per_point(prob, k)
        v0 = np.asarray(prob.obs_valid)
        v1 = np.asarray(capped.obs_valid)
        assert (~v0 | v1 | ~v1).all()  # capping only clears bits
        assert not (v1 & ~v0).any()
        counts = np.bincount(np.asarray(prob.obs_pt)[v1], minlength=n_pts)
        assert counts.max() <= k
        # groups at/below the cap are untouched
        c0 = np.bincount(np.asarray(prob.obs_pt)[v0], minlength=n_pts)
        for p in range(n_pts):
            if c0[p] <= k:
                assert counts[p] == c0[p], p
            else:
                assert counts[p] == k, p
        # kept observations are spread: first and (near-)last ranks survive
        idx = np.nonzero(v0)[0]
        order = np.argsort(np.asarray(prob.obs_pt)[idx], kind="stable")
        o_sorted = idx[order]
        for p in range(n_pts):
            grp = o_sorted[np.asarray(prob.obs_pt)[o_sorted] == p]
            if len(grp) > k:
                assert v1[grp[0]]  # rank 0 kept


class TestBAIsNotATautology:
    def test_noisy_keyframe_measurements_give_nonzero_cost_and_ba_reduces_it(self):
        """Regression for the round-4 EuRoC no-op: build_ba_problem must use
        each keyframe's OWN measured local points as observations — with
        per-keyframe measurement noise the initial cost is nonzero and BA
        reduces it. (Projecting the deduped store position into every
        camera instead makes the problem self-consistent at its initial
        values: cost identically 0, LM strictly rejects every step.)"""
        from parakeet_slam_tpu.backend import ba as ba_mod

        rng = np.random.default_rng(21)
        sys_ = SLAMSystem(_cfg(max_landmarks=128))
        F, W = 32, 8
        world = rng.uniform(-6, 6, (F, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
        for i in range(4):
            pose = np.array([0.6 * i, 0.1 * i, 0, 0, 0, 0, 1], np.float32)
            noisy = world + rng.normal(0, 0.05, world.shape).astype(np.float32)
            kf = _make_kf(i, pose, noisy, desc, np.ones(F, bool))
            sys_.keyframes.append(kf)
            sys_._kf_store_append(kf)
        prob = sys_.build_ba_problem()
        assert prob is not None
        cost0 = float(ba_mod.ba_cost(sys_.camera, prob, huber_delta=2.0))
        assert cost0 > 1.0, cost0  # independent measurements disagree
        res = sys_.run_ba(iters=8)
        cost1 = float(np.asarray(res.costs)[-1])
        assert np.isfinite(cost1)
        assert cost1 < cost0, (cost0, cost1)

"""Schur block apply against numpy + distributed BA equals single-device BA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parakeet_slam_tpu.backend import ba as ba_mod
from parakeet_slam_tpu.dist import dist_ba
from parakeet_slam_tpu.dist.mesh import make_mesh
from parakeet_slam_tpu.kernels import schur


class TestSchurKernel:
    @pytest.mark.parametrize("n", [1, 100, 1024, 5000])
    def test_apply_cinv_parity(self, n):
        key = jax.random.PRNGKey(n)
        a = jax.random.normal(key, (n, 3, 3))
        C = a @ jnp.swapaxes(a, -1, -2) + 0.5 * jnp.eye(3)
        u = jax.random.normal(jax.random.fold_in(key, 1), (n, 3))
        y_ref = schur.cinv_apply(C, u)
        y_np = np.linalg.solve(np.asarray(C), np.asarray(u)[..., None])[..., 0]
        np.testing.assert_allclose(np.asarray(y_ref), y_np, rtol=1e-3, atol=1e-4)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
class TestDistributedBA:
    def test_matches_single_device(self):
        from tests.test_backend import _make_ba_problem

        cam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(11))
        # single-device reference
        res = ba_mod.optimize_ba(
            cam, prob, iters=6, pcg_iters=60, solver="pcg", huber_delta=50.0
        )
        # distributed over 8 map shards (full mesh on dcn axis)
        mesh = make_mesh(n_devices=8, map_axis=8)
        sp = dist_ba.shard_problem(prob, 8)
        prob_d, costs = dist_ba.optimize_ba_distributed(
            cam, sp, mesh, iters=6, pcg_iters=60, huber_delta=50.0
        )
        # both recover the gt camera ring (deterministic-psum tolerance,
        # SURVEY.md §5 "multi-host without a pod")
        np.testing.assert_allclose(
            np.asarray(prob_d.cam_pose[:, :3]),
            np.asarray(res.problem.cam_pose[:, :3]),
            atol=5e-3,
        )
        err = np.linalg.norm(
            np.asarray(prob_d.cam_pose[:, :3] - gt_poses[:, :3]), axis=1
        )
        assert err.max() < 0.05, err.max()


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
class TestDistributedBA2D:
    def test_2d_sharded_matches_single_device(self):
        """Keyframe axis over dcn x point axis over ici (SURVEY.md §2b
        trajectory/keyframe sharding): the (2, 4) mesh result must agree
        with the single-device solver."""
        from tests.test_backend import _make_ba_problem

        cam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(11))
        res = ba_mod.optimize_ba(
            cam, prob, iters=6, pcg_iters=60, solver="pcg", huber_delta=50.0
        )
        mesh = make_mesh(n_devices=8, map_axis=2)  # (dcn=2, ici=4)
        sp = dist_ba.shard_problem_2d(prob, 2, 4)
        prob_d, costs = dist_ba.optimize_ba_distributed_2d(
            cam, sp, mesh, iters=6, pcg_iters=60, huber_delta=50.0
        )
        np.testing.assert_allclose(
            np.asarray(prob_d.cam_pose[:, :3]),
            np.asarray(res.problem.cam_pose[:, :3]),
            atol=5e-3,
        )
        err = np.linalg.norm(
            np.asarray(prob_d.cam_pose[:, :3] - gt_poses[:, :3]), axis=1
        )
        assert err.max() < 0.05, err.max()
        # costs strictly descend overall
        c = np.asarray(costs)
        assert c[-1] < c[0]

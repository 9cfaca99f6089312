"""Config-5 demonstration at spec scale (BASELINE.json:11): panoramic
online SLAM with the particle axis sharded over `ici`, a 131072-landmark
map capacity, ring-streamed matching over the full sharded descriptor
database, distributed BA with 100k+ points sharded over `dcn`, and the
weak-scaling table (BASELINE.json:5 "scaling efficiency").

Run on an 8-virtual-device CPU mesh (what CI can validate without an
accelerator — SURVEY.md §5 "multi-device without a cluster"):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m parakeet_slam_tpu.eval.config5_demo

On real devices the same code produces the headline numbers (the mesh
axes map to GPUs instead of virtual CPU devices). Emits one JSON line
per measurement and writes the full artifact to --out (default
eval_artifacts/config5_cpu8.json).
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _sync(x):
    jax.block_until_ready(x)


def demo_online_sharded(n_frames=6, L=131072, P=32, Z=16):
    """Panoramic online system, particle axis sharded, 131072-slot map.

    On the CPU mesh the filter runs the XLA reference path, whose per-
    observation [P, L] traffic bounds throughput — Z is kept small here so
    the demo validates the 100k-map sharded program end-to-end in minutes;
    on the GPU the association sweep is the score kernel (map read once
    per frame)."""
    from parakeet_slam_tpu.core.config import (
        BackendConfig, DistConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )
    from parakeet_slam_tpu.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu.system import SLAMSystem

    H, W = 128, 256
    cfg = SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0,
            new_landmark_loglik=-14.0, max_range=45.0,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.12,
            camera="equirect", image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=64, keyframe_translation=1.0),
        dist=DistConfig(particle_axis=4, map_axis=2),
    )
    world = make_panoramic_world(
        num_landmarks=300, num_steps=n_frames, image_size=(H, W), seed=11
    )
    sys_ = SLAMSystem(cfg)
    assert sys_._sharded is not None, "mesh did not fit — need 8 devices"
    est = sys_.process_frame(world.render(0), world.odom[0])  # compile
    _sync(est)
    t0 = time.perf_counter()
    for t in range(1, n_frames):
        est = sys_.process_frame(world.render(t), world.odom[t])
    _sync(est)
    fps = (n_frames - 1) / (time.perf_counter() - t0)
    sys_.flush_flags()
    row = {
        "bench": "online_sharded_filter",
        "mesh": dict(sys_.mesh.shape),
        "particles": P,
        "map_capacity": L,
        "frames_per_s": round(fps, 3),
        "keyframes": len(sys_.keyframes),
    }
    print(json.dumps(row))
    return row


def demo_ring_match(M=131072, N=256, W=8):
    """Full-map descriptor matching with the database sharded over all
    devices and streamed around the ring (dist/ring_match.py)."""
    from jax.sharding import PartitionSpec as P_

    try:
        from jax import shard_map as shard_map_fn
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map as shard_map_fn

    from parakeet_slam_tpu.dist.mesh import make_mesh
    from parakeet_slam_tpu.dist.ring_match import ring_hamming_top2
    from parakeet_slam_tpu.kernels import match as match_mod

    n_dev = jax.device_count()
    mesh = make_mesh(n_devices=n_dev, map_axis=1)
    rng = np.random.default_rng(0)
    qd = jnp.asarray(rng.integers(0, 2**32, (N, W), dtype=np.uint32))
    db = jnp.asarray(rng.integers(0, 2**32, (M, W), dtype=np.uint32))
    dbv = jnp.asarray(rng.random(M) > 0.05)

    fn = shard_map_fn(
        lambda q, d, v: ring_hamming_top2(q, jnp.ones(q.shape[0], bool), d, v, "ici"),
        mesh=mesh,
        in_specs=(P_(), P_("ici"), P_("ici")),
        out_specs=(P_(), P_(), P_()),
        check_vma=False,
    )
    fn = jax.jit(fn)
    bi, b1, b2 = fn(qd, db, dbv)
    _sync(bi)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        bi, b1, b2 = fn(qd, db, dbv)
    _sync(bi)
    dt = (time.perf_counter() - t0) / reps
    # verify vs the single-device reference
    bi_x, b1_x, b2_x = match_mod.hamming_top2(qd, db, dbv)
    ok = bool(
        (np.asarray(b1) == np.asarray(b1_x)).all()
        and (np.asarray(b2) == np.asarray(b2_x)).all()
    )
    row = {
        "bench": "ring_match",
        "db_size": M,
        "queries": N,
        "devices": n_dev,
        "ms": round(dt * 1e3, 2),
        "parity_vs_reference": ok,
    }
    print(json.dumps(row))
    return row


def _make_big_ba(C=64, Pts=110000, obs_per_cam=2000, seed=0):
    from parakeet_slam_tpu.backend.graph import make_ba_problem
    from parakeet_slam_tpu.core import geometry
    from parakeet_slam_tpu.frontend.camera import Pinhole

    cam = Pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
    key = jax.random.PRNGKey(seed)
    pts = jax.random.uniform(
        key, (Pts, 3), minval=-10.0, maxval=10.0
    ) + jnp.array([0.0, 0.0, 15.0])
    poses = jnp.tile(jnp.zeros((7,)).at[6].set(1.0), (C, 1))
    poses = poses.at[:, 0].set(jnp.linspace(0, 5, C))
    O = C * obs_per_cam
    obs_cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), obs_per_cam)
    obs_pt = jax.random.randint(
        jax.random.fold_in(key, 1), (O,), 0, Pts, dtype=jnp.int32
    )
    uv = jax.vmap(
        lambda c, p: cam.project(geometry.se3_apply_inverse(poses[c], pts[p]))
    )(obs_cam, obs_pt)
    uv = uv + 0.5 * jax.random.normal(jax.random.fold_in(key, 2), uv.shape)
    return cam, make_ba_problem(poses, pts, obs_cam, obs_pt, uv)


def demo_dist_ba(Pts=110000, iters=3, pcg_iters=15, map_axes=(1, 2, 4)):
    """Distributed BA at 100k+ points: landmark blocks sharded over `dcn`,
    reduced camera system psum-assembled. Weak-scaling over the map axis."""
    from parakeet_slam_tpu.dist import dist_ba
    from parakeet_slam_tpu.dist.mesh import make_mesh

    cam, prob = _make_big_ba(Pts=Pts)
    rows = []
    base = None
    for S in map_axes:
        if S > jax.device_count():
            continue
        mesh = make_mesh(n_devices=S, map_axis=S)
        sp = dist_ba.shard_problem(prob, S)
        call = lambda: dist_ba.optimize_ba_distributed(  # noqa: E731
            cam, sp, mesh, iters=iters, pcg_iters=pcg_iters, huber_delta=50.0
        )
        res_prob, costs = call()
        _sync(res_prob.cam_pose)
        t0 = time.perf_counter()
        res_prob, costs = call()
        _sync(res_prob.cam_pose)
        dt = (time.perf_counter() - t0) / iters
        ips = 1.0 / dt
        if base is None:
            base = ips
        rows.append({
            "bench": "dist_ba",
            "points": Pts,
            "obs": int(np.asarray(prob.obs_valid).sum()),
            "map_shards": S,
            "lm_iters_per_s": round(ips, 3),
            "efficiency_vs_1shard": round(ips / base, 3),
            "final_cost": float(np.asarray(costs)[-1]),
        })
        print(json.dumps(rows[-1]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="eval_artifacts/config5_cpu8.json")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--ba-points", type=int, default=110000)
    ap.add_argument(
        "--platform", default="cpu8",
        help="'cpu8' (default) forces an 8-virtual-device CPU platform; "
        "'native' uses the ambient platform (e.g. four GPUs)",
    )
    args = ap.parse_args(argv)
    if args.platform == "cpu8":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    print(f"devices: {jax.device_count()} x {jax.devices()[0].platform}")
    art = {
        "devices": jax.device_count(),
        "platform": jax.devices()[0].platform,
    }
    art["online"] = demo_online_sharded(n_frames=args.frames)
    art["ring_match"] = demo_ring_match()
    art["dist_ba"] = demo_dist_ba(Pts=args.ba_points)

    from parakeet_slam_tpu.eval.scaling import measure_scaling

    art["filter_weak_scaling"] = measure_scaling()
    if args.platform == "cpu8":
        art["note"] = (
            "8-virtual-device CPU mesh: all devices share one physical "
            "CPU, so per-device throughput necessarily drops as devices "
            "are added — these rows validate the collective STRUCTURE "
            "(sharding, ring streams, psum assembly produce correct "
            "results at 100k+ landmark scale); scaling efficiency per "
            "BASELINE.json:5 is only measurable on real multi-chip "
            "hardware."
        )

    import os

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

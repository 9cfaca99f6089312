"""Per-operation timings on the GPU at the KITTI 00 preset's widths.

Times what the filter and backend run per frame or per iteration — the
association score sweep (the Pallas kernel and its XLA reference), the XLA
EKF apply pass, the resampling gather, descriptor matching, the Schur
block apply, a BA iteration — and one whole FastSLAM 2.0 frame with the
score kernel on and off. Each row gives milliseconds, the bytes and
operations the step needs (computed from shapes), and the share of the
card's published memory-bandwidth peak. The card must be in `_PEAKS`:
an unknown device is an error, not a default.

    python -m parakeet_slam_tpu.cli bench [--kernel NAME]
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

# Published peaks by `device_kind`: (memory GB/s, float32 TFLOP/s outside
# the tensor cores). NVIDIA H100 SXM data sheet, dense rates, 700 W.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 67.0),
}

# KITTI 00 preset widths (configs/kitti_00.yaml)
P_KITTI, L_KITTI, Z_KITTI, W_DESC = 2048, 10240, 128, 8


def peaks_for(device) -> tuple[float, float]:
    kind = device.device_kind
    if kind not in _PEAKS:
        raise KeyError(
            f"no published peaks for device {kind!r} ({device.platform}); "
            f"known: {sorted(_PEAKS)}"
        )
    return _PEAKS[kind]


def _timed(fn, reps=10):
    from parakeet_slam_tpu.eval.profiling import timed

    dt, _ = timed(fn, reps=reps, warmup=1)
    return dt


def vision_filter(model="stereo_3d", P=P_KITTI, L=L_KITTI, Z=Z_KITTI,
                  algorithm="fastslam2"):
    """A filter of the given camera model at the KITTI 00 preset's
    settings (camera of the preset that uses the model)."""
    from parakeet_slam_tpu.core.config import FilterConfig, FrontendConfig
    from parakeet_slam_tpu.filter import make_filter

    Dz = 3 if model == "stereo_3d" else 2
    fe = {
        "stereo_3d": FrontendConfig(
            camera="stereo", intrinsics=(718.856, 718.856, 607.1928, 185.2157),
            baseline=0.5372, image_size=(376, 1241),
        ),
        "pinhole_3d": FrontendConfig(
            camera="pinhole", intrinsics=(458.654, 457.296, 367.215, 248.375),
            image_size=(480, 752),
        ),
        "equirect_3d": FrontendConfig(camera="equirect", image_size=(1024, 2048)),
    }[model]
    cfg = FilterConfig(
        num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3,
        obs_dim=Dz, pose_dim=7, desc_words=W_DESC, sig_dim=0,
        measurement_model=model, motion_model="se3_odometry",
        algorithm=algorithm, motion_noise=(0.022, 0.003),
        meas_noise=(1.5, 1.5, 1.0)[:Dz], max_range=60.0, cull_unseen=True,
        weight_min_count=5, weight_only_matched=True, assoc_gate_px=4.0,
        init_range_prior=5.0, init_range_sigma=3.0,
    )
    return make_filter(cfg, fe)


def synthetic_map_state(slam, key, live_frac: float = 1.0):
    """A filled map as the filter builds it: every landmark initialised by
    the measurement model from a random pixel (stereo: depth 4-50 m) at a
    near-identity particle pose, its covariance shrunk by up to 20x as
    updates would, 90% of lanes valid below `live_frac * L`. Returns
    (state, obs): the observations re-see particle 0's first Z landmarks
    with 1 px noise and their own descriptors."""
    from parakeet_slam_tpu.core.state import make_observation

    c, fe = slam.cfg, slam.fe_cfg
    P, L, Z, Dz = c.num_particles, c.max_landmarks, c.max_observations, c.obs_dim
    H, W = fe.image_size
    k = jax.random.split(key, 9)
    cols = [
        jax.random.uniform(k[0], (L,), minval=0.0, maxval=W),
        jax.random.uniform(k[1], (L,), minval=0.0, maxval=H),
    ]
    if Dz == 3:
        depth = jax.random.uniform(k[2], (L,), minval=4.0, maxval=50.0)
        cols.append(fe.intrinsics[0] * fe.baseline / depth)
    z_lm = jnp.stack(cols, axis=1)
    t = 0.05 * jax.random.normal(k[3], (P, 3))
    q = jax.random.normal(k[4], (P, 4)) * jnp.array([0.005, 0.005, 0.005, 1.0])
    pose = jnp.concatenate([t, q / jnp.linalg.norm(q, axis=1, keepdims=True)], 1)

    @jax.jit
    def init_map(pose, z_lm, shrink):
        with jax.default_matmul_precision("highest"):
            mean, cov = jax.vmap(
                jax.vmap(slam.model.init, in_axes=(None, 0)), in_axes=(0, None)
            )(pose, z_lm)
        return mean, cov * shrink

    shrink = jax.random.uniform(k[5], (P, L, 1, 1), minval=0.05, maxval=1.0)
    mean, cov = init_map(pose, z_lm, shrink)
    desc = jax.random.bits(k[6], (P, L, W_DESC), jnp.uint32)
    valid = (jax.random.uniform(k[7], (P, L)) < 0.9) & (
        jnp.arange(L) < int(live_frac * L)
    )
    count = jax.random.randint(k[8], (P, L), 0, 20)
    state = slam.init_state().replace(
        pose=pose, lm_mean=mean, lm_cov=cov, lm_desc=desc,
        lm_valid=valid, lm_count=count,
    )
    z = z_lm[:Z] + jax.random.normal(k[0], (Z, Dz))
    obs = make_observation(z, desc=desc[0, :Z], valid=jnp.ones((Z,), bool))
    return state, obs


def _state_bytes(slam) -> int:
    c = slam.cfg
    per_lane = 4 * (3 + 9 + c.desc_words + 1) + 1  # mean, cov, desc, count, valid
    return c.num_particles * c.max_landmarks * per_lane


def bench_score(kernel: bool, model="stereo_3d"):
    """Whole-frame association sweep at KITTI width: the Pallas kernel or
    the XLA scan (one map read per observation)."""
    slam = vision_filter(model)
    state, obs = synthetic_map_state(slam, jax.random.PRNGKey(0))
    slam.score_kernel = kernel
    fn = jax.jit(slam._frame_scores)
    dt = _timed(lambda: fn(state, obs))
    c = slam.cfg
    sweeps = 1 if kernel else c.max_observations
    return dt, _state_bytes(slam) * sweeps, c.num_particles * c.max_landmarks * c.max_observations * 60


def bench_apply():
    """XLA EKF apply pass (association bookkeeping, per-observation EKF
    update/allocation scan, culling) at KITTI width with given scores."""
    slam = vision_filter()
    state, obs = synthetic_map_state(slam, jax.random.PRNGKey(0))
    scores = jax.jit(slam._frame_scores)(state, obs)
    fn = jax.jit(lambda st, o, s: slam.measurement_core(st, o, False, s))
    dt = _timed(lambda: fn(state, obs, scores))
    # each observation's one-hot writes rewrite the mean/cov/desc/count planes
    return dt, _state_bytes(slam) * 2 * slam.cfg.max_observations, 0


def bench_resample():
    """Resampling gather of the whole particle state (`jnp.take`)."""
    from parakeet_slam_tpu.kernels import resample

    slam = vision_filter()
    state, _ = synthetic_map_state(slam, jax.random.PRNGKey(0))
    idx = jax.random.randint(jax.random.PRNGKey(1), (P_KITTI,), 0, P_KITTI)
    fn = jax.jit(resample.gather_particles)
    dt = _timed(lambda: fn(state, idx))
    return dt, 2 * _state_bytes(slam), 0


def bench_frame(kernel: bool):
    """One FastSLAM 2.0 frame (proposal, association, EKF apply, resample)
    at KITTI width, with the score kernel on or off."""
    slam = vision_filter()
    state, obs = synthetic_map_state(slam, jax.random.PRNGKey(0), live_frac=0.4)
    slam.score_kernel = kernel
    u = jnp.zeros((6,)).at[2].set(0.8)
    fn = jax.jit(slam.step)
    dt = _timed(lambda: fn(state, u, obs, jax.random.PRNGKey(7)), reps=5)
    return dt, 0, 0


def bench_match(N=512, M=100_000):
    """Keyframe descriptor matching (XOR + popcount + top-2) against a
    100k-entry database."""
    from parakeet_slam_tpu.kernels import match

    key = jax.random.PRNGKey(0)
    qd = jax.random.bits(key, (N, W_DESC), jnp.uint32)
    db = jax.random.bits(jax.random.fold_in(key, 1), (M, W_DESC), jnp.uint32)
    valid = jnp.ones((M,), bool)
    fn = jax.jit(match.hamming_top2)
    dt = _timed(lambda: fn(qd, db, valid))
    return dt, (N + M) * W_DESC * 4, N * M * W_DESC * 3


def bench_schur(N=262144):
    from parakeet_slam_tpu.kernels import schur

    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (N, 3, 3))
    C = a @ jnp.swapaxes(a, -1, -2) + 0.5 * jnp.eye(3)
    u = jax.random.normal(jax.random.fold_in(key, 1), (N, 3))
    fn = jax.jit(schur.cinv_apply)
    dt = _timed(lambda: fn(C, u))
    return dt, N * (9 + 3 + 3) * 4, N * 60


def bench_ba(C=64, Pts=50000, obs_per_cam=2000, iters=4, pcg_iters=25):
    """Schur/PCG BA iterations at EuRoC-config scale (SURVEY.md §7 'BA
    iterations/s'): C cameras, 50k landmarks, C*obs_per_cam residuals."""
    from parakeet_slam_tpu.backend import ba as ba_mod
    from parakeet_slam_tpu.backend.graph import make_ba_problem, pack_buckets
    from parakeet_slam_tpu.core import geometry
    from parakeet_slam_tpu.frontend.camera import Pinhole

    cam = Pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
    key = jax.random.PRNGKey(0)
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
    bk = pack_buckets(make_ba_problem(poses, pts, obs_cam, obs_pt, uv))

    def call():
        return ba_mod.optimize_ba(
            cam, bk, iters=iters, pcg_iters=pcg_iters, huber_delta=50.0
        ).problem.cam_pose

    dt = _timed(call, reps=3)
    flops = iters * O * (500 + pcg_iters * 120)
    bytes_moved = iters * (1 + pcg_iters) * O * (2 + 12 + 6) * 4
    return dt / iters, bytes_moved / iters, flops / iters


BENCHES = {
    "score_kernel": lambda: bench_score(True),
    "score_xla": lambda: bench_score(False),
    "apply_xla": bench_apply,
    "resample": bench_resample,
    "frame_kernel": lambda: bench_frame(True),
    "frame_xla": lambda: bench_frame(False),
    "match": bench_match,
    "schur": bench_schur,
    "ba_iteration": bench_ba,
}


def main(args=None):
    from parakeet_slam_tpu.eval.profiling import card_name_and_power_limit

    which = getattr(args, "kernel", "all") if args else "all"
    dev = jax.devices()[0]
    peak_bw, _ = peaks_for(dev)
    print(card_name_and_power_limit())
    rows = []
    for name, fn in BENCHES.items():
        if which not in ("all", name):
            continue
        dt, bytes_moved, flops = fn()
        gbs = bytes_moved / dt / 1e9
        rows.append({
            "op": name,
            "device": dev.device_kind,
            "ms": dt * 1e3,
            "GB/s": gbs,
            "bw_share": gbs / peak_bw,
            "GFLOP/s": flops / dt / 1e9,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

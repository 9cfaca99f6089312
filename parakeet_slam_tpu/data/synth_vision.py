"""Full-scale synthetic vision sequences for driver benchmark configs 2-3
(TUM fr1/desk-class monocular, KITTI 00-class stereo) + on-disk format
writers so the real TUM/KITTI loaders are exercised end-to-end.

The container has no dataset downloads (BASELINE.md provenance note), so
the headline ATE numbers are produced on procedurally generated worlds
rendered at the real datasets' resolutions/intrinsics and written in the
real datasets' on-disk formats — the CLI then drives the actual
`data/tum.py` / `data/kitti.py` loaders, the full frontend, the filter,
and the backend exactly as it would on the downloaded data.

Rendering is a vectorized local-patch Gaussian splat (numpy `add.at` over
[N_blobs, S, S] windows) — O(visible landmarks), not O(H*W*landmarks) like
the small panoramic renderer, so 640x480 and 1241x376 sequences render in
milliseconds per frame. Each landmark carries a stable 3-blob texture
signature so BRIEF descriptors are repeatable across frames (same trick as
`data/panoramic.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

import jax.numpy as jnp

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.data.png import write_png

# body (x-forward, z-up, yaw) -> optical (z-forward, y-down) quaternion,
# same convention as data/panoramic.py make_panoramic_world.
_Q_BC = np.array([-0.5, 0.5, -0.5, 0.5], np.float32)

_PATCH_R = 12  # splat window radius (3 sigma of the largest blob + satellites)


def _quat_rotate_many(q, v):
    return np.asarray(geometry.quat_rotate(jnp.asarray(q)[None], jnp.asarray(v)))


def _splat(img, u, v, amp, sigma, wrap_x):
    """Accumulate Gaussian blobs at float centers (u, v) into img in-place.

    u, v, amp, sigma: [N]. Only a (2R+1)^2 window per blob is touched."""
    H, W = img.shape
    n = len(u)
    if n == 0:
        return
    R = _PATCH_R
    off = np.arange(-R, R + 1)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    gx = ui[:, None] + off[None, :]                       # [N, S]
    gy = vi[:, None] + off[None, :]                       # [N, S]
    dx = gx - u[:, None]
    dy = gy - v[:, None]
    val = amp[:, None, None] * np.exp(
        -(dx[:, None, :] ** 2 + dy[:, :, None] ** 2)
        / (2.0 * sigma[:, None, None] ** 2)
    )                                                     # [N, S, S]
    ok_y = (gy >= 0) & (gy < H)
    if wrap_x:
        gx = gx % W
        ok_x = np.ones_like(gx, bool)
    else:
        ok_x = (gx >= 0) & (gx < W)
    mask = ok_y[:, :, None] & ok_x[:, None, :]
    np.add.at(
        img,
        (np.clip(gy, 0, H - 1)[:, :, None].repeat(2 * R + 1, axis=2),
         np.clip(gx, 0, W - 1)[:, None, :].repeat(2 * R + 1, axis=1)),
        np.where(mask, val, 0.0),
    )


@dataclass
class VisionWorld:
    """Procedural textured landmark world rendered through a real camera."""

    landmarks: np.ndarray          # [N, 3] world positions
    gt_pose: np.ndarray            # [T, 7] world-from-camera (t, qxyzw)
    odom: np.ndarray               # [T, 6] noisy body-frame twist increments
    image_size: tuple[int, int]    # (H, W)
    intrinsics: tuple[float, float, float, float]
    baseline: float                # stereo baseline (0 = monocular)
    max_render_range: float
    seed: int

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 99)
        n = len(self.landmarks)
        self._sizes = rng.uniform(1.6, 3.0, n).astype(np.float32)
        self._sat = rng.uniform(-6, 6, (n, 2, 2)).astype(np.float32)
        self._sat_amp = rng.uniform(0.35, 0.9, (n, 2)).astype(np.float32)

    def __len__(self):
        return self.gt_pose.shape[0]

    def _render_pose(self, pose: np.ndarray) -> np.ndarray:
        H, W = self.image_size
        fx, fy, cx, cy = self.intrinsics
        t, q = pose[:3], pose[3:]
        p_cam = _quat_rotate_many(
            np.asarray(geometry.quat_conjugate(jnp.asarray(q))),
            self.landmarks - t,
        )
        z = p_cam[:, 2]
        vis = (z > 0.25) & (z < self.max_render_range)
        zs = np.where(vis, z, 1.0)
        u = fx * p_cam[:, 0] / zs + cx
        v = fy * p_cam[:, 1] / zs + cy
        m = _PATCH_R
        vis &= (u >= -m) & (u < W + m) & (v >= -m) & (v < H + m)
        j = np.where(vis)[0]
        img = np.zeros((H, W), np.float32)
        # center blob + two satellite blobs per visible landmark
        us = np.concatenate(
            [u[j], u[j] + self._sat[j, 0, 0], u[j] + self._sat[j, 1, 0]]
        )
        vs = np.concatenate(
            [v[j], v[j] + self._sat[j, 0, 1], v[j] + self._sat[j, 1, 1]]
        )
        amps = np.concatenate(
            [np.ones(len(j), np.float32), self._sat_amp[j, 0], self._sat_amp[j, 1]]
        )
        sig = np.concatenate([self._sizes[j]] * 3)
        _splat(img, us, vs, amps, sig, wrap_x=False)
        return np.clip(img, 0.0, 1.0)

    def render(self, i: int) -> np.ndarray:
        return self._render_pose(self.gt_pose[i])

    def render_stereo(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        assert self.baseline > 0, "monocular world"
        pose = self.gt_pose[i]
        left = self._render_pose(pose)
        offset = np.asarray(
            geometry.se3_apply(
                jnp.asarray(pose), jnp.array([self.baseline, 0.0, 0.0])
            )
        )
        right_pose = pose.copy()
        right_pose[:3] = offset
        right = self._render_pose(right_pose)
        return left, right


def _poses_from_track(xy, yaw, height, rng, odom_noise):
    """Yaw-only body track -> optical-frame SE(3) poses + noisy odometry."""
    T = len(xy)
    poses = np.zeros((T, 7), np.float32)
    for i in range(T):
        se2 = jnp.array([xy[i, 0], xy[i, 1], yaw[i]])
        p = np.array(geometry.se2_to_se3(se2))
        p[2] = height[i]
        q = np.asarray(
            geometry.quat_multiply(jnp.asarray(p[3:]), jnp.asarray(_Q_BC))
        )
        poses[i] = np.concatenate([p[:3], q])
    odom = np.zeros((T, 6), np.float32)
    for i in range(1, T):
        rel = np.asarray(
            geometry.se3_log(
                geometry.se3_between(
                    jnp.asarray(poses[i - 1]), jnp.asarray(poses[i])
                )
            )
        )
        noise = np.concatenate(
            [rng.normal(0, odom_noise[0], 3), rng.normal(0, odom_noise[1], 3)]
        )
        odom[i] = rel + noise
    return poses, odom


def make_desk_world(
    num_landmarks: int = 1000,
    num_steps: int = 600,
    image_size: tuple[int, int] = (480, 640),
    intrinsics: tuple[float, ...] = (517.3, 516.5, 318.6, 255.3),
    orbit_radius: float = 1.8,
    odom_noise: tuple[float, float] = (0.004, 0.002),
    seed: int = 20,
) -> VisionWorld:
    """TUM fr1/desk-class monocular world (driver config 2): a handheld-like
    camera orbits a cluttered desk twice (second orbit revisits the first —
    loop closures), 640x480 @ fr1 intrinsics, ~1k landmarks."""
    rng = np.random.default_rng(seed)
    n_desk = int(num_landmarks * 0.6)
    n_room = num_landmarks - n_desk
    desk = np.stack(
        [
            rng.uniform(-0.7, 0.7, n_desk),
            rng.uniform(-0.5, 0.5, n_desk),
            rng.uniform(0.0, 0.35, n_desk),
        ],
        axis=1,
    )
    # room shell: points on walls 2.5-4 m out, at desk-to-ceiling heights
    az = rng.uniform(0, 2 * np.pi, n_room)
    r = rng.uniform(2.5, 4.0, n_room)
    room = np.stack(
        [r * np.cos(az), r * np.sin(az), rng.uniform(-0.7, 1.4, n_room)], axis=1
    )
    landmarks = np.concatenate([desk, room]).astype(np.float32)

    th = np.linspace(0, 4 * np.pi, num_steps, endpoint=False)  # two orbits
    # handheld wobble on radius/height
    wob_r = 0.12 * np.sin(3.1 * th) + 0.05 * np.sin(7.3 * th)
    wob_h = 0.08 * np.sin(2.3 * th + 1.0)
    rad = orbit_radius + wob_r
    xy = np.stack([rad * np.cos(th), rad * np.sin(th)], axis=1)
    yaw = th + np.pi  # face the desk center
    height = 0.85 + wob_h
    poses, odom = _poses_from_track(xy, yaw, height, rng, odom_noise)
    # pitch the camera down toward the desk surface
    pitch = np.deg2rad(22.0)
    q_pitch = np.array(
        [np.sin(pitch / 2) * -1.0, 0.0, 0.0, np.cos(pitch / 2)], np.float32
    )  # rotate about optical x: look down
    for i in range(num_steps):
        poses[i, 3:] = np.asarray(
            geometry.quat_multiply(
                jnp.asarray(poses[i, 3:]), jnp.asarray(q_pitch)
            )
        )
    # re-derive odometry after the pitch (increments change)
    for i in range(1, num_steps):
        rel = np.asarray(
            geometry.se3_log(
                geometry.se3_between(
                    jnp.asarray(poses[i - 1]), jnp.asarray(poses[i])
                )
            )
        )
        noise = np.concatenate(
            [rng.normal(0, odom_noise[0], 3), rng.normal(0, odom_noise[1], 3)]
        )
        odom[i] = rel + noise
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom,
        image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]),
        baseline=0.0, max_render_range=8.0, seed=seed,
    )


def make_drive_world(
    num_landmarks: int = 10000,
    num_steps: int = 700,
    image_size: tuple[int, int] = (376, 1241),
    intrinsics: tuple[float, ...] = (718.856, 718.856, 607.1928, 185.2157),
    baseline: float = 0.5372,
    circuit_half: float = 90.0,
    speed: float = 1.0,
    odom_noise: tuple[float, float] = (0.02, 0.002),
    seed: int = 21,
) -> VisionWorld:
    """KITTI 00-class stereo world (driver config 3): a vehicle drives a
    closed rounded-square street circuit (perimeter ~ 8*half) with building-
    facade landmarks on both sides; the final frames revisit the start so
    the pose-graph backend gets a real loop closure."""
    rng = np.random.default_rng(seed)

    # rounded-square centerline (side 2*half, corner radius rc),
    # parameterized by arclength; alternating straight/arc segments each
    # rotated 90 deg from the previous quadrant
    rc = 20.0
    side = 2 * circuit_half - 2 * rc
    L = 4 * side + 2 * np.pi * rc

    def center(s):
        s = np.mod(s, L)
        seg = np.empty((len(s), 2))
        yaw = np.empty(len(s))
        for i, si in enumerate(s):
            k = 0
            while si >= (side if k % 2 == 0 else np.pi * rc / 2):
                si -= side if k % 2 == 0 else np.pi * rc / 2
                k += 1
            if k % 2 == 0:  # straight, unrotated: along bottom edge heading +x
                p = np.array([-circuit_half + rc + si, -circuit_half])
                a = 0.0
            else:  # quarter arc around the bottom-right corner
                a = si / rc
                c = np.array([circuit_half - rc, -circuit_half + rc])
                p = c + rc * np.array([np.sin(a), -np.cos(a)])
            rot = (k // 2) * (np.pi / 2)
            cr, sr = np.cos(rot), np.sin(rot)
            seg[i] = np.array([cr * p[0] - sr * p[1], sr * p[0] + cr * p[1]])
            yaw[i] = rot + a
        return seg, yaw

    s = np.arange(num_steps) * speed
    xy, yaw = center(s)

    # facade landmarks: along the circuit at lateral offsets both sides
    s_lm = rng.uniform(0, L, num_landmarks)
    lat = rng.uniform(6.0, 18.0, num_landmarks) * rng.choice(
        [-1.0, 1.0], num_landmarks
    )
    hgt = rng.uniform(-1.0, 8.0, num_landmarks)
    c_lm, yaw_lm = center(s_lm)
    normal = np.stack([-np.sin(yaw_lm), np.cos(yaw_lm)], axis=1)
    lm_xy = c_lm + normal * lat[:, None]
    landmarks = np.concatenate([lm_xy, hgt[:, None]], axis=1).astype(np.float32)

    height = np.full(num_steps, 1.65)  # camera height above ground
    poses, odom = _poses_from_track(xy, yaw, height, rng, odom_noise)
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom,
        image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]),
        baseline=baseline, max_render_range=70.0, seed=seed,
    )


def make_hall_world(
    num_landmarks: int = 8000,
    num_steps: int = 400,
    session: int = 0,
    image_size: tuple[int, int] = (480, 752),
    intrinsics: tuple[float, ...] = (458.654, 457.296, 367.215, 248.375),
    odom_noise: tuple[float, float] = (0.01, 0.004),
    seed: int = 30,
) -> VisionWorld:
    """EuRoC MH-class multi-session world (driver config 4): a machine-hall
    box (wall/floor/ceiling + interior structure landmarks) flown in an
    oval loop. `session` varies the loop's radius/height/phase while the
    LANDMARKS stay identical (same seed), so sessions revisit the same
    structure — the cross-session loop closures and the joint BA that
    config 4 exercises are real, not coincidental."""
    rng = np.random.default_rng(seed)  # session-independent: shared world
    hx, hy, hz = 9.0, 6.0, 3.0  # hall half-extents (z: 0..2*hz)
    n_wall = int(num_landmarks * 0.6)
    n_struct = num_landmarks - n_wall
    # walls: points on the 4 side planes
    side = rng.integers(0, 4, n_wall)
    u = rng.uniform(-1, 1, n_wall)
    z = rng.uniform(0.0, 2 * hz, n_wall)
    wx = np.where(side == 0, hx, np.where(side == 1, -hx, u * hx))
    wy = np.where(side < 2, u * hy, np.where(side == 2, hy, -hy))
    walls = np.stack([wx, wy, z], axis=1)
    # interior structures: clustered blocks
    n_clusters = 12
    centers = np.stack(
        [
            rng.uniform(-hx * 0.7, hx * 0.7, n_clusters),
            rng.uniform(-hy * 0.7, hy * 0.7, n_clusters),
            rng.uniform(0.2, 2 * hz * 0.7, n_clusters),
        ],
        axis=1,
    )
    ci = rng.integers(0, n_clusters, n_struct)
    struct = centers[ci] + rng.normal(0, 0.6, (n_struct, 3))
    landmarks = np.concatenate([walls, struct]).astype(np.float32)

    # session trajectory: oval loop, two laps; radius/height/phase vary
    srng = np.random.default_rng(seed + 1000 + session)
    rx = 4.5 + 0.6 * session
    ry = 2.8 + 0.35 * session
    h0 = 1.0 + 0.45 * session
    phase = session * 1.1
    th = np.linspace(0, 4 * np.pi, num_steps, endpoint=False) + phase
    wob = 0.15 * np.sin(2.7 * th) + 0.06 * np.sin(6.1 * th)
    xy = np.stack([(rx + wob) * np.cos(th), (ry + wob) * np.sin(th)], axis=1)
    # face along the direction of travel
    dx = -(rx + wob) * np.sin(th)
    dy = (ry + wob) * np.cos(th)
    yaw = np.arctan2(dy, dx)
    height = h0 + 0.25 * np.sin(1.7 * th)
    poses, odom = _poses_from_track(xy, yaw, height, srng, odom_noise)
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom,
        image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]),
        baseline=0.0, max_render_range=14.0, seed=seed,
    )


# ---------------------------------------------------------------------------
# On-disk format writers (drive the real dataset loaders)
# ---------------------------------------------------------------------------


def write_tum_format(world: VisionWorld, out_dir: str, fps: float = 30.0):
    """Write rgb/*.png + rgb.txt + groundtruth.txt (TUM RGB-D layout,
    `data/tum.py` loader contract)."""
    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(len(world)):
        ts = i / fps
        name = f"rgb/{ts:.6f}.png"
        img = (world.render(i) * 255).astype(np.uint8)
        write_png(out / name, img)
        rgb_lines.append(f"{ts:.6f} {name}")
        p = world.gt_pose[i]
        gt_lines.append(
            f"{ts:.6f} " + " ".join(f"{x:.6f}" for x in p)
        )
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def write_euroc_format(world: VisionWorld, out_dir: str, fps: float = 20.0):
    """Write mav0/cam0/{data.csv,data/*.png} + state_groundtruth_estimate0/
    data.csv (ASL layout, `data/euroc.py` loader contract — NOTE the
    groundtruth quaternion is stored qw-FIRST)."""
    out = Path(out_dir)
    cam = out / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    gt_dir = out / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True, exist_ok=True)
    cam_rows = ["#timestamp [ns],filename"]
    gt_rows = [
        "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
        "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"
    ]
    for i in range(len(world)):
        ts_ns = int(i / fps * 1e9)
        name = f"{ts_ns}.png"
        img = (world.render(i) * 255).astype(np.uint8)
        write_png(cam / "data" / name, img)
        cam_rows.append(f"{ts_ns},{name}")
        p = world.gt_pose[i]
        gt_rows.append(
            f"{ts_ns},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
            f"{p[6]:.6f},{p[3]:.6f},{p[4]:.6f},{p[5]:.6f}"  # qw first
        )
    (cam / "data.csv").write_text("\n".join(cam_rows) + "\n")
    (gt_dir / "data.csv").write_text("\n".join(gt_rows) + "\n")
    return str(out)


def write_kitti_format(world: VisionWorld, out_dir: str, sequence: str = "00"):
    """Write sequences/NN/{image_0,image_1,calib.txt,times.txt} +
    poses/NN.txt (KITTI odometry layout, `data/kitti.py` loader contract).
    Returns the sequence directory path."""
    out = Path(out_dir)
    seq = out / "sequences" / sequence
    (seq / "image_0").mkdir(parents=True, exist_ok=True)
    (seq / "image_1").mkdir(parents=True, exist_ok=True)
    (out / "poses").mkdir(parents=True, exist_ok=True)
    fx, fy, cx, cy = world.intrinsics
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * world.baseline
    with open(seq / "calib.txt", "w") as f:
        for name, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)):
            f.write(name + ": " + " ".join(f"{x:.12e}" for x in P.ravel()) + "\n")
    times, pose_rows = [], []
    for i in range(len(world)):
        left, right = world.render_stereo(i)
        write_png(seq / "image_0" / f"{i:06d}.png", (left * 255).astype(np.uint8))
        write_png(seq / "image_1" / f"{i:06d}.png", (right * 255).astype(np.uint8))
        times.append(f"{i * 0.1:.6e}")
        p = world.gt_pose[i]
        R = np.asarray(geometry.quat_to_matrix(jnp.asarray(p[3:])))
        M = np.concatenate([R, p[:3, None]], axis=1)  # world-from-cam0 3x4
        pose_rows.append(" ".join(f"{x:.9e}" for x in M.ravel()))
    (seq / "times.txt").write_text("\n".join(times) + "\n")
    (out / "poses" / f"{sequence}.txt").write_text("\n".join(pose_rows) + "\n")
    return str(seq)

"""Motion and measurement model zoo for the FastSLAM filter.

Implements the behavioral contract of SURVEY.md §3 (FastSLAM 1.0, Thrun et
al. ch. 13): sampled motion models and landmark measurement models with
**analytic** Jacobians. Analytic (not autodiff) because the same closed-form
expressions are re-emitted inside the association kernel
(`kernels/score_3d`), where `jax.jacfwd` is unavailable; the tests hold the
kernel to these models.

Model interface (all per-single-landmark; the filter vmaps over [P, L]):
  h(pose, lm)        -> zhat [Dz]         predicted measurement
  jac(pose, lm)      -> H [Dz, Dl]        d h / d lm
  residual(z, zhat)  -> nu [Dz]           angle/wrap-aware z ⊖ zhat
  init(pose, z)      -> (mean [Dl], cov [Dl, Dl])  inverse model for new lms
  in_fov(pose, lm)   -> bool              gate for culling bookkeeping

The reference's measurement is a bearing+color blob observation
(SURVEY.md §3 "Reference-style"); `bearing_2d` with a signature channel
reproduces that, `range_bearing_2d` is the corridor-sim default, and the
pinhole/stereo/equirect models cover the TUM/KITTI/panoramic configs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu.core.geometry import wrap_angle

# Minimum camera-frame depth for projective models. Must be large enough
# that H ~ fx/z stays in float32 range through det(Q) ~ (sigma * (fx*x/z^2)^2)^3
# for out-of-view landmarks — 1e-3 overflows det3 to inf-inf=NaN and poisons
# the particle weights (NaN wins every argmax comparison).
MIN_DEPTH = 0.1

# ---------------------------------------------------------------------------
# Motion models (sampled, per SURVEY.md §3 "Motion update")
# ---------------------------------------------------------------------------


def sample_odometry_2d(key, pose, u, alphas):
    """Odometry motion model: u = [dx, dy, dth] in the robot frame.

    Noise std scales with the motion magnitude (alpha1..alpha4 mixing trans
    and rot contributions), then the noisy increment is composed onto each
    particle pose. pose [..., 3], u [3] -> [..., 3].
    """
    trans = jnp.linalg.norm(u[:2])
    rot = jnp.abs(u[2])
    a1, a2, a3, a4 = alphas
    sig_trans = a1 * trans + a2 * rot + 1e-6
    sig_rot = a3 * rot + a4 * trans + 1e-6
    noise = jax.random.normal(key, (*pose.shape[:-1], 3))
    du = jnp.stack(
        [
            u[0] + noise[..., 0] * sig_trans,
            u[1] + noise[..., 1] * sig_trans,
            u[2] + noise[..., 2] * sig_rot,
        ],
        axis=-1,
    )
    return geometry.se2_compose(pose, du)


def sample_velocity_2d(key, pose, u, alphas):
    """Velocity model: u = [v, omega, dt]."""
    v, w, dt = u[0], u[1], u[2]
    a1, a2, a3, a4 = alphas
    sig_v = jnp.sqrt(a1 * v * v + a2 * w * w) + 1e-6
    sig_w = jnp.sqrt(a3 * v * v + a4 * w * w) + 1e-6
    noise = jax.random.normal(key, (*pose.shape[:-1], 2))
    v_s = v + noise[..., 0] * sig_v
    w_s = w + noise[..., 1] * sig_w
    twist = jnp.stack([v_s * dt, jnp.zeros_like(v_s), w_s * dt], axis=-1)
    return geometry.se2_compose(pose, geometry.se2_exp(twist))


def sample_se3_odometry(key, pose, u, sigmas):
    """SE(3) odometry: u = twist [6]; sigmas = (sig_trans, sig_rot)."""
    s_t, s_r = sigmas[0], sigmas[1]
    noise = jax.random.normal(key, (*pose.shape[:-1], 6))
    scale = jnp.concatenate(
        [jnp.full((3,), s_t, pose.dtype), jnp.full((3,), s_r, pose.dtype)]
    )
    xi = u + noise * scale
    return geometry.se3_compose(pose, geometry.se3_exp(xi))


MOTION_MODELS: dict[str, Callable] = {
    "odometry_2d": sample_odometry_2d,
    "velocity_2d": sample_velocity_2d,
    "se3_odometry": sample_se3_odometry,
}


def get_motion_model(name: str) -> Callable:
    return MOTION_MODELS[name]


# ---------------------------------------------------------------------------
# Gaussian motion models (mean + tangent covariance) for the FastSLAM 2.0
# optimal proposal (Thrun et al. ch. 13.4; SURVEY.md §3). Each returns the
# deterministic motion mean and the noise covariance expressed in the pose's
# tangent parameterization: additive [dx, dy, dθ] for SE(2), right-perturbation
# se(3) twist for SE(3) (pose' = pose ∘ exp(δ)).
# ---------------------------------------------------------------------------


def se2_retract(pose, delta):
    """Additive SE(2) tangent retraction: pose [..., 3] ⊞ δ [..., 3]."""
    out = pose + delta
    return out.at[..., 2].set(wrap_angle(out[..., 2]))


def se3_retract(pose, delta):
    """Right-perturbation SE(3) retraction: pose [..., 7] ∘ exp(δ [..., 6])."""
    return geometry.se3_compose(pose, geometry.se3_exp(delta))


def _odometry_2d_mean_cov(pose, u, alphas):
    trans = jnp.linalg.norm(u[:2])
    rot = jnp.abs(u[2])
    a1, a2, a3, a4 = alphas
    sig_trans = a1 * trans + a2 * rot + 1e-6
    sig_rot = a3 * rot + a4 * trans + 1e-6
    mean = geometry.se2_compose(pose, u)
    # Noise is isotropic in the robot-frame xy increment, so the world-frame
    # rotation R(θ) M R(θ)ᵀ leaves the xy block diagonal.
    cov = jnp.diag(
        jnp.stack([sig_trans**2, sig_trans**2, sig_rot**2]).astype(pose.dtype)
    )
    return mean, cov


def _velocity_2d_mean_cov(pose, u, alphas):
    v, w, dt = u[0], u[1], u[2]
    a1, a2, a3, a4 = alphas
    sig_v = jnp.sqrt(a1 * v * v + a2 * w * w) + 1e-6
    sig_w = jnp.sqrt(a3 * v * v + a4 * w * w) + 1e-6

    def f(vw):
        twist = jnp.stack([vw[0] * dt, jnp.zeros((), pose.dtype), vw[1] * dt])
        return geometry.se2_compose(pose, geometry.se2_exp(twist))

    vw0 = jnp.stack([v, w])
    mean = f(vw0)
    J = jax.jacfwd(f)(vw0)  # [3, 2] — rank-2: regularize below
    M = jnp.diag(jnp.stack([sig_v**2, sig_w**2]))
    cov = J @ M @ J.T + 1e-8 * jnp.eye(3, dtype=pose.dtype)
    return mean, cov


def _se3_odometry_mean_cov(pose, u, sigmas):
    s_t, s_r = sigmas[0], sigmas[1]
    mean = geometry.se3_compose(pose, geometry.se3_exp(u))

    def f(eps):
        p = geometry.se3_compose(pose, geometry.se3_exp(u + eps))
        return geometry.se3_log(geometry.se3_between(mean, p))

    J = jax.jacfwd(f)(jnp.zeros((6,), pose.dtype))  # right Jacobian of exp at u
    M = jnp.diag(
        jnp.concatenate(
            [jnp.full((3,), s_t**2, pose.dtype), jnp.full((3,), s_r**2, pose.dtype)]
        )
    )
    return mean, J @ M @ J.T + 1e-10 * jnp.eye(6, dtype=pose.dtype)


# name -> (mean_cov(pose, u, noise) -> (mean [pd], cov [dt, dt]),
#          retract(pose, delta), tangent_dim)
MOTION_MEAN_COV: dict[str, tuple[Callable, Callable, int]] = {
    "odometry_2d": (_odometry_2d_mean_cov, se2_retract, 3),
    "velocity_2d": (_velocity_2d_mean_cov, se2_retract, 3),
    "se3_odometry": (_se3_odometry_mean_cov, se3_retract, 6),
}


def get_motion_mean_cov(name: str) -> tuple[Callable, Callable, int]:
    return MOTION_MEAN_COV[name]


# ---------------------------------------------------------------------------
# Measurement models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeasurementModel:
    name: str
    obs_dim: int
    lm_dim: int
    h: Callable       # (pose, lm) -> zhat
    jac: Callable     # (pose, lm) -> H [Dz, Dl]
    residual: Callable  # (z, zhat) -> nu
    init: Callable    # (pose, z, cfg-backed params) -> (mean, cov)
    in_fov: Callable  # (pose, lm) -> bool


def _range_bearing_2d(cfg: FilterConfig) -> MeasurementModel:
    """z = [range, bearing] of a 2-D landmark from an SE(2) pose."""

    def h(pose, lm):
        d = lm - pose[:2]
        r = jnp.sqrt(jnp.sum(d * d) + 1e-12)
        phi = wrap_angle(jnp.arctan2(d[1], d[0]) - pose[2])
        return jnp.stack([r, phi])

    def jac(pose, lm):
        d = lm - pose[:2]
        q = jnp.sum(d * d) + 1e-12
        r = jnp.sqrt(q)
        return jnp.stack(
            [jnp.stack([d[0] / r, d[1] / r]), jnp.stack([-d[1] / q, d[0] / q])]
        )

    def residual(z, zhat):
        return jnp.stack([z[0] - zhat[0], wrap_angle(z[1] - zhat[1])])

    def init(pose, z):
        r, phi = z[0], z[1]
        ang = pose[2] + phi
        mean = pose[:2] + r * jnp.stack([jnp.cos(ang), jnp.sin(ang)])
        Hm = jac(pose, mean)
        Hinv, _ = _inv2(Hm)
        R = jnp.diag(jnp.asarray(cfg.meas_noise[:2], mean.dtype) ** 2)
        cov = cfg.init_cov_inflation * (Hinv @ R @ Hinv.T)
        return mean, cov

    def in_fov(pose, lm):
        zhat = h(pose, lm)
        return (zhat[0] < cfg.max_range) & (jnp.abs(zhat[1]) < cfg.fov_half_angle)

    return MeasurementModel("range_bearing_2d", 2, 2, h, jac, residual, init, in_fov)


def _bearing_2d(cfg: FilterConfig) -> MeasurementModel:
    """Bearing-only z = [bearing]; the reference's blob-observation geometry
    (appearance channels ride separately as the signature)."""

    def h(pose, lm):
        d = lm - pose[:2]
        return wrap_angle(jnp.arctan2(d[1], d[0]) - pose[2])[None]

    def jac(pose, lm):
        d = lm - pose[:2]
        q = jnp.sum(d * d) + 1e-12
        return jnp.stack([-d[1] / q, d[0] / q])[None, :]

    def residual(z, zhat):
        return wrap_angle(z - zhat)

    def init(pose, z):
        # Unobservable depth: place at the prior range along the bearing ray
        # with large radial variance (SURVEY.md §8 "monocular landmark init").
        r0 = cfg.init_range_prior
        ang = pose[2] + z[0]
        c, s = jnp.cos(ang), jnp.sin(ang)
        mean = pose[:2] + r0 * jnp.stack([c, s])
        sig_r = cfg.init_range_sigma
        sig_t = r0 * cfg.meas_noise[0]  # bearing noise -> tangential spread
        # Rotate diag(sig_r^2, sig_t^2) into world frame.
        Rm = jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])
        cov = Rm @ jnp.diag(jnp.stack([sig_r**2, sig_t**2])) @ Rm.T
        return mean, cfg.init_cov_inflation * cov

    def in_fov(pose, lm):
        d = lm - pose[:2]
        r = jnp.sqrt(jnp.sum(d * d))
        phi = wrap_angle(jnp.arctan2(d[1], d[0]) - pose[2])
        return (r < cfg.max_range) & (jnp.abs(phi) < cfg.fov_half_angle)

    return MeasurementModel("bearing_2d", 1, 2, h, jac, residual, init, in_fov)


def _inv2(m):
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    inv = jnp.stack(
        [jnp.stack([m[1, 1], -m[0, 1]]), jnp.stack([-m[1, 0], m[0, 0]])]
    ) / det_safe
    return inv, det


def _pinhole_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """z = [u, v] pixel projection of a 3-D landmark from an SE(3) pose.

    Pose is camera-in-world [t, q]; landmark in world. Monocular init uses
    an inverse-range prior along the viewing ray (depth unobservable).
    """
    fx, fy, cx, cy = fe.intrinsics[:4]

    def cam_point(pose, lm):
        return geometry.se3_apply_inverse(pose, lm)

    def h(pose, lm):
        p = cam_point(pose, lm)
        z = jnp.clip(p[2], MIN_DEPTH)
        return jnp.stack([fx * p[0] / z + cx, fy * p[1] / z + cy])

    def jac(pose, lm):
        p = cam_point(pose, lm)
        z = jnp.clip(p[2], MIN_DEPTH)
        duv_dp = jnp.stack(
            [
                jnp.stack([fx / z, jnp.zeros_like(z), -fx * p[0] / (z * z)]),
                jnp.stack([jnp.zeros_like(z), fy / z, -fy * p[1] / (z * z)]),
            ]
        )
        # dp_cam/dlm_world = R_cw = R(q)^T
        R_wc = geometry.quat_to_matrix(pose[3:])
        return duv_dp @ R_wc.T

    def residual(z, zhat):
        return z - zhat

    def init(pose, z):
        u, v = z[0], z[1]
        ray_c = jnp.stack([(u - cx) / fx, (v - cy) / fy, jnp.ones(())])
        ray_c = ray_c / jnp.linalg.norm(ray_c)
        r0 = cfg.init_range_prior
        mean = geometry.se3_apply(pose, r0 * ray_c)
        R_wc = geometry.quat_to_matrix(pose[3:])
        ray_w = R_wc @ ray_c
        # Large variance along the ray, pixel-noise-scaled across it.
        sig_r = cfg.init_range_sigma
        sig_t = r0 * cfg.meas_noise[0] / fx
        eye = jnp.eye(3)
        along = jnp.outer(ray_w, ray_w)
        cov = sig_r**2 * along + sig_t**2 * (eye - along)
        return mean, cfg.init_cov_inflation * cov

    def in_fov(pose, lm):
        p = cam_point(pose, lm)
        uv = h(pose, lm)
        H, W = fe.image_size
        return (
            (p[2] > 0.05)
            & (p[2] < cfg.max_range)
            & (uv[0] >= 0) & (uv[0] < W) & (uv[1] >= 0) & (uv[1] < H)
        )

    return MeasurementModel("pinhole_3d", 2, 3, h, jac, residual, init, in_fov)


def _stereo_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """z = [u_left, v, disparity]; disparity = fx * b / depth. Depth is
    observable, so init is exact triangulation."""
    fx, fy, cx, cy = fe.intrinsics[:4]
    b = fe.baseline

    def h(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = jnp.clip(p[2], MIN_DEPTH)
        return jnp.stack(
            [fx * p[0] / z + cx, fy * p[1] / z + cy, fx * b / z]
        )

    def jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = jnp.clip(p[2], MIN_DEPTH)
        zero = jnp.zeros_like(z)
        dz_dp = jnp.stack(
            [
                jnp.stack([fx / z, zero, -fx * p[0] / (z * z)]),
                jnp.stack([zero, fy / z, -fy * p[1] / (z * z)]),
                jnp.stack([zero, zero, -fx * b / (z * z)]),
            ]
        )
        R_wc = geometry.quat_to_matrix(pose[3:])
        return dz_dp @ R_wc.T

    def residual(z, zhat):
        return z - zhat

    def init(pose, z):
        u, v, d = z[0], z[1], z[2]
        depth = fx * b / jnp.clip(d, 1e-3)
        p_c = jnp.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth])
        mean = geometry.se3_apply(pose, p_c)
        Hm = jac(pose, mean)
        Hinv = jnp.linalg.inv(Hm + 1e-9 * jnp.eye(3))
        R = jnp.diag(jnp.asarray(cfg.meas_noise[:3], mean.dtype) ** 2)
        return mean, cfg.init_cov_inflation * (Hinv @ R @ Hinv.T)

    def in_fov(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        uvd = h(pose, lm)
        H, W = fe.image_size
        return (
            (p[2] > 0.05) & (p[2] < cfg.max_range)
            & (uvd[0] >= 0) & (uvd[0] < W) & (uvd[1] >= 0) & (uvd[1] < H)
        )

    return MeasurementModel("stereo_3d", 3, 3, h, jac, residual, init, in_fov)


def _equirect_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """Equirectangular panoramic camera: z = [u, v] with azimuth wrap-around
    on u (SURVEY.md §3 measurement models / §8 'panoramic wrap-around')."""
    H_img, W_img = fe.image_size

    def h(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        r = jnp.linalg.norm(p) + 1e-9
        az = jnp.arctan2(p[1], p[0])            # (-pi, pi]
        el = jnp.arcsin(jnp.clip(p[2] / r, -1.0, 1.0))
        u = (az + jnp.pi) / (2 * jnp.pi) * W_img
        v = (jnp.pi / 2 - el) / jnp.pi * H_img
        return jnp.stack([u, v])

    def jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        x, y, z = p[0], p[1], p[2]
        rho2 = x * x + y * y + 1e-9
        r2 = rho2 + z * z
        rho = jnp.sqrt(rho2)
        ku = W_img / (2 * jnp.pi)
        kv = H_img / jnp.pi
        du_dp = ku * jnp.stack([-y / rho2, x / rho2, jnp.zeros_like(x)])
        # v = kv*(pi/2 - el); d el/dp = [ -xz, -yz, rho2 ] / (r2 * rho)
        dv_dp = -kv * jnp.stack([-x * z, -y * z, rho2]) / (r2 * rho)
        R_wc = geometry.quat_to_matrix(pose[3:])
        return jnp.stack([du_dp, dv_dp]) @ R_wc.T

    def residual(z, zhat):
        du = z[0] - zhat[0]
        # wrap u-residual to (-W/2, W/2]
        du = du - W_img * jnp.round(du / W_img)
        return jnp.stack([du, z[1] - zhat[1]])

    def init(pose, z):
        u, v = z[0], z[1]
        az = u / W_img * 2 * jnp.pi - jnp.pi
        el = jnp.pi / 2 - v / H_img * jnp.pi
        ray_c = jnp.stack(
            [jnp.cos(el) * jnp.cos(az), jnp.cos(el) * jnp.sin(az), jnp.sin(el)]
        )
        r0 = cfg.init_range_prior
        mean = geometry.se3_apply(pose, r0 * ray_c)
        R_wc = geometry.quat_to_matrix(pose[3:])
        ray_w = R_wc @ ray_c
        sig_r = cfg.init_range_sigma
        sig_t = r0 * (2 * jnp.pi / W_img) * cfg.meas_noise[0]
        eye = jnp.eye(3)
        along = jnp.outer(ray_w, ray_w)
        cov = sig_r**2 * along + sig_t**2 * (eye - along)
        return mean, cfg.init_cov_inflation * cov

    def in_fov(pose, lm):
        # Omnidirectional: only range-gated.
        p = geometry.se3_apply_inverse(pose, lm)
        return jnp.linalg.norm(p) < cfg.max_range

    return MeasurementModel("equirect_3d", 2, 3, h, jac, residual, init, in_fov)


def get_measurement_model(
    cfg: FilterConfig, fe: FrontendConfig | None = None
) -> MeasurementModel:
    fe = fe or FrontendConfig()
    name = cfg.measurement_model
    if name == "range_bearing_2d":
        return _range_bearing_2d(cfg)
    if name == "bearing_2d":
        return _bearing_2d(cfg)
    if name == "pinhole_3d":
        return _pinhole_3d(cfg, fe)
    if name == "stereo_3d":
        return _stereo_3d(cfg, fe)
    if name == "equirect_3d":
        return _equirect_3d(cfg, fe)
    raise KeyError(f"unknown measurement model {name!r}")

"""SE(2)/SE(3) geometry, Lie maps, and trajectory alignment.

Pure-JAX, shape-polymorphic over leading batch dims; every function is safe
under `jit`/`vmap`/`scan`. The reference (`buckbaskin/parakeet_slam`,
SURVEY.md L0 "math utilities") carried only angle wrapping and small numpy
helpers; this module is the batched superset needed for the pose-graph /
BA backend (SE(3) manifold steps) and ATE evaluation (Umeyama alignment).

Conventions:
- SE(2) poses as vectors [x, y, theta].
- SE(3) poses as vectors [tx, ty, tz, qx, qy, qz, qw] (Hamilton, unit quat).
- Tangent (twist) vectors: SE(2) [vx, vy, omega]; SE(3) [v(3), omega(3)].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Angles
# ---------------------------------------------------------------------------


def wrap_angle(theta: jax.Array) -> jax.Array:
    """Wrap angles to (-pi, pi]. Elementwise, branch-free."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------


def se2_compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """Compose two SE(2) poses a ∘ b (apply b in a's frame). [..., 3]."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, th], axis=-1)


def se2_inverse(a: jax.Array) -> jax.Array:
    """Inverse pose. [..., 3]."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return jnp.stack([x, y, wrap_angle(-a[..., 2])], axis=-1)


def se2_between(a: jax.Array, b: jax.Array) -> jax.Array:
    """Relative pose a^{-1} ∘ b."""
    return se2_compose(se2_inverse(a), b)


def se2_apply(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Transform points [..., 2] from pose frame into world frame."""
    c, s = jnp.cos(pose[..., 2:3]), jnp.sin(pose[..., 2:3])
    x = pose[..., 0:1] + c * pts[..., 0:1] - s * pts[..., 1:2]
    y = pose[..., 1:2] + s * pts[..., 0:1] + c * pts[..., 1:2]
    return jnp.concatenate([x, y], axis=-1)


def se2_apply_inverse(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Transform world points [..., 2] into the pose's local frame."""
    c, s = jnp.cos(pose[..., 2:3]), jnp.sin(pose[..., 2:3])
    dx = pts[..., 0:1] - pose[..., 0:1]
    dy = pts[..., 1:2] - pose[..., 1:2]
    return jnp.concatenate([c * dx + s * dy, -s * dx + c * dy], axis=-1)


def se2_exp(xi: jax.Array) -> jax.Array:
    """Exponential map R^3 -> SE(2). xi = [vx, vy, omega]."""
    v, w = xi[..., :2], xi[..., 2]
    # V(w) = [[sin w / w, -(1-cos w)/w], [(1-cos w)/w, sin w / w]]
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    a = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    b = jnp.where(small, w / 2.0, (1.0 - jnp.cos(w_safe)) / w_safe)
    x = a * v[..., 0] - b * v[..., 1]
    y = b * v[..., 0] + a * v[..., 1]
    return jnp.stack([x, y, wrap_angle(w)], axis=-1)


def se2_log(p: jax.Array) -> jax.Array:
    """Log map SE(2) -> R^3."""
    w = wrap_angle(p[..., 2])
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    half = w / 2.0
    # V^{-1} = (w/2) * [[cot(w/2), 1], [-1, cot(w/2)]]  (scaled)
    cot = jnp.where(
        small,
        1.0 - w * w / 12.0,
        half * jnp.cos(w_safe / 2.0) / jnp.sin(jnp.where(small, 1.0, w_safe / 2.0)),
    )
    vx = cot * p[..., 0] + half * p[..., 1]
    vy = -half * p[..., 0] + cot * p[..., 1]
    return jnp.stack([vx, vy, w], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions (Hamilton, [x, y, z, w])
# ---------------------------------------------------------------------------


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    x1, y1, z1, w1 = jnp.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def hat3(v: jax.Array) -> jax.Array:
    """so(3) hat operator: [..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors [..., 3] by unit quaternions [..., 4]."""
    u, w = q[..., :3], q[..., 3:4]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (branch-free).

    Uses the four Shepperd candidates and picks the numerically best via
    argmax of the diagonal-derived norms - jit/vmap safe.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Candidate squared norms (4 * q_i^2), all >= 0 up to fp error.
    qw2 = jnp.maximum(1.0 + tr, 0.0)
    qx2 = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy2 = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz2 = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    # Build each candidate quaternion (unnormalized), select the largest pivot.
    cw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, qw2], axis=-1)
    cx = jnp.stack([qx2, m10 + m01, m02 + m20, m21 - m12], axis=-1)
    cy = jnp.stack([m10 + m01, qy2, m21 + m12, m02 - m20], axis=-1)
    cz = jnp.stack([m02 + m20, m21 + m12, qz2, m10 - m01], axis=-1)

    norms = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    idx = jnp.argmax(norms, axis=-1)
    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # [..., 4(cand), 4(xyzw)]
    q = jnp.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------



def _safe_norm(w: jax.Array) -> jax.Array:
    """norm(w) with a finite derivative at w=0 (jacfwd/jacrev through the
    Lie maps would otherwise produce NaN tangents from d|w|/dw at 0)."""
    return jnp.sqrt(jnp.sum(w * w, axis=-1) + 1e-24)

def so3_exp_quat(w: jax.Array) -> jax.Array:
    """so(3) tangent [..., 3] -> unit quaternion."""
    theta = _safe_norm(w)[..., None]
    small = theta < 1e-8
    theta_safe = jnp.where(small, 1.0, theta)
    half = theta / 2.0
    k = jnp.where(small, 0.5 - theta**2 / 48.0, jnp.sin(half) / theta_safe)
    return jnp.concatenate([k * w, jnp.cos(half)], axis=-1)


def so3_log_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion -> so(3) tangent [..., 3]."""
    qn = jnp.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    u, w = qn[..., :3], qn[..., 3]
    norm_u = _safe_norm(u)
    theta = 2.0 * jnp.arctan2(norm_u, w)
    small = norm_u < 1e-8
    scale = jnp.where(small, 2.0 / jnp.clip(w, 1e-8)[...], theta / jnp.where(small, 1.0, norm_u))
    return scale[..., None] * u


def _so3_hat(w: jax.Array) -> jax.Array:
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            zeros, -w[..., 2], w[..., 1],
            w[..., 2], zeros, -w[..., 0],
            -w[..., 1], w[..., 0], zeros,
        ],
        axis=-1,
    ).reshape(*w.shape[:-1], 3, 3)


def _se3_V(w: jax.Array) -> jax.Array:
    """Left Jacobian of SO(3), V(w) such that t = V @ v for exp."""
    theta = _safe_norm(w)
    small = theta < 1e-6
    th = jnp.where(small, 1.0, theta)
    A = jnp.where(small, 1.0 - theta**2 / 6.0, jnp.sin(th) / th)
    B = jnp.where(small, 0.5 - theta**2 / 24.0, (1.0 - jnp.cos(th)) / th**2)
    C = jnp.where(small, 1.0 / 6.0 - theta**2 / 120.0, (1.0 - A) / th**2)
    del A
    W = _so3_hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _se3_V_inv(w: jax.Array) -> jax.Array:
    theta = _safe_norm(w)
    small = theta < 1e-6
    th = jnp.where(small, 1.0, theta)
    half = th / 2.0
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta**2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / th**2,
    )
    W = _so3_hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * (W @ W)


def se3_exp(xi: jax.Array) -> jax.Array:
    """se(3) twist [..., 6] (v, w) -> pose [..., 7] (t, quat)."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    t = (_se3_V(w) @ v[..., None])[..., 0]
    return jnp.concatenate([t, q], axis=-1)


def se3_log(p: jax.Array) -> jax.Array:
    """Pose [..., 7] -> twist [..., 6]."""
    t, q = p[..., :3], p[..., 3:]
    w = so3_log_quat(q)
    v = (_se3_V_inv(w) @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def se3_compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """a ∘ b for poses [..., 7]."""
    ta, qa = a[..., :3], a[..., 3:]
    tb, qb = b[..., :3], b[..., 3:]
    t = ta + quat_rotate(qa, tb)
    q = quat_normalize(quat_multiply(qa, qb))
    return jnp.concatenate([t, q], axis=-1)


def se3_inverse(a: jax.Array) -> jax.Array:
    t, q = a[..., :3], a[..., 3:]
    qi = quat_conjugate(q)
    return jnp.concatenate([-quat_rotate(qi, t), qi], axis=-1)


def se3_between(a: jax.Array, b: jax.Array) -> jax.Array:
    return se3_compose(se3_inverse(a), b)


def se3_apply(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """World-from-local point transform, pts [..., 3]."""
    return pose[..., :3] + quat_rotate(pose[..., 3:], pts)


def se3_apply_inverse(pose: jax.Array, pts: jax.Array) -> jax.Array:
    return quat_rotate(quat_conjugate(pose[..., 3:]), pts - pose[..., :3])


def se2_to_se3(p: jax.Array) -> jax.Array:
    """Lift planar poses [..., 3] to SE(3) [..., 7] (z=0, yaw-only)."""
    half = p[..., 2] / 2.0
    zeros = jnp.zeros_like(half)
    q = jnp.stack([zeros, zeros, jnp.sin(half), jnp.cos(half)], axis=-1)
    t = jnp.stack([p[..., 0], p[..., 1], zeros], axis=-1)
    return jnp.concatenate([t, q], axis=-1)


# ---------------------------------------------------------------------------
# Trajectory alignment (evaluation support)
# ---------------------------------------------------------------------------


def umeyama(src: jax.Array, dst: jax.Array, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, both [N, D].

    Returns (s, R, t) with dst ≈ s * R @ src + t. Umeyama (1991) closed form;
    used by `eval.metrics.ate_rmse` exactly as standard SLAM evaluation does.
    """
    mu_s = jnp.mean(src, axis=0)
    mu_d = jnp.mean(dst, axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, S, Vt = jnp.linalg.svd(cov)
    d = src.shape[-1]
    sign = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    D = jnp.ones((d,), dtype=src.dtype).at[-1].set(sign)
    R = (U * D[None, :]) @ Vt
    if with_scale:
        var_s = jnp.mean(jnp.sum(xs * xs, axis=-1))
        s = jnp.sum(S * D) / jnp.clip(var_s, 1e-12)
    else:
        s = jnp.array(1.0, dtype=src.dtype)
    t = mu_d - s * R @ mu_s
    return s, R, t

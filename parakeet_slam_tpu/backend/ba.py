"""Bundle adjustment: Schur-complement reduced camera system, solved by PCG
with an implicit operator — the large-scale accelerator design.

SURVEY.md §3 backend contract: minimize Σ ρ(‖π(T_c, X_p) − u‖²) over camera
poses T (SE(3) tangent steps) and points X. Normal equations
[B E; Eᵀ C][δc; δp] = -[v; w] with C block-diagonal (3×3 per landmark).
Schur: (B − E C⁻¹ Eᵀ) δc = -v + E C⁻¹ w, then δp = -C⁻¹(w + Eᵀ δc).

Design choices (cf. MegBA, PAPERS.md:9, for the distributed pattern):
- The reduced camera matrix S = B − E C⁻¹ Eᵀ is **never materialized**.
  PCG needs only S·x, computed per-observation with gathers + segment-sums:
      S·x = B·x − Jcᵀ(Jp(C⁻¹(Jpᵀ(Jc·x))))
  Every term is a dense batched einsum over the observation axis, with
  static shapes and no irregular camera-pair assembly.
- C⁻¹ is applied by `kernels/schur.cinv_apply` (closed-form cofactor
  inverse in one fused pass; C⁻¹ never reaches device memory).
  No linalg.solve anywhere.
- Robust Huber weights fold into the residual/Jacobian weighting.
- Distribution (SURVEY.md §2b "map-block parallelism"): observations and
  landmark blocks shard over the `dcn` mesh axis; each shard computes its
  partial Jcᵀ(...) contraction and a `psum` assembles the full [C, 6]
  vector — see `dist/dist_ba.py`. The math here is written as pure
  per-observation maps + segment reductions precisely so the sharded
  version is the same code under `shard_map`.
- Jacobians in closed form (`linearize`): dpi = camera.jac_project chained
  with the SE(3) right-perturbation — verified against the vmapped
  `jax.jacfwd` twin (`linearize_ad`) in tests/test_ba_jacobians.py.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import geometry, linalg
from parakeet_slam_tpu.kernels import schur
from parakeet_slam_tpu.backend.graph import BAProblem


class BAResult(NamedTuple):
    problem: BAProblem
    costs: jax.Array        # [iters]
    pcg_residuals: jax.Array  # [iters]


def _project_residual(camera, delta, cam_pose, point, uv):
    """Reprojection residual for one observation, with 6-dof camera tangent
    and 3-dof point perturbations baked in (delta = [δc(6), δp(3)])."""
    pose = geometry.se3_compose(cam_pose, geometry.se3_exp(delta[:6]))
    p_cam = geometry.se3_apply_inverse(pose, point + delta[6:])
    pred = camera.project(p_cam)
    if hasattr(camera, "residual"):
        return camera.residual(uv, pred)
    return uv - pred


def linearize_ad(camera, prob: BAProblem, huber_delta: float):
    """Autodiff (jacfwd) twin of `linearize` — the semantics oracle for
    tests/test_ba_jacobians.py; the production path is the closed form."""
    cam = prob.cam_pose[prob.obs_cam]
    pt = prob.points[prob.obs_pt]
    zero = jnp.zeros((9,))

    def one(c, p, uv):
        r = _project_residual(camera, zero, c, p, uv)
        J = jax.jacfwd(_project_residual, argnums=1)(camera, zero, c, p, uv)
        return r, J

    r, J = jax.vmap(one)(cam, pt, prob.obs_uv)
    Jc, Jp = J[..., :6], J[..., 6:]
    return r, Jc, Jp, _huber_weights(prob, r, huber_delta)


def _huber_weights(prob, r, huber_delta):
    """w = min(1, delta / ||r||) folded with observation validity."""
    rnorm = jnp.linalg.norm(r, axis=-1)
    w_huber = jnp.minimum(1.0, huber_delta / jnp.maximum(rnorm, 1e-9))
    return w_huber * prob.obs_valid.astype(r.dtype)


def linearize(camera, prob: BAProblem, huber_delta: float):
    """Residuals + closed-form Jacobians for all observations.

    Returns (r [O, Dz], Jc [O, Dz, 6], Jp [O, Dz, 3], w [O]) where w folds
    validity and the Huber robust weight.

    Derivation (right-perturbation on the camera, additive on the point):
      p_cam(dc, dp) = (T.exp(dc))^-1 (X + dp) = exp(-dc) . q,
      q = T^-1 X  =>  d p_cam/d v = -I,  d p_cam/d w = [q]_x,
      d p_cam/d X = R(T)^T;  residual = z_obs (-) proj(p_cam)  =>
      Jc = [dpi, -dpi [q]_x],  Jp = -dpi R^T  with dpi = camera.jac_project.
    Verified against jacfwd in tests/test_ba_jacobians.py for all three
    camera models; 3-5x cheaper than the 9-wide dual-number forward pass.
    """
    cam = prob.cam_pose[prob.obs_cam]                     # [O, 7]
    pt = prob.points[prob.obs_pt]                         # [O, 3]
    q = geometry.se3_apply_inverse(cam, pt)               # camera-frame point
    pred = camera.project(q)
    if hasattr(camera, "residual"):
        r = camera.residual(prob.obs_uv, pred)
    else:
        r = prob.obs_uv - pred
    dpi = camera.jac_project(q)                           # [O, Dz, 3]
    qx = geometry.hat3(q)                                 # [O, 3, 3]
    Jc = jnp.concatenate([dpi, -dpi @ qx], axis=-1)       # [O, Dz, 6]
    Rt = geometry.quat_to_matrix(geometry.quat_conjugate(cam[..., 3:]))
    Jp = -dpi @ Rt                                        # [O, Dz, 3]
    return r, Jc, Jp, _huber_weights(prob, r, huber_delta)


def _build_blocks(prob, r, Jc, Jp, w, lam):
    """Per-camera B blocks, per-point C blocks (damped), gradient halves."""
    C_, P_ = prob.num_cams, prob.num_points
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    # B = Σ Jcᵀ W Jc per camera; C = Σ Jpᵀ W Jp per point
    Bo = jnp.einsum("oki,okj->oij", Jc, wJc)
    Co = jnp.einsum("oki,okj->oij", Jp, wJp)
    B = jnp.zeros((C_, 6, 6)).at[prob.obs_cam].add(Bo)
    C = jnp.zeros((P_, 3, 3)).at[prob.obs_pt].add(Co)
    # gradient: v = Σ Jcᵀ W r, w_g = Σ Jpᵀ W r
    v = jnp.zeros((C_, 6)).at[prob.obs_cam].add(
        jnp.einsum("oki,ok->oi", wJc, r)
    )
    wg = jnp.zeros((P_, 3)).at[prob.obs_pt].add(
        jnp.einsum("oki,ok->oi", wJp, r)
    )
    # LM damping (additive, keeps blocks PD); fixed cameras get huge damping
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    cam_damp = jnp.where(prob.cam_fixed | ~prob.cam_valid, 1e12, lam)
    B = B + cam_damp[:, None, None] * eye6
    pt_damp = jnp.where(prob.pt_valid, lam, 1e12)
    C = C + pt_damp[:, None, None] * eye3 + 1e-6 * eye3
    return B, C, v, wg


def _schur_matvec(x, prob, B, C, Jc, Jp, w):
    """S·x = B·x − Jcᵀ W Jp C⁻¹ Jpᵀ W Jc x, all per-observation. The C⁻¹
    apply is `kernels/schur.cinv_apply` (cofactor inverse fused with the
    matvec by XLA, C⁻¹ never materialized in HBM)."""
    Bx = jnp.einsum("cij,cj->ci", B, x)
    # t = W Jc x  per obs [O, Dz]
    t = jnp.einsum("okj,oj->ok", Jc, x[prob.obs_cam]) * w[:, None]
    # u = Jpᵀ t aggregated per point [P, 3]
    u = jnp.zeros((prob.num_points, 3)).at[prob.obs_pt].add(
        jnp.einsum("oki,ok->oi", Jp, t)
    )
    y = schur.cinv_apply(C, u)
    # back: s = W Jp y per obs, then Jcᵀ s per camera
    s = jnp.einsum("oki,oi->ok", Jp, y[prob.obs_pt]) * w[:, None]
    ECEx = jnp.zeros((prob.num_cams, 6)).at[prob.obs_cam].add(
        jnp.einsum("oki,ok->oi", Jc, s)
    )
    return Bx - ECEx


def _pcg(matvec: Callable, b, Minv, iters: int, tol: float):
    """Preconditioned conjugate gradients on the reduced camera system."""
    x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    z0 = jnp.einsum("cij,cj->ci", Minv, r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def body(carry, _):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = jnp.einsum("cij,cj->ci", Minv, r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        return (x, r, p, rz_new), jnp.sqrt(jnp.sum(r * r))

    (x, r, _, _), res = jax.lax.scan(body, (x0, r0, p0, rz0), None, length=iters)
    # breakdown guard: fp32 PCG can diverge on ill-conditioned reduced
    # systems (small LM damping); a non-finite solution becomes a zero step,
    # which the LM accept test then rejects (cost unchanged) and retries
    # with more damping — instead of propagating NaN into the pose update.
    good = jnp.isfinite(jnp.sum(x * x))
    return jnp.where(good, x, x0), res[-1]


def ba_cost(camera, prob: BAProblem, huber_delta: float) -> jax.Array:
    cam = prob.cam_pose[prob.obs_cam]
    pt = prob.points[prob.obs_pt]
    zero = jnp.zeros((9,))
    r = jax.vmap(lambda c, p, uv: _project_residual(camera, zero, c, p, uv))(
        cam, pt, prob.obs_uv
    )
    n = jnp.linalg.norm(r, axis=-1)
    # Huber cost
    quad = 0.5 * n * n
    lin = huber_delta * (n - 0.5 * huber_delta)
    rho = jnp.where(n <= huber_delta, quad, lin)
    return jnp.sum(rho * prob.obs_valid)


# ---------------------------------------------------------------------------
# Point-major packed path (the production layout — see
# graph.BAProblemPacked): per-point aggregations are dense axis-1 sums,
# killing the 50k-wide XLA scatter-adds that dominated the obs-major matvec.
# ---------------------------------------------------------------------------


def linearize_packed(camera, packed, huber_delta: float):
    """Closed-form residuals/Jacobians over the [Lm, K] bucketed table.
    Same math as `linearize`, batched over (point, bucket-slot)."""
    cam = packed.cam_pose[packed.p_cam]                   # [Lm, K, 7]
    q = geometry.se3_apply_inverse(cam, packed.points[:, None, :])
    pred = camera.project(q)
    if hasattr(camera, "residual"):
        r = camera.residual(packed.p_uv, pred)
    else:
        r = packed.p_uv - pred
    dpi = camera.jac_project(q)                           # [Lm, K, Dz, 3]
    qx = geometry.hat3(q)
    Jc = jnp.concatenate([dpi, -dpi @ qx], axis=-1)       # [Lm, K, Dz, 6]
    Rt = geometry.quat_to_matrix(geometry.quat_conjugate(cam[..., 3:]))
    Jp = -dpi @ Rt                                        # [Lm, K, Dz, 3]
    rnorm = jnp.linalg.norm(r, axis=-1)
    w_huber = jnp.minimum(1.0, huber_delta / jnp.maximum(rnorm, 1e-9))
    w = w_huber * packed.p_valid.astype(r.dtype)
    return r, Jc, Jp, w


def _build_blocks_packed(packed, r, Jc, Jp, w, lam):
    C_, P_ = packed.num_cams, packed.num_points
    K = packed.k_max
    wJc = Jc * w[..., None, None]
    wJp = Jp * w[..., None, None]
    # B, v: scatter-add over the small [C, ...] tables (cheap target)
    Bo = jnp.einsum("lkdi,lkdj->lkij", Jc, wJc).reshape(P_ * K, 6, 6)
    cam_flat = packed.p_cam.reshape(-1)
    B = jnp.zeros((C_, 6, 6)).at[cam_flat].add(Bo)
    v = jnp.zeros((C_, 6)).at[cam_flat].add(
        jnp.einsum("lkdi,lkd->lki", wJc, r).reshape(P_ * K, 6)
    )
    # C, w_g: dense per-point sums (the point-major payoff)
    C = jnp.einsum("lkdi,lkdj->lij", Jp, wJp)
    wg = jnp.einsum("lkdi,lkd->li", wJp, r)
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    cam_damp = jnp.where(packed.cam_fixed | ~packed.cam_valid, 1e12, lam)
    B = B + cam_damp[:, None, None] * eye6
    pt_damp = jnp.where(packed.pt_valid, lam, 1e12)
    C = C + pt_damp[:, None, None] * eye3 + 1e-6 * eye3
    return B, C, v, wg


def _schur_matvec_packed(x, packed, B, C, Jc, Jp, w):
    """S·x with dense per-point reductions; C⁻¹ apply is
    `kernels/schur.cinv_apply`."""
    C_ = packed.num_cams
    Bx = jnp.einsum("cij,cj->ci", B, x)
    t = jnp.einsum("lkdj,lkj->lkd", Jc, x[packed.p_cam]) * w[..., None]
    u = jnp.einsum("lkdi,lkd->li", Jp, t)                 # dense sum over K
    y = schur.cinv_apply(C, u)
    s = jnp.einsum("lkdi,li->lkd", Jp, y) * w[..., None]  # dense broadcast
    back = jnp.einsum("lkdi,lkd->lki", Jc, s)
    ECEx = jnp.zeros((C_, 6)).at[packed.p_cam.reshape(-1)].add(
        back.reshape(-1, 6)
    )
    return Bx - ECEx


def ba_cost_packed(camera, packed, huber_delta: float) -> jax.Array:
    cam = packed.cam_pose[packed.p_cam]
    q = geometry.se3_apply_inverse(cam, packed.points[:, None, :])
    pred = camera.project(q)
    if hasattr(camera, "residual"):
        r = camera.residual(packed.p_uv, pred)
    else:
        r = packed.p_uv - pred
    n = jnp.linalg.norm(r, axis=-1)
    quad = 0.5 * n * n
    lin = huber_delta * (n - 0.5 * huber_delta)
    rho = jnp.where(n <= huber_delta, quad, lin)
    return jnp.sum(rho * packed.p_valid)


def optimize_ba(
    camera,
    prob,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
    step_clamp: tuple = (10.0, 50.0),
    pose_edges=None,
) -> BAResult:
    """Levenberg-damped GN with Schur elimination of the landmark blocks.

    Accepts a `BAProblem` (packed on the host into the bucketed point-major
    layout — call from outside jit; pack once and pass the
    `BAProblemBuckets` directly when optimizing the same problem
    repeatedly), a `BAProblemBuckets`, or a legacy `BAProblemPacked`.
    Returns the same BAResult shape as always (problem carries updated
    poses/points)."""
    from parakeet_slam_tpu.backend import graph as graph_mod

    out_prob = None
    if isinstance(prob, BAProblem):
        packed = graph_mod.pack_buckets(prob)
        out_prob = prob
    else:
        packed = prob
    if isinstance(packed, graph_mod.BAProblemBuckets):
        res = _optimize_buckets(
            camera, packed, iters=iters, lam=lam, pcg_iters=pcg_iters,
            pcg_tol=pcg_tol, huber_delta=huber_delta, solver=solver,
            step_clamp=step_clamp, pose_edges=pose_edges,
        )
    else:
        res = _optimize_packed(
            camera, packed, iters=iters, lam=lam, pcg_iters=pcg_iters,
            pcg_tol=pcg_tol, huber_delta=huber_delta, solver=solver,
        )
    packed_out, costs, pcg_res = res
    if out_prob is not None:
        problem = out_prob.replace(
            cam_pose=packed_out.cam_pose, points=packed_out.points
        )
    else:
        problem = packed_out
    return BAResult(problem=problem, costs=costs, pcg_residuals=pcg_res)


# ---------------------------------------------------------------------------
# Bucketed point-major path (see graph.BAProblemBuckets): per-point work is
# dense within each [Lb, Kb] bucket, camera-side aggregation is a one-hot
# matmul — the whole LM iteration runs with zero XLA scatters except one
# per-iteration write-back of δp into the [Lm, 3] point table.
# ---------------------------------------------------------------------------


def _onehot_gather(onehot, table, shape):
    """table[p_cam] as a one-hot [N, C] @ [C, D] matmul instead of a row
    gather from the small [C, D] table."""
    flat = jnp.einsum("nc,cd->nd", onehot, table)
    return flat.reshape(*shape, table.shape[-1])


def _linearize_bucket(camera, cam_pose, pts_b, p_cam, p_uv, p_valid, huber_delta,
                      onehot=None):
    """Closed-form residual/Jacobian math for one bucket's [Lb, Kb] table.
    Same derivation as `linearize` (see its docstring)."""
    if onehot is not None:
        cam = _onehot_gather(onehot, cam_pose, p_cam.shape)
    else:
        cam = cam_pose[p_cam]                              # [Lb, K, 7]
    q = geometry.se3_apply_inverse(cam, pts_b[:, None, :])
    pred = camera.project(q)
    if hasattr(camera, "residual"):
        r = camera.residual(p_uv, pred)
    else:
        r = p_uv - pred
    dpi = camera.jac_project(q)                            # [Lb, K, Dz, 3]
    qx = geometry.hat3(q)
    Jc = jnp.concatenate([dpi, -dpi @ qx], axis=-1)        # [Lb, K, Dz, 6]
    Rt = geometry.quat_to_matrix(geometry.quat_conjugate(cam[..., 3:]))
    Jp = -dpi @ Rt                                         # [Lb, K, Dz, 3]
    rnorm = jnp.linalg.norm(r, axis=-1)
    w_huber = jnp.minimum(1.0, huber_delta / jnp.maximum(rnorm, 1e-9))
    w = w_huber * p_valid.astype(r.dtype)
    return r, Jc, Jp, w


def _cost_buckets(camera, bk, cam_pose, points, huber_delta, onehots=None):
    total = jnp.float32(0.0)
    for i, (pt_idx, p_cam, p_uv, p_valid) in enumerate(zip(
        bk.pt_idx, bk.p_cam, bk.p_uv, bk.p_valid
    )):
        if onehots is not None:
            cam = _onehot_gather(onehots[i], cam_pose, p_cam.shape)
        else:
            cam = cam_pose[p_cam]
        q = geometry.se3_apply_inverse(cam, points[pt_idx][:, None, :])
        pred = camera.project(q)
        if hasattr(camera, "residual"):
            r = camera.residual(p_uv, pred)
        else:
            r = p_uv - pred
        n = jnp.linalg.norm(r, axis=-1)
        quad = 0.5 * n * n
        lin = huber_delta * (n - 0.5 * huber_delta)
        rho = jnp.where(n <= huber_delta, quad, lin)
        total = total + jnp.sum(rho * p_valid)
    return total


@partial(
    jax.jit,
    static_argnames=("camera", "iters", "pcg_iters", "solver", "step_clamp"),
)
def _optimize_buckets(
    camera,
    bk,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
    step_clamp: tuple = (10.0, 50.0),
    pose_edges=None,
):
    C_ = bk.num_cams
    cam_range = jnp.arange(C_)
    # one-hot [N, C] per bucket depends only on the (static) observation
    # graph — built once per solve, hoisted out of the LM scan; every
    # camera-side gather AND segment-sum becomes a matmul against it.
    onehots = tuple(
        (p_cam.reshape(-1)[:, None] == cam_range[None, :]).astype(jnp.float32)
        for p_cam in bk.p_cam
    )

    # Pose-graph fusion (graph-constrained BA): relative-pose edges from
    # the keyframe graph (odometry chain + verified loop closures) enter
    # the SAME normal equations as the reprojection terms — camera-camera
    # 6x6 blocks on B's diagonal plus off-diagonal couplings applied
    # inside the reduced-system matvec. Pure-reprojection BA optimizes
    # consistency with per-keyframe landmark measurements, which embed the
    # filter's DRIFTED relative geometry — it descends cost while undoing
    # the loop-closure corrections (measured r5 EuRoC: pose-graph ATE
    # 0.575 -> BA 0.679). The fused problem keeps the graph's global
    # anchoring while reconciling multi-view structure.
    if pose_edges is not None:
        from parakeet_slam_tpu.backend import posegraph as _pg

        pe_ij, pe_rel, pe_info, pe_valid = pose_edges
        _zero12 = jnp.zeros((12,))

        def _pe_lin(poses):
            pi = poses[pe_ij[:, 0]]
            pj = poses[pe_ij[:, 1]]
            r = jax.vmap(_pg.edge_residual)(pi, pj, pe_rel)
            J = jax.vmap(
                lambda a, b, z: jax.jacfwd(_pg._edge_residual_perturbed)(
                    _zero12, a, b, z
                )
            )(pi, pj, pe_rel)
            return r, J[..., :6], J[..., 6:]

        def _pe_cost(poses):
            pi = poses[pe_ij[:, 0]]
            pj = poses[pe_ij[:, 1]]
            r = jax.vmap(_pg.edge_residual)(pi, pj, pe_rel)
            we = pe_info * pe_valid[:, None]
            return 0.5 * jnp.sum(we * r * r)
    else:
        _pe_cost = lambda poses: 0.0  # noqa: E731

    def step(carry, _):
        cam_pose, points, lam_t = carry
        eye6 = jnp.eye(6)
        eye3 = jnp.eye(3)
        cam_damp = jnp.where(bk.cam_fixed | ~bk.cam_valid, 1e12, lam_t)
        B = cam_damp[:, None, None] * eye6
        v = jnp.zeros((C_, 6))
        pe_terms = None
        if pose_edges is not None:
            r_e, Ji, Jj = _pe_lin(cam_pose)
            we = pe_info * pe_valid[:, None]                 # [E, 6]
            JiW = Ji * we[:, :, None]
            JjW = Jj * we[:, :, None]
            hp = jax.lax.Precision.HIGHEST
            ii = pe_ij[:, 0]
            jj = pe_ij[:, 1]
            B = B.at[ii].add(jnp.einsum("eki,ekj->eij", Ji, JiW, precision=hp))
            B = B.at[jj].add(jnp.einsum("eki,ekj->eij", Jj, JjW, precision=hp))
            v = v.at[ii].add(jnp.einsum("eki,ek->ei", Ji, we * r_e, precision=hp))
            v = v.at[jj].add(jnp.einsum("eki,ek->ei", Jj, we * r_e, precision=hp))
            Hij = jnp.einsum("eki,ekj->eij", Ji, JjW, precision=hp)
            pe_terms = (ii, jj, Hij)
        per_bucket = []
        for pt_idx, row_valid, p_cam, p_uv, p_valid, onehot in zip(
            bk.pt_idx, bk.row_valid, bk.p_cam, bk.p_uv, bk.p_valid, onehots
        ):
            pts_b = points[pt_idx]
            r, Jc, Jp, w = _linearize_bucket(
                camera, cam_pose, pts_b, p_cam, p_uv, p_valid, huber_delta,
                onehot=onehot,
            )
            wJc = Jc * w[..., None, None]
            wJp = Jp * w[..., None, None]
            N = p_cam.size
            Bo = jnp.einsum("lkdi,lkdj->lkij", Jc, wJc).reshape(N, 36)
            B = B + jnp.einsum("nc,nd->cd", onehot, Bo).reshape(C_, 6, 6)
            v = v + jnp.einsum(
                "nc,nd->cd", onehot,
                jnp.einsum("lkdi,lkd->lki", wJc, r).reshape(N, 6),
            )
            Cb = jnp.einsum("lkdi,lkdj->lij", Jp, wJp)
            pv_b = bk.pt_valid[pt_idx] & row_valid
            pt_damp = jnp.where(pv_b, lam_t, 1e12)
            Cb = Cb + pt_damp[:, None, None] * eye3 + 1e-6 * eye3
            wg = jnp.einsum("lkdi,lkd->li", wJp, r)
            per_bucket.append((pt_idx, row_valid, p_cam, Jc, Jp, w, Cb, wg, onehot))

        def matvec(x):
            acc = jnp.einsum("cij,cj->ci", B, x)
            if pe_terms is not None:
                ii, jj, Hij = pe_terms
                acc = acc.at[ii].add(jnp.einsum("eij,ej->ei", Hij, x[jj]))
                acc = acc.at[jj].add(jnp.einsum("eji,ej->ei", Hij, x[ii]))
            for pt_idx, row_valid, p_cam, Jc, Jp, w, Cb, wg, onehot in per_bucket:
                xg = _onehot_gather(onehot, x, p_cam.shape)
                t = jnp.einsum("lkdj,lkj->lkd", Jc, xg) * w[..., None]
                u = jnp.einsum("lkdi,lkd->li", Jp, t)
                y = schur.cinv_apply(Cb, u)
                s = jnp.einsum("lkdi,li->lkd", Jp, y) * w[..., None]
                back = jnp.einsum("lkdi,lkd->lki", Jc, s).reshape(-1, 6)
                acc = acc - jnp.einsum("nc,nd->cd", onehot, back)
            return acc

        rhs = -v
        for pt_idx, row_valid, p_cam, Jc, Jp, w, Cb, wg, onehot in per_bucket:
            y = schur.cinv_apply(Cb, wg)
            s = jnp.einsum("lkdi,li->lkd", Jp, y) * w[..., None]
            back = jnp.einsum("lkdi,lkd->lki", Jc, s).reshape(-1, 6)
            rhs = rhs + jnp.einsum("nc,nd->cd", onehot, back)

        if solver == "pcg":
            Minv = jnp.linalg.inv(B)
            dc, pcg_res = _pcg(matvec, rhs, Minv, pcg_iters, pcg_tol)
        else:
            S = jax.vmap(
                lambda e: matvec(e.reshape(C_, 6)), in_axes=1, out_axes=2
            )(jnp.eye(C_ * 6)).reshape(C_ * 6, C_ * 6)
            dc = jnp.linalg.solve(S.T, rhs.reshape(-1)).reshape(C_, 6)
            pcg_res = jnp.float32(0.0)

        # Trust-region sanitization: an ill-conditioned reduced system can
        # return inf/NaN or astronomically long steps (observed on the
        # EuRoC multi-session problem — se3_exp(inf) poisons the candidate
        # and LM rejects every iteration forever). Non-finite components
        # zero out. The clamp radii are config-exposed guards against
        # pathological magnitudes only (advisor r4: the old hard-coded
        # 1.0 m/rad radius truncated every legitimately large correction,
        # stalling convergence on badly-initialized problems — LM's own
        # accept test is the trust region for finite steps).
        clamp_c, clamp_p = step_clamp
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        dc = dc * jnp.minimum(
            1.0, clamp_c / (jnp.linalg.norm(dc, axis=1, keepdims=True) + 1e-12)
        )

        # back-substitute: δp = -C⁻¹(w_g + Eᵀ δc), one scatter-add per step
        dp_full = jnp.zeros_like(points)
        for pt_idx, row_valid, p_cam, Jc, Jp, w, Cb, wg, onehot in per_bucket:
            dcg = _onehot_gather(onehot, dc, p_cam.shape)
            t = jnp.einsum("lkdj,lkj->lkd", Jc, dcg) * w[..., None]
            Etdc = jnp.einsum("lkdi,lkd->li", Jp, t)
            dp = -schur.cinv_apply(Cb, wg + Etdc)
            dp_full = dp_full.at[pt_idx].add(dp * row_valid[:, None])
        dp_full = jnp.where(jnp.isfinite(dp_full), dp_full, 0.0)
        dp_full = dp_full * jnp.minimum(
            1.0,
            clamp_p / (jnp.linalg.norm(dp_full, axis=1, keepdims=True) + 1e-12),
        )

        new_cam = jax.vmap(
            lambda po, d: geometry.se3_compose(po, geometry.se3_exp(d))
        )(cam_pose, dc)
        new_cam = jnp.where(bk.cam_fixed[:, None], cam_pose, new_cam)
        new_points = points + dp_full * bk.pt_valid[:, None]

        old_cost = _cost_buckets(
            camera, bk, cam_pose, points, huber_delta, onehots
        ) + _pe_cost(cam_pose)
        new_cost = _cost_buckets(
            camera, bk, new_cam, new_points, huber_delta, onehots
        ) + _pe_cost(new_cam)
        accept = jnp.isfinite(new_cost) & (new_cost < old_cost)
        cam_out = jnp.where(accept, new_cam, cam_pose)
        pts_out = jnp.where(accept, new_points, points)
        lam_next = jnp.where(accept, lam_t * 0.5, lam_t * 4.0)
        # report the ACHIEVED cost (a rejected candidate's cost — possibly
        # non-finite — is not the state the solver returns)
        cost_rep = jnp.where(accept, new_cost, old_cost)
        return (cam_out, pts_out, lam_next), (cost_rep, pcg_res)

    # fp32 accumulation discipline (SURVEY.md §8): reduced-precision matmuls
    # (TF32 on the GPU by default) corrupt the normal equations enough to
    # stall or diverge LM.
    with jax.default_matmul_precision("highest"):
        (cam_f, pts_f, _), (costs, pcg_res) = jax.lax.scan(
            step, (bk.cam_pose, bk.points, jnp.float32(lam)), None,
            length=iters,
        )
    return bk.replace(cam_pose=cam_f, points=pts_f), costs, pcg_res


@partial(jax.jit, static_argnames=("camera", "iters", "pcg_iters", "solver"))
def _optimize_packed(
    camera,
    packed,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
):
    def step(carry, _):
        cam_pose, points, lam_t = carry
        p = packed.replace(cam_pose=cam_pose, points=points)
        r, Jc, Jp, w = linearize_packed(camera, p, huber_delta)
        B, C, v, wg = _build_blocks_packed(p, r, Jc, Jp, w, lam_t)
        # rhs = -v + E C⁻¹ w_g
        s = jnp.einsum(
            "lkdi,li->lkd", Jp, schur.cinv_apply(C, wg)
        ) * w[..., None]
        ECw = jnp.zeros((p.num_cams, 6)).at[p.p_cam.reshape(-1)].add(
            jnp.einsum("lkdi,lkd->lki", Jc, s).reshape(-1, 6)
        )
        rhs = -v + ECw

        matvec = lambda x: _schur_matvec_packed(x, p, B, C, Jc, Jp, w)
        if solver == "pcg":
            # block-Jacobi preconditioner = B⁻¹
            Minv = jnp.linalg.inv(B)
            dc, pcg_res = _pcg(matvec, rhs, Minv, pcg_iters, pcg_tol)
        else:
            S = jax.vmap(
                lambda e: matvec(e.reshape(p.num_cams, 6)), in_axes=1, out_axes=2
            )(jnp.eye(p.num_cams * 6)).reshape(p.num_cams * 6, p.num_cams * 6)
            dc = jnp.linalg.solve(S.T, rhs.reshape(-1)).reshape(p.num_cams, 6)
            pcg_res = jnp.float32(0.0)

        # back-substitute points: δp = -C⁻¹(w_g + Eᵀ δc)
        t = jnp.einsum("lkdj,lkj->lkd", Jc, dc[p.p_cam]) * w[..., None]
        Etdc = jnp.einsum("lkdi,lkd->li", Jp, t)
        dp = -schur.cinv_apply(C, wg + Etdc)

        new_cam = jax.vmap(
            lambda po, d: geometry.se3_compose(po, geometry.se3_exp(d))
        )(cam_pose, dc)
        new_cam = jnp.where(packed.cam_fixed[:, None], cam_pose, new_cam)
        new_points = points + dp * packed.pt_valid[:, None]

        old_cost = ba_cost_packed(camera, p, huber_delta)
        new_cost = ba_cost_packed(
            camera, p.replace(cam_pose=new_cam, points=new_points), huber_delta
        )
        accept = new_cost < old_cost
        cam_out = jnp.where(accept, new_cam, cam_pose)
        pts_out = jnp.where(accept, new_points, points)
        lam_next = jnp.where(accept, lam_t * 0.5, lam_t * 4.0)
        return (cam_out, pts_out, lam_next), (new_cost, pcg_res)

    # fp32 accumulation discipline (SURVEY.md §8): reduced-precision matmuls
    # (TF32 on the GPU by default) corrupt the normal equations enough to
    # stall or diverge LM.
    with jax.default_matmul_precision("highest"):
        (cam_f, pts_f, _), (costs, pcg_res) = jax.lax.scan(
            step, (packed.cam_pose, packed.points, jnp.float32(lam)), None,
            length=iters,
        )
    return packed.replace(cam_pose=cam_f, points=pts_f), costs, pcg_res


@partial(jax.jit, static_argnames=("camera", "iters", "pcg_iters", "solver"))
def optimize_ba_obsmajor(
    camera,
    prob: BAProblem,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
) -> BAResult:
    """Obs-major reference optimizer (jit-callable with a raw BAProblem) —
    semantics oracle for tests and the fallback when packing is impossible
    (e.g. the problem lives inside a traced computation)."""

    def step(carry, _):
        cam_pose, points, lam_t = carry
        p = prob.replace(cam_pose=cam_pose, points=points)
        r, Jc, Jp, w = linearize(camera, p, huber_delta)
        B, C, v, wg = _build_blocks(p, r, Jc, Jp, w, lam_t)
        # rhs = -v + E C⁻¹ w_g ; E x = Jcᵀ W Jp x pattern as in matvec
        s = jnp.einsum(
            "oki,oi->ok", Jp, schur.cinv_apply(C, wg)[p.obs_pt]
        ) * w[:, None]
        ECw = jnp.zeros((p.num_cams, 6)).at[p.obs_cam].add(
            jnp.einsum("oki,ok->oi", Jc, s)
        )
        rhs = -v + ECw

        matvec = lambda x: _schur_matvec(x, p, B, C, Jc, Jp, w)
        if solver == "pcg":
            # block-Jacobi preconditioner = B⁻¹ (6x6 -> use jnp solve once)
            Minv = jnp.linalg.inv(B)
            dc, pcg_res = _pcg(matvec, rhs, Minv, pcg_iters, pcg_tol)
        else:
            # dense reduced system (small C): build S column by column
            S = jax.vmap(
                lambda e: matvec(e.reshape(p.num_cams, 6)), in_axes=1, out_axes=2
            )(jnp.eye(p.num_cams * 6)).reshape(p.num_cams * 6, p.num_cams * 6)
            dc = jnp.linalg.solve(S.T, rhs.reshape(-1)).reshape(p.num_cams, 6)
            pcg_res = jnp.float32(0.0)

        # back-substitute points: δp = -C⁻¹(w_g + Eᵀ δc)
        t = jnp.einsum("okj,oj->ok", Jc, dc[p.obs_cam]) * w[:, None]
        Etdc = jnp.zeros((p.num_points, 3)).at[p.obs_pt].add(
            jnp.einsum("oki,ok->oi", Jp, t)
        )
        dp = -schur.cinv_apply(C, wg + Etdc)

        new_cam = jax.vmap(
            lambda po, d: geometry.se3_compose(po, geometry.se3_exp(d))
        )(cam_pose, dc)
        new_cam = jnp.where(prob.cam_fixed[:, None], cam_pose, new_cam)
        new_points = points + dp * prob.pt_valid[:, None]

        old_cost = ba_cost(camera, p, huber_delta)
        new_cost = ba_cost(
            camera, p.replace(cam_pose=new_cam, points=new_points), huber_delta
        )
        accept = new_cost < old_cost
        cam_out = jnp.where(accept, new_cam, cam_pose)
        pts_out = jnp.where(accept, new_points, points)
        lam_next = jnp.where(accept, lam_t * 0.5, lam_t * 4.0)
        return (cam_out, pts_out, lam_next), (new_cost, pcg_res)

    # fp32 accumulation discipline (SURVEY.md §8): TPU's default bf16 matmul
    # precision corrupts the normal equations enough to stall/diverge LM —
    # observed on-device with the pose graph; same physics applies here.
    with jax.default_matmul_precision("highest"):
        (cam_f, pts_f, _), (costs, pcg_res) = jax.lax.scan(
            step, (prob.cam_pose, prob.points, jnp.float32(lam)), None,
            length=iters,
        )
    return BAResult(
        problem=prob.replace(cam_pose=cam_f, points=pts_f),
        costs=costs,
        pcg_residuals=pcg_res,
    )


def window_problem(prob: BAProblem, window: int) -> BAProblem:
    """Sliding-window (local) BA: keep only the newest `window` cameras
    free; older cameras are frozen (cam_fixed) but their observations still
    constrain the shared points — the keyframe-window blocking analog of
    long-context processing (SURVEY.md §6). Shapes are unchanged, so the
    same jitted optimizer serves full and windowed BA."""
    C = prob.num_cams
    last_valid = jnp.where(prob.cam_valid, jnp.arange(C), -1).max()
    frozen = jnp.arange(C) <= (last_valid - window)
    return prob.replace(cam_fixed=prob.cam_fixed | frozen)

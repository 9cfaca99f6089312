"""Pose-graph optimization: Levenberg-damped Gauss-Newton on SE(3).

SURVEY.md §3 backend contract: minimize
    Σ_e ‖ log( Z_e⁻¹ · T_i⁻¹ · T_j ) ‖²_Λe
over keyframe poses by GN with left-multiplied tangent perturbations
(T ← T·exp(δ)), first valid node gauge-fixed.

Batched formulation: residual Jacobians per edge come from one `jax.jacfwd`
over the 12-dim (δi, δj) edge perturbation — batched over ALL edges with
vmap, so the linearization is a single fused XLA op; the normal system is
assembled densely ([K*6, K*6]) with scatter-adds and solved by Cholesky.
Dense is right-sized here: K ≤ a few hundred keyframes is the online
regime; the 50k-landmark scale lives in `backend/ba.py`'s Schur/PCG path
instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.backend.graph import PoseGraph


def edge_residual(pose_i, pose_j, rel):
    """r = log(rel⁻¹ · pose_i⁻¹ · pose_j) ∈ R⁶."""
    between = geometry.se3_between(pose_i, pose_j)
    err = geometry.se3_compose(geometry.se3_inverse(rel), between)
    return geometry.se3_log(err)


def _edge_residual_perturbed(delta, pose_i, pose_j, rel):
    """Residual with tangent perturbations applied: T·exp(δ)."""
    di, dj = delta[:6], delta[6:]
    pi = geometry.se3_compose(pose_i, geometry.se3_exp(di))
    pj = geometry.se3_compose(pose_j, geometry.se3_exp(dj))
    return edge_residual(pi, pj, rel)


def graph_cost(g: PoseGraph) -> jax.Array:
    pi = g.poses[g.edge_ij[:, 0]]
    pj = g.poses[g.edge_ij[:, 1]]
    r = jax.vmap(edge_residual)(pi, pj, g.edge_rel)
    w = g.edge_valid[:, None] * g.edge_info
    return 0.5 * jnp.sum(w * r * r)


@partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    g: PoseGraph, iters: int = 10, damping: float = 1e-4,
    huber: float = 3.0,
) -> tuple[PoseGraph, jax.Array]:
    """Levenberg-Marquardt with adaptive damping and step acceptance;
    returns (graph with optimized poses, per-iter costs).

    Plain GN (constant tiny damping, always-accept) diverges on loop-closure
    graphs whose Horn-estimated edges are mutually inconsistent — observed
    on-device: costs 8e3 -> 8e4 -> ... -> inf -> nan, after which the NaN
    correction poisons every particle pose. LM rejects cost-increasing
    steps and raises lambda instead. All linear algebra is pinned to
    full-float32 matmuls: reduced-precision inputs (TF32 on the GPU by
    default) corrupt H enough that a graph converging in float32 diverges
    (SURVEY.md §8 fp32 accumulation discipline).

    `huber`: robust kernel width in information-weighted sigma units
    (IRLS: each edge is down-weighted by min(1, huber/||r||_Λ) at every
    relinearization; 0 disables). Closure edges carry a heavy error tail
    (round-5 measurement on TUM: median 0.14 m but p90 0.52 m) — a single
    bad Horn fit at quadratic cost visibly bends the whole graph.
    """
    K = g.max_nodes
    # Gauge: fix the first valid node.
    first = jnp.argmax(g.node_valid)
    free = g.node_valid & (jnp.arange(K) != first)
    w = g.edge_valid[:, None] * g.edge_info  # [E, 6]

    def linearize(poses):
        pi = poses[g.edge_ij[:, 0]]
        pj = poses[g.edge_ij[:, 1]]
        zero = jnp.zeros((12,))
        r = jax.vmap(lambda a, b, z: _edge_residual_perturbed(zero, a, b, z))(
            pi, pj, g.edge_rel
        )
        J = jax.vmap(
            lambda a, b, z: jax.jacfwd(_edge_residual_perturbed)(zero, a, b, z)
        )(pi, pj, g.edge_rel)  # [E, 6, 12]
        return r, J[..., :6], J[..., 6:]

    def cost_at(poses):
        pi = poses[g.edge_ij[:, 0]]
        pj = poses[g.edge_ij[:, 1]]
        r = jax.vmap(edge_residual)(pi, pj, g.edge_rel)
        if huber <= 0.0:
            return 0.5 * jnp.sum(w * r * r)
        s2 = jnp.sum(w * r * r, axis=1)
        sn = jnp.sqrt(jnp.maximum(s2, 1e-12))
        rho = jnp.where(
            sn <= huber, 0.5 * s2, huber * (sn - 0.5 * huber)
        )
        return jnp.sum(rho)

    def robust_w(r):
        """IRLS edge weights: w scaled by min(1, huber/||r||_Λ)."""
        if huber <= 0.0:
            return w
        sn = jnp.sqrt(jnp.maximum(jnp.sum(w * r * r, axis=1), 1e-12))
        return w * jnp.minimum(1.0, huber / sn)[:, None]

    def step(carry, _):
        poses, lam, cost = carry
        r, Ji, Jj = linearize(poses)
        we = robust_w(r)
        wr = we * r
        # Assemble H [K, 6, K, 6] and b [K, 6] with scatter-adds.
        JiW = Ji * we[:, :, None]  # information-weighted (robust)
        JjW = Jj * we[:, :, None]
        hp = jax.lax.Precision.HIGHEST
        Hii = jnp.einsum("eki,ekj->eij", Ji, JiW, precision=hp)
        Hjj = jnp.einsum("eki,ekj->eij", Jj, JjW, precision=hp)
        Hij = jnp.einsum("eki,ekj->eij", Ji, JjW, precision=hp)
        bi = jnp.einsum("eki,ek->ei", Ji, wr, precision=hp)
        bj = jnp.einsum("eki,ek->ei", Jj, wr, precision=hp)
        ii = g.edge_ij[:, 0]
        jj = g.edge_ij[:, 1]
        H = jnp.zeros((K, 6, K, 6))
        H = H.at[ii, :, ii, :].add(Hii)
        H = H.at[jj, :, jj, :].add(Hjj)
        H = H.at[ii, :, jj, :].add(Hij)
        H = H.at[jj, :, ii, :].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 6)).at[ii].add(bi).at[jj].add(bj)

        # Gauge + invalid nodes: project out their DOFs.
        mask = free.astype(poses.dtype)
        Hm = H * mask[:, None, None, None] * mask[None, None, :, None]
        Hm = Hm.reshape(K * 6, K * 6)
        bm = (b * mask[:, None]).reshape(K * 6)
        # LM damping proportional to the diagonal; unit diagonal on fixed
        # DOFs keeps the system nonsingular.
        diag = jnp.diagonal(Hm)
        diag_fix = (1.0 - jnp.repeat(mask, 6)) + lam * jnp.maximum(diag, 1e-8)
        Hm = Hm + jnp.diag(diag_fix)
        with jax.default_matmul_precision("highest"):
            delta = -jnp.linalg.solve(Hm, bm).reshape(K, 6)
        delta = delta * mask[:, None]
        cand = jax.vmap(
            lambda p, d: geometry.se3_compose(p, geometry.se3_exp(d))
        )(poses, delta)
        new_cost = cost_at(cand)
        accept = jnp.isfinite(new_cost) & (new_cost < cost)
        poses = jnp.where(accept, cand, poses)
        lam = jnp.clip(jnp.where(accept, lam * 0.3, lam * 8.0), 1e-7, 1e6)
        cost = jnp.where(accept, new_cost, cost)
        return (poses, lam, cost), cost

    init = (g.poses, jnp.asarray(damping), cost_at(g.poses))
    with jax.default_matmul_precision("highest"):
        (poses, _, _), costs = jax.lax.scan(step, init, None, length=iters)
    return g.replace(poses=poses), costs

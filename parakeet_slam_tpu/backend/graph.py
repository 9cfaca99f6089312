"""Fixed-capacity keyframe / factor-graph state containers.

Backend counterpart of `core/state.py`: keyframes, pose-graph edges, and BA
observations are dense masked arrays with static capacities so the whole
optimizer is one jitted program (SURVEY.md §2c `backend/posegraph`,
`backend/ba`). Keyframe insertion and edge insertion are masked writes at a
cursor — the same capacity discipline as the filter's landmark table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.core.state import pytree_dataclass


@pytree_dataclass
class PoseGraph:
    """SE(3) pose graph: nodes + relative-pose edges.

    poses      [K, 7]  keyframe poses (world-from-keyframe)
    node_valid [K]
    edge_ij    [E, 2]  int32 endpoints (i observes j: Z_ij ≈ T_i⁻¹ T_j)
    edge_rel   [E, 7]  measured relative pose Z_ij
    edge_info  [E, 6]  diagonal information (per-tangent-dim weights)
    edge_valid [E]
    n_nodes, n_edges   int32 cursors
    """

    poses: jax.Array
    node_valid: jax.Array
    edge_ij: jax.Array
    edge_rel: jax.Array
    edge_info: jax.Array
    edge_valid: jax.Array
    n_nodes: jax.Array
    n_edges: jax.Array

    @property
    def max_nodes(self) -> int:
        return self.poses.shape[0]

    @property
    def max_edges(self) -> int:
        return self.edge_ij.shape[0]


def make_pose_graph(max_nodes: int, max_edges: int) -> PoseGraph:
    identity = jnp.zeros((7,)).at[6].set(1.0)
    return PoseGraph(
        poses=jnp.tile(identity, (max_nodes, 1)),
        node_valid=jnp.zeros((max_nodes,), bool),
        edge_ij=jnp.zeros((max_edges, 2), jnp.int32),
        edge_rel=jnp.tile(identity, (max_edges, 1)),
        edge_info=jnp.ones((max_edges, 6)),
        edge_valid=jnp.zeros((max_edges,), bool),
        n_nodes=jnp.int32(0),
        n_edges=jnp.int32(0),
    )


def shrink_to_active(g: PoseGraph, min_cap: int = 32) -> tuple[PoseGraph, int, int]:
    """Host-side view of the graph at power-of-two capacities covering the
    LIVE node/edge counts. The optimizer's dense normal system is
    [K*6, K*6]; solving at the full preset capacity (e.g. 1024 nodes =
    a 6144² Cholesky) on a 60-keyframe run wastes ~1000× the flops and
    runs at EVERY accepted loop closure. Power-of-two rounding keeps the
    jit-compile count O(log K) over a run. Returns (view, n_nodes,
    n_edges); write results back with `unshrink` semantics: poses[:n] of
    the view are the live ones. Call from the host (concrete cursors)."""
    n_nodes = int(g.n_nodes)
    n_edges = int(g.n_edges)
    kc = min_cap
    while kc < n_nodes:
        kc *= 2
    ec = min_cap
    while ec < n_edges:
        ec *= 2
    kc = min(kc, g.max_nodes)
    ec = min(ec, g.max_edges)
    view = g.replace(
        poses=g.poses[:kc],
        node_valid=g.node_valid[:kc],
        edge_ij=g.edge_ij[:ec],
        edge_rel=g.edge_rel[:ec],
        edge_info=g.edge_info[:ec],
        edge_valid=g.edge_valid[:ec],
    )
    return view, n_nodes, n_edges


def add_node(g: PoseGraph, pose: jax.Array) -> PoseGraph:
    """Masked append (no-op when full)."""
    k = g.n_nodes
    ok = k < g.max_nodes
    kc = jnp.clip(k, 0, g.max_nodes - 1)
    return g.replace(
        poses=g.poses.at[kc].set(jnp.where(ok, pose, g.poses[kc])),
        node_valid=g.node_valid.at[kc].set(ok | g.node_valid[kc]),
        n_nodes=k + ok.astype(jnp.int32),
    )


def add_edge(g: PoseGraph, i, j, rel: jax.Array, info=None, valid=True) -> PoseGraph:
    e = g.n_edges
    ok = (e < g.max_edges) & jnp.asarray(valid)
    ec = jnp.clip(e, 0, g.max_edges - 1)
    if info is None:
        info = jnp.ones((6,))
    return g.replace(
        edge_ij=g.edge_ij.at[ec].set(
            jnp.where(ok, jnp.stack([jnp.int32(i), jnp.int32(j)]), g.edge_ij[ec])
        ),
        edge_rel=g.edge_rel.at[ec].set(jnp.where(ok, rel, g.edge_rel[ec])),
        edge_info=g.edge_info.at[ec].set(jnp.where(ok, info, g.edge_info[ec])),
        edge_valid=g.edge_valid.at[ec].set(ok | g.edge_valid[ec]),
        n_edges=e + ok.astype(jnp.int32),
    )


@pytree_dataclass
class BAProblem:
    """Bundle-adjustment problem: cameras, points, projections.

    cam_pose  [C, 7]  world-from-camera SE(3)
    cam_valid [C]
    points    [Lm, 3] world landmarks
    pt_valid  [Lm]
    obs_cam   [O]     int32 camera index per observation
    obs_pt    [O]     int32 point index
    obs_uv    [O, Dz] measured projection (2 for mono/equirect, 3 stereo)
    obs_valid [O]
    cam_fixed [C]     gauge-fixing mask (first camera typically)
    """

    cam_pose: jax.Array
    cam_valid: jax.Array
    points: jax.Array
    pt_valid: jax.Array
    obs_cam: jax.Array
    obs_pt: jax.Array
    obs_uv: jax.Array
    obs_valid: jax.Array
    cam_fixed: jax.Array

    @property
    def num_cams(self) -> int:
        return self.cam_pose.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_obs(self) -> int:
        return self.obs_cam.shape[0]


def make_ba_problem(
    cam_pose, points, obs_cam, obs_pt, obs_uv,
    cam_valid=None, pt_valid=None, obs_valid=None, cam_fixed=None,
) -> BAProblem:
    cam_pose = jnp.asarray(cam_pose)
    points = jnp.asarray(points)
    C, Lm, O = cam_pose.shape[0], points.shape[0], obs_cam.shape[0]
    if cam_valid is None:
        cam_valid = jnp.ones((C,), bool)
    if pt_valid is None:
        pt_valid = jnp.ones((Lm,), bool)
    if obs_valid is None:
        obs_valid = jnp.ones((O,), bool)
    if cam_fixed is None:
        cam_fixed = jnp.zeros((C,), bool).at[0].set(True)
    return BAProblem(
        cam_pose=cam_pose, cam_valid=cam_valid,
        points=points, pt_valid=pt_valid,
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_uv=jnp.asarray(obs_uv),
        obs_valid=obs_valid, cam_fixed=cam_fixed,
    )


@pytree_dataclass
class BAProblemPacked:
    """Point-major padded BA problem — a dense execution layout.

    Derived from `BAProblem` by `pack_problem`: every point's observations
    are bucketed into a dense [Lm, Kmax] table.  The Schur matvec's
    per-point aggregations (Jpᵀ t, C blocks, w_g, back-substitution) then
    become dense axis-1 sums and broadcasts — no XLA scatter/gather on the
    50k-wide point axis.  Camera-side ops still index the small [C, ...]
    tables.

    cam_pose  [C, 7], cam_valid [C], cam_fixed [C]
    points    [Lm, 3], pt_valid [Lm]
    p_cam     [Lm, K] int32 camera index per bucketed observation
    p_uv      [Lm, K, Dz]
    p_valid   [Lm, K] bool (padding rows are False)
    """

    cam_pose: jax.Array
    cam_valid: jax.Array
    points: jax.Array
    pt_valid: jax.Array
    cam_fixed: jax.Array
    p_cam: jax.Array
    p_uv: jax.Array
    p_valid: jax.Array

    @property
    def num_cams(self) -> int:
        return self.cam_pose.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def k_max(self) -> int:
        return self.p_cam.shape[1]


def pack_problem(prob: BAProblem, k_max: int | None = None) -> BAProblemPacked:
    """Host-side repack of a BAProblem into the point-major padded layout.

    k_max defaults to the actual maximum observations-per-point (rounded up
    to a multiple of 4 to limit recompilation churn across problems). Must
    be called OUTSIDE jit (uses concrete numpy values).
    """
    import numpy as np

    obs_pt = np.asarray(prob.obs_pt)
    obs_cam = np.asarray(prob.obs_cam)
    obs_uv = np.asarray(prob.obs_uv)
    valid = np.asarray(prob.obs_valid)
    Lm = prob.num_points
    Dz = obs_uv.shape[1]

    pt_v = obs_pt[valid]
    counts = np.bincount(pt_v, minlength=Lm) if pt_v.size else np.zeros(Lm, np.int64)
    need = int(counts.max()) if counts.size else 1
    if k_max is None:
        k_max = max(4, ((need + 3) // 4) * 4)
    elif need > k_max:
        raise ValueError(
            f"pack_problem: k_max={k_max} < max obs/point {need}; "
            "raise k_max or split the problem"
        )

    p_cam = np.zeros((Lm, k_max), np.int32)
    p_uv = np.zeros((Lm, k_max, Dz), obs_uv.dtype)
    p_valid = np.zeros((Lm, k_max), bool)
    idx = np.nonzero(valid)[0]
    if idx.size:
        order = np.argsort(obs_pt[idx], kind="stable")
        o_sorted = idx[order]
        pts = obs_pt[o_sorted]
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        slots = np.arange(o_sorted.size) - starts[pts]
        p_cam[pts, slots] = obs_cam[o_sorted]
        p_uv[pts, slots] = obs_uv[o_sorted]
        p_valid[pts, slots] = True

    return BAProblemPacked(
        cam_pose=prob.cam_pose,
        cam_valid=prob.cam_valid,
        points=prob.points,
        pt_valid=prob.pt_valid,
        cam_fixed=prob.cam_fixed,
        p_cam=jnp.asarray(p_cam),
        p_uv=jnp.asarray(p_uv),
        p_valid=jnp.asarray(p_valid),
    )


@pytree_dataclass
class BAProblemBuckets:
    """Bucketed point-major BA layout — the production execution form.

    `BAProblemPacked` pads every point to the global max obs/point, which
    on skewed covisibility (KITTI/EuRoC: mean ~2.6, max ~12+) multiplies
    the dense work ~4.7x.  Here points are grouped by observation count
    into a few tables, each padded only to its own K cap, so padded work
    stays within ~2x of the true observation count.  Each point appears in
    exactly one bucket; per-point reductions (C blocks, w_g, back-
    substitution) are dense axis-1 sums inside a bucket, and camera-side
    aggregations are one-hot matmuls — the Schur matvec contains **no
    scatter at all**.

    cam_pose [C, 7], cam_valid [C], cam_fixed [C]
    points   [Lm, 3], pt_valid [Lm]
    pt_idx   tuple of [Lb]        original point index per bucket row
    row_valid tuple of [Lb]       padding rows are False
    p_cam    tuple of [Lb, Kb] int32
    p_uv     tuple of [Lb, Kb, Dz]
    p_valid  tuple of [Lb, Kb]
    """

    cam_pose: jax.Array
    cam_valid: jax.Array
    points: jax.Array
    pt_valid: jax.Array
    cam_fixed: jax.Array
    pt_idx: tuple
    row_valid: tuple
    p_cam: tuple
    p_uv: tuple
    p_valid: tuple

    @property
    def num_cams(self) -> int:
        return self.cam_pose.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


_BUCKET_CAPS = (4, 8, 16, 32, 64, 128)


def pack_buckets(prob: BAProblem, caps=_BUCKET_CAPS) -> BAProblemBuckets:
    """Host-side repack of a BAProblem into the bucketed point-major layout.

    Bucket row counts round up to multiples of 512 (and K caps are the
    fixed ladder above) so repeated packs of similar problems reuse the
    jitted optimizer's compilation. Must be called outside jit.
    """
    import numpy as np

    obs_pt = np.asarray(prob.obs_pt)
    obs_cam = np.asarray(prob.obs_cam)
    obs_uv = np.asarray(prob.obs_uv)
    valid = np.asarray(prob.obs_valid)
    Lm = prob.num_points
    Dz = obs_uv.shape[1]

    idx = np.nonzero(valid)[0]
    counts = np.bincount(obs_pt[idx], minlength=Lm)
    need = int(counts.max()) if idx.size else 1
    caps = [k for k in caps if k < need] + [max(4, int(2 ** np.ceil(np.log2(need))))]
    caps = sorted(set(caps))

    # observations sorted by point; per-point slot = rank within the point
    order = np.argsort(obs_pt[idx], kind="stable")
    o_sorted = idx[order]
    pts_sorted = obs_pt[o_sorted]
    starts = np.concatenate(([0], np.cumsum(counts)))
    slots = np.arange(o_sorted.size) - starts[pts_sorted]

    # bucket id per point (points with zero obs join no bucket)
    bucket_of = np.searchsorted(caps, counts, side="left")
    pt_idx_t, row_valid_t, p_cam_t, p_uv_t, p_valid_t = [], [], [], [], []
    for b, K in enumerate(caps):
        members = np.nonzero((bucket_of == b) & (counts > 0))[0]
        if members.size == 0:
            continue
        Lb = int(-(-members.size // 512) * 512)
        row_of = np.full(Lm, -1, np.int64)
        row_of[members] = np.arange(members.size)
        pt_idx = np.zeros(Lb, np.int32)
        pt_idx[: members.size] = members
        row_valid = np.zeros(Lb, bool)
        row_valid[: members.size] = True
        p_cam = np.zeros((Lb, K), np.int32)
        p_uv = np.zeros((Lb, K, Dz), obs_uv.dtype)
        p_valid = np.zeros((Lb, K), bool)
        sel = row_of[pts_sorted] >= 0
        r = row_of[pts_sorted[sel]]
        s = slots[sel]
        o = o_sorted[sel]
        p_cam[r, s] = obs_cam[o]
        p_uv[r, s] = obs_uv[o]
        p_valid[r, s] = True
        pt_idx_t.append(jnp.asarray(pt_idx))
        row_valid_t.append(jnp.asarray(row_valid))
        p_cam_t.append(jnp.asarray(p_cam))
        p_uv_t.append(jnp.asarray(p_uv))
        p_valid_t.append(jnp.asarray(p_valid))

    if not pt_idx_t:  # degenerate: no valid observations at all
        pt_idx_t = [jnp.zeros((512,), jnp.int32)]
        row_valid_t = [jnp.zeros((512,), bool)]
        p_cam_t = [jnp.zeros((512, 4), jnp.int32)]
        p_uv_t = [jnp.zeros((512, 4, Dz), obs_uv.dtype)]
        p_valid_t = [jnp.zeros((512, 4), bool)]

    return BAProblemBuckets(
        cam_pose=prob.cam_pose,
        cam_valid=prob.cam_valid,
        points=prob.points,
        pt_valid=prob.pt_valid,
        cam_fixed=prob.cam_fixed,
        pt_idx=tuple(pt_idx_t),
        row_valid=tuple(row_valid_t),
        p_cam=tuple(p_cam_t),
        p_uv=tuple(p_uv_t),
        p_valid=tuple(p_valid_t),
    )


def cap_obs_per_point(prob: BAProblem, k: int) -> BAProblem:
    """Host-side covisibility thinning: keep at most k observations per
    point, spread evenly across that point's observing cameras (by
    observation order = keyframe order). Long multi-session runs re-observe
    hall landmarks hundreds of times; beyond a few dozen views per point
    the extra residuals barely change the solution but the bucketed
    point-major pack's [Lb, Kmax] temporaries grow linearly (267-view
    points OOMed the round-4 EuRoC joint BA). Must be called outside jit."""
    import numpy as np

    if k <= 0:
        return prob
    obs_pt = np.asarray(prob.obs_pt)
    valid = np.asarray(prob.obs_valid).copy()
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return prob
    order = np.argsort(obs_pt[idx], kind="stable")
    o_sorted = idx[order]
    pts_sorted = obs_pt[o_sorted]
    counts = np.bincount(pts_sorted, minlength=prob.num_points)
    starts = np.concatenate(([0], np.cumsum(counts)))
    rank = np.arange(o_sorted.size) - starts[pts_sorted]
    cnt = np.maximum(counts[pts_sorted], 1)
    # Even decimation: keep rank r iff floor(r*k/c) advanced. For c > k
    # this keeps exactly k ranks (floor hits each of 0..k-1 once); for
    # c <= k it advances every step and keeps all.
    keep = (rank * k) // cnt != ((rank - 1) * k) // cnt
    keep |= rank == 0
    drop = o_sorted[~keep]
    valid[drop] = False
    return prob.replace(obs_valid=jnp.asarray(valid))


def gate_outlier_obs(camera, prob: BAProblem, max_px: float) -> BAProblem:
    """Invalidate observations whose reprojection residual at the INITIAL
    values exceeds max_px — the standard gross-outlier gate before bundle
    adjustment (wrong data associations and diverged landmarks produce
    1e5-px-class residuals whose robustified cost still drowns the real
    signal)."""
    from parakeet_slam_tpu.core import geometry as geo

    cam = prob.cam_pose[prob.obs_cam]
    pt = prob.points[prob.obs_pt]
    p_cam = jax.vmap(geo.se3_apply_inverse)(cam, pt)
    pred = camera.project(p_cam)
    if hasattr(camera, "residual"):
        r = camera.residual(prob.obs_uv, pred)
    else:
        r = prob.obs_uv - pred
    n = jnp.linalg.norm(r, axis=-1)
    ok = jnp.isfinite(n) & (n < max_px)
    return prob.replace(obs_valid=prob.obs_valid & ok)


def estimate_relative_pose_3d3d(pa: jax.Array, pb: jax.Array, valid: jax.Array):
    """SE(3) T such that pa ≈ T(pb), from masked 3-D correspondences
    (Horn/Umeyama closed form, weights = valid mask). Used to turn loop-
    closure landmark matches into pose-graph edge measurements."""
    w = valid.astype(pa.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu_a = jnp.sum(pa * w[:, None], axis=0) / n
    mu_b = jnp.sum(pb * w[:, None], axis=0) / n
    xa = (pa - mu_a) * w[:, None]
    xb = (pb - mu_b) * w[:, None]
    cov = xa.T @ xb / n
    U, _, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U) @ jnp.linalg.det(Vt)) if False else jnp.sign(
        jnp.linalg.det(U) * jnp.linalg.det(Vt)
    )
    D = jnp.ones((3,)).at[2].set(d)
    R = (U * D[None, :]) @ Vt
    t = mu_a - R @ mu_b
    q = geometry.matrix_to_quat(R)
    return jnp.concatenate([t, q])

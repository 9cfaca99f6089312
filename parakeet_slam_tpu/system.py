"""Visual SLAM system: frontend -> particle filter -> keyframe backend.

The user-facing integration layer (reference analog: the ROS node wrapper,
SURVEY.md §1 L4 / §4.1 — but here the per-frame path is one jitted device
program and the backend is a real pose-graph/BA optimizer instead of rviz
markers).

Per frame (`process_frame`):
  1. detect + describe on the grayscale image (frontend, jitted),
  2. assemble a fixed-capacity Observation (pixel measurement + packed
     BRIEF descriptor per keypoint),
  3. FastSLAM step (motion propagate + fused measurement update),
  4. keyframe decision by motion threshold; on keyframe: snapshot the best
     particle's landmark cloud (positions in keyframe frame + descriptors),
     add an odometry edge, and attempt loop closure by Hamming-matching
     descriptor sets against stored keyframes (the tiled matcher kernel);
     accepted closures become pose-graph edges via Horn 3D-3D alignment,
  5. on loop closure: optimize the pose graph and apply the resulting
     correction of the latest keyframe to every particle (left-multiply).

Host-side control flow handles only the keyframe bookkeeping (rare,
data-dependent); all dense math runs on device.
"""

from __future__ import annotations

import functools
import sys as _sys
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from parakeet_slam_tpu.backend import ba as ba_mod
from parakeet_slam_tpu.backend import graph as graph_mod
from parakeet_slam_tpu.backend import posegraph as pg_mod
from parakeet_slam_tpu.core import geometry
from parakeet_slam_tpu.core.config import SLAMConfig
from parakeet_slam_tpu.core.state import make_observation
from parakeet_slam_tpu.filter import make_filter
from parakeet_slam_tpu.frontend import camera as camera_mod
from parakeet_slam_tpu.frontend.describe import describe
from parakeet_slam_tpu.frontend.detect import detect
from parakeet_slam_tpu.kernels import match as match_mod
from parakeet_slam_tpu.utils.metrics_log import MetricsLogger


@functools.partial(jax.jit, static_argnames=("ratio",))
def _batched_kf_match(qd, qv, db, dbv, ratio: float):
    """Forward+reverse Lowe-ratio matches of one query descriptor set
    against a stacked keyframe store, vmapped over the keyframe axis.

    qd [F, W] uint32, qv [F] bool, db [K, F, W], dbv [K, F].
    Returns (fwd [K, F], rev [K, F]) int32 match indices (-1 = none) with
    per-keyframe semantics identical to matching each keyframe separately —
    but ONE device dispatch for the whole store instead of a host loop
    (round-1 review: O(K) sequential dispatches at 2048 keyframes).
    """

    def fwd1(d, v):
        idx, _ = match_mod.match(qd, qv, d, v, ratio=ratio)
        return idx

    def rev1(d, v):
        idx, _ = match_mod.match(d, v, qd, qv, ratio=ratio)
        return idx

    return jax.vmap(fwd1)(db, dbv), jax.vmap(rev1)(db, dbv)


@functools.partial(jax.jit, static_argnames=("cap", "max_ham"))
def _assign_point_ids(desc, valid, world, *, cap: int, max_ham: int):
    """Deduplicate keyframe landmark snapshots into a global point table.

    Scans keyframes in order; each step matches the keyframe's F descriptors
    against the point store built so far (ONE matcher dispatch) and
    allocates store slots for unmatched rows in row order. Replaces the
    round-1 pure-Python per-observation O(K²F²) host loop with a
    `lax.scan` of K matcher dispatches.

    desc [K, F, W] uint32, valid [K, F] bool, world [K, F, 3] first-seen
    world positions. Returns ((store_desc, store_valid, store_pos, count,
    dropped), pid [K, F] int32) where pid is the per-observation point id
    (-1 = invalid row or dropped by capacity).

    Intra-keyframe semantics: each keyframe's rows match only against the
    store built from PRIOR keyframes (the store update commits after the
    whole keyframe's match). Duplicate descriptors WITHIN one keyframe are
    therefore NOT merged — each valid unmatched row allocates its own point
    (distinct ascending slots via the cumsum rank). This is deliberate: two
    same-looking detections in one frame are distinct physical points by
    construction (the detector's NMS separates them spatially), and
    cross-keyframe matching is what establishes identity.
    """
    K, F, W = desc.shape

    def step(carry, inp):
        sd, sv, sp, cnt, drop = carry
        d_k, v_k, w_k = inp
        bi, b1, _ = match_mod.hamming_top2(d_k, sd, sv)
        matched = v_k & (b1 < max_ham)
        is_new = v_k & ~matched
        slot = cnt + jnp.cumsum(is_new.astype(jnp.int32)) - 1
        ok_new = is_new & (slot < cap)
        pid = jnp.where(matched, bi, jnp.where(ok_new, slot, -1))
        widx = jnp.where(ok_new, slot, cap)  # cap = dropped by scatter mode
        sd = sd.at[widx].set(d_k, mode="drop")
        sv = sv.at[widx].set(True, mode="drop")
        sp = sp.at[widx].set(w_k, mode="drop")
        cnt = jnp.minimum(cnt + jnp.sum(is_new.astype(jnp.int32)), cap)
        drop = drop + jnp.sum((is_new & ~ok_new).astype(jnp.int32))
        return (sd, sv, sp, cnt, drop), pid

    carry0 = (
        jnp.zeros((cap, W), jnp.uint32),
        jnp.zeros((cap,), bool),
        jnp.zeros((cap, 3), jnp.float32),
        jnp.int32(0),
        jnp.int32(0),
    )
    return jax.lax.scan(step, carry0, (desc, valid, world.astype(jnp.float32)))


def _global_descriptor(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Bit-frequency signature of a packed-descriptor set: fraction of
    valid descriptors with each of the W*32 bits set, L2-normalized after
    centering at 0.5 (a bag-of-binary-words-lite whole-frame signature;
    robust to WHICH keypoints fired, sensitive to the texture mix)."""
    F, W = desc.shape
    if valid.sum() == 0:
        return np.zeros((W * 32,), np.float32)
    bits = np.unpackbits(
        desc[valid].view(np.uint8), bitorder="little"
    ).reshape(-1, W * 32)
    f = bits.mean(axis=0).astype(np.float32) - 0.5
    n = float(np.linalg.norm(f))
    return f / n if n > 1e-9 else f


@dataclass
class Keyframe:
    index: int
    pose: np.ndarray          # [7] CURRENT best pose (updated by optimize/BA)
    points_kf: np.ndarray     # [F, 3] landmark positions in keyframe frame
    desc: np.ndarray          # [F, W] packed descriptors
    valid: np.ndarray         # [F]
    frame: int = 0            # source frame index (loop-closure recency gate)
    # Emission-frame anchor SEGMENTS: list of (start_frame, pose[7]). Each
    # entry says "online estimates emitted at frame >= start_frame (until
    # the next entry) are relative to this emission pose of the keyframe".
    # A loop-closure correction shifts the filter-estimate frame mid-run,
    # so the keyframe gets a NEW anchor segment starting at the next
    # emitted frame — rows already emitted keep the pre-correction anchor
    # (advisor r4: a single mutable anchor left the up-to-lag rows between
    # the flagged frame and the flush off by the correction).
    # corrected_trajectory() maps row t as pose . anchor(t)^-1 . est_t.
    anchors: list = field(default_factory=list)
    # Global place-recognition descriptor: per-bit frequency over the
    # keyframe's valid BRIEF descriptors ([W*32] f32 in [0, 1]). A coarse
    # whole-image signature — cosine similarity proposes mid-loop closure
    # candidates whose pairwise mutual-match count alone would lose the
    # argmax (VERDICT r4 item 5: KITTI found closures only at exact
    # revisit).
    gdesc: np.ndarray | None = None

    @property
    def anchor(self) -> np.ndarray:
        """Latest emission anchor (current filter-estimate frame)."""
        return self.anchors[-1][1]


@dataclass
class SLAMSystem:
    cfg: SLAMConfig

    def __post_init__(self):
        fe = self.cfg.frontend
        self.slam = make_filter(self.cfg.filter, fe)
        self.camera = camera_mod.from_config(fe)
        self.wrap_x = fe.camera == "equirect"
        self.keyframes: list[Keyframe] = []
        self.graph = graph_mod.make_pose_graph(
            self.cfg.backend.max_keyframes, 4 * self.cfg.backend.max_keyframes
        )
        # Multi-device: dist.particle_axis > 1 shards the particle axis over
        # the `ici` mesh axis (SURVEY §2b particle-DP) — the filter stage of
        # the fused step runs under shard_map, the rest is GSPMD-propagated.
        self._sharded = None
        self.mesh = None
        d = self.cfg.dist
        n_mesh = d.particle_axis * d.map_axis
        if n_mesh > len(jax.devices()):
            raise ValueError(
                f"dist config needs {n_mesh} devices (particle_axis x "
                f"map_axis) but {len(jax.devices())} are visible"
            )
        if d.particle_axis > 1:
            from parakeet_slam_tpu.dist.mesh import make_mesh
            from parakeet_slam_tpu.dist.sharded_filter import ShardedFastSLAM

            self.mesh = make_mesh(n_devices=n_mesh, map_axis=d.map_axis)
            self._sharded = ShardedFastSLAM(self.slam, self.mesh)
            self.state = self._sharded.init_state()
        else:
            self.state = self.slam.init_state()
        self.key = jax.random.PRNGKey(self.cfg.filter.seed)
        self.frame_idx = 0
        self.last_kf_pose = None
        self.metrics = MetricsLogger(self.cfg.metrics_path or None)
        self.loop_closures: list[tuple[int, int]] = []
        self._frontend_jit = jax.jit(self._frontend, static_argnums=())
        self._fused_frame = jax.jit(self._fused_frame_impl)
        self._fused_stereo = jax.jit(self._fused_stereo_impl)
        self._fused_obs = jax.jit(self._fused_obs_impl)
        self._kf_snapshot = jax.jit(self._kf_snapshot_impl)
        self._horn_consensus = jax.jit(self._horn_consensus_impl)
        self._refine_rel = jax.jit(self._refine_rel_impl)
        self._refine_rel_depth = jax.jit(self._refine_rel_depth_impl)

        def _verify_batch(pa, pb, valid):
            def one(pa1, pb1, v1):
                rel, n_in = self._horn_consensus_impl(pa1, pb1, v1)
                refine = (
                    self._refine_rel_depth_impl
                    if self.cfg.backend.loop_refine_depth_sigma > 0.0
                    else self._refine_rel_impl
                )
                return refine(rel, pa1, pb1, v1), n_in

            return jax.vmap(one)(pa, pb, valid)

        # Batched closure verification: ALL candidates of a flush window
        # verify in ONE device dispatch (vmapped Horn consensus + refine) —
        # the per-candidate dispatch+fetch pattern cost ~2 device->host
        # round-trips per keyframe.
        self._verify_candidates = jax.jit(_verify_batch)
        # Device-side keyframe-motion reference ([7] pose; identity until the
        # first keyframe exists). The keyframe test AND the reference update
        # both run inside the fused step: when a frame trips the motion
        # threshold its own estimate becomes the new reference, device-side,
        # so the keyframe CADENCE is a pure function of the frame sequence —
        # independent of when the host happens to drain the flag window
        # (round-3 regression: checkpoint-time flushes changed the keyframe
        # set, tests/test_checkpoint_resume.py).
        self._last_kf_dev = jnp.zeros((7,)).at[6].set(1.0)
        self._has_kf = False
        # metrics stay device arrays until flushed (one transfer per flush
        # instead of 4 blocking float() syncs per frame)
        self._metrics_pending: list[tuple] = []
        # Keyframe flags are fetched in batches of `kf_flag_lag` frames: a
        # single scalar device->host fetch costs a full round-trip, so
        # per-frame flag syncs alone would cap the frame rate. Flushes
        # happen at ABSOLUTE frame-index boundaries
        # (frame_idx % lag == 0), and each flagged frame carries its own
        # in-step map snapshot, so both the keyframe set and the keyframe
        # content are flush-timing-independent; a mid-window checkpoint
        # persists the window instead of draining it. The first keyframe is
        # never lagged.
        self.kf_flag_lag = 4
        self._flag_pending: list[tuple] = []
        # Device-resident stacked keyframe descriptor store [capK, F, W] /
        # [capK, F], grown by doubling so loop closure is one batched match
        # against the whole history (no per-keyframe host loop).
        self._kf_desc_dev: jax.Array | None = None
        self._kf_valid_dev: jax.Array | None = None
        # Dispatched-but-unresolved closure matches (kf_index, n_old,
        # fwd [K, F], rev [K, F] device arrays) — drained at the next flush.
        self._closure_pending: list[tuple] = []

    # -- frontend ---------------------------------------------------------

    def _frontend(self, img):
        fe = self.cfg.frontend
        if fe.pyramid_levels > 1:
            from parakeet_slam_tpu.frontend.pyramid import detect_pyramid

            xy, score, _lvl, valid = detect_pyramid(
                img,
                levels=fe.pyramid_levels,
                max_features=fe.max_features,
                detector=fe.detector,
                threshold=fe.fast_threshold,
                nms_radius=fe.nms_radius,
                wrap_x=self.wrap_x,
            )
        else:
            xy, score, valid = detect(
                img,
                max_features=fe.max_features,
                detector=fe.detector,
                threshold=fe.fast_threshold,
                nms_radius=fe.nms_radius,
                wrap_x=self.wrap_x,
            )
        desc = describe(img, xy, valid, wrap_x=self.wrap_x)
        return xy, desc, valid

    def _to_observation(self, z, desc, valid):
        """Keypoint measurements -> fixed-capacity filter Observation."""
        Z = self.cfg.filter.max_observations
        z = z[:Z]
        desc = desc[:Z]
        valid = valid[:Z]
        pad = Z - z.shape[0]
        if pad > 0:
            z = jnp.pad(z, ((0, pad), (0, 0)))
            desc = jnp.pad(desc, ((0, pad), (0, 0)))
            valid = jnp.pad(valid, (0, pad))
        return make_observation(z, desc=desc, valid=valid)

    # -- keyframe / loop closure -----------------------------------------

    def _kf_snapshot_impl(self, state, est_pose):
        """Best-particle map snapshot in the keyframe frame — one jitted
        program so keyframe creation costs one dispatch + one device_get
        (the round-2 version issued ~6 separate fetches per keyframe, one
        device->host round-trip each).

        Lane SELECTION is view-relevance-ranked: valid in-FOV lanes first
        (most-observed first), then valid out-of-view lanes. The round-3
        version took the FIRST F lanes of the table — at KITTI scale
        (L=10240, F=512) those low lanes hold whatever allocation history
        left there, so revisit keyframes never shared landmarks with the
        keyframes they should close against (the 700-frame loop produced
        exactly one closure, between keyframes 4 frames apart, with
        residual 0.000 — a tautology; the real end-of-circuit closure
        never fired)."""
        means, valid = self.slam.best_particle_map(state)
        best = jnp.argmax(state.log_w)
        desc = state.lm_desc[best]
        count = state.lm_count[best]
        F = min(self.cfg.frontend.max_features, means.shape[0])
        in_fov = jax.vmap(
            lambda m: self.slam.model.in_fov(est_pose, m)
        )(means)
        # Sanity gate: a monocular EKF lane can diverge (means at 1e28 were
        # observed leaking into keyframes and poisoning BA observations to
        # inf). Exclude non-finite or absurdly distant lanes entirely.
        dist = jnp.linalg.norm(means - est_pose[:3][None, :], axis=-1)
        sane = jnp.isfinite(dist) & (dist < 8.0 * self.cfg.filter.max_range)
        score = jnp.where(
            valid & sane,
            jnp.where(in_fov, 1e6, 0.0) + count.astype(jnp.float32),
            -1.0,
        )
        _, sel = jax.lax.top_k(score, F)
        pts_kf = jax.vmap(
            lambda m: geometry.se3_apply_inverse(est_pose, m)
        )(means[sel])
        return pts_kf, desc[sel], valid[sel] & sane[sel]

    def _make_keyframe(self, est_pose, snap=None, frame=None, anchor_pose=None):
        """Materialize a keyframe from a map snapshot (the flagged frame's
        in-step snapshot when given; otherwise the current state's).
        `anchor_pose`, when given, is the RAW emission-frame estimate (it
        differs from est_pose only when a correction was applied earlier in
        the same flush window — est_pose then carries the correction for
        graph consistency while already-emitted rows are still relative to
        the raw estimate)."""
        est_pose = jnp.asarray(est_pose)
        if snap is None:
            snap = self._kf_snapshot(self.state, est_pose)
        pts_kf, desc, valid = snap
        pose_np, pts_np, desc_np, valid_np = jax.device_get(
            (est_pose, pts_kf, desc, valid)
        )
        fr = self.frame_idx if frame is None else frame
        gdesc = _global_descriptor(desc_np, valid_np)
        anchor_np = (
            pose_np.copy() if anchor_pose is None
            else np.asarray(jax.device_get(anchor_pose), np.float32)
        )
        kf = Keyframe(
            index=len(self.keyframes),
            pose=pose_np,
            points_kf=pts_np,
            desc=desc_np,
            valid=valid_np,
            frame=fr,
            anchors=[(fr, anchor_np)],
            gdesc=gdesc,
        )
        self.keyframes.append(kf)
        self._kf_store_append(kf)
        self.graph = graph_mod.add_node(self.graph, jnp.asarray(est_pose))
        if kf.index > 0:
            prev = self.keyframes[kf.index - 1]
            rel = geometry.se3_between(
                jnp.asarray(prev.pose), jnp.asarray(est_pose)
            )
            # Odometry-edge information scales with the ACTUAL odometry
            # noise accumulated over the edge's frame span: sigma^2 =
            # n_frames * odom_sigma^2 + estimate-jitter floor (the config
            # odom_edge_info encodes the floor, measured 0.056 m on TUM).
            # A fixed info is wildly wrong in the degraded-odometry regime
            # (10x noise -> the graph overtrusts odometry 40x and closures
            # cannot correct it).
            df = max(kf.frame - prev.frame, 1)
            it0, ir0 = self.cfg.backend.odom_edge_info
            st, sr = self.cfg.data.odom_noise
            it = 1.0 / (df * float(st) ** 2 + 1.0 / it0)
            ir = 1.0 / (df * float(sr) ** 2 + 1.0 / ir0)
            self.graph = graph_mod.add_edge(
                self.graph, kf.index - 1, kf.index, rel,
                info=jnp.asarray([it, it, it, ir, ir, ir], jnp.float32),
            )
        return kf

    def _kf_store_append(self, kf: Keyframe):
        """Write a keyframe's descriptors into the stacked device store,
        doubling capacity as needed (recompiles of the batched matcher are
        then O(log K) over a run, not O(K))."""
        F, W = kf.desc.shape
        cap = 0 if self._kf_desc_dev is None else self._kf_desc_dev.shape[0]
        if kf.index + 1 > cap:
            new_cap = 64 if cap == 0 else cap * 2
            while new_cap < kf.index + 1:
                new_cap *= 2
            desc = jnp.zeros((new_cap, F, W), jnp.uint32)
            val = jnp.zeros((new_cap, F), bool)
            if cap:
                desc = desc.at[:cap].set(self._kf_desc_dev)
                val = val.at[:cap].set(self._kf_valid_dev)
            self._kf_desc_dev, self._kf_valid_dev = desc, val
        self._kf_desc_dev = self._kf_desc_dev.at[kf.index].set(
            jnp.asarray(kf.desc)
        )
        self._kf_valid_dev = self._kf_valid_dev.at[kf.index].set(
            jnp.asarray(kf.valid)
        )

    def _rebuild_kf_store(self):
        self._kf_desc_dev = self._kf_valid_dev = None
        if not self.keyframes:
            return
        # bulk upload once (checkpoint restore), then normal appends resume
        cap = 64
        while cap < len(self.keyframes):
            cap *= 2
        F, W = self.keyframes[0].desc.shape
        desc = np.zeros((cap, F, W), np.uint32)
        val = np.zeros((cap, F), bool)
        for kf in self.keyframes:
            desc[kf.index] = kf.desc
            val[kf.index] = kf.valid
        self._kf_desc_dev = jnp.asarray(desc)
        self._kf_valid_dev = jnp.asarray(val)

    def _try_loop_closure(self, kf: Keyframe, min_matches: int = 12):
        """Synchronous convenience wrapper (tests / one-off callers):
        dispatch this keyframe's closure match and resolve it immediately.
        Returns True when an accepted closure wants an inline optimize."""
        self._dispatch_loop_closure(kf)
        return self._resolve_closures(min_matches)

    def _dispatch_loop_closure(self, kf: Keyframe):
        """Launch the batched descriptor match of this keyframe against ALL
        eligible older keyframes (one vmapped matcher dispatch over the
        stacked store) WITHOUT blocking on the result — the [K, F] match
        tables stay on device until the next flush drains them
        (SURVEY.md §2b frontend/filter/backend pipelining: closure
        verdicts ride one flag window behind keyframe creation, so the
        device->host round-trip per keyframe overlaps the frame loop
        instead of stalling it)."""
        # keyframes are created in frame order, so frame-gap eligibility is
        # a prefix of the store
        gap = self.cfg.backend.loop_min_frame_gap
        n_old = sum(1 for k in self.keyframes[: kf.index] if k.frame <= kf.frame - gap)
        if n_old == 0:
            return
        eligible = jnp.arange(self._kf_desc_dev.shape[0]) < n_old
        fwd, rev = _batched_kf_match(
            jnp.asarray(kf.desc), jnp.asarray(kf.valid),
            self._kf_desc_dev, self._kf_valid_dev & eligible[:, None],
            ratio=self.cfg.frontend.match_ratio,
        )
        self._closure_pending.append((kf.index, n_old, fwd, rev))

    def _resolve_closures(self, min_matches: int = 12) -> bool:
        """Drain the dispatched closure matches (ONE batched device->host
        transfer), cross-check correspondences, Horn-fit the best candidate
        per keyframe, and add accepted edges. Returns True when at least
        one accepted closure passes the innovation gate — the caller then
        runs ONE optimize+correct for the whole batch (round-4: one
        pose-graph solve per closure at 211 closures halved throughput).

        Correspondences are mutually cross-checked (forward+reverse NN must
        agree — the one-directional ratio test alone lets many query rows
        collapse onto one train row and feeds Horn garbage), then the Horn
        fit is iterated on inliers and the closure rejected unless a tight
        consensus remains."""
        pend, self._closure_pending = self._closure_pending, []
        if not pend:
            return False
        fetched = jax.device_get([(f, r) for _, _, f, r in pend])
        # -- phase 1 (host): candidate selection + correspondence tables --
        cand_rows = []  # (kf_index, old_index, pa, pb, valid)
        for (kidx, n_old, _, _), (fwd, rev) in zip(pend, fetched):
            kf = self.keyframes[kidx]
            F = fwd.shape[1]
            rows = np.arange(F)[None, :]
            mutual = (fwd >= 0) & (
                np.take_along_axis(rev, np.clip(fwd, 0, F - 1), axis=1) == rows
            )
            counts = mutual.sum(axis=1)
            counts[n_old:] = 0
            # up to 2 distinct closure targets per keyframe: independent
            # edges to different map regions average their errors in the
            # pose-graph LM instead of riding one (possibly biased) fit
            cands = [
                (int(k), min_matches)
                for k in np.argsort(counts)[::-1][:2]
            ]
            # global place-recognition tier (bit-frequency signatures):
            # propose high-similarity places at a RELAXED mutual-count
            # threshold — geometric verification (Horn inliers) stays
            # strict, so this raises recall, not false positives
            if kf.gdesc is not None:
                sims = np.asarray(
                    [
                        float(kf.gdesc @ self.keyframes[i].gdesc)
                        if self.keyframes[i].gdesc is not None
                        else -1.0
                        for i in range(n_old)
                    ]
                )
                seen = {c[0] for c in cands}
                for i in np.argsort(sims)[::-1][:2]:
                    i = int(i)
                    if (
                        sims[i] > 0.5
                        and i not in seen
                        and counts[i] >= max(6, min_matches // 2)
                    ):
                        cands.append((i, max(6, min_matches // 2)))
            for k_best, thr in cands:
                if counts[k_best] < thr:
                    continue
                old = self.keyframes[k_best]
                # fixed-capacity correspondence table so the jitted
                # verification compiles once (padding rows start invalid)
                pa = np.zeros((F, 3), np.float32)
                pb = np.zeros((F, 3), np.float32)
                sel = np.where(mutual[k_best])[0]
                pa[: len(sel)] = kf.points_kf[sel]               # kf frame
                pb[: len(sel)] = old.points_kf[fwd[k_best, sel]]  # old frame
                cand_rows.append(
                    (kidx, k_best, pa, pb, np.arange(F) < len(sel))
                )
        if not cand_rows:
            return False
        # -- phase 2 (device, ONE dispatch): vmapped Horn + reprojection
        # refine over the padded candidate batch. T: p_old ≈ T(p_kf) =>
        # Z_{old,kf} = T_old⁻¹ T_kf. The refinement's pixel-space targets
        # are free of the monocular depth error that dominates the 3D-3D
        # fit. (A Schur-reduced two-view refine with FREE kf-side depths
        # was tried and measured WORSE — short-baseline closures leave
        # mono two-view geometry near-degenerate, so the fixed-structure
        # symmetric form is the regularized one.)
        Nc = 1
        while Nc < len(cand_rows):
            Nc *= 2
        F = cand_rows[0][2].shape[0]
        pa_b = np.zeros((Nc, F, 3), np.float32)
        pb_b = np.zeros((Nc, F, 3), np.float32)
        v_b = np.zeros((Nc, F), bool)
        for i, (_, _, pa, pb, v) in enumerate(cand_rows):
            pa_b[i], pb_b[i], v_b[i] = pa, pb, v
        rels, n_ins = jax.device_get(
            self._verify_candidates(
                jnp.asarray(pa_b), jnp.asarray(pb_b), jnp.asarray(v_b)
            )
        )
        # -- phase 3 (host): accept edges, innovation-gate the optimize --
        need_opt = False
        for (kidx, oldidx, _, _, _), rel, n_in in zip(
            cand_rows, rels, n_ins
        ):
            if int(n_in) < max(min_matches, 4):
                continue
            kf = self.keyframes[kidx]
            old = self.keyframes[oldidx]
            it, ir = self.cfg.backend.loop_edge_info
            self.graph = graph_mod.add_edge(
                self.graph, old.index, kf.index, jnp.asarray(rel),
                info=jnp.asarray([it, it, it, ir, ir, ir], jnp.float32),
            )
            self.loop_closures.append((old.index, kf.index))
            # Innovation gate (backend.loop_min_innovation): the edge is
            # kept either way, but the INLINE optimize+correct only pays
            # off when the measurement disagrees with the current graph —
            # i.e. there is drift to remove. ~Agreeing closures
            # (short-horizon revisits) are deferred to the final optimize.
            gate = self.cfg.backend.loop_min_innovation
            if gate > 0.0:
                pred = geometry.se3_between(
                    jnp.asarray(old.pose), jnp.asarray(kf.pose)
                )
                xi = np.asarray(
                    geometry.se3_log(
                        geometry.se3_between(jnp.asarray(rel), pred)
                    )
                )
                inno = float(
                    np.linalg.norm(xi[:3]) + 3.0 * np.linalg.norm(xi[3:])
                )
                if inno < gate:
                    continue
            need_opt = True
        return need_opt

    def _refine_rel_impl(self, rel0, pa, pb, valid):
        """Reprojection-refine a Horn closure edge: Gauss-Newton on the
        SE(3) tangent of rel (Z_{old,kf}: maps kf-frame points into the
        old keyframe's frame), minimizing SYMMETRIC pixel reprojection
        error — project(rel · p_kf) vs project(p_old) in the old camera
        and project(rel⁻¹ · p_old) vs project(p_kf) in the new one. The
        projection of a cloud's OWN points reproduces the original pixel
        measurements, so each direction's target is (nearly) depth-error
        free — unlike the 3D-3D Horn fit, whose residuals are dominated by
        monocular depth error along the rays (measured round-5: Horn edges
        at 0.23 m / 0.12 rad median vs 0.056 m odometry edges). Huber in
        pixels; falls back to the Horn estimate when the refined cost is
        not better."""
        cam = self.camera
        delta = 3.0  # px Huber

        def cost_res(rel):
            pao = jax.vmap(lambda q: geometry.se3_apply(rel, q))(pa)
            pbk = jax.vmap(
                lambda q: geometry.se3_apply_inverse(rel, q)
            )(pb)
            r1 = cam.project(pao) - cam.project(pb)
            r2 = cam.project(pbk) - cam.project(pa)
            r = jnp.concatenate([r1, r2], axis=0)           # [2F, Dz]
            vm = jnp.concatenate([valid, valid], axis=0)
            n = jnp.linalg.norm(r, axis=-1)
            w = jnp.where(
                vm, jnp.minimum(1.0, delta / jnp.maximum(n, 1e-6)), 0.0
            )
            c = jnp.sum(
                jnp.where(
                    n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta)
                ) * vm
            )
            return c, r, w

        def gn_step(rel, _):
            def res_of(xi):
                _, r, _ = cost_res(
                    geometry.se3_compose(rel, geometry.se3_exp(xi))
                )
                return r.reshape(-1)

            zero = jnp.zeros((6,), pa.dtype)
            _, r0, w = cost_res(rel)
            J = jax.jacfwd(res_of)(zero)                    # [2F*Dz, 6]
            Dz = r0.shape[-1]
            wf = jnp.repeat(w, Dz)
            A = J.T @ (wf[:, None] * J) + 1e-4 * jnp.eye(6, dtype=pa.dtype)
            b = J.T @ (wf * r0.reshape(-1))
            xi = -jnp.linalg.solve(A, b)
            xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
            cand = geometry.se3_compose(rel, geometry.se3_exp(xi))
            c_old, _, _ = cost_res(rel)
            c_new, _, _ = cost_res(cand)
            return jnp.where(
                jnp.isfinite(c_new) & (c_new < c_old), cand, rel
            ), None

        with jax.default_matmul_precision("highest"):
            rel, _ = jax.lax.scan(gn_step, rel0, None, length=8)
            c0, _, _ = cost_res(rel0)
            c1, _, _ = cost_res(rel)
        return jnp.where(jnp.isfinite(c1) & (c1 <= c0), rel, rel0)

    def _refine_rel_depth_impl(self, rel0, pa, pb, valid):
        """Depth-relaxed closure refinement (backend.loop_refine_depth_
        sigma > 0): like _refine_rel_impl but the kf-side point depths are
        FREE variables with a relative Gaussian prior (sigma = that
        fraction of the Horn depth). Fully free depths are near-degenerate
        at short-baseline closures (measured worse); fully fixed depths
        bias the pose by the cloud's monocular depth error (the residual
        ~0.14 m closure floor). The prior interpolates. Depths are 1x1
        Schur blocks, so each GN iteration is one batched 6x6 solve."""
        cam = self.camera
        delta = 3.0
        eps = 1e-6
        rs = float(self.cfg.backend.loop_refine_depth_sigma)
        d0 = jnp.linalg.norm(pa, axis=1)
        ray = pa / jnp.maximum(d0, eps)[:, None]
        uv_b = cam.project(pb)
        uv_a = cam.project(pa)
        vm = valid & (d0 > eps)
        wp = 1.0 / jnp.maximum((rs * d0) ** 2, eps)          # prior info

        def res12(rel, d):
            pao = jax.vmap(lambda q: geometry.se3_apply(rel, q))(
                d[:, None] * ray
            )
            pbk = jax.vmap(
                lambda q: geometry.se3_apply_inverse(rel, q)
            )(pb)
            r1 = cam.project(pao) - uv_b
            r2 = cam.project(pbk) - uv_a
            return r1, r2

        def hw(r):
            n = jnp.linalg.norm(r, axis=-1)
            w = jnp.where(
                vm, jnp.minimum(1.0, delta / jnp.maximum(n, eps)), 0.0
            )
            c = jnp.sum(
                jnp.where(
                    n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta)
                )
                * vm
            )
            return c, w

        def cost(rel, d):
            r1, r2 = res12(rel, d)
            c1, _ = hw(r1)
            c2, _ = hw(r2)
            return c1 + c2 + 0.5 * jnp.sum(
                jnp.where(vm, wp * (d - d0) ** 2, 0.0)
            )

        def gn(carry, _):
            rel, d = carry
            r1, r2 = res12(rel, d)
            _, w1 = hw(r1)
            _, w2 = hw(r2)
            zero = jnp.zeros((6,), pa.dtype)
            A1 = jax.jacfwd(
                lambda x: res12(
                    geometry.se3_compose(rel, geometry.se3_exp(x)), d
                )[0]
            )(zero)                                          # [F, Dz, 6]
            A2 = jax.jacfwd(
                lambda x: res12(
                    geometry.se3_compose(rel, geometry.se3_exp(x)), d
                )[1]
            )(zero)
            B1 = jax.jacfwd(lambda dd: res12(rel, dd)[0])(d)  # [F,Dz,F]
            B1 = jax.vmap(lambda m, i: m[:, i])(
                B1, jnp.arange(d.shape[0])
            )                                                # [F, Dz]
            wA1 = A1 * w1[:, None, None]
            wA2 = A2 * w2[:, None, None]
            Hxx = (
                jnp.einsum("fdi,fdj->ij", A1, wA1)
                + jnp.einsum("fdi,fdj->ij", A2, wA2)
            )
            Hdd = jnp.sum(B1 * B1 * w1[:, None], axis=1) + wp + 1e-8
            Hxd = jnp.einsum("fdi,fd->fi", wA1, B1)
            gx = (
                jnp.einsum("fdi,fd->i", wA1, r1)
                + jnp.einsum("fdi,fd->i", wA2, r2)
            )
            gd = jnp.sum(B1 * r1 * w1[:, None], axis=1) + wp * (d - d0)
            S = Hxx - jnp.einsum(
                "fi,fj->ij", Hxd / Hdd[:, None], Hxd
            ) + 1e-4 * jnp.eye(6, dtype=pa.dtype)
            rhs = gx - jnp.sum(Hxd * (gd / Hdd)[:, None], axis=0)
            dxi = -jnp.linalg.solve(S, rhs)
            dxi = jnp.where(jnp.isfinite(dxi), dxi, 0.0)
            dd = -(gd + Hxd @ dxi) / Hdd
            dd = jnp.where(jnp.isfinite(dd) & vm, dd, 0.0)
            cand_rel = geometry.se3_compose(rel, geometry.se3_exp(dxi))
            cand_d = jnp.clip(d + dd, 0.05, 1e4)
            good = jnp.isfinite(cost(cand_rel, cand_d)) & (
                cost(cand_rel, cand_d) < cost(rel, d)
            )
            rel = jnp.where(good, cand_rel, rel)
            d = jnp.where(good, cand_d, d)
            return (rel, d), None

        with jax.default_matmul_precision("highest"):
            (rel, d), _ = jax.lax.scan(gn, (rel0, d0), None, length=10)
            better = jnp.isfinite(cost(rel, d)) & (
                cost(rel, d) <= cost(rel0, d0)
            )
        return jnp.where(better, rel, rel0)

    def _horn_consensus_impl(self, pa, pb, valid):
        """Three rounds of Horn 3D-3D fit + inlier re-selection (RANSAC-lite
        consensus), fully on device — one dispatch + one fetch instead of
        the round-2 host loop's ~8 round-trips per closure candidate.
        Matches the host-loop semantics: rounds always run; a collapsed
        inlier set only shows up in the returned count (caller thresholds).
        Re-selection is ANDed with the original padding mask: zero-padded
        rows (pa=pb=0) have residual ~|t| of the fitted transform, which for
        small closures is inside the radius — without the mask hundreds of
        fake 0->0 correspondences join rounds 2-3 and collapse the edge."""
        radius = self.cfg.backend.loop_inlier_radius

        def round_(cur, _):
            rel = graph_mod.estimate_relative_pose_3d3d(pb, pa, cur)
            fit = jax.vmap(lambda p: geometry.se3_apply(rel, p))(pa)
            res = jnp.linalg.norm(fit - pb, axis=1)
            return (res < radius) & valid, rel

        valid1, _ = round_(valid, None)
        valid2, _ = round_(valid1, None)
        valid3, rel = round_(valid2, None)
        return rel, jnp.sum(valid3.astype(jnp.int32))

    def _optimize_graph(self):
        """Optimize the pose graph at its LIVE size: the dense normal
        system is [K*6, K*6], so solving at the preset capacity (1024
        nodes = a 6144-square Cholesky) on a 60-keyframe run wastes ~1000x
        the flops — at EVERY accepted closure. Power-of-two view capacities
        keep recompiles O(log K) over a run."""
        view, _, _ = graph_mod.shrink_to_active(self.graph)
        view, _ = pg_mod.optimize_pose_graph(
            view, iters=self.cfg.backend.gn_iters
        )
        kc = view.poses.shape[0]
        return self.graph.replace(
            poses=self.graph.poses.at[:kc].set(view.poses)
        )

    def _optimize_and_correct(self):
        """Optimize the pose graph and left-apply the resulting correction
        of the latest keyframe to the filter state. Returns the correction
        [7] (numpy) so a flush loop can compose it into pending frames
        captured before it (advisor r4 medium)."""
        self.graph = self._optimize_graph()
        k = len(self.keyframes) - 1
        opt_pose = self.graph.poses[k]
        est_pose = jnp.asarray(self.keyframes[k].pose)
        # left-correction mapping the filter estimate onto the optimized pose
        corr = geometry.se3_compose(opt_pose, geometry.se3_inverse(est_pose))
        self.state = self.state.replace(
            pose=jax.vmap(lambda p: geometry.se3_compose(corr, p))(self.state.pose),
            lm_mean=jax.vmap(
                jax.vmap(lambda m: geometry.se3_apply(corr, m), in_axes=0)
            )(self.state.lm_mean),
        )
        # The keyframe-motion reference lives in the filter-estimate frame;
        # the correction just shifted that frame, so shift the reference
        # with it (otherwise the next motion test compares a corrected
        # estimate against an uncorrected reference and trips spuriously).
        self._last_kf_dev = geometry.se3_compose(corr, self._last_kf_dev)
        poses_np, corr_np = jax.device_get(
            (self.graph.poses[: len(self.keyframes)], corr)
        )
        for i, kf in enumerate(self.keyframes):
            kf.pose = poses_np[i]
        # Estimates emitted AFTER this correction are relative to the newly
        # shifted filter frame: open a new anchor segment on the latest
        # keyframe starting at the next frame. Rows already emitted (up to
        # frame_idx, incl. the pre-flush lag window) keep the previous
        # segment (advisor r4 low: they were off by corr^-1 before).
        last = self.keyframes[-1]
        shifted = np.asarray(
            geometry.se3_compose(jnp.asarray(corr_np), jnp.asarray(last.anchor))
        )
        start = self.frame_idx + 1
        if last.anchors[-1][0] >= start:
            last.anchors[-1] = (last.anchors[-1][0], shifted)
        else:
            last.anchors.append((start, shifted))
        return corr_np

    # -- fused per-frame device step --------------------------------------
    #
    # The whole per-frame path (frontend -> observation -> filter step ->
    # estimate -> keyframe-motion test) is ONE jitted program; the host
    # syncs exactly once per frame, on the keyframe flag. The round-2
    # version dispatched each stage separately and synced ~7x per frame
    # (se3 motion test + 4 metric float()s + np.asarray(est)): the
    # round-trips, not the kernels, set the frame rate.

    def _kf_test(self, est, last_kf, has_kf):
        xi = geometry.se3_log(geometry.se3_between(last_kf, est))
        be = self.cfg.backend
        return (
            ~has_kf
            | (jnp.linalg.norm(xi[:3]) > be.keyframe_translation)
            | (jnp.linalg.norm(xi[3:]) > be.keyframe_rotation)
        )

    def _filter_step(self, state, odom_u, obs, key):
        """One filter step — through the shard_map'd sharded filter when a
        particle mesh is configured, else the single-device FastSLAM step."""
        if self._sharded is not None:
            return self._sharded.step(state, odom_u, obs, key)
        return self.slam.step(state, odom_u, obs, key)

    def _fused_tail(self, state, est, key_next, last_kf, has_kf, metrics):
        """Shared epilogue of every fused step: keyframe flag, device-side
        reference latch (a flagged frame's estimate becomes the reference
        for the NEXT frame's motion test), and the flagged frame's own map
        snapshot — so keyframe cadence AND content are independent of when
        the host drains the flag window."""
        flag = self._kf_test(est, last_kf, has_kf)
        new_ref = jnp.where(flag, est, last_kf)
        snap = self._kf_snapshot_impl(state, est)
        return state, est, key_next, flag, new_ref, snap, metrics

    def _fused_frame_impl(self, state, img, odom_u, key, last_kf, has_kf):
        k_step, key_next = jax.random.split(key)
        xy, desc, valid = self._frontend(img)
        obs = self._to_observation(xy, desc, valid)
        state, metrics = self._filter_step(state, odom_u, obs, k_step)
        est = self.slam.estimate_pose(state)
        return self._fused_tail(state, est, key_next, last_kf, has_kf, metrics)

    def _fused_stereo_impl(self, state, img_l, img_r, odom_u, key, last_kf, has_kf):
        from parakeet_slam_tpu.frontend.stereo import keypoint_disparity

        k_step, key_next = jax.random.split(key)
        xy, desc, valid = self._frontend(img_l)
        Z = self.cfg.filter.max_observations
        xy, desc, valid = xy[:Z], desc[:Z], valid[:Z]
        disp, dvalid = keypoint_disparity(img_l, img_r, xy, valid)
        uvd = jnp.concatenate([xy, disp[:, None]], axis=1)
        obs = self._to_observation(uvd, desc, valid & dvalid)
        state, metrics = self._filter_step(state, odom_u, obs, k_step)
        est = self.slam.estimate_pose(state)
        return self._fused_tail(state, est, key_next, last_kf, has_kf, metrics)

    def _fused_obs_impl(self, state, obs, odom_u, key, last_kf, has_kf):
        k_step, key_next = jax.random.split(key)
        state, metrics = self._filter_step(state, odom_u, obs, k_step)
        est = self.slam.estimate_pose(state)
        return self._fused_tail(state, est, key_next, last_kf, has_kf, metrics)

    # -- main entry -------------------------------------------------------

    def process_frame(self, img, odom_u):
        """One camera frame + odometry increment. Returns the pose estimate
        [7] as a DEVICE array (convert with np.asarray when needed; batch
        conversions at the end of a run to keep the frame loop async)."""
        self.state, est, self.key, kf_flag, self._last_kf_dev, snap, metrics = (
            self._fused_frame(
                self.state, jnp.asarray(img), jnp.asarray(odom_u, jnp.float32),
                self.key, self._last_kf_dev, jnp.bool_(self._has_kf),
            )
        )
        return self._post_step(est, kf_flag, snap, metrics)

    def process_obs(self, obs, odom_u):
        """Bypass the image frontend with a ready Observation (simulation,
        or an external detector)."""
        self.state, est, self.key, kf_flag, self._last_kf_dev, snap, metrics = (
            self._fused_obs(
                self.state, obs, jnp.asarray(odom_u, jnp.float32),
                self.key, self._last_kf_dev, jnp.bool_(self._has_kf),
            )
        )
        return self._post_step(est, kf_flag, snap, metrics)

    def process_stereo_frame(self, img_left, img_right, odom_u):
        """Stereo pair (KITTI config 3): detect/describe on the left image,
        SAD disparity against the right, feed [u, v, d] observations to the
        stereo_3d measurement model."""
        if self.cfg.filter.obs_dim != 3:
            raise ValueError("stereo frames need obs_dim=3 (stereo_3d model)")
        self.state, est, self.key, kf_flag, self._last_kf_dev, snap, metrics = (
            self._fused_stereo(
                self.state, jnp.asarray(img_left), jnp.asarray(img_right),
                jnp.asarray(odom_u, jnp.float32),
                self.key, self._last_kf_dev, jnp.bool_(self._has_kf),
            )
        )
        return self._post_step(est, kf_flag, snap, metrics)

    def _post_step(self, est, kf_flag, snap, metrics):
        self.frame_idx += 1
        self._metrics_pending.append(
            (
                self.frame_idx,
                (metrics.ess, metrics.num_landmarks,
                 metrics.match_frac, metrics.resampled),
                len(self.keyframes),
            )
        )
        if len(self._metrics_pending) >= 256:
            self.flush_metrics()
        self._flag_pending.append((self.frame_idx, est, kf_flag, snap))
        # Absolute-phase flushes (frame_idx % lag == 0, plus every frame
        # until the first keyframe exists): flush timing is a function of
        # the frame index alone, so keyframe materialization — and the
        # pose-graph corrections it can trigger — happens at the same frame
        # in an uninterrupted run and a checkpoint/resume run.
        if not self._has_kf or self.frame_idx % self.kf_flag_lag == 0:
            self.flush_flags()
        return est

    def flush_flags(self):
        """Fetch the pending keyframe flags (ONE device round-trip) and
        materialize a keyframe for EVERY flagged frame, from that frame's
        own in-step snapshot. Each flagged frame was tested against the
        device-latched reference (its predecessor flagged frame), so the
        flag set is exact — nothing here depends on flush timing."""
        pend, self._flag_pending = self._flag_pending, []
        flags = jax.device_get([f for _, _, f, _ in pend]) if pend else []
        # Resolve closure matches dispatched in the PREVIOUS window first
        # (pipelined: the match ran on device while frames kept flowing).
        # A resulting correction shifts the filter-estimate frame BEFORE
        # this window's keyframes are materialized, so it must compose
        # into their pending estimates below (advisor r4 medium: pending
        # tuples were captured pre-correction and ended up off by the
        # full correction). The snapshots need no fix-up — points_kf are
        # keyframe-relative and a left-correction of both pose and map
        # cancels there. The odometry edge is then consistent:
        # prev.pose after a correction equals corr . prev_creation_pose
        # for the latest keyframe, so se3_between(prev.pose, corr . est)
        # == se3_between of the raw emission estimates.
        pend_corr = None
        if self._resolve_closures():
            pend_corr = self._optimize_and_correct()
        if not any(flags):
            return
        for (fi, est, _, snap), f in zip(pend, flags):
            if not f:
                continue
            est_raw = est
            if pend_corr is not None:
                est = geometry.se3_compose(jnp.asarray(pend_corr), jnp.asarray(est))
            kf = self._make_keyframe(est, snap, frame=fi, anchor_pose=est_raw)
            if pend_corr is not None:
                # rows already emitted (<= frame_idx) are relative to the
                # RAW estimate; rows after the flush live in the corrected
                # frame -> second anchor segment
                kf.anchors.append(
                    (self.frame_idx + 1, np.asarray(jax.device_get(est), np.float32))
                )
            self.last_kf_pose = kf.pose
            self._has_kf = True
            self._dispatch_loop_closure(kf)
        ce = self.cfg.checkpoint_every
        if ce > 0 and self.cfg.checkpoint_dir and len(self.keyframes) % ce == 0:
            self.save_checkpoint(
                f"{self.cfg.checkpoint_dir}/ckpt_{self.frame_idx:08d}"
            )

    def flush_metrics(self):
        """Drain the device-side metrics buffer into the JSONL logger (one
        batched transfer). Called automatically every 256 frames and from
        save_checkpoint; call once at the end of a run."""
        pend, self._metrics_pending = self._metrics_pending, []
        if not pend:
            return
        fetched = jax.device_get([p[1] for p in pend])
        for (fi, _, nkf), (ess, lms, mf, rs) in zip(pend, fetched):
            self.metrics.log(
                fi,
                ess=float(ess),
                landmarks=float(lms),
                match_frac=float(mf),
                resampled=bool(rs),
                keyframes=nkf,
            )

    # -- checkpoint / resume (SURVEY.md §6) --------------------------------

    def save_checkpoint(self, path_prefix: str):
        """Snapshot filter state + pose graph (+ host-side keyframe store,
        RNG key, cursors, the device keyframe reference, and the un-flushed
        flag window) so a killed run resumes bit-identically. The pending
        window is PERSISTED, not flushed: flushing here would materialize
        keyframes at the checkpoint frame instead of the next absolute
        window boundary, diverging from an uninterrupted run."""
        from parakeet_slam_tpu.utils import checkpoint as ckpt

        self.flush_metrics()
        ckpt.save_checkpoint(
            path_prefix + ".state.npz",
            {"state": self.state, "graph": self.graph, "key": self.key},
            step=self.frame_idx,
        )
        kfs = self.keyframes
        pend = jax.device_get(self._flag_pending)
        # pending (dispatched, unresolved) closure matches: fetched to host
        # and persisted so a resumed run resolves them at the same flush
        # an uninterrupted run would have (pad K-axis to the largest store
        # capacity among entries; fwd=-1 pad rows can never match)
        cp = jax.device_get(self._closure_pending)
        if cp:
            Kmax = max(f.shape[0] for _, _, f, _ in cp)
            def _padk(a):
                return np.pad(a, ((0, Kmax - a.shape[0]), (0, 0)),
                              constant_values=-1)
            cp_kidx = np.asarray([c[0] for c in cp], np.int32)
            cp_nold = np.asarray([c[1] for c in cp], np.int32)
            cp_fwd = np.stack([_padk(np.asarray(c[2])) for c in cp])
            cp_rev = np.stack([_padk(np.asarray(c[3])) for c in cp])
        else:
            cp_kidx = np.zeros((0,), np.int32)
            cp_nold = np.zeros((0,), np.int32)
            cp_fwd = np.zeros((0, 0, 0), np.int32)
            cp_rev = np.zeros((0, 0, 0), np.int32)
        F = self.cfg.frontend.max_features
        W = self.cfg.filter.desc_words
        np.savez(
            path_prefix + ".kf.npz",
            n=np.int32(len(kfs)),
            frame_idx=np.int32(self.frame_idx),
            last_kf_pose=(
                self.last_kf_pose
                if self.last_kf_pose is not None
                else np.full((7,), np.nan, np.float32)
            ),
            kf_ref=np.asarray(jax.device_get(self._last_kf_dev), np.float32),
            has_kf=np.bool_(self._has_kf),
            loop_closures=np.asarray(self.loop_closures, np.int32).reshape(-1, 2),
            pose=np.stack([k.pose for k in kfs]) if kfs else np.zeros((0, 7), np.float32),
            points=np.stack([k.points_kf for k in kfs]) if kfs else np.zeros((0, 0, 3), np.float32),
            desc=np.stack([k.desc for k in kfs]) if kfs else np.zeros((0, 0, 1), np.uint32),
            valid=np.stack([k.valid for k in kfs]) if kfs else np.zeros((0, 0), bool),
            kf_frame=np.asarray([k.frame for k in kfs], np.int32),
            anchor_kf=np.asarray(
                [k.index for k in kfs for _ in k.anchors], np.int32
            ),
            anchor_start=np.asarray(
                [s for k in kfs for s, _ in k.anchors], np.int64
            ),
            anchor_val=(
                np.stack([a for k in kfs for _, a in k.anchors])
                if kfs else np.zeros((0, 7), np.float32)
            ),
            p_frame=np.asarray([p[0] for p in pend], np.int32),
            p_est=np.stack([p[1] for p in pend]) if pend else np.zeros((0, 7), np.float32),
            p_flag=np.asarray([p[2] for p in pend], bool),
            p_pts=np.stack([p[3][0] for p in pend]) if pend else np.zeros((0, F, 3), np.float32),
            p_desc=np.stack([p[3][1] for p in pend]) if pend else np.zeros((0, F, max(W, 1)), np.uint32),
            p_valid=np.stack([p[3][2] for p in pend]) if pend else np.zeros((0, F), bool),
            cp_kidx=cp_kidx, cp_nold=cp_nold, cp_fwd=cp_fwd, cp_rev=cp_rev,
        )

    def load_checkpoint(self, path_prefix: str):
        """Restore a `save_checkpoint` snapshot into this system."""
        from parakeet_slam_tpu.utils import checkpoint as ckpt

        tree, step = ckpt.load_checkpoint(
            path_prefix + ".state.npz",
            {"state": self.state, "graph": self.graph, "key": self.key},
        )
        self.state, self.graph, self.key = tree["state"], tree["graph"], tree["key"]
        data = np.load(path_prefix + ".kf.npz")
        self.frame_idx = int(data["frame_idx"])
        lkp = data["last_kf_pose"]
        self.last_kf_pose = None if np.isnan(lkp).any() else lkp
        # pre-restore pending work would leak this system's frames into the
        # restored run (advisor r3); the restored window replaces both.
        self._metrics_pending = []
        if "has_kf" in data:
            self._has_kf = bool(data["has_kf"])
            self._last_kf_dev = jnp.asarray(data["kf_ref"])
        else:  # legacy snapshot (round-3 format)
            self._has_kf = self.last_kf_pose is not None
            self._last_kf_dev = jnp.asarray(
                self.last_kf_pose
                if self._has_kf
                else np.eye(1, 7, 6, dtype=np.float32)[0]
            )
        if "p_est" in data and len(data["p_est"]):
            self._flag_pending = [
                (
                    int(data["p_frame"][i]),
                    jnp.asarray(data["p_est"][i]),
                    jnp.asarray(data["p_flag"][i]),
                    (
                        jnp.asarray(data["p_pts"][i]),
                        jnp.asarray(data["p_desc"][i]),
                        jnp.asarray(data["p_valid"][i]),
                    ),
                )
                for i in range(len(data["p_est"]))
            ]
        else:
            self._flag_pending = []
        self.loop_closures = [tuple(r) for r in data["loop_closures"]]
        self._closure_pending = (
            [
                (
                    int(data["cp_kidx"][i]), int(data["cp_nold"][i]),
                    data["cp_fwd"][i], data["cp_rev"][i],
                )
                for i in range(len(data["cp_kidx"]))
            ]
            if "cp_kidx" in data
            else []
        )
        kf_frame = (
            data["kf_frame"]
            if "kf_frame" in data
            else np.arange(int(data["n"]), dtype=np.int32)
        )
        n_kf = int(data["n"])
        if "anchor_kf" in data:
            seg_lists: list[list] = [[] for _ in range(n_kf)]
            for ki, st, av in zip(
                data["anchor_kf"], data["anchor_start"], data["anchor_val"]
            ):
                seg_lists[int(ki)].append((int(st), av.copy()))
        else:  # legacy snapshot (single mutable anchor per keyframe)
            legacy = data["anchor"] if "anchor" in data else data["pose"]
            seg_lists = [
                [(int(kf_frame[i]), legacy[i].copy())] for i in range(n_kf)
            ]
        self.keyframes = [
            Keyframe(
                index=i, pose=data["pose"][i], points_kf=data["points"][i],
                desc=data["desc"][i], valid=data["valid"][i],
                frame=int(kf_frame[i]), anchors=seg_lists[i],
                gdesc=_global_descriptor(data["desc"][i], data["valid"][i]),
            )
            for i in range(n_kf)
        ]
        self._rebuild_kf_store()

    # -- offline refinement ----------------------------------------------

    def corrected_trajectory(self, est, final_optimize: bool = True):
        """Map the ONLINE per-frame estimates onto the optimized keyframe
        graph (the standard SLAM evaluation trajectory): loop-closure
        corrections applied during the run only fix frames emitted AFTER
        them, so the raw online trajectory keeps all pre-closure drift.
        Here each frame t in keyframe i's segment is re-emitted as

            est'_t = pose_i . anchor_i^-1 . est_t

        where pose_i is keyframe i's optimized pose and anchor_i the
        emission-frame pose the segment's estimates are relative to.
        est: [T, 7] array of per-frame estimates (frame t = row t-1).
        """
        est = np.asarray(est)
        if not self.keyframes:
            return est
        self.flush_flags()
        # drain closure matches dispatched by the final window
        if self._resolve_closures() and not final_optimize:
            self._optimize_and_correct()
        if final_optimize and self.loop_closures:
            self.graph = self._optimize_graph()
            poses_np = jax.device_get(self.graph.poses[: len(self.keyframes)])
            for i, kf in enumerate(self.keyframes):
                kf.pose = poses_np[i]
        kf_frames = np.asarray([kf.frame for kf in self.keyframes])
        poses = jnp.asarray(np.stack([kf.pose for kf in self.keyframes]))
        # Flatten the per-keyframe anchor SEGMENTS: row t in keyframe k's
        # segment uses k's latest anchor whose start_frame <= t (estimates
        # emitted before a mid-run correction are relative to the
        # pre-correction emission pose; later ones to the shifted pose).
        a_kf = []
        a_start = []
        a_val = []
        for kf in self.keyframes:
            for s, a in kf.anchors:
                a_kf.append(kf.index)
                a_start.append(s)
                a_val.append(a)
        a_kf = np.asarray(a_kf, np.int64)
        a_start = np.asarray(a_start, np.int64)
        corr = jax.vmap(
            lambda k, a: geometry.se3_compose(
                poses[k], geometry.se3_inverse(a)
            )
        )(jnp.asarray(a_kf), jnp.asarray(np.stack(a_val)))
        # frame index of row t is t+1; rows before the first keyframe keep
        # their online estimate
        frames = np.arange(1, len(est) + 1, dtype=np.int64)
        seg = np.searchsorted(kf_frames, frames, "right") - 1
        keys = a_kf * (np.int64(1) << 32) + a_start
        rowkey = seg.astype(np.int64) * (np.int64(1) << 32) + frames
        j = np.searchsorted(keys, rowkey, "right") - 1
        out = jax.vmap(
            lambda c, e: geometry.se3_compose(c, e)
        )(corr[np.clip(j, 0, None)], jnp.asarray(est))
        return np.where((seg >= 0)[:, None], np.asarray(out), est)

    def build_ba_problem(
        self, dedup_max_hamming: int = 40
    ) -> graph_mod.BAProblem | None:
        """Assemble a BA problem from the keyframe stores: cameras =
        keyframe poses; points = union of keyframe landmark snapshots
        deduplicated by descriptor matching (first-seen world position is
        the point); observations = projections of the stored point.

        Vectorized: the dedup is a `lax.scan` of fused matcher kernels
        over keyframes (`_assign_point_ids`) and the projections are one
        batched device op — the round-1 version did a pure-Python
        per-observation loop with an O(N) numpy Hamming scan per row."""
        self.flush_flags()
        if len(self.keyframes) < 2:
            return None
        K = len(self.keyframes)
        poses = np.stack([kf.pose for kf in self.keyframes]).astype(np.float32)
        pts_kf = np.stack([kf.points_kf for kf in self.keyframes])
        desc = np.stack([kf.desc for kf in self.keyframes])
        valid = np.stack([kf.valid for kf in self.keyframes])
        F = desc.shape[1]
        cap = int(min(K * F, self.cfg.backend.max_landmarks))
        poses_d = jnp.asarray(poses)
        world = jax.vmap(
            lambda T, ps: jax.vmap(lambda p: geometry.se3_apply(T, p))(ps)
        )(poses_d, jnp.asarray(pts_kf))
        (sd, sv, sp, n_pts, n_drop), pid = _assign_point_ids(
            jnp.asarray(desc), jnp.asarray(valid), world,
            cap=cap, max_ham=dedup_max_hamming,
        )
        if int(n_drop):
            # recorded in the metrics stream (not just stderr) so capacity
            # exhaustion is visible in run artifacts (advisor r2 item 1)
            self.metrics.log(
                self.frame_idx, ba_points_dropped=int(n_drop),
                ba_point_capacity=cap,
            )
            print(
                f"build_ba_problem: point capacity {cap} "
                f"(backend.max_landmarks) exhausted; dropped {int(n_drop)} "
                "new points (their observations are excluded)",
                file=_sys.stderr,
            )
        pid_c = jnp.clip(pid, 0, cap - 1)
        # Observations are each keyframe's OWN measured landmark position
        # (kf.points_kf, the snapshot-time local coordinates) projected
        # through the camera — NOT the deduped store position projected
        # into every camera, which would make the problem exactly
        # self-consistent at its initial values (cost 0, BA a no-op — the
        # round-4 EuRoC joint BA was such a tautology). Independent per-
        # keyframe measurements of the same point are what BA reconciles.
        uv = self.camera.project(jnp.asarray(pts_kf))       # [K, F, Dz]
        # Observation gating: checkpoints restored from older runs (and any
        # residual diverged lane) can carry insane local points whose
        # projections overflow f32 in the Huber cost — gate them out like
        # any BA outlier.
        fe = self.cfg.frontend
        uv_bound = 10.0 * float(max(fe.image_size))
        uv_ok = jnp.all(jnp.isfinite(uv) & (jnp.abs(uv) < uv_bound), axis=-1)
        pt_ok = jnp.all(jnp.isfinite(sp) & (jnp.abs(sp) < 1e6), axis=-1)
        cam_fixed = jnp.zeros((K,), bool).at[0].set(True)
        if K > 1 and not self.cfg.backend.ba_fuse_pose_graph:
            # pin monocular scale gauge; with fused pose-graph edges the
            # odometry chain carries metric scale, so only cam 0 is pinned
            cam_fixed = cam_fixed.at[1].set(True)
        return graph_mod.make_ba_problem(
            poses_d, sp,
            jnp.repeat(jnp.arange(K, dtype=jnp.int32), F),
            pid_c.reshape(-1),
            uv.reshape(K * F, -1),
            pt_valid=sv & pt_ok,
            obs_valid=((pid >= 0) & uv_ok & pt_ok[pid_c]).reshape(-1),
            cam_fixed=cam_fixed,
        )

    def graph_pose_edges(self, weight: float = 1.0):
        """The pose graph's live edges as BA fusion terms
        (edge_ij, edge_rel, edge_info * weight, edge_valid) — None when
        empty."""
        ne = int(jax.device_get(self.graph.n_edges))
        if ne == 0:
            return None
        g = self.graph
        return (
            g.edge_ij[:ne], g.edge_rel[:ne], g.edge_info[:ne] * weight,
            g.edge_valid[:ne],
        )

    def run_ba(self, iters: int | None = None, distributed: bool | None = None):
        """Refine keyframe poses + deduped points by bundle adjustment.

        distributed=None (default) auto-selects: when dist.map_axis > 1 the
        point blocks shard over the `dcn` axis and the reduced camera
        system is psum-assembled (dist/dist_ba.py — SURVEY §2b map-block
        parallelism); otherwise the single-device bucketed solver runs."""
        prob = self.build_ba_problem()
        if prob is None:
            return None
        be = self.cfg.backend
        if be.ba_outlier_px > 0:
            prob = graph_mod.gate_outlier_obs(self.camera, prob, be.ba_outlier_px)
        if be.ba_max_obs_per_point > 0:
            prob = graph_mod.cap_obs_per_point(prob, be.ba_max_obs_per_point)
        d = self.cfg.dist
        if distributed is None:
            distributed = d.map_axis > 1
        if distributed:
            from parakeet_slam_tpu.dist import dist_ba
            from parakeet_slam_tpu.dist.mesh import MAP_AXIS, make_mesh

            mesh = self.mesh
            if mesh is None or mesh.shape[MAP_AXIS] != d.map_axis:
                mesh = make_mesh(n_devices=d.map_axis, map_axis=d.map_axis)
            sp = dist_ba.shard_problem(prob, d.map_axis)
            res_prob, costs = dist_ba.optimize_ba_distributed(
                self.camera, sp, mesh,
                iters=iters or be.gn_iters,
                lam=be.lm_damping_init,
                pcg_iters=be.pcg_iters,
                huber_delta=be.huber_delta,
            )
            res = ba_mod.BAResult(
                problem=res_prob, costs=costs,
                pcg_residuals=jnp.zeros_like(costs),
            )
        else:
            res = ba_mod.optimize_ba(
                self.camera, prob,
                iters=iters or be.gn_iters,
                lam=be.lm_damping_init,
                pcg_iters=be.pcg_iters,
                huber_delta=be.huber_delta,
                solver=be.solver if be.solver in ("pcg", "dense") else "pcg",
                step_clamp=(be.ba_step_clamp_cam, be.ba_step_clamp_pt),
                pose_edges=(
                    self.graph_pose_edges(be.ba_pose_edge_weight)
                    if be.ba_fuse_pose_graph
                    else None
                ),
            )
        for i, kf in enumerate(self.keyframes):
            kf.pose = np.asarray(res.problem.cam_pose[i])
        return res

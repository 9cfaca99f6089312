"""Dense-batched FastSLAM engine (Rao-Blackwellized particle filter).

Implements SURVEY.md §3 exactly — sampled motion update, per-particle
maximum-likelihood data association, per-landmark EKF updates, importance
weighting, adaptive systematic resampling, and counter-based map management
— but batched: where the reference iterates Python dicts per particle
(SURVEY.md §4.1 entry 2, the O(particles x landmarks) interpreted hot
loop), every step here is one batched XLA program over dense
[P, Lmax] arrays with validity masks. Map growth/culling are masked
writes; capacities are static so one jit covers the whole run.

Association scores the whole frame against the PRE-FRAME map (one best
landmark per particle and observation); the EKF updates and allocations
then compose sequentially over the observations with a `lax.scan`, fully
parallel over particles and landmarks inside each step.

On the GPU the association sweep of the 3-D camera models runs as a
Pallas kernel (`kernels/score_3d`); the plain-JAX scan below is its
reference and the implementation everywhere else.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import linalg
from parakeet_slam_tpu.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu.core.geometry import wrap_angle
from parakeet_slam_tpu.core.state import Observation, ParticleState, make_particle_state
from parakeet_slam_tpu.filter import models as model_zoo
from parakeet_slam_tpu.kernels import resample as resample_kernel
from parakeet_slam_tpu.kernels import score_3d

_NEG_INF = -1e30


class StepMetrics(NamedTuple):
    """Per-frame observability metrics (SURVEY.md §6 'metrics/logging')."""

    ess: jax.Array            # effective sample size
    num_landmarks: jax.Array  # mean live landmarks per particle
    match_frac: jax.Array     # fraction of valid observations associated
    resampled: jax.Array      # bool


class FastSLAM:
    """Config-specialized FastSLAM filter; all public methods are jittable."""

    def __init__(self, cfg: FilterConfig, fe_cfg: FrontendConfig | None = None):
        self.cfg = cfg
        self.fe_cfg = fe_cfg
        self.model = model_zoo.get_measurement_model(cfg, fe_cfg)
        self.motion = model_zoo.get_motion_model(cfg.motion_model)
        self.score_kernel = score_3d.applies(
            self.model.name, cfg.sig_dim, jax.default_backend()
        )
        if cfg.obs_dim != self.model.obs_dim or cfg.lm_dim != self.model.lm_dim:
            raise ValueError(
                f"config dims ({cfg.obs_dim},{cfg.lm_dim}) do not match model "
                f"{self.model.name} ({self.model.obs_dim},{self.model.lm_dim})"
            )

    # -- state ------------------------------------------------------------

    def init_state(self, init_pose=None) -> ParticleState:
        c = self.cfg
        return make_particle_state(
            c.num_particles, c.max_landmarks, c.lm_dim, c.sig_dim,
            c.desc_words, c.pose_dim, init_pose,
        )

    # -- motion update (SURVEY.md §3) -------------------------------------

    def motion_update(self, state: ParticleState, u, key) -> ParticleState:
        noise = self.cfg.motion_noise
        pose = self.motion(key, state.pose, jnp.asarray(u), noise)
        return state.replace(pose=pose)

    # -- measurement update ------------------------------------------------

    def _meas_var(self, assoc: bool = False):
        """Measurement noise variances (diagonal of R). `assoc=True`
        returns the ASSOCIATION/scoring variances: meas_noise with
        config.assoc_gate_px added in quadrature — drift-tolerant gates for
        matching/weighting while the EKF update keeps the true noise."""
        c = self.cfg
        v = tuple(float(x) ** 2 for x in c.meas_noise[: c.obs_dim])
        if assoc and c.assoc_gate_px > 0.0:
            v = tuple(x + float(c.assoc_gate_px) ** 2 for x in v)
        return v

    def _log_p0_assoc(self) -> float:
        """New-landmark threshold in the ASSOCIATION scoring's units.
        Inflating R (assoc_gate_px) lowers every score's normalization
        constant by 0.5*sum(log(v_assoc/v_true)) — at a 40 px gate that
        alone is ~ -7.4, i.e. below new_landmark_loglik=-8 at zero
        residual, silently disabling vision. Shift the threshold by the
        same delta so the chi^2 margin it encodes is gate-invariant."""
        import math

        c = self.cfg
        p0 = float(c.new_landmark_loglik)
        if c.assoc_gate_px <= 0.0:
            return p0
        vt = self._meas_var(False)
        va = self._meas_var(True)
        return p0 - 0.5 * sum(math.log(a / t) for a, t in zip(va, vt))

    def _per_pair_stats(self, pose, lm_mean, lm_cov, z, assoc: bool = False):
        """Likelihood ingredients for one (particle pose, landmark, z):
        returns (nu, Q, H, loglik_geometric)."""
        R = jnp.diag(jnp.asarray(self._meas_var(assoc), pose.dtype))
        zhat = self.model.h(pose, lm_mean)
        H = self.model.jac(pose, lm_mean)
        nu = self.model.residual(z, zhat)
        Q = H @ lm_cov @ H.T + R
        ll = linalg.gaussian_loglik(Q, nu)
        return nu, Q, H, ll

    def _appearance_loglik(self, obs_sig, obs_desc, lm_sig, lm_desc, dtype):
        """Signature (float) + descriptor (Hamming) likelihood terms,
        broadcast over [P, L]."""
        c = self.cfg
        ll = jnp.zeros(lm_sig.shape[:2], dtype)
        if c.sig_dim > 0:
            var = jnp.asarray(c.sig_noise, dtype) ** 2
            d2 = jnp.sum((lm_sig - obs_sig[None, None, :]) ** 2, axis=-1)
            ll = ll - 0.5 * d2 / var
        if c.desc_words > 0:
            x = jnp.bitwise_xor(lm_desc, obs_desc[None, None, :])
            ham = jnp.sum(
                jax.lax.population_count(x).astype(jnp.int32), axis=-1
            ).astype(dtype)
            ll = ll - c.desc_weight * ham
        return ll

    def _score_observation(self, state: ParticleState, z, sig, desc):
        """Likelihood of one observation against every (particle, landmark)
        pair of the PRE-FRAME map. Returns (best_idx [P], best_ll [P])."""
        dtype = state.pose.dtype
        pair_fn = jax.vmap(  # over landmarks
            lambda pose, m, cov: self._per_pair_stats(pose, m, cov, z, assoc=True)[3],
            in_axes=(None, 0, 0),
        )
        pair_fn = jax.vmap(pair_fn, in_axes=(0, 0, 0))  # over particles
        ll = pair_fn(state.pose, state.lm_mean, state.lm_cov)
        ll = ll + self._appearance_loglik(sig, desc, state.lm_sig, state.lm_desc, dtype)
        # Non-finite likelihoods (fp32 overflow in Q for degenerate geometry)
        # must lose the association argmax, not win it via NaN comparisons.
        ll = jnp.where(state.lm_valid & jnp.isfinite(ll), ll, _NEG_INF)
        best = jnp.argmax(ll, axis=-1)
        best_ll = jnp.take_along_axis(ll, best[:, None], axis=1)[:, 0]
        return best, best_ll

    def _score_frame(self, state: ParticleState, obs: Observation):
        """Score every observation against the PRE-FRAME map: returns
        (best [P, Z] lane, best_ll [P, Z])."""

        def sc(_, row):
            z, sig, desc = row
            return None, self._score_observation(state, z, sig, desc)

        _, (best, best_ll) = jax.lax.scan(sc, None, (obs.z, obs.sig, obs.desc))
        return best.T, best_ll.T

    @property
    def _vision_3d(self) -> bool:
        """3-D camera model without an appearance signature: the filters
        whose association the score kernel covers, and whose FastSLAM 2.0
        proposal scores the frame once (`fs2_association: auto`)."""
        return self.cfg.sig_dim == 0 and self.model.name in score_3d.VISION_MODELS

    def _frame_scores(self, state: ParticleState, obs: Observation):
        """Association of the WHOLE frame against the pre-frame map at the
        state's poses: the score kernel where it applies (GPU), the XLA
        scoring scan otherwise. Returns (best [P, Z], best_ll [P, Z])."""
        if self.score_kernel:
            return score_3d.score_3d(
                state.pose, state.lm_mean, state.lm_cov, state.lm_desc,
                state.lm_valid, obs.z, obs.desc,
                model=self.model.name,
                par=self._vision_kernel_params(),
                r_var=self._meas_var(assoc=True),
                desc_weight=float(self.cfg.desc_weight),
            )
        # float32 contractions may otherwise run as TF32 on the GPU
        with jax.default_matmul_precision("highest"):
            return self._score_frame(state, obs)

    def _weight_delta(self, state: ParticleState, obs: Observation, scores):
        """Per-particle frame log-weight increment from association scores
        (best lane [P, Z], best loglik [P, Z]), applying the weight-shaping
        config (weight_min_count / weight_only_matched — see
        core/config.py)."""
        c = self.cfg
        best, best_ll = scores
        L = state.lm_valid.shape[1]
        is_new = best_ll < self._log_p0_assoc()
        new_w = 0.0 if c.weight_only_matched else c.new_landmark_loglik
        dw = jnp.where(is_new, new_w, best_ll)
        if c.weight_min_count > 0:
            cnt = jnp.take_along_axis(
                state.lm_count, jnp.clip(best, 0, L - 1), axis=1
            )
            dw = jnp.where(is_new | (cnt >= c.weight_min_count), dw, 0.0)
        return jnp.sum(jnp.where(obs.valid[None, :], dw, 0.0), axis=1)

    def _associate_frame(self, state: ParticleState, obs: Observation, scores):
        """Batched pre-frame association for the whole frame from its
        scores (best, best_ll): every observation scored against the
        PRE-FRAME map; new landmarks take ascending free slots in
        observation order.

        Returns (target [P, Z] int32 lane or -1, is_new [P, Z],
                 do_upd [P, Z], do_alloc [P, Z], best_ll [P, Z]).
        """
        c = self.cfg
        P, L = state.lm_valid.shape
        Z = obs.capacity

        best, best_ll = scores
        valid = obs.valid[None, :]                           # [1, Z]
        any_cand = jnp.any(state.lm_valid, axis=-1)[:, None]
        is_new = (best_ll < self._log_p0_assoc()) | ~any_cand
        do_new = is_new & valid

        # Free slots in ascending lane order (holes from culling, then the
        # virgin tail); at most n_fs allocations per frame.
        n_fs = min(Z, 64)
        lanes = jnp.arange(L, dtype=jnp.int32)[None, :]
        free_sorted = jnp.sort(
            jnp.where(state.lm_valid, jnp.int32(2**30), lanes), axis=1
        )[:, :n_fs]                                          # [P, n_fs]
        arank = jnp.cumsum(do_new.astype(jnp.int32), axis=1) - do_new
        slot = jnp.take_along_axis(
            free_sorted, jnp.clip(arank, 0, n_fs - 1), axis=1
        )
        has_free = (slot < L) & (arank < n_fs)
        do_alloc = do_new & has_free
        do_upd = ~is_new & valid
        target = jnp.where(
            do_upd, best, jnp.where(do_alloc, slot, jnp.int32(-1))
        )
        return target, is_new, do_upd, do_alloc, best_ll

    def _apply_observation(self, state: ParticleState, matched, obs_row):
        """Apply one observation's EKF update / allocation at its
        pre-assigned target lane (sequential composition step of the v2
        semantics). obs_row = (z, sig, desc, target [P], is_new [P])."""
        c = self.cfg
        z, sig, desc, target, is_new = obs_row
        P, L = state.lm_valid.shape
        dtype = state.pose.dtype
        active = target >= 0
        do_update = active & ~is_new
        do_alloc = active & is_new
        tgt = jnp.clip(target, 0, L - 1)

        take = lambda a: jnp.take_along_axis(
            a, tgt.reshape(P, *([1] * (a.ndim - 1))), axis=1
        )[:, 0]
        cov_b = take(state.lm_cov)
        mean_b = take(state.lm_mean)
        # Anchor freeze (config.freeze_min_count): converged landmarks stop
        # moving — their mean/cov writes are suppressed below (count/desc
        # bookkeeping continues).
        frozen = (
            (take(state.lm_count) >= c.freeze_min_count)
            if c.freeze_min_count > 0
            else jnp.zeros_like(do_update)
        )
        nu_b, Q_b, H_b, _ = jax.vmap(self._per_pair_stats, in_axes=(0, 0, 0, None))(
            state.pose, mean_b, cov_b, z
        )
        Qinv_b, _ = linalg.inv_psd(Q_b)
        K = cov_b @ jnp.swapaxes(H_b, -1, -2) @ Qinv_b      # [P, Dl, Dz]
        mean_new = mean_b + (K @ nu_b[..., None])[..., 0]
        eye = jnp.eye(c.lm_dim, dtype=dtype)
        cov_new = (eye - K @ H_b) @ cov_b
        # Joseph-lite symmetrization for numerical hygiene.
        cov_new = 0.5 * (cov_new + jnp.swapaxes(cov_new, -1, -2))

        onehot_best = jax.nn.one_hot(tgt, L, dtype=bool) & do_update[:, None]
        onehot_move = onehot_best & ~frozen[:, None]
        state = state.replace(
            lm_mean=jnp.where(onehot_move[..., None], mean_new[:, None, :], state.lm_mean),
            lm_cov=jnp.where(
                onehot_move[..., None, None], cov_new[:, None, :, :], state.lm_cov
            ),
            lm_count=state.lm_count + 2 * onehot_best.astype(jnp.int32),
        )
        if c.sig_dim > 0:
            # Running-average appearance update (reference-style blob color).
            sig_b = take(state.lm_sig)
            cnt_b = jnp.maximum(take(state.lm_count).astype(dtype), 1.0)
            sig_upd = sig_b + (sig[None, :] - sig_b) / cnt_b[:, None]
            state = state.replace(
                lm_sig=jnp.where(onehot_best[..., None], sig_upd[:, None, :], state.lm_sig)
            )
        if c.desc_words > 0:
            # Latest-wins binary descriptor refresh.
            state = state.replace(
                lm_desc=jnp.where(onehot_best[..., None], desc[None, None, :], state.lm_desc)
            )

        # --- new-landmark allocation at the pre-assigned slot -------------
        init_fn = jax.vmap(lambda pose: self.model.init(pose, z))
        mean0, cov0 = init_fn(state.pose)                   # [P, Dl], [P, Dl, Dl]
        onehot_free = jax.nn.one_hot(tgt, L, dtype=bool) & do_alloc[:, None]
        state = state.replace(
            lm_mean=jnp.where(onehot_free[..., None], mean0[:, None, :], state.lm_mean),
            lm_cov=jnp.where(
                onehot_free[..., None, None], cov0[:, None, :, :], state.lm_cov
            ),
            lm_valid=state.lm_valid | onehot_free,
            lm_count=jnp.where(onehot_free, 1, state.lm_count),
        )
        if c.sig_dim > 0:
            state = state.replace(
                lm_sig=jnp.where(onehot_free[..., None], sig[None, None, :], state.lm_sig)
            )
        if c.desc_words > 0:
            state = state.replace(
                lm_desc=jnp.where(onehot_free[..., None], desc[None, None, :], state.lm_desc)
            )

        matched = matched | onehot_best | onehot_free
        return state, matched, do_update | do_alloc

    def _vision_kernel_params(self):
        """Static camera-parameter tuple of the score kernel."""
        fe = self.fe_cfg
        fx, fy, cx, cy = (fe.intrinsics[:4] if fe else (500.0, 500.0, 320.0, 240.0))
        H_img, W_img = fe.image_size if fe else (480, 640)
        return (
            ("fx", float(fx)), ("fy", float(fy)),
            ("cx", float(cx)), ("cy", float(cy)),
            ("baseline", float(fe.baseline if fe else 0.1)),
            ("img_w", float(W_img)), ("img_h", float(H_img)),
        )

    def measurement_update(
        self, state: ParticleState, obs: Observation, key=None
    ) -> tuple[ParticleState, StepMetrics]:
        """Process a frame's observation batch; cull; adaptively resample."""
        log_w0 = state.log_w
        state, mean_match = self.measurement_core(state, obs)
        state = self._temper(state, log_w0)
        return self._resample_and_metrics(state, obs, mean_match, key)

    def _temper(self, state: ParticleState, log_w0):
        """Likelihood tempering (config.likelihood_temper): rescale the
        frame's log-weight increment. Applied to the DELTA so every
        weight-producing path (FastSLAM 1 & 2 steps, the sharded step)
        shares it."""
        T = self.cfg.likelihood_temper
        if T == 1.0:
            return state
        return state.replace(log_w=log_w0 + (state.log_w - log_w0) / T)

    def measurement_core(
        self, state: ParticleState, obs: Observation,
        weight_matched: bool = True, scores=None,
    ) -> tuple[ParticleState, jax.Array]:
        """Association + EKF updates + map management WITHOUT resampling —
        purely per-particle, so it runs unchanged inside `shard_map` with
        the particle axis sharded (dist/sharded_filter.py). Returns
        (state, mean associated-observation count).

        `scores` (best [P, Z], best_ll [P, Z]), when given, replaces the
        association sweep (FastSLAM 2.0: scored once at the proposal pose)."""
        c = self.cfg
        P, L = state.lm_valid.shape
        if scores is None:
            scores = self._frame_scores(state, obs)

        matched0 = jnp.zeros((P, L), bool)
        # The EKF small-matrix products (H S H^T, K nu, (I-KH) S) would run
        # as TF32 on the GPU at default precision: pin full float32.
        with jax.default_matmul_precision("highest"):
            # batched pre-frame association, then sequential per-obs
            # composition
            target, is_new, do_upd, do_alloc, best_ll = self._associate_frame(
                state, obs, scores
            )
            if weight_matched:
                state = state.replace(
                    log_w=state.log_w + self._weight_delta(state, obs, scores)
                )

            def scan_body(carry, obs_row):
                st, matched = carry
                st, matched, _did = self._apply_observation(st, matched, obs_row)
                return (st, matched), None

            (state, matched), _ = jax.lax.scan(
                scan_body,
                (state, matched0),
                (obs.z, obs.sig, obs.desc, target.T, is_new.T),
            )
            n_match = jnp.sum((do_upd | do_alloc).astype(jnp.float32), axis=1)

        # --- map management: decrement in-FOV-but-unmatched, cull ---------
        if c.cull_enabled:
            if c.cull_unseen:
                # decay-eviction (config.cull_unseen): unmatched lanes age
                # regardless of visibility, so long trajectories recycle
                # capacity instead of freezing on the first L landmarks
                decrement = state.lm_valid & ~matched
            else:
                fov_fn = jax.vmap(
                    jax.vmap(self.model.in_fov, in_axes=(None, 0)),
                    in_axes=(0, 0),
                )
                in_fov = fov_fn(state.pose, state.lm_mean)
                decrement = state.lm_valid & in_fov & ~matched
            count = state.lm_count - decrement.astype(jnp.int32)
            alive = state.lm_valid & (count >= 0)
            state = state.replace(lm_count=count, lm_valid=alive)

        return state, jnp.mean(n_match)

    def _resample_and_metrics(self, state, obs, mean_match, key):
        """Shared tail of the measurement update: adaptive systematic
        resampling + per-frame metrics."""
        c = self.cfg
        P = state.num_particles
        ess = state.effective_sample_size()
        need = ess < c.resample_frac * P
        if key is None:
            key = jax.random.PRNGKey(0)

        def do_resample(st):
            idx = resample_kernel.systematic_resample_indices(key, st.log_w)
            return resample_kernel.gather_particles(st, idx)

        state = jax.lax.cond(need, do_resample, lambda st: st, state)

        n_obs = jnp.maximum(jnp.sum(obs.valid.astype(jnp.float32)), 1.0)
        metrics = StepMetrics(
            ess=ess,
            num_landmarks=jnp.mean(state.num_landmarks().astype(jnp.float32)),
            match_frac=mean_match / n_obs,
            resampled=need,
        )
        return state, metrics

    # -- full step ---------------------------------------------------------

    @partial(jax.jit, static_argnums=0)
    def step(self, state: ParticleState, u, obs: Observation, key):
        """One SLAM frame: motion propagate + measurement update."""
        k_motion, k_resample = jax.random.split(key)
        state = self.motion_update(state, u, k_motion)
        return self.measurement_update(state, obs, k_resample)

    # -- estimates ----------------------------------------------------------

    def estimate_pose(self, state: ParticleState) -> jax.Array:
        """Weighted-mean pose (angle-aware for SE(2))."""
        w = state.normalized_weights()
        if self.cfg.pose_dim == 3:
            xy = jnp.sum(w[:, None] * state.pose[:, :2], axis=0)
            s = jnp.sum(w * jnp.sin(state.pose[:, 2]))
            cth = jnp.sum(w * jnp.cos(state.pose[:, 2]))
            return jnp.concatenate([xy, wrap_angle(jnp.arctan2(s, cth))[None]])
        # SE(3): weighted translation + weighted quaternion mean (sign-
        # aligned to the best particle, then renormalized — the first-order
        # chordal mean). The round-4 version returned the best particle's
        # quaternion verbatim: a single sample from the cloud, whose
        # per-frame jitter leaks into TRANSLATION wherever the estimate is
        # composed (keyframe odometry edges, corrected_trajectory anchors —
        # rotation error x segment lever arm).
        best = jnp.argmax(state.log_w)
        t = jnp.sum(w[:, None] * state.pose[:, :3], axis=0)
        q = state.pose[:, 3:]
        sign = jnp.where(jnp.sum(q * q[best][None, :], axis=1) < 0, -1.0, 1.0)
        qm = jnp.sum((w * sign)[:, None] * q, axis=0)
        qm = qm / jnp.maximum(jnp.linalg.norm(qm), 1e-9)
        return jnp.concatenate([t, qm])

    def best_particle_map(self, state: ParticleState):
        """(means [L, Dl], valid [L]) of the highest-weight particle."""
        best = jnp.argmax(state.log_w)
        return state.lm_mean[best], state.lm_valid[best]

"""FastSLAM 2.0: measurement-informed optimal proposal distribution.

FastSLAM 1.0 (filter/fastslam.py) samples particle poses from the motion
model alone; when odometry is noisy relative to the sensor this wastes most
particles on poses the observations immediately rule out. FastSLAM 2.0
(Thrun et al., *Probabilistic Robotics* ch. 13.4 — the second half of the
SURVEY.md §3 algorithm-family contract) instead folds the current frame's
observations INTO the proposal: per particle, a small Gaussian over the
pose tangent is initialized from the motion model's mean/covariance and
EKF-updated by every observation that associates to a known landmark; the
pose is then sampled from that refined Gaussian, and importance weights
become `N(z; ẑ, H_x P H_xᵀ + H_m Σ H_mᵀ + R)` — the target/proposal ratio.
The result is near-reference accuracy with far fewer particles.

Batched formulation: the proposal stage is a `lax.scan` over the static
observation capacity whose body is fully batched over particles — the pose
Gaussian lives as dense `[P, dt]` / `[P, dt, dt]` arrays (dt = 3 for SE(2),
6 for the SE(3) right-tangent), association is the same masked `[P, L]`
argmax as FastSLAM 1, and all pose-EKF algebra is closed-form small-matrix
math (core/linalg.py) fused by XLA. Pose Jacobians `H_x = ∂h/∂(pose ⊞ δ)`
come from `jax.jacfwd` at δ=0, so every measurement model in the zoo
(range-bearing, bearing-only, pinhole, stereo, equirectangular) gets the
optimal proposal for free.

The landmark-map update then reuses the FastSLAM 1 measurement core with
`weight_matched=False`: ALL weight contributions (matched likelihood and
new-landmark log p0) were already applied in the proposal stage, so the
core only re-associates at the sampled pose and updates the maps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.core import linalg
from parakeet_slam_tpu.core.state import Observation, ParticleState
from parakeet_slam_tpu.filter import models as model_zoo
from parakeet_slam_tpu.filter.fastslam import _NEG_INF, FastSLAM

_JITTER = 1e-9


class FastSLAM2(FastSLAM):
    """FastSLAM with the optimal (measurement-informed) proposal."""

    def __init__(self, cfg, fe_cfg=None):
        super().__init__(cfg, fe_cfg)
        self.motion_mean_cov, self.retract, self.tangent_dim = (
            model_zoo.get_motion_mean_cov(cfg.motion_model)
        )

    # -- proposal stage -----------------------------------------------------

    def _pose_jacobian(self, pose, lm):
        """H_x = ∂h/∂δ of z = h(pose ⊞ δ, lm) at δ = 0.  [Dz, dt]."""
        zero = jnp.zeros((self.tangent_dim,), pose.dtype)
        return jax.jacfwd(lambda d: self.model.h(self.retract(pose, d), lm))(zero)

    def _hoist_association(self):
        mode = self.cfg.fs2_association
        if mode == "auto":
            return self._vision_3d
        return mode == "hoisted"

    def _associate(self, pose, state: ParticleState, z, sig, desc):
        """Masked ML association of one observation at the given poses
        (sequential mode). Returns (best [P], best_ll [P])."""
        pair_fn = jax.vmap(
            lambda p, m, c_: self._per_pair_stats(p, m, c_, z, assoc=True)[-1],
            in_axes=(None, 0, 0),
        )
        ll_geom = jax.vmap(pair_fn, in_axes=(0, 0, 0))(
            pose, state.lm_mean, state.lm_cov
        )
        ll = ll_geom + self._appearance_loglik(
            sig, desc, state.lm_sig, state.lm_desc, pose.dtype
        )
        ll = jnp.where(state.lm_valid & jnp.isfinite(ll), ll, _NEG_INF)
        best = jnp.argmax(ll, axis=-1)
        best_ll = jnp.take_along_axis(ll, best[:, None], axis=1)[:, 0]
        return best, best_ll

    def _propose(self, state: ParticleState, u, obs: Observation, key):
        """Refine a per-particle pose Gaussian with this frame's matched
        observations, then sample poses from it.

        Association mode (config.fs2_association): "hoisted" scores the
        whole frame ONCE at the motion-mean pose — one landmark sweep
        (`_frame_scores`) instead of a [P, L] map sweep per observation
        (scoring at the proposal
        mean is the standard practical approximation, sound when motion
        noise is small relative to landmark spacing — the vision configs
        with odometry priors). "sequential" re-associates each observation
        at the progressively refined pose (textbook; better in high-noise /
        sparse-landmark regimes like the 2-D corridor). Either way the EKF
        pose refinement is sequential: observation i's innovation is
        evaluated at the pose refined by observations 0..i-1.

        The importance weights are FULLY determined here: matched
        observations contribute `log N(ν; 0, H_x P H_xᵀ + Q)` and unmatched
        ones contribute log p0 — the map pass afterwards runs with weight
        updates suppressed (and in hoisted mode REUSES these association
        scores), so it can never double-count a weight.

        Returns (state with sampled poses and updated log-weights,
        the (best, best_ll) scores for the map pass — None in sequential
        mode, where the map pass re-associates at the sampled pose)."""
        c = self.cfg
        dtype = state.pose.dtype
        dt = self.tangent_dim
        P = state.num_particles
        # Association-inflated R (config.assoc_gate_px): the proposal EKF
        # and importance weight treat unmodeled map-relative drift as extra
        # measurement noise — a drifted-but-matched old landmark then pulls
        # the pose GENTLY toward re-anchoring instead of either being gated
        # out (map fragments, vision goes dead) or yanking the pose with a
        # catastrophic chi^2 at the true pixel noise.
        R = jnp.diag(jnp.asarray(self._meas_var(assoc=True), dtype))
        eye_t = jnp.eye(dt, dtype=dtype)

        mean0, cov0 = jax.vmap(
            lambda p: self.motion_mean_cov(p, jnp.asarray(u), c.motion_noise)
        )(state.pose)

        hoist = self._hoist_association()
        if hoist:
            scores = self._frame_scores(state.replace(pose=mean0), obs)
            best_all, best_ll_all = scores
        else:
            scores = None
            Zc = obs.capacity
            best_all = jnp.zeros((P, Zc), jnp.int32)       # unused carrier
            best_ll_all = jnp.zeros((P, Zc), state.pose.dtype)
        any_valid = jnp.any(state.lm_valid, axis=-1)       # [P]

        def obs_body(carry, obs_row):
            pose, P_cov, log_w = carry
            z, sig, desc, valid, best, best_ll = obs_row   # best [P]
            if not hoist:
                best, best_ll = self._associate(pose, state, z, sig, desc)
            matched = valid & any_valid & (best_ll >= self._log_p0_assoc())

            take = lambda a: jnp.take_along_axis(
                a, best.reshape(P, *([1] * (a.ndim - 1))), axis=1
            )[:, 0]
            mu_b, cov_b = take(state.lm_mean), take(state.lm_cov)
            # Weight shaping (core/config.py): only MATURE landmarks inform
            # the proposal refinement and the importance weight — a fresh
            # monocular landmark is an init-prior guess whose innovation
            # would pull the pose toward the guess.
            if c.weight_min_count > 0:
                matched = matched & (take(state.lm_count) >= c.weight_min_count)

            def pair(p, mu, cv):
                zhat = self.model.h(p, mu)
                Hm = self.model.jac(p, mu)
                Hx = self._pose_jacobian(p, mu)
                nu = self.model.residual(z, zhat)
                Q = Hm @ cv @ Hm.T + R
                return nu, Q, Hx

            nu, Q, Hx = jax.vmap(pair)(pose, mu_b, cov_b)
            S = Hx @ P_cov @ jnp.swapaxes(Hx, -1, -2) + Q      # [P, Dz, Dz]
            Sinv, _ = linalg.inv_psd(S)
            K = P_cov @ jnp.swapaxes(Hx, -1, -2) @ Sinv        # [P, dt, Dz]
            delta = (K @ nu[..., None])[..., 0]
            # Joseph form: (I-KH)P(I-KH)' + KQK' is PSD by construction —
            # the short form (I-KH)P can go slightly indefinite in fp32,
            # and a non-PSD P reaching the sampling Cholesky returns NaN
            # poses (observed killing FastSLAM2 runs at frame ~2).
            IKH = eye_t - K @ Hx
            P_new = (
                IKH @ P_cov @ jnp.swapaxes(IKH, -1, -2)
                + K @ Q @ jnp.swapaxes(K, -1, -2)
            )
            P_new = 0.5 * (P_new + jnp.swapaxes(P_new, -1, -2))

            # Numerical guards: one degenerate landmark (near-singular S
            # from a clipped-depth or diverged lane) must not poison the
            # whole particle — a non-finite delta/P/loglik cascades through
            # the scan carry into NaN poses for the rest of the run
            # (observed: FastSLAM2 runs dying frame ~1 on TUM). The obs is
            # simply skipped for refinement/weights.
            ll_s = linalg.gaussian_loglik(S, nu)
            ok = (
                jnp.all(jnp.isfinite(delta), axis=-1)
                & jnp.all(jnp.isfinite(P_new), axis=(-2, -1))
                & jnp.isfinite(ll_s)
                & (jnp.linalg.norm(delta, axis=-1) < 1.0)
            )
            matched = matched & ok

            m = matched[:, None]
            pose = jnp.where(m, self.retract(pose, delta), pose)
            P_cov = jnp.where(m[..., None], P_new, P_cov)
            unmatched_w = (
                0.0 if c.weight_only_matched else c.new_landmark_loglik
            )
            log_w = log_w + jnp.where(
                matched,
                ll_s,
                jnp.where(valid, unmatched_w, 0.0),
            )
            return (pose, P_cov, log_w), None

        with jax.default_matmul_precision("highest"):
            (pose, P_cov, log_w), _ = jax.lax.scan(
                obs_body,
                (mean0, cov0, state.log_w),
                (obs.z, obs.sig, obs.desc, obs.valid,
                 best_all.T, best_ll_all.T),
            )

            # Sample pose ~ N(mean, P) per particle in tangent coordinates.
            # A degenerate P (all refinement mass consumed) must sample AT
            # the refined mean, not NaN the particle: zero a non-finite
            # Cholesky factor.
            chol = jnp.linalg.cholesky(P_cov + _JITTER * eye_t)
            chol = jnp.where(jnp.isfinite(chol), chol, 0.0)
            eps = jax.random.normal(key, (P, dt), dtype)
            pose = self.retract(pose, (chol @ eps[..., None])[..., 0])

        return state.replace(pose=pose, log_w=log_w), scores

    # -- full step ------------------------------------------------------------

    def measurement_update(self, state, obs, key=None):
        # For API parity with FastSLAM 1 (measurement-only callers): the
        # proposal stage needs the PRE-motion pose, so route through step().
        log_w0 = state.log_w
        state, mean_match = self.measurement_core(state, obs, weight_matched=True)
        state = self._temper(state, log_w0)
        return self._resample_and_metrics(state, obs, mean_match, key)

    @partial(jax.jit, static_argnums=0)
    def step(self, state: ParticleState, u, obs: Observation, key):
        """One FastSLAM 2.0 frame: proposal-refined pose sampling, landmark
        EKF updates (weights for matched obs already applied), resample.
        The map pass reuses the proposal's association scores — two full
        landmark sweeps per frame become one sweep plus one narrow apply."""
        k_prop, k_resample = jax.random.split(key)
        log_w0 = state.log_w
        state, scores = self._propose(state, u, obs, k_prop)
        state, mean_match = self.measurement_core(
            state, obs, weight_matched=False, scores=scores
        )
        state = self._temper(state, log_w0)
        return self._resample_and_metrics(state, obs, mean_match, k_resample)


def make_filter(cfg, fe_cfg=None) -> FastSLAM:
    """Algorithm-selecting factory: cfg.algorithm in {fastslam1, fastslam2}."""
    algo = getattr(cfg, "algorithm", "fastslam1")
    if algo == "fastslam2":
        return FastSLAM2(cfg, fe_cfg)
    if algo == "fastslam1":
        return FastSLAM(cfg, fe_cfg)
    raise ValueError(f"unknown algorithm {algo!r}")

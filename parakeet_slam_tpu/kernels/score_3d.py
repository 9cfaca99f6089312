"""Association-score sweep of the 3-D camera models as a GPU kernel
(Pallas through Triton).

For every (particle, observation) pair of a frame the filter needs the
landmark lane with the highest association log-likelihood against the
pre-frame map: `FastSLAM._score_frame`, the XLA reference, computes it with
a `lax.scan` over the Z observations that re-reads the whole [P, L] map
once per observation. Here each block owns one (particle tile, landmark
chunk): it loads the chunk's means, covariances and descriptor words once,
computes the predicted measurement and inverse innovation covariance of
every pair once, and then loops over the observations, writing the chunk's
best (log-likelihood, lane) for each (particle, observation). A small XLA
reduce over the chunks keeps the first maximum, which is the smallest lane,
as `jnp.argmax` does in the reference.

Blocks run in no particular order, so nothing is carried from one to the
next. Chunks that start past the map's highest live lane skip the work and
write the empty result: every lane in them is invalid.

The scores agree with the reference up to the order of float sums: a tie
or a near-tie between two lanes may be broken the other way.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from parakeet_slam_tpu.core import geometry

VISION_MODELS = ("pinhole_3d", "stereo_3d", "equirect_3d")

_NEG_INF = -1e30
_EPS = 1e-12
_LOG_2PI = math.log(2.0 * math.pi)
# (particle tile, landmark chunk, warps): 1024 pairs per block keeps the
# ~20 per-pair values the observation loop needs in registers.
_BLOCK = (8, 128, 8)


def applies(model: str, sig_dim: int, platform: str) -> bool:
    """Whether the kernel scores this filter on this platform. It has no
    signature term, and it runs only where it was compiled for: the GPU.
    Everywhere else the XLA scan is the implementation."""
    return platform == "gpu" and sig_dim == 0 and model in VISION_MODELS


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Small-matrix algebra over lists of [Pt, Lc] planes, unrolled at trace time
# ---------------------------------------------------------------------------


def _matmul(A, B):
    return [
        [sum(A[i][t] * B[t][j] for t in range(len(B))) for j in range(len(B[0]))]
        for i in range(len(A))
    ]


def _predict(model, m, S, R, t, par, r_var):
    """Predicted measurement zhat, unique entries of Q^-1 (row-major upper
    triangle) and log|Q| of every pair, with Q = H S H^T + diag(r_var). The
    inverse and the log-determinant follow `core/linalg.py`."""
    d = [m[k] - t[k] for k in range(3)]
    p = [sum(R[i][k] * d[k] for k in range(3)) for i in range(3)]
    if model == "equirect_3d":
        ku = par["img_w"] / (2.0 * math.pi)
        kv = par["img_h"] / math.pi
        x, y, z = p
        rho2 = x * x + y * y + 1e-9
        r2 = rho2 + z * z
        rho = jnp.sqrt(rho2)
        zhat = [
            (jnp.arctan2(y, x) + math.pi) * ku,
            (math.pi / 2.0 - jnp.arctan2(z, rho)) * kv,
        ]
        s = kv / (r2 * rho)
        Hp = [[-ku * y / rho2, ku * x / rho2, None], [x * z * s, y * z * s, -rho2 * s]]
    else:
        from parakeet_slam_tpu.filter.models import MIN_DEPTH

        fx, fy, cx, cy = par["fx"], par["fy"], par["cx"], par["cy"]
        z = jnp.maximum(p[2], MIN_DEPTH)
        iz = 1.0 / z
        zhat = [fx * p[0] * iz + cx, fy * p[1] * iz + cy]
        Hp = [[fx * iz, None, -fx * p[0] * iz * iz], [None, fy * iz, -fy * p[1] * iz * iz]]
        if model == "stereo_3d":
            fxb = fx * par["baseline"]
            zhat.append(fxb * iz)
            Hp.append([None, None, -fxb * iz * iz])
    # H = dzhat/dp_cam . R_cw (None marks a structural zero of dzhat/dp_cam)
    H = [
        [sum(row[k] * R[k][j] for k in range(3) if row[k] is not None) for j in range(3)]
        for row in Hp
    ]
    HS = _matmul(H, S)
    Dz = len(zhat)
    Q = {
        (a, b): sum(HS[a][k] * H[b][k] for k in range(3)) + (r_var[a] if a == b else 0.0)
        for a in range(Dz) for b in range(a, Dz)
    }
    if Dz == 2:
        det = Q[0, 0] * Q[1, 1] - Q[0, 1] * Q[0, 1]
        cof = {(0, 0): Q[1, 1], (0, 1): -Q[0, 1], (1, 1): Q[0, 0]}
    else:
        a, b, c = Q[0, 0], Q[0, 1], Q[0, 2]
        e, f, i = Q[1, 1], Q[1, 2], Q[2, 2]
        A = e * i - f * f
        B = -(b * i - f * c)
        C = b * f - e * c
        det = a * A + b * B + c * C
        cof = {
            (0, 0): A, (0, 1): B, (0, 2): C,
            (1, 1): a * i - c * c, (1, 2): -(a * f - c * b), (2, 2): a * e - b * b,
        }
    det_safe = jnp.where(jnp.abs(det) < _EPS, _EPS, det)
    Qi = {k: v / det_safe for k, v in cof.items()}
    return zhat, Qi, jnp.log(jnp.maximum(det, _EPS))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _kernel(cam_ref, z_ref, dz_ref, hi_ref, *refs, model, W, Z, par, r_var, desc_weight):
    mean_r, cov_r = refs[0:3], refs[3:9]
    desc_r, valid_r = refs[9 : 9 + W], refs[9 + W]
    ll_out, ix_out = refs[10 + W], refs[11 + W]
    pt, lc = valid_r.shape
    lane0 = pl.program_id(1) * lc
    live = lane0 <= hi_ref[0]

    @pl.when(jnp.logical_not(live))
    def _():
        ll_out[...] = jnp.full(ll_out.shape, _NEG_INF, jnp.float32)
        ix_out[...] = jnp.full(ix_out.shape, lane0, jnp.int32)

    @pl.when(live)
    def _():
        R = [[cam_ref[:, 3 * i + j][:, None] for j in range(3)] for i in range(3)]
        t = [cam_ref[:, 9 + k][:, None] for k in range(3)]
        m = [mean_r[k][...] for k in range(3)]
        c6 = [cov_r[k][...] for k in range(6)]
        ut = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}
        S = [[c6[ut[min(a, b), max(a, b)]] for b in range(3)] for a in range(3)]
        zhat, Qi, ld = _predict(model, m, S, R, t, par, r_var)
        Dz = len(zhat)
        ok = valid_r[...] != 0
        descs = [desc_r[w][...] for w in range(W)]
        lanes = lane0 + jax.lax.broadcasted_iota(jnp.int32, (pt, lc), 1)

        def obs_body(i, carry):
            nu = [z_ref[k, i] - zhat[k] for k in range(Dz)]
            if model == "equirect_3d":
                w_img = par["img_w"]
                nu[0] = nu[0] - w_img * jnp.floor(nu[0] / w_img + 0.5)
            maha = sum(
                Qi[a, b] * nu[a] * nu[b] * (1.0 if a == b else 2.0)
                for a in range(Dz) for b in range(a, Dz)
            )
            ll = -0.5 * (jnp.maximum(maha, 0.0) + ld + Dz * _LOG_2PI)
            if W:
                ham = sum(
                    jax.lax.population_count(jnp.bitwise_xor(descs[w], dz_ref[w, i]))
                    for w in range(W)
                )
                ll = ll - desc_weight * ham.astype(jnp.float32)
            ll = jnp.where(ok & jnp.isfinite(ll), ll, _NEG_INF)
            best = jnp.max(ll, axis=1)
            lane = jnp.min(jnp.where(ll == best[:, None], lanes, 2**30), axis=1)
            ll_out[:, i] = best
            ix_out[:, i] = lane
            return carry

        jax.lax.fori_loop(0, Z, obs_body, 0)


@functools.partial(
    jax.jit,
    static_argnames=("model", "par", "r_var", "desc_weight", "block", "interpret"),
)
def score_3d(
    pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc,
    *,
    model: str,
    par: tuple,
    r_var: tuple,
    desc_weight: float,
    block: tuple = _BLOCK,
    interpret: bool = False,
):
    """Best association of every observation against the pre-frame map.

    pose [P, 7] (t, q camera-in-world), lm_mean [P, L, 3], lm_cov
    [P, L, 3, 3], lm_desc [P, L, W] uint32, lm_valid [P, L], z [Z, Dz],
    desc [Z, W]. `par` holds the camera as (name, value) pairs and `r_var`
    the association variances. Returns (best lane [P, Z] int32, best
    log-likelihood [P, Z] f32), as `FastSLAM._score_frame` does.
    """
    par = dict(par)
    pt, lc, num_warps = block
    P, L = lm_valid.shape
    Z, Dz = z.shape
    W = lm_desc.shape[-1]
    Pp, Lp, Zp = _round_up(P, pt), _round_up(L, lc), _next_pow2(max(Z, 16))
    n_chunks = Lp // lc

    def plane(a, dtype):
        return jnp.pad(a.astype(dtype), ((0, Pp - P), (0, Lp - L)))

    Rcw = jnp.swapaxes(geometry.quat_to_matrix(pose[:, 3:]), -1, -2)
    cam = jnp.concatenate([Rcw.reshape(P, 9), pose[:, :3]], axis=1)
    cam = jnp.pad(cam.astype(jnp.float32), ((0, Pp - P), (0, 4)))
    means = [plane(lm_mean[..., k], jnp.float32) for k in range(3)]
    covs = [
        plane(lm_cov[..., i, j], jnp.float32)
        for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    ]
    words = jax.lax.bitcast_convert_type(lm_desc, jnp.int32)
    descs = [plane(words[..., w], jnp.int32) for w in range(W)]
    valid = plane(lm_valid, jnp.int32)
    z_t = jnp.pad(z.T.astype(jnp.float32), ((0, 4 - Dz), (0, Zp - Z)))
    Wp = _next_pow2(max(W, 1))
    dz_t = jnp.zeros((Wp, Zp), jnp.int32)
    if W:
        dz_t = dz_t.at[:W, :Z].set(jax.lax.bitcast_convert_type(desc, jnp.int32).T)
    hi = jnp.max(jnp.where(lm_valid, jnp.arange(L, dtype=jnp.int32), -1))[None]

    full = lambda shape: pl.BlockSpec(shape, lambda i, j: (0,) * len(shape))  # noqa: E731
    tile = pl.BlockSpec((pt, lc), lambda i, j: (i, j))
    out = pl.BlockSpec((pt, Zp), lambda i, j: (i, j))
    kernel = functools.partial(
        _kernel, model=model, W=W, Z=Z, par=par, r_var=tuple(r_var),
        desc_weight=float(desc_weight),
    )
    ll_p, ix_p = pl.pallas_call(
        kernel,
        grid=(Pp // pt, n_chunks),
        in_specs=[
            pl.BlockSpec((pt, 16), lambda i, j: (i, 0)),
            full((4, Zp)),
            full((Wp, Zp)),
            full((1,)),
        ]
        + [tile] * (10 + W),
        out_specs=(out, out),
        out_shape=(
            jax.ShapeDtypeStruct((Pp, n_chunks * Zp), jnp.float32),
            jax.ShapeDtypeStruct((Pp, n_chunks * Zp), jnp.int32),
        ),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="score_3d",
    )(cam, z_t, dz_t, hi, *means, *covs, *descs, valid)
    return reduce_chunks(
        ll_p.reshape(Pp, n_chunks, Zp)[:P, :, :Z],
        ix_p.reshape(Pp, n_chunks, Zp)[:P, :, :Z],
    )


def reduce_chunks(ll_p, ix_p):
    """Per-chunk bests [P, C, Z] -> (best lane [P, Z], best ll [P, Z]). The
    first chunk holding the maximum wins: chunks are in lane order, so that
    is the smallest lane, as `jnp.argmax` picks it."""
    c = jnp.argmax(ll_p, axis=1)[:, None, :]
    best_ll = jnp.take_along_axis(ll_p, c, axis=1)[:, 0]
    best = jnp.take_along_axis(ix_p, c, axis=1)[:, 0]
    return best, best_ll

"""Feature detection: FAST-style corners + Harris, as dense array ops.

The reference delegated detection to an upstream ROS blob-detector node
(SURVEY.md §1 L2); BASELINE.json's north star requires real feature
detection on incoming (incl. panoramic) frames. Formulation:

- FAST segment test as 16 shifted-image views (pure elementwise work,
  no gather): a pixel is a corner when >= `arc` contiguous ring neighbors
  are all brighter (or all darker) than center +- t. Contiguous-arc check
  is an AND-reduction over a rolled boolean ring — still elementwise.
- Harris as separable box-filtered structure tensor (convolutions).
- NMS as max-pool equality (`lax.reduce_window`), no sorting.
- Fixed-capacity keypoint output via `lax.top_k` on the flattened score
  map — static shapes end to end, jit/scan-safe.
- Panoramic frames: `wrap_x=True` rolls the azimuth axis circularly so the
  ring/NMS windows see across the seam (SURVEY.md §8 "panoramic
  wrap-around").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# FAST-16 Bresenham circle offsets (radius 3), clockwise from 12 o'clock.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2d(img, dy, dx, wrap_x):
    """View of img shifted so out[y, x] = img[y+dy, x+dx] (zero/wrap pad)."""
    out = jnp.roll(img, (-dy, -dx), axis=(0, 1))
    H, W = img.shape
    if dy != 0:  # vertical never wraps
        ys = jnp.arange(H)
        valid = (ys + dy >= 0) & (ys + dy < H)
        out = jnp.where(valid[:, None], out, 0.0)
    if dx != 0 and not wrap_x:
        xs = jnp.arange(W)
        valid = (xs + dx >= 0) & (xs + dx < W)
        out = jnp.where(valid[None, :], out, 0.0)
    return out


def fast_score(img: jax.Array, threshold: float, arc: int = 9, wrap_x: bool = False):
    """FAST-16 corner score map [H, W] (0 where not a corner).

    Score = sum of |ring - center| over ring pixels exceeding the threshold,
    gated on an `arc`-long contiguous bright or dark run.
    """
    img = img.astype(jnp.float32)
    ring = jnp.stack(
        [_shift2d(img, dy, dx, wrap_x) for dy, dx in _FAST_RING], axis=0
    )  # [16, H, W]
    diff = ring - img[None]
    bright = diff > threshold
    dark = diff < -threshold

    def has_run(mask):
        # any contiguous run of `arc` true values on the circular ring
        acc = jnp.ones_like(mask[0], dtype=bool)
        runs = []
        for start in range(16):
            acc = jnp.ones_like(mask[0], dtype=bool)
            for k in range(arc):
                acc = acc & mask[(start + k) % 16]
            runs.append(acc)
        return jnp.any(jnp.stack(runs, axis=0), axis=0)

    is_corner = has_run(bright) | has_run(dark)
    strength = jnp.sum(jnp.where(bright | dark, jnp.abs(diff), 0.0), axis=0)
    score = jnp.where(is_corner, strength, 0.0)
    # kill the border where the ring fell outside the image
    H, W = img.shape
    ys = jnp.arange(H)
    score = jnp.where((ys[:, None] >= 3) & (ys[:, None] < H - 3), score, 0.0)
    if not wrap_x:
        xs = jnp.arange(W)
        score = jnp.where((xs[None, :] >= 3) & (xs[None, :] < W - 3), score, 0.0)
    return score


def harris_score(img: jax.Array, k: float = 0.04, window: int = 5, wrap_x: bool = False):
    """Harris corner response via box-filtered structure tensor."""
    img = img.astype(jnp.float32)
    # Sobel-ish gradients from shifted views (elementwise, wrap-aware).
    gx = 0.5 * (_shift2d(img, 0, 1, wrap_x) - _shift2d(img, 0, -1, wrap_x))
    gy = 0.5 * (_shift2d(img, 1, 0, wrap_x) - _shift2d(img, -1, 0, wrap_x))

    def box(a):
        pad = "wrap" if wrap_x else "constant"
        r = window // 2
        a = jnp.pad(a, ((r, r), (0, 0)), mode="constant")
        a = jnp.pad(a, ((0, 0), (r, r)), mode=pad)
        return jax.lax.reduce_window(
            a, 0.0, jax.lax.add, (window, window), (1, 1), "VALID"
        )

    ixx, iyy, ixy = box(gx * gx), box(gy * gy), box(gx * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def nms(score: jax.Array, radius: int, wrap_x: bool = False):
    """Keep only local maxima in a (2r+1)^2 window (max-pool equality)."""
    w = 2 * radius + 1
    pad_mode = "wrap" if wrap_x else "constant"
    padded = jnp.pad(score, ((radius, radius), (0, 0)), mode="constant")
    padded = jnp.pad(padded, ((0, 0), (radius, radius)), mode=pad_mode)
    local_max = jax.lax.reduce_window(
        padded, -jnp.inf, jax.lax.max, (w, w), (1, 1), "VALID"
    )
    return jnp.where((score == local_max) & (score > 0.0), score, 0.0)


@partial(jax.jit, static_argnames=("max_features", "detector", "nms_radius", "wrap_x", "arc"))
def detect(
    img: jax.Array,
    max_features: int = 512,
    detector: str = "fast",
    threshold: float = 0.08,
    nms_radius: int = 4,
    wrap_x: bool = False,
    arc: int = 9,
):
    """Detect keypoints on a grayscale [H, W] image in [0, 1].

    Returns (xy [K, 2] float32 (x=col, y=row), score [K], valid [K]) with
    static capacity K = max_features.
    """
    if detector == "fast":
        score = fast_score(img, threshold, arc=arc, wrap_x=wrap_x)
    elif detector == "harris":
        score = harris_score(img, wrap_x=wrap_x)
    else:
        raise ValueError(f"unknown detector {detector!r}")
    score = nms(score, nms_radius, wrap_x=wrap_x)

    H, W = score.shape
    flat = score.reshape(-1)
    top, idx = jax.lax.top_k(flat, max_features)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    valid = top > 0.0
    return jnp.stack([xs, ys], axis=-1), top, valid

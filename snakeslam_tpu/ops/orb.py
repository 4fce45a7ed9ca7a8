"""ORB feature extraction: pyramid, FAST, NMS, orientation, rBRIEF.

Device replacement for saiga's ``ORBExtractor`` / ``ORBExtractorGPU``
(reference call sites: Snake/Preprocess/FeatureDetector.cpp:14-17,28-42,
113-125).  The design is data-parallel end to end — no octree recursion, no
per-keypoint scalar loops:

  * FAST-16 segment test as pure elementwise bit arithmetic over the whole
    image (16 shifted views -> packed arc masks -> contiguous-9 test via
    bit rotations), SAD corner score, 3x3 max-pool NMS.
  * Keypoint distribution: top-k per fixed grid cell + global top-N by
    score — the batched equivalent of the reference's octree distribution
    (the goal, spatially even coverage, is the same).
  * Orientation by intensity centroid over a radius-15 disc; descriptors by
    rotated BRIEF over a 7x7-box-smoothed image.  Both operate on gathered
    per-keypoint patches (vmap of dynamic_slice), fixed keypoint count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock
FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)  # (dx, dy)

PATCH_R = 15          # orientation disc radius (ORB HALF_PATCH_SIZE)
DESC_BITS = 256


def fast_score(img: jax.Array, threshold: float):
    """FAST-16 segment test + SAD score, fully vectorized.

    The 16 ring pixels are read as shifted slices of one edge-padded
    image and folded into running bit masks and sums, so XLA fuses the
    whole test into a single elementwise pass (no (16, H, W) stack is
    materialized).

    Args:
      img: (H, W) float32 grayscale.
    Returns (score (H, W) float32, is_corner (H, W) bool); borders (3 px)
    are zeroed.
    """
    H, W = img.shape
    pad = jnp.pad(img, 3, mode="edge")
    hi = img + threshold
    lo = img - threshold
    bits_b = jnp.zeros((H, W), jnp.int32)
    bits_d = jnp.zeros((H, W), jnp.int32)
    sum_b = jnp.zeros((H, W), img.dtype)
    sum_d = jnp.zeros((H, W), img.dtype)
    for k, (dx, dy) in enumerate(FAST_RING):
        ring = pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        bright = ring > hi
        dark = ring < lo
        bits_b = bits_b | (bright.astype(jnp.int32) << k)
        bits_d = bits_d | (dark.astype(jnp.int32) << k)
        sum_b = sum_b + jnp.where(bright, ring - img - threshold, 0.0)
        sum_d = sum_d + jnp.where(dark, img - ring - threshold, 0.0)

    def arc9(bits):
        # 9 contiguous set bits among 16, circularly
        m = bits | (bits << 16)  # duplicate so rotation = shift
        acc = m
        for k in range(1, 9):
            acc = acc & (m >> k)
        return (acc & 0xFFFF) != 0

    is_corner = arc9(bits_b) | arc9(bits_d)
    score = jnp.where(is_corner, jnp.maximum(sum_b, sum_d), 0.0)

    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    border = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    score = jnp.where(border, score, 0.0)
    return score, is_corner & border


def nms3(score: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= m) & (score > 0), score, 0.0)


def select_keypoints(score: jax.Array, n_keypoints: int, cell: int = 32,
                     per_cell: int = 4):
    """Spatially distributed top-N selection.

    Top-`per_cell` responses per (cell x cell) block, then global top-N.
    Returns (uv (N, 2) float32 level coords, resp (N,), valid (N,)).
    """
    H, W = score.shape
    Hc = -(-H // cell)
    Wc = -(-W // cell)
    pad_h = Hc * cell - H
    pad_w = Wc * cell - W
    s = jnp.pad(score, ((0, pad_h), (0, pad_w)))
    blocks = s.reshape(Hc, cell, Wc, cell).transpose(0, 2, 1, 3).reshape(
        Hc * Wc, cell * cell
    )
    # per-cell top-k as `per_cell` argmax+suppress rounds: NMS leaves cells
    # sparse, and k max-reductions are cheap elementwise passes where a
    # batched lax.top_k pays a per-row sort
    vals_l, idx_l = [], []
    b = blocks
    col = jnp.arange(blocks.shape[1])[None, :]
    for _ in range(per_cell):
        i = jnp.argmax(b, axis=1)
        vals_l.append(jnp.take_along_axis(b, i[:, None], axis=1)[:, 0])
        idx_l.append(i)
        b = jnp.where(col == i[:, None], -jnp.inf, b)
    vals = jnp.stack(vals_l, axis=1)                # (Hc*Wc, per_cell)
    idx = jnp.stack(idx_l, axis=1)
    # convert block-local indices to image coords
    cy = (jnp.arange(Hc * Wc) // Wc) * cell
    cx = (jnp.arange(Hc * Wc) % Wc) * cell
    py = idx // cell + cy[:, None]
    px = idx % cell + cx[:, None]
    flat_vals = vals.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    take = min(n_keypoints, flat_vals.shape[0])
    top_vals, top_i = jax.lax.top_k(flat_vals, take)
    uv = jnp.stack(
        [flat_x[top_i].astype(jnp.float32), flat_y[top_i].astype(jnp.float32)],
        axis=1,
    )
    valid = top_vals > 0
    if take < n_keypoints:
        uv = jnp.pad(uv, ((0, n_keypoints - take), (0, 0)))
        top_vals = jnp.pad(top_vals, (0, n_keypoints - take))
        valid = jnp.pad(valid, (0, n_keypoints - take))
    return uv, top_vals, valid


# ---------------------------------------------------------------------------
# per-keypoint patch work: orientation + descriptors
# ---------------------------------------------------------------------------

_PATCH = 2 * PATCH_R + 1
_disc_y, _disc_x = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
_DISC_MASK = (_disc_x**2 + _disc_y**2 <= PATCH_R**2).astype(np.float32)


def _extract_patches(img: jax.Array, uv: jax.Array, size: int):
    """(N, size, size) patches centered at uv (clamped to the image)."""
    half = size // 2
    H, W = img.shape
    y0 = jnp.clip(uv[:, 1].astype(jnp.int32) - half, 0, H - size)
    x0 = jnp.clip(uv[:, 0].astype(jnp.int32) - half, 0, W - size)

    def one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (size, size))

    return jax.vmap(one)(y0, x0)


def orientations(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Intensity-centroid angle (degrees) per keypoint (IC_Angle analog)."""
    patches = _extract_patches(img, uv, _PATCH)     # (N, 31, 31)
    wx = jnp.asarray(_disc_x * _DISC_MASK)
    wy = jnp.asarray(_disc_y * _DISC_MASK)
    m10 = jnp.einsum("nij,ij->n", patches, wx)
    m01 = jnp.einsum("nij,ij->n", patches, wy)
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def _make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """256 point pairs, Gaussian-distributed in the 31x31 patch.

    A seeded Gaussian pattern (original BRIEF recipe) — descriptors are
    self-consistent within this framework, which is all matching needs.
    """
    rng = np.random.default_rng(seed)
    pts = np.clip(
        rng.normal(scale=PATCH_R / 2.3, size=(DESC_BITS, 2, 2)),
        -(PATCH_R - 2), PATCH_R - 2,
    )
    return pts.astype(np.float32)  # (256, 2 endpoints, 2 coords (x, y))


BRIEF_PATTERN = _make_brief_pattern()


_INTERP_CACHE: dict = {}


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, half-pixel centers
    (the sampling convention of jax.image.resize 'linear')."""
    key = (n_out, n_in)
    m = _INTERP_CACHE.get(key)
    if m is None:
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        x1 = np.clip(x0 + 1, 0, n_in - 1)
        w = np.clip(x - x0, 0.0, 1.0)
        m = np.zeros((n_out, n_in), dtype=np.float32)
        m[np.arange(n_out), x0] += 1.0 - w
        m[np.arange(n_out), x1] += w
        _INTERP_CACHE[key] = m
    return m


def _resize_matmul(imgs: jax.Array, h: int, w: int) -> jax.Array:
    """(B, H, W) -> (B, h, w) bilinear downscale as two matmuls.

    The same interpolation as jax.image.resize, written as dense banded
    matrices so it runs as matrix products instead of gathers (~0.3 GFLOP
    per level batch)."""
    B, H, W = imgs.shape
    Ah = jnp.asarray(_interp_matrix(h, H))
    Aw = jnp.asarray(_interp_matrix(w, W))
    out = jnp.einsum("hH,bHW->bhW", Ah, imgs,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("bhW,wW->bhw", out, Aw,
                      preferred_element_type=jnp.float32)


def box_blur_batch(imgs: jax.Array, k: int = 7) -> jax.Array:
    """(B, H, W) k x k box filter (separable) — the BRIEF pre-smoothing.

    Shift-and-add, not conv: a 1-channel conv_general_dilated has no
    matrix work to offer, while 2k fused adds are one elementwise pass.
    Zero padding keeps the conv 'SAME' semantics this replaced."""
    r = k // 2
    scale = imgs.dtype.type(1.0 / k)
    p = jnp.pad(imgs, ((0, 0), (r, r), (0, 0)))
    out = sum(p[:, i:i + imgs.shape[1], :] for i in range(k)) * scale
    p = jnp.pad(out, ((0, 0), (0, 0), (r, r)))
    out = sum(p[:, :, i:i + imgs.shape[2]] for i in range(k)) * scale
    return out


def box_blur(img: jax.Array, k: int = 7) -> jax.Array:
    """k x k box filter (separable) — the BRIEF pre-smoothing."""
    return box_blur_batch(img[None], k)[0]


# rBRIEF angle quantization: 30 bins of 12 deg (the ORB recipe — OpenCV
# quantizes to 2*pi/30 before sampling), which lets the rotated sample
# positions be PRECOMPUTED per bin as static patch offsets.
_BRIEF_BINS = 30
_BRIEF_PATCH = 40          # rotated samples reach |13*sqrt(2)| ~ 18.4 px


def _make_brief_offsets() -> np.ndarray:
    """(30, 512) static flat offsets into a 40x40 patch, one row per
    quantized angle; columns are [endpoint0 x256, endpoint1 x256]."""
    half = _BRIEF_PATCH // 2
    out = np.empty((_BRIEF_BINS, 2 * DESC_BITS), dtype=np.int32)
    for b in range(_BRIEF_BINS):
        a = np.radians(b * 360.0 / _BRIEF_BINS)
        c, s = np.cos(a), np.sin(a)
        px = BRIEF_PATTERN[:, :, 0]
        py = BRIEF_PATTERN[:, :, 1]
        ix = np.round(c * px - s * py).astype(np.int32) + half
        iy = np.round(s * px + c * py).astype(np.int32) + half
        lin = iy * _BRIEF_PATCH + ix                 # (256, 2)
        out[b] = np.concatenate([lin[:, 0], lin[:, 1]])
    return out


_BRIEF_OFFSETS = _make_brief_offsets()


def brief_descriptors(img_blur: jax.Array, uv: jax.Array,
                      angle_deg: jax.Array) -> jax.Array:
    """Rotated BRIEF: (N, 256) bits in {0, 1} (int8).

    Static sampling: angles quantize to 30 bins of 12 deg (the ORB
    recipe), so every bin's rotated sample positions are STATIC offsets
    into a per-keypoint 40x40 patch.  Patches come from one block gather
    (vmapped dynamic_slice), then 30 unrolled static column-takes select
    each bin's samples and a where-accumulate keeps the right bin per
    keypoint, instead of a 512-index random gather per keypoint.  Near the
    border the
    clamped patch off-centers the pattern (same policy as orientations);
    descriptors stay deterministic and backend-independent."""
    H, W = img_blur.shape
    if H < _BRIEF_PATCH or W < _BRIEF_PATCH:
        # tiny pyramid levels (small fixture images): pad so the 40x40
        # window always fits — static, shape-derived, free for real sizes
        img_blur = jnp.pad(img_blur, ((0, max(0, _BRIEF_PATCH - H)),
                                      (0, max(0, _BRIEF_PATCH - W))))
    patches = _extract_patches(img_blur, uv, _BRIEF_PATCH)
    patches = patches.reshape(uv.shape[0], _BRIEF_PATCH * _BRIEF_PATCH)
    return _brief_from_patches(patches, angle_deg)


def _brief_from_patches(patches: jax.Array, angle_deg: jax.Array):
    """(N, 1600) flattened blurred 40x40 patches + angles -> (N, 256) bits."""
    bin_ = jnp.round(angle_deg * (_BRIEF_BINS / 360.0)).astype(jnp.int32)
    bin_ = jnp.mod(bin_, _BRIEF_BINS)
    samples = jnp.zeros((patches.shape[0], 2 * DESC_BITS),
                        dtype=patches.dtype)
    for b in range(_BRIEF_BINS):
        take_b = patches[:, _BRIEF_OFFSETS[b]]       # static indices
        samples = jnp.where((bin_ == b)[:, None], take_b, samples)
    return (samples[:, :DESC_BITS] < samples[:, DESC_BITS:]).astype(jnp.int8)


# fused patch pipeline: one 46x46 pull per keypoint feeds orientation,
# BRIEF pre-smoothing, and the rotated BRIEF samples
_BRIEF_SRC = _BRIEF_PATCH + 6           # 7x7 box-blur halo (r=3 each side)
_CENTER_OFF = (_BRIEF_SRC - _PATCH) // 2   # 31x31 orientation disc offset


def _box_blur_patches(p: jax.Array, k: int = 7) -> jax.Array:
    """(N, S, S) -> (N, S-k+1, S-k+1) valid-region box blur (separable
    shift-and-add; every output uses real image pixels — no pad ring)."""
    s = p.shape[1]
    o = s - k + 1
    scale = p.dtype.type(1.0 / k)
    out = sum(p[:, i:i + o, :] for i in range(k)) * scale
    out = sum(out[:, :, i:i + o] for i in range(k)) * scale
    return out


def orient_and_brief(img: jax.Array, uv: jax.Array):
    """Fused orientation + rotated BRIEF from ONE patch pull per keypoint.

    A 46x46 patch from the UNBLURRED level image supplies (a) the 31x31
    intensity-centroid disc (IC_Angle) from its center, and (b) the 7x7
    box-blurred 40x40 window the BRIEF samples read — so the whole-image
    blur pass and the second per-keypoint gather disappear (they were two
    of the extractor's top stage costs).  Blur semantics inside the patch
    match the whole-image blur exactly away from image borders; at borders
    the clamped patch recenters (the same clamping policy the separate
    BRIEF path already had)."""
    H, W = img.shape
    if H < _BRIEF_SRC or W < _BRIEF_SRC:
        img = jnp.pad(img, ((0, max(0, _BRIEF_SRC - H)),
                            (0, max(0, _BRIEF_SRC - W))))
    src = _extract_patches(img, uv, _BRIEF_SRC)          # (N, 46, 46)
    # materialize the patch pull: XLA's producer fusion would otherwise
    # RE-GATHER the source patches inside every consumer
    src = jax.lax.optimization_barrier(src)
    center = src[:, _CENTER_OFF:_CENTER_OFF + _PATCH,
                 _CENTER_OFF:_CENTER_OFF + _PATCH]       # (N, 31, 31)
    wx = jnp.asarray(_disc_x * _DISC_MASK)
    wy = jnp.asarray(_disc_y * _DISC_MASK)
    m10 = jnp.einsum("nij,ij->n", center, wx)
    m01 = jnp.einsum("nij,ij->n", center, wy)
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    ang = jnp.where(ang < 0, ang + 360.0, ang)
    blur = _box_blur_patches(src)                        # (N, 40, 40)
    # same recompute hazard: the 30 static takes below must read ONE
    # materialized blur, not re-run the separable blur per bin
    blur = jax.lax.optimization_barrier(blur)
    bits = _brief_from_patches(
        blur.reshape(uv.shape[0], _BRIEF_PATCH * _BRIEF_PATCH), ang)
    return ang, bits


# ---------------------------------------------------------------------------
# the full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    uv: jax.Array        # (N, 2) level-0 pixel coords
    response: jax.Array  # (N,)
    octave: jax.Array    # (N,) int32
    angle: jax.Array     # (N,) degrees
    desc_bits: jax.Array  # (N, 256) int8
    valid: jax.Array     # (N,) bool


@functools.partial(
    jax.jit, static_argnames=("n_features", "levels", "scale_factor",
                              "threshold"),
)
def extract_orb(
    image: jax.Array,
    n_features: int = 1000,
    levels: int = 4,
    scale_factor: float = 1.2,
    threshold: float = 20.0,
):
    """Full ORB pipeline over an image pyramid.

    Args:
      image: (H, W) grayscale float32 in [0, 255].
    Returns OrbFeatures with n_features slots (coords in level-0 pixels).
    """
    out = extract_orb_batch(image[None], n_features, levels, scale_factor,
                            threshold)
    return OrbFeatures(*[x[0] for x in out])


@functools.partial(
    jax.jit, static_argnames=("n_features", "levels", "scale_factor",
                              "threshold"),
)
def extract_orb_batch(
    images: jax.Array,
    n_features: int = 1000,
    levels: int = 4,
    scale_factor: float = 1.2,
    threshold: float = 20.0,
):
    """Batched ORB: (B, H, W) images -> OrbFeatures with leading B.

    The throughput path of the front-end (the analog of the reference's
    CUDA extractor pipelining frames, FeatureDetector.cpp:28-42,119): a
    whole frame window is extracted in ONE dispatch — every stage (resize,
    FAST, NMS, selection, orientation, BRIEF) is batch-vectorized XLA, so
    per-dispatch overhead and small-op latency amortize over B frames.
    """
    B, H, W = images.shape
    # per-level feature budget ~ geometric (like the reference's
    # distribution over octaves)
    inv = [scale_factor ** (-i) for i in range(levels)]
    total = sum(inv)
    budgets = [max(int(round(n_features * v / total)), 8) for v in inv]
    budgets[0] += n_features - sum(budgets)

    # stage names (jax.named_scope) let a profiler trace attribute device
    # time to resize / fast / nms / select / orient_brief / compact
    all_feats = []
    imgs_l = images
    for lvl in range(levels):
        scale = scale_factor**lvl
        if lvl > 0:
            h = int(round(H / scale))
            w = int(round(W / scale))
            with jax.named_scope("resize"):
                imgs_l = _resize_matmul(images, h, w)
        with jax.named_scope("fast"):
            score, _ = jax.vmap(lambda im: fast_score(im, threshold))(imgs_l)
        with jax.named_scope("nms"):
            score = jax.vmap(nms3)(score)
        with jax.named_scope("select"):
            uv, resp, valid = jax.vmap(
                lambda s: select_keypoints(s, budgets[lvl])
            )(score)
        with jax.named_scope("orient_brief"):
            ang, bits = jax.vmap(orient_and_brief)(imgs_l, uv)
        all_feats.append(
            (uv * scale, resp,
             jnp.full(uv.shape[:2], lvl, dtype=jnp.int32), ang, bits, valid)
        )

    uv = jnp.concatenate([f[0] for f in all_feats], axis=1)
    resp = jnp.concatenate([f[1] for f in all_feats], axis=1)
    octv = jnp.concatenate([f[2] for f in all_feats], axis=1)
    ang = jnp.concatenate([f[3] for f in all_feats], axis=1)
    bits = jnp.concatenate([f[4] for f in all_feats], axis=1)
    valid = jnp.concatenate([f[5] for f in all_feats], axis=1)

    # compact to exactly n_features slots per frame, strongest first
    with jax.named_scope("compact"):
        order_key = jnp.where(valid, resp, -1.0)
        _, idx = jax.lax.top_k(order_key, n_features)  # (B, n_features)
        take = jax.vmap(lambda x, i: x[i])
        return OrbFeatures(
            uv=take(uv, idx), response=take(resp, idx),
            octave=take(octv, idx), angle=take(ang, idx),
            desc_bits=take(bits, idx), valid=take(valid, idx),
        )

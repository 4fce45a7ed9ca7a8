"""ORB front-end tests on rendered synthetic images."""

import numpy as np
import jax
import jax.numpy as jnp

from snakeslam_tpu.ops import orb as ORB
from snakeslam_tpu.ops.matching import knn2_ratio_match


def render_scene(rng, H=240, W=320, n_rects=40):
    """Gray background + random bright/dark rectangles (corner-rich)."""
    img = np.full((H, W), 128.0, dtype=np.float32)
    for _ in range(n_rects):
        h = rng.integers(8, 40)
        w = rng.integers(8, 40)
        y = rng.integers(0, H - h)
        x = rng.integers(0, W - w)
        val = rng.choice([40.0, 90.0, 170.0, 220.0])
        img[y:y + h, x:x + w] = val
    return img


def test_fast_detects_square_corners(rng):
    img = np.full((64, 64), 100.0, dtype=np.float32)
    img[20:40, 20:40] = 200.0
    score, corner = ORB.fast_score(jnp.asarray(img), 20.0)
    corner = np.asarray(corner)
    # corners of the square fire; flat regions and straight edges don't
    assert corner[20, 20] or corner[20, 21] or corner[21, 20]
    assert not corner[10, 10]      # flat
    assert not corner[20, 30]      # straight edge midpoint
    assert not corner[30, 30]      # interior


def _fast_oracle(img, threshold):
    """Per-pixel FAST-16 in plain numpy: a ring pixel is bright/dark past
    the threshold, a corner has 9 contiguous such pixels (circularly),
    and the score is the larger of the bright and dark SAD sums."""
    H, W = img.shape
    score = np.zeros((H, W), np.float32)
    corner = np.zeros((H, W), bool)
    c = img[3:H - 3, 3:W - 3]
    ring = np.stack([img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx]
                     for dx, dy in ORB.FAST_RING])            # (16, h, w)
    bright = ring > c + threshold
    dark = ring < c - threshold

    def arc9(m):
        m2 = np.concatenate([m, m[:8]])
        run = np.zeros(m.shape[1:], bool)
        for s0 in range(16):
            run |= m2[s0:s0 + 9].all(axis=0)
        return run

    is_c = arc9(bright) | arc9(dark)
    sb = np.where(bright, ring - c - threshold, 0.0).sum(axis=0)
    sd = np.where(dark, c - ring - threshold, 0.0).sum(axis=0)
    score[3:H - 3, 3:W - 3] = np.where(is_c, np.maximum(sb, sd), 0.0)
    corner[3:H - 3, 3:W - 3] = is_c
    return score, corner


def test_fast_score_matches_numpy_oracle(rng):
    """The XLA FAST stage against a plain numpy oracle at EuRoC size."""
    img = render_scene(rng, H=480, W=752, n_rects=300)
    img = img + rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    s_ref, c_ref = _fast_oracle(img, 20.0)
    s, c = ORB.fast_score(jnp.asarray(img), 20.0)
    assert c_ref.sum() > 500
    assert (np.asarray(c) == c_ref).all()
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-5, atol=1e-3)


def test_extract_orb_basic(rng):
    img = render_scene(rng)
    feats = ORB.extract_orb(jnp.asarray(img), n_features=300, levels=3)
    valid = np.asarray(feats.valid)
    assert valid.sum() > 100
    uv = np.asarray(feats.uv)[valid]
    assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 320).all()
    # spatial distribution: keypoints spread over at least half the cells
    cells = set(map(tuple, (uv // 64).astype(int)))
    assert len(cells) >= 8
    octv = np.asarray(feats.octave)[valid]
    assert octv.max() >= 1  # multiple pyramid levels contribute


def test_orb_descriptor_repeatability(rng):
    img = render_scene(rng, n_rects=60)
    shift = 5
    img2 = np.roll(img, shift, axis=1)
    f1 = ORB.extract_orb(jnp.asarray(img), n_features=300, levels=2)
    f2 = ORB.extract_orb(jnp.asarray(img2), n_features=300, levels=2)
    idx, dist = knn2_ratio_match(
        f1.desc_bits, f2.desc_bits, f1.valid, f2.valid,
        ratio=0.8, max_dist=60,
    )
    idx = np.asarray(idx)
    matched = np.nonzero(idx >= 0)[0]
    assert len(matched) > 40
    duv = np.asarray(f2.uv)[idx[matched]] - np.asarray(f1.uv)[matched]
    # the dominant displacement equals the shift
    med = np.median(duv, axis=0)
    assert abs(med[0] - shift) < 1.0
    assert abs(med[1]) < 1.0


def test_orientation_consistency(rng):
    # a gradient patch: rotating the image by 180 deg flips the centroid angle
    img = render_scene(rng, n_rects=30)
    f1 = ORB.extract_orb(jnp.asarray(img), n_features=100, levels=1)
    img_rot = img[::-1, ::-1].copy()
    f2 = ORB.extract_orb(jnp.asarray(img_rot), n_features=100, levels=1)
    idx, _ = knn2_ratio_match(
        f1.desc_bits, f2.desc_bits, f1.valid, f2.valid,
        ratio=0.8, max_dist=60,
    )
    idx = np.asarray(idx)
    matched = np.nonzero(idx >= 0)[0]
    assert len(matched) > 15
    a1 = np.asarray(f1.angle)[matched]
    a2 = np.asarray(f2.angle)[idx[matched]]
    d = np.abs(((a1 - a2 + 180.0) % 360.0) - 180.0)
    # angles should differ by ~180 deg for most matches
    assert np.median(np.abs(d - 180.0)) < 25.0 or np.median(d) > 150.0

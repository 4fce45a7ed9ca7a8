"""Batched feature matching kernels: projection matchers, knn, rotation filter.

JAX replacement for the reference's OMP-parallel matchers
(reference: Snake/Tracking/SnakeORBMatcher.{h,cpp}).  The reference's idiom —
parallel per-point candidate search into per-thread scratch followed by a
serial conflict-resolving commit pass (SnakeORBMatcher.cpp:321-332,508-525) —
maps here onto dense masked (P x N) score matrices (matrix products) plus a
segment-min commit: every gate (frustum, scale region, view-cos, per-octave
radius, stereo consistency, ratio test) becomes a broadcasted mask instead of
an early `continue`.

All shapes are static; invalid entries are masked.  Thresholds mirror the
reference exactly: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30
(SnakeORBMatcher.h:34-37).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops.descriptors import DESC_BITS, hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INVALID_DIST = 256


class FrameFeatures(NamedTuple):
    """Fixed-size device-side view of one frame's features (N slots)."""

    uv: jax.Array          # (N, 2) undistorted pixel coords
    right: jax.Array       # (N,) right-image x coord; < 0 if none
    octave: jax.Array      # (N,) int32
    angle: jax.Array       # (N,) degrees
    desc_bits: jax.Array   # (N, 256) {0,1}
    valid: jax.Array       # (N,) bool


class LocalMapPoints(NamedTuple):
    """Fixed-size device-side snapshot of local-map points (P slots).

    Mirrors the reference's LocalMap<FineTrackingPoint> payload
    (Snake/Map/LocalMap.h:17-79): local copies of position/normal/descriptor
    so matching runs without touching the map.
    """

    position: jax.Array    # (P, 3) world
    normal: jax.Array      # (P, 3) unit viewing normal
    desc_bits: jax.Array   # (P, 256)
    ref_depth: jax.Array   # (P,) reference depth for scale prediction
    ref_level: jax.Array   # (P,) int32 reference octave
    angle: jax.Array       # (P,) source keypoint angle (frame-frame matching)
    valid: jax.Array       # (P,) bool


class ScaleTables(NamedTuple):
    """Per-octave constants (static arrays baked into the jitted program)."""

    scales: jax.Array       # (L,)
    log_scale_factor: jax.Array
    levels: int

    @staticmethod
    def from_pyramid(pyr) -> "ScaleTables":
        return ScaleTables(
            scales=jnp.asarray(pyr.scales),
            log_scale_factor=jnp.asarray(pyr.log_scale_factor),
            levels=pyr.levels,
        )


def min_max_distance(st: ScaleTables, ref_depth, ref_level):
    """Scale-invariance region of a point (ORB-SLAM convention; reference
    gate MATCHING_MIN_MAX_DISTANCE2, SnakeORBMatcher.cpp:408-418)."""
    max_c = ref_depth * st.scales[jnp.clip(ref_level, 0, st.levels - 1)]
    min_d = 0.8 * max_c / st.scales[st.levels - 1]
    max_d = 1.2 * max_c
    return min_d, max_d


def predict_scale_level(st: ScaleTables, ref_depth, ref_level, dist):
    """Predicted octave of a point re-observed at distance `dist`."""
    max_c = ref_depth * st.scales[jnp.clip(ref_level, 0, st.levels - 1)]
    ratio = jnp.maximum(max_c / jnp.maximum(dist, 1e-9), 1e-9)
    level = jnp.ceil(jnp.log(ratio) / st.log_scale_factor)
    return jnp.clip(level, 0, st.levels - 1).astype(jnp.int32)


def _resolve_matches(best_feat: jax.Array, best_dist: jax.Array,
                     point_ok: jax.Array, n_features: int):
    """Conflict-resolving commit: each feature accepts the best point.

    The reference's serial commit is first-wins (SnakeORBMatcher.cpp:508-525);
    we resolve by minimum descriptor distance (strictly better) with point
    index as tie-break, via a segment-min scatter.

    Returns:
      feat_point: (N,) int32 — winning point index per feature, -1 if none.
    """
    P = best_feat.shape[0]
    seg = jnp.where(point_ok, best_feat, n_features)
    key = best_dist.astype(jnp.int32) * (P + 1) + jnp.arange(P, dtype=jnp.int32)
    key = jnp.where(point_ok, key, jnp.iinfo(jnp.int32).max)
    seg_min = jax.ops.segment_min(key, seg, num_segments=n_features + 1)
    winner = point_ok & (key == seg_min[seg])
    feat_point = jnp.full((n_features,), -1, dtype=jnp.int32)
    scatter_idx = jnp.where(winner, best_feat, n_features)
    feat_point = feat_point.at[scatter_idx].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop"
    )
    return feat_point


def _common_point_gates(lm: LocalMapPoints, frame: FrameFeatures, pose_cw,
                        cam: Pinhole, image_bounds, eps=1e-6):
    """Shared projection gates: frustum, image bounds, view-cos.

    Returns uv_p (P,2), z (P,), dist (P,), view_cos (P,), in_view (P,).
    """
    xmin, ymin, xmax, ymax = image_bounds
    pc = lie.transform_points(pose_cw, lm.position)
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < eps, eps, z)
    uv_p = jnp.stack(
        [pc[..., 0] / zs * cam.fx + cam.cx, pc[..., 1] / zs * cam.fy + cam.cy],
        axis=-1,
    )
    cam_pos = lie.translation(lie.se3_inverse(pose_cw))
    po = cam_pos[None, :] - lm.position
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * lm.normal, axis=-1) / jnp.maximum(dist, eps)
    in_view = (
        lm.valid
        & (z > 0)
        & (uv_p[:, 0] >= xmin) & (uv_p[:, 0] < xmax)
        & (uv_p[:, 1] >= ymin) & (uv_p[:, 1] < ymax)
    )
    return uv_p, z, dist, view_cos, in_view


def _candidate_mask(uv_p, z, radius, frame: FrameFeatures, oct_min, oct_max,
                    bf, feat_free):
    """(P, N) candidate gate: radius, octave window, stereo consistency."""
    d2 = jnp.sum((uv_p[:, None, :] - frame.uv[None, :, :]) ** 2, axis=-1)
    in_radius = d2 < (radius[:, None] ** 2)
    oct_ok = (frame.octave[None, :] >= oct_min[:, None]) & (
        frame.octave[None, :] <= oct_max[:, None]
    )
    # stereo right-point consistency (SnakeORBMatcher.cpp:476-486):
    # expected u_r = u - bf / z ; reject if |expected - measured| > r/2
    expected_ur = uv_p[:, 0:1] - bf / jnp.maximum(z[:, None], 1e-6)
    has_right = frame.right[None, :] > 0
    stereo_ok = jnp.where(
        has_right,
        jnp.abs(expected_ur - frame.right[None, :]) <= radius[:, None] * 0.5,
        True,
    )
    return in_radius & oct_ok & stereo_ok & frame.valid[None, :] & feat_free[None, :]


def search_by_projection_fine(
    lm: LocalMapPoints,
    frame: FrameFeatures,
    pose_cw: jax.Array,
    cam: Pinhole,
    bf: jax.Array,
    image_bounds,
    st: ScaleTables,
    feat_free: jax.Array,
    th: float = 1.0,
    ratio: float = 0.9,
    feature_error: int = TH_HIGH,
):
    """Local-map-point -> frame matching for fine tracking.

    Mirrors SearchByProjection2 (reference: SnakeORBMatcher.cpp:365-526):
    frustum + scale-region + view-cos gates, viewing-cos radius, predicted
    octave window, best/second-best with level-aware ratio test, TH_HIGH cut
    (``feature_error`` tightens the cut — loop verification re-search uses
    50, SnakeORBMatcher::SearchByProjectionFrameToKeyframe callers).

    Args:
      feat_free: (N,) bool — feature has no map point yet.
    Returns dict with:
      feat_point (N,) int32 assignment (-1 = none), visible (P,) bool mask
      (for the found/visible statistics), n_matches scalar.
    """
    uv_p, z, dist, view_cos, in_view = _common_point_gates(
        lm, frame, pose_cw, cam, image_bounds
    )
    min_d, max_d = min_max_distance(st, lm.ref_depth, lm.ref_level)
    in_region = (dist >= min_d) & (dist <= max_d)
    visible = in_view & in_region & (view_cos >= 0.5)

    pred = predict_scale_level(st, lm.ref_depth, lm.ref_level, dist)
    r = jnp.where(view_cos > 0.998, 2.5, 4.0) * th * st.scales[pred]

    cand = _candidate_mask(uv_p, z, r, frame, pred - 1, pred + 1, bf, feat_free)
    cand = cand & visible[:, None]

    H = hamming_matrix(lm.desc_bits, frame.desc_bits)
    Hm = jnp.where(cand, H, INVALID_DIST)

    best = jnp.min(Hm, axis=1)
    best_idx = jnp.argmin(Hm, axis=1).astype(jnp.int32)
    # second best (mask out the best column per row)
    Hm2 = Hm.at[jnp.arange(Hm.shape[0]), best_idx].set(INVALID_DIST)
    best2 = jnp.min(Hm2, axis=1)
    best2_idx = jnp.argmin(Hm2, axis=1).astype(jnp.int32)
    lvl1 = frame.octave[best_idx]
    lvl2 = frame.octave[best2_idx]

    ok = (best <= feature_error) & visible
    # ratio applies only when best & second-best share an octave
    # (SnakeORBMatcher.cpp:508-512)
    same_level = (lvl1 == lvl2) & (best2 < INVALID_DIST)
    ok = ok & jnp.where(same_level, best.astype(jnp.float32)
                        <= ratio * best2.astype(jnp.float32), True)

    feat_point = _resolve_matches(best_idx, best, ok, frame.uv.shape[0])
    return {
        "feat_point": feat_point,
        "visible": visible,
        "n_matches": jnp.sum(feat_point >= 0),
    }


def search_by_projection_coarse(
    lm: LocalMapPoints,
    frame: FrameFeatures,
    pose_cw: jax.Array,
    cam: Pinhole,
    bf: jax.Array,
    image_bounds,
    st: ScaleTables,
    feat_free: jax.Array,
    th: float,
    feature_error: int = TH_HIGH,
    forward: jax.Array | None = None,
    backward: jax.Array | None = None,
    use_rotation_hist: bool = True,
):
    """Frame-to-frame projection matching for coarse tracking.

    Mirrors SearchByProjectionFrameFrame2 (reference:
    SnakeORBMatcher.cpp:191-354): radius = th * scale(last octave), octave
    window from forward/backward motion, best-only (no ratio), rotation
    histogram consistency keeping the top-3 bins.
    """
    uv_p, z, dist, view_cos, in_view = _common_point_gates(
        lm, frame, pose_cw, cam, image_bounds
    )
    visible = in_view & (view_cos >= 0.5)

    last_lvl = lm.ref_level
    r = th * st.scales[jnp.clip(last_lvl, 0, st.levels - 1)]
    if forward is None:
        forward = jnp.zeros((), dtype=bool)
    if backward is None:
        backward = jnp.zeros((), dtype=bool)
    oct_min = jnp.where(forward, last_lvl - 1,
                        jnp.where(backward, 0, last_lvl - 1))
    oct_max = jnp.where(forward, 100,
                        jnp.where(backward, last_lvl, last_lvl + 1))
    oct_min = jnp.broadcast_to(oct_min, last_lvl.shape)
    oct_max = jnp.broadcast_to(oct_max, last_lvl.shape)

    cand = _candidate_mask(uv_p, z, r, frame, oct_min, oct_max, bf, feat_free)
    cand = cand & visible[:, None]

    H = hamming_matrix(lm.desc_bits, frame.desc_bits)
    Hm = jnp.where(cand, H, INVALID_DIST)
    best = jnp.min(Hm, axis=1)
    best_idx = jnp.argmin(Hm, axis=1).astype(jnp.int32)
    ok = (best <= feature_error) & visible

    feat_point = _resolve_matches(best_idx, best, ok, frame.uv.shape[0])

    if use_rotation_hist:
        feat_point = rotation_consistency_filter(
            feat_point, lm.angle, frame.angle
        )
    return {
        "feat_point": feat_point,
        "visible": visible,
        "n_matches": jnp.sum(feat_point >= 0),
    }


def rotation_consistency_filter(feat_point: jax.Array, point_angle: jax.Array,
                                feat_angle: jax.Array) -> jax.Array:
    """Keep only matches whose angle difference lands in the top-3 of a
    30-bin histogram (reference: SnakeORBMatcher.cpp:27-68,334-351).

    Args:
      feat_point: (N,) int32 point index per feature (-1 = unmatched).
      point_angle: (P,) source angles (deg); feat_angle: (N,) target angles.
    """
    matched = feat_point >= 0
    pidx = jnp.maximum(feat_point, 0)
    rot = point_angle[pidx] - feat_angle
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    bin_ = jnp.round(rot * (HISTO_LENGTH / 360.0)).astype(jnp.int32)
    bin_ = jnp.where(bin_ >= HISTO_LENGTH, 0, bin_)
    bin_ = jnp.clip(bin_, 0, HISTO_LENGTH - 1)
    seg = jnp.where(matched, bin_, HISTO_LENGTH)
    counts = jax.ops.segment_sum(
        jnp.ones_like(seg), seg, num_segments=HISTO_LENGTH + 1
    )[:HISTO_LENGTH]
    top3 = jax.lax.top_k(counts, 3)[0]
    thresh = top3[2]
    # ComputeThreeMaxima also zeroes bins whose count < 0.1 * max
    keep_bin = (counts >= jnp.maximum(thresh, 1)) & (
        counts.astype(jnp.float32) >= 0.1 * top3[0].astype(jnp.float32)
    )
    keep = matched & keep_bin[jnp.clip(bin_, 0, HISTO_LENGTH - 1)]
    return jnp.where(keep, feat_point, -1)


@functools.partial(jax.jit, static_argnames=("ratio", "max_dist",
                                              "cross_check"))
def _knn2_jit(bits_a, bits_b, valid_a, valid_b, ratio, max_dist,
              cross_check):
    return knn2_ratio_match(bits_a, bits_b, valid_a, valid_b,
                            ratio=ratio, max_dist=max_dist,
                            cross_check=cross_check)


def knn2_ratio_match_np(bits_a, bits_b, ratio: float = 0.8,
                        max_dist: int = TH_LOW, cross_check: bool = True,
                        bucket: int = 256):
    """Host front door for brute-force 2-NN matching on ragged inputs.

    Pads both sides to ``bucket`` multiples and jits, so repeated calls
    with varying keypoint counts reuse ONE compile per shape bucket.
    Loop detection calls brute-force matching once per (keyframe,
    candidate) pair with that pair's exact point counts — unpadded that
    is a fresh XLA executable per pair, and a compile storm measured at
    ~140 s per 55 tracked frames on the loop-closure workload (every
    hamming_matrix/argmin shape was new).  bits are (N, 256) {0,1}
    host arrays; returns host (idx into b or -1, dist) of length
    len(bits_a)."""
    na, nb = len(bits_a), len(bits_b)
    pa = -(-max(na, 1) // bucket) * bucket
    pb = -(-max(nb, 1) // bucket) * bucket
    a = np.zeros((pa, DESC_BITS), dtype=np.uint8)
    a[:na] = bits_a
    b = np.zeros((pb, DESC_BITS), dtype=np.uint8)
    b[:nb] = bits_b
    idx, dist = _knn2_jit(
        jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(np.arange(pa) < na), jnp.asarray(np.arange(pb) < nb),
        ratio=float(ratio), max_dist=int(max_dist),
        cross_check=bool(cross_check))
    from snakeslam_tpu.utils.fetch import fetch_list

    idx, dist = fetch_list([idx, dist])   # one round trip, not two
    return idx[:na], dist[:na]


def knn2_ratio_match_packed_np(packed_a: np.ndarray, packed_b: np.ndarray,
                               ratio: float = 0.8, max_dist: int = TH_LOW,
                               cross_check: bool = True):
    """Pure-HOST 2-NN Hamming matching on PACKED (n, 32) uint8 descriptors
    via the hardware popcount (np.bitwise_count over 4 uint64 lanes).

    Same contract as knn2_ratio_match_np, but never touches the device:
    loop detection calls brute-force matching once per (keyframe,
    candidate) pair, and each device call pays a blocking dispatch +
    fetch.  (The device path remains right when the operands already live
    in device memory.)"""
    na, nb = len(packed_a), len(packed_b)
    if na == 0 or nb == 0:
        return (np.full(na, -1, dtype=np.int32),
                np.full(na, INVALID_DIST, dtype=np.int32))
    a64 = np.ascontiguousarray(packed_a).view(np.uint64)   # (na, 4)
    b64 = np.ascontiguousarray(packed_b).view(np.uint64)   # (nb, 4)
    dist = np.bitwise_count(
        a64[:, None, :] ^ b64[None, :, :]
    ).sum(axis=-1).astype(np.int32)                        # (na, nb)
    ar = np.arange(na)
    j1 = dist.argmin(axis=1).astype(np.int32)
    d1 = dist[ar, j1]
    if cross_check:
        rev = dist.argmin(axis=0).astype(np.int32)         # best a per b
    if nb > 1:
        saved = d1.copy()
        dist[ar, j1] = INVALID_DIST
        d2 = dist.min(axis=1)
        dist[ar, j1] = saved
    else:
        d2 = np.full(na, INVALID_DIST, dtype=np.int32)
    ok = (d1 <= max_dist) & (d1.astype(np.float32) <= ratio * d2)
    if cross_check:
        ok &= rev[j1] == ar
    idx = np.where(ok, j1, -1).astype(np.int32)
    return idx, d1


def knn2_ratio_match(bits_a, bits_b, valid_a, valid_b, ratio: float = 0.8,
                     max_dist: int = TH_LOW, cross_check: bool = True):
    """Brute-force 2-NN Hamming matching with ratio test.

    Replacement for saiga's BruteForceMatcher::matchKnn2_omp + filterMatches
    (reference: Snake/Tracking/TrackingCoarse.cpp:350-352).

    Returns (match_idx (Na,) int32 into b or -1, match_dist (Na,) int32).
    """
    H = hamming_matrix(bits_a, bits_b)
    Hm = jnp.where(valid_a[:, None] & valid_b[None, :], H, INVALID_DIST)
    best = jnp.min(Hm, axis=1)
    best_idx = jnp.argmin(Hm, axis=1).astype(jnp.int32)
    Hm2 = Hm.at[jnp.arange(Hm.shape[0]), best_idx].set(INVALID_DIST)
    best2 = jnp.min(Hm2, axis=1)
    ok = (best <= max_dist) & (
        best.astype(jnp.float32) <= ratio * best2.astype(jnp.float32)
    )
    if cross_check:
        rev_best_idx = jnp.argmin(Hm, axis=0).astype(jnp.int32)
        ok = ok & (rev_best_idx[best_idx] == jnp.arange(Hm.shape[0]))
    return jnp.where(ok, best_idx, -1), jnp.where(ok, best, INVALID_DIST)

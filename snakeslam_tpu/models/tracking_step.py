"""Jitted per-frame tracking megasteps: coarse and fine.

These are the flagship device programs of the framework — each one fuses
projection matching + robust pose GN + outlier classification into a single
XLA computation so the per-frame loop does exactly two device dispatches
(reference equivalents: Tracking::TrackCoarse at
Snake/Tracking/TrackingCoarse.cpp:150-341 and Tracking::TrackFine/computePose
at Snake/Tracking/TrackingFine.cpp:20-217, where each stage is a separate
OMP-parallel matcher pass followed by a CPU GN solve).

All inputs are fixed-shape; scalars arrive as 0-d jnp arrays so shapes (and
the compiled program) never change between frames.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops import matching as M
from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine

# tracking constants (reference: Snake/Tracking/Tracking.h:181-189)
COARSE_MIN_INLIERS_LAST_FRAME = 20
FINE_MIN_PROJECTION_MATCHES = 25
COARSE_FEATURE_TH = 75  # descriptor gate (TrackingCoarse.cpp:205)


def _weights_from_octave(octave, inv_scales):
    """Observation weight = 1/scale(octave) (PoseRefinement.h:52-53)."""
    return inv_scales[jnp.clip(octave, 0, inv_scales.shape[0] - 1)]


@functools.partial(jax.jit, static_argnames=("use_rotation_hist",))
def coarse_step(
    lm: M.LocalMapPoints,
    frame: M.FrameFeatures,
    T_pred: jax.Array,
    cam: Pinhole,
    bf: jax.Array,
    image_bounds: jax.Array,      # (4,) xmin ymin xmax ymax
    scales: jax.Array,            # (L,)
    log_scale_factor: jax.Array,
    radius: jax.Array,            # () coarse search radius (15 mono / 10 stereo)
    prior_weight_rotation: jax.Array,
    prior_weight_translation: jax.Array,
    use_rotation_hist: bool = True,
):
    """Coarse tracking: frame-frame projection match + robust pose refine.

    Returns dict: T (4,4), assign (N,) local point idx per feature (-1 =
    none), inlier (N,), n_matches, n_inliers, ok (bool).
    """
    st = M.ScaleTables(scales=scales, log_scale_factor=log_scale_factor,
                       levels=scales.shape[0])
    bounds = (image_bounds[0], image_bounds[1], image_bounds[2], image_bounds[3])

    out1 = M.search_by_projection_coarse(
        lm, frame, T_pred, cam, bf, bounds, st,
        feat_free=frame.valid, th=radius,
        feature_error=COARSE_FEATURE_TH,
        use_rotation_hist=use_rotation_hist,
    )
    # retry with doubled radius when too few matches
    # (TrackingCoarse.cpp:252-258)
    out2 = M.search_by_projection_coarse(
        lm, frame, T_pred, cam, bf, bounds, st,
        feat_free=frame.valid, th=2.0 * radius,
        feature_error=COARSE_FEATURE_TH,
        use_rotation_hist=use_rotation_hist,
    )
    retry = out1["n_matches"] < COARSE_MIN_INLIERS_LAST_FRAME
    assign = jnp.where(retry, out2["feat_point"], out1["feat_point"])
    n_matches = jnp.where(retry, out2["n_matches"], out1["n_matches"])

    matched = assign >= 0
    pidx = jnp.clip(assign, 0, lm.position.shape[0] - 1)
    obs = PoseObs(
        points=lm.position[pidx],
        uv=frame.uv,
        right=frame.right,
        weight=_weights_from_octave(frame.octave, 1.0 / scales),
        mask=matched,
    )
    T, inlier, n_inl = robust_pose_refine(
        T_pred, obs, cam, bf,
        prior_T=T_pred,
        prior_weight_rotation=prior_weight_rotation,
        prior_weight_translation=prior_weight_translation,
    )
    assign = jnp.where(inlier, assign, -1)
    ok = (n_matches >= COARSE_MIN_INLIERS_LAST_FRAME) & (
        n_inl >= COARSE_MIN_INLIERS_LAST_FRAME
    )
    # single flat output: one device->host transfer per frame, since each
    # transfer costs latency regardless of its size
    N = frame.uv.shape[0]
    packed = jnp.concatenate([
        T.reshape(-1).astype(jnp.float32),                    # [0:16]
        jnp.stack([
            n_matches.astype(jnp.float32),
            n_inl.astype(jnp.float32),
            ok.astype(jnp.float32),
        ]),                                                    # [16:19]
        assign.astype(jnp.float32),                            # [19:19+N]
    ])
    return {
        "T": T,
        "assign": assign,
        "inlier": inlier,
        "n_matches": n_matches,
        "n_inliers": n_inl,
        "ok": ok,
        "packed": packed,
    }


@jax.jit
def fine_step(
    lm: M.LocalMapPoints,
    frame: M.FrameFeatures,
    T_coarse: jax.Array,
    coarse_pos: jax.Array,        # (N, 3) positions of coarse-matched points
    coarse_matched: jax.Array,    # (N,) bool
    cam: Pinhole,
    bf: jax.Array,
    image_bounds: jax.Array,
    scales: jax.Array,
    log_scale_factor: jax.Array,
    th: jax.Array,                # fine search th (5 mono / 4 stereo)
    prior_T: jax.Array,
    prior_weight_rotation: jax.Array,
    prior_weight_translation: jax.Array,
):
    """Fine tracking: local-map projection match + pose refine + stats.

    Returns dict: T, fine_assign (N,), inlier (N,), n_inliers, visible (P,)
    and found (P,) masks for the found/visible point statistics
    (reference: TrackingFine.cpp:140-217).
    """
    st = M.ScaleTables(scales=scales, log_scale_factor=log_scale_factor,
                       levels=scales.shape[0])
    bounds = (image_bounds[0], image_bounds[1], image_bounds[2], image_bounds[3])

    out = M.search_by_projection_fine(
        lm, frame, T_coarse, cam, bf, bounds, st,
        feat_free=frame.valid & (~coarse_matched),
        th=th, ratio=0.8,
    )
    fine_assign = out["feat_point"]
    fine_matched = fine_assign >= 0
    pidx = jnp.clip(fine_assign, 0, lm.position.shape[0] - 1)
    pos = jnp.where(coarse_matched[:, None], coarse_pos, lm.position[pidx])
    matched = coarse_matched | fine_matched
    obs = PoseObs(
        points=pos,
        uv=frame.uv,
        right=frame.right,
        weight=_weights_from_octave(frame.octave, 1.0 / scales),
        mask=matched,
    )
    T, inlier, n_inl = robust_pose_refine(
        T_coarse, obs, cam, bf,
        prior_T=prior_T,
        prior_weight_rotation=prior_weight_rotation,
        prior_weight_translation=prior_weight_translation,
    )
    # found/visible statistics for the fine local map
    visible = out["visible"]
    P = lm.position.shape[0]
    found = jnp.zeros((P,), dtype=bool).at[
        jnp.where(fine_matched & inlier, fine_assign, P)
    ].set(True, mode="drop")
    fine_assign_out = jnp.where(inlier, fine_assign, -1)
    N = frame.uv.shape[0]
    P = lm.position.shape[0]
    packed = jnp.concatenate([
        T.reshape(-1).astype(jnp.float32),                    # [0:16]
        n_inl.astype(jnp.float32)[None],                      # [16]
        fine_assign_out.astype(jnp.float32),                  # [17:17+N]
        inlier.astype(jnp.float32),                           # [+N]
        visible.astype(jnp.float32),                          # [+P]
        found.astype(jnp.float32),                            # [+P]
    ])
    return {
        "T": T,
        "fine_assign": fine_assign_out,
        "inlier": inlier,
        "matched": matched,
        "n_inliers": n_inl,
        "visible": visible,
        "found": found,
        "packed": packed,
    }

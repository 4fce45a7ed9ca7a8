"""Batched epipolar matching + triangulation between keyframe pairs.

JAX replacement for the reference's Triangulator inner loop
(reference: Snake/LocalMapping/Triangulator.cpp:113-294 — per KF-pair
epipolar BoW-bucketed search, parallax arbitration, DLT, two-sided chi2 and
scale-consistency gates) and MappingORBMatcher::SearchForTriangulation2
(Snake/LocalMapping/MappingORBMatcher.cpp:14-102).  The whole candidate
matrix per pair is evaluated densely as matrix products; the 10-neighbor fan-out is a
vmap over pairs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops.descriptors import hamming_matrix
from snakeslam_tpu.ops.matching import FrameFeatures
from snakeslam_tpu.ops.triangulation import triangulate_homogeneous
from snakeslam_tpu.ops.twoview import essential_matrix, epipolar_distance_squared

FEATURE_DISTANCE = 50     # Triangulator params (LocalMapping.cpp:317-329)
EPIPOLAR_DISTANCE = 4.0   # px
ERROR_MONO = 2.1
ERROR_STEREO = 2.3


def _normalized(cam: Pinhole, uv):
    return jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy],
        axis=-1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("feature_distance", "epipolar_distance", "error_mono",
                     "error_stereo", "bounds_wh"),
)
def triangulate_pair(
    feats_a: FrameFeatures,
    feats_b: FrameFeatures,
    free_a: jax.Array,          # (N,) feature has no map point yet
    free_b: jax.Array,
    T_a: jax.Array,             # (4, 4) world->cam
    T_b: jax.Array,
    cam: Pinhole,
    bf: jax.Array,
    scales: jax.Array,          # (L,)
    inv_sigma2: jax.Array,      # (L,)
    feature_distance: int = FEATURE_DISTANCE,
    epipolar_distance: float = EPIPOLAR_DISTANCE,
    error_mono: float = ERROR_MONO,
    grid_a: jax.Array | None = None,   # (GH, GW) depth grid for image a
    bounds_wh: tuple = (752.0, 480.0),
    error_stereo: float = ERROR_STEREO,
    th_depth: jax.Array | float = 1e9,  # far-point threshold (settings)
):
    """Match unmatched features across one KF pair and triangulate.

    Returns dict with per-A-feature arrays:
      match_b (N,) int32 (-1 = none), point (N, 3) world, valid (N,) bool.
    """
    N = feats_a.uv.shape[0]

    # relative geometry: E maps so that xn_a^T E xn_b = 0, with
    # T_ab = T_a @ T_b^-1 (cam_b -> cam_a)
    T_ab = T_a @ lie.se3_inverse(T_b)
    E = essential_matrix(T_ab)

    xn_a = _normalized(cam, feats_a.uv)
    xn_b = _normalized(cam, feats_b.uv)

    # pairwise gates
    H = hamming_matrix(feats_a.desc_bits, feats_b.desc_bits)
    # symmetric epipolar line distance for ALL pairs, in pixels
    ones_a = jnp.ones((N, 1), dtype=xn_a.dtype)
    h_a = jnp.concatenate([xn_a, ones_a], axis=1)          # (N, 3)
    h_b = jnp.concatenate([xn_b, jnp.ones_like(ones_a)], axis=1)
    l_b = h_a @ E                                          # (N, 3) line in b
    val = l_b @ h_b.T                                      # (N, M)
    l_a = h_b @ E.T                                        # (M, 3) line in a
    da2 = val**2 / jnp.maximum(
        (l_a[:, 0] ** 2 + l_a[:, 1] ** 2)[None, :], 1e-12
    )
    db2 = val**2 / jnp.maximum(
        (l_b[:, 0] ** 2 + l_b[:, 1] ** 2)[:, None], 1e-12
    )
    focal2 = cam.fx * cam.fy
    epi_px2 = 0.5 * (da2 + db2) * focal2                   # (N, M) pixels^2

    oct_ok = jnp.abs(
        feats_a.octave[:, None] - feats_b.octave[None, :]
    ) <= 1
    pair_ok = (
        (H <= feature_distance)
        & (epi_px2 <= epipolar_distance**2)
        & oct_ok
        & (free_a & feats_a.valid)[:, None]
        & (free_b & feats_b.valid)[None, :]
    )
    Hm = jnp.where(pair_ok, H, 256)
    best = jnp.min(Hm, axis=1)
    best_idx = jnp.argmin(Hm, axis=1).astype(jnp.int32)
    matched = best <= feature_distance

    # mutual best check (each b feature claimed once)
    rev_best = jnp.argmin(Hm, axis=0).astype(jnp.int32)
    matched = matched & (rev_best[best_idx] == jnp.arange(N))

    if grid_a is not None:
        # depth-guided second tier (SearchForTriangulationProject,
        # MappingORBMatcher.cpp:168-250): features the epipolar-best pass
        # left unmatched retry within a 20 px window around where the
        # depth-completion grid predicts them in image b — the depth prior
        # breaks repeated-texture ambiguity along the epipolar line.
        GH, GW = grid_a.shape
        gx = jnp.clip((feats_a.uv[:, 0] / bounds_wh[0] * GW)
                      .astype(jnp.int32), 0, GW - 1)
        gy = jnp.clip((feats_a.uv[:, 1] / bounds_wh[1] * GH)
                      .astype(jnp.int32), 0, GH - 1)
        z = grid_a[gy, gx]
        has_z = z > 1e-6
        # unproject feature a at grid depth, express in cam b, project
        Pa = jnp.concatenate([xn_a * z[:, None], z[:, None]], axis=1)
        Pb = lie.transform_points(lie.se3_inverse(T_ab), Pa)
        zb_pred = jnp.maximum(Pb[:, 2], 1e-6)
        uv_pred = jnp.stack(
            [cam.fx * Pb[:, 0] / zb_pred + cam.cx,
             cam.fy * Pb[:, 1] / zb_pred + cam.cy], axis=1)
        win2 = jnp.sum(
            (feats_b.uv[None, :, :] - uv_pred[:, None, :]) ** 2, axis=-1)
        proj_ok = (win2 <= 20.0**2) & (has_z & (Pb[:, 2] > 0))[:, None]
        # b features claimed by the first tier stay claimed
        claimed = jnp.zeros(feats_b.uv.shape[0], dtype=bool
                            ).at[best_idx].max(matched)
        Hm2 = jnp.where(pair_ok & proj_ok & ~claimed[None, :], H, 256)
        best2 = jnp.min(Hm2, axis=1)
        best_idx2 = jnp.argmin(Hm2, axis=1).astype(jnp.int32)
        matched2 = (~matched) & (best2 <= feature_distance)
        best_idx = jnp.where(matched2, best_idx2, best_idx)
        matched = matched | matched2

    xb = xn_b[best_idx]

    # ---- stereo-parallax arbitration (Triangulator.cpp:199-263) --------
    # Per endpoint, the stereo measurement's own parallax angle
    # 2*atan2(baseline/2, depth) competes with the pair's ray parallax:
    # DLT only when the rays beat the better stereo measurement; otherwise
    # the point is unprojected directly from that endpoint's depth (close
    # geometry where two-view triangulation is worse than the disparity).
    disp_a = feats_a.uv[:, 0] - feats_a.right
    z_a = jnp.where(feats_a.right > 0, bf / jnp.maximum(disp_a, 1e-6), -1.0)
    disp_b = feats_b.uv[:, 0] - feats_b.right
    z_b_all = jnp.where(feats_b.right > 0, bf / jnp.maximum(disp_b, 1e-6),
                        -1.0)
    z_b = z_b_all[best_idx]
    stereo1 = z_a > 0
    stereo2 = z_b > 0
    baseline = bf / cam.fx

    # ray parallax in world space (from the unprojected directions, not
    # the triangulated point — Triangulator.cpp:189-198)
    ray1 = h_a @ T_a[:3, :3]                    # R_a^T xn1
    h_b_m = h_b[best_idx]
    ray2 = h_b_m @ T_b[:3, :3]
    cos_rays = jnp.sum(ray1 * ray2, axis=1) / jnp.maximum(
        jnp.linalg.norm(ray1, axis=1) * jnp.linalg.norm(ray2, axis=1), 1e-12
    )
    no_stereo = cos_rays + 1.0                  # "worse than any parallax"
    cos_st1 = jnp.where(
        stereo1, jnp.cos(2.0 * jnp.arctan2(baseline / 2.0,
                                           jnp.maximum(z_a, 1e-6))),
        no_stereo,
    )
    # reference quirk kept verbatim: stereo2's angle is only computed when
    # endpoint 1 has no stereo (the `else if`, Triangulator.cpp:204-207)
    cos_st2 = jnp.where(
        (~stereo1) & stereo2,
        jnp.cos(2.0 * jnp.arctan2(baseline / 2.0, jnp.maximum(z_b, 1e-6))),
        no_stereo,
    )
    cos_st = jnp.minimum(cos_st1, cos_st2)

    use_dlt = ((cos_rays < cos_st) & (cos_rays > 0)
               & (stereo1 | stereo2 | (cos_rays < 0.9998)))
    use_s1 = (~use_dlt) & stereo1 & (cos_st1 < cos_st2)
    use_s2 = (~use_dlt) & (~use_s1) & stereo2 & (cos_st2 < cos_st1)
    tri_ok = use_dlt | use_s1 | use_s2

    X_dlt = triangulate_homogeneous(
        jnp.broadcast_to(T_a, (N, 4, 4)),
        jnp.broadcast_to(T_b, (N, 4, 4)),
        xn_a, xb,
    )
    zs_a = jnp.maximum(z_a, 1e-6)
    X_s1 = lie.transform_points(
        lie.se3_inverse(T_a),
        jnp.concatenate([xn_a * zs_a[:, None], zs_a[:, None]], axis=1),
    )
    zs_b = jnp.maximum(z_b, 1e-6)
    X_s2 = lie.transform_points(
        lie.se3_inverse(T_b),
        jnp.concatenate([xb * zs_b[:, None], zs_b[:, None]], axis=1),
    )
    X = jnp.where(use_s1[:, None], X_s1,
                  jnp.where(use_s2[:, None], X_s2, X_dlt))
    far_away = (use_s1 & (z_a > th_depth)) | (use_s2 & (z_b > th_depth))

    # gates (Triangulator.cpp:239-283)
    pa = lie.transform_points(T_a, X)
    pb = lie.transform_points(T_b, X)
    za, zb = pa[:, 2], pb[:, 2]
    front = (za > 1e-3) & (zb > 1e-3)

    # two-sided chi2 with per-octave sigma; stereo-visible endpoints get
    # the 3-dof projectStereo residual and the stereo threshold
    # (Triangulator.cpp:247-270)
    zsa = jnp.where(front, za, 1.0)
    zsb = jnp.where(front, zb, 1.0)
    ua = jnp.stack([cam.fx * pa[:, 0] / zsa + cam.cx,
                    cam.fy * pa[:, 1] / zsa + cam.cy], axis=1)
    ub = jnp.stack([cam.fx * pb[:, 0] / zsb + cam.cx,
                    cam.fy * pb[:, 1] / zsb + cam.cy], axis=1)
    La = jnp.clip(feats_a.octave, 0, scales.shape[0] - 1)
    Lb = jnp.clip(feats_b.octave[best_idx], 0, scales.shape[0] - 1)
    er_a = (ua[:, 0] - bf / zsa) - feats_a.right
    er_b = (ub[:, 0] - bf / zsb) - feats_b.right[best_idx]
    ea2 = (jnp.sum((ua - feats_a.uv) ** 2, axis=1)
           + jnp.where(stereo1, er_a**2, 0.0)) * inv_sigma2[La]
    eb2 = (jnp.sum((ub - feats_b.uv[best_idx]) ** 2, axis=1)
           + jnp.where(stereo2, er_b**2, 0.0)) * inv_sigma2[Lb]
    th_a = jnp.where(stereo1, error_stereo**2, error_mono**2)
    th_b = jnp.where(stereo2, error_stereo**2, error_mono**2)
    chi_ok = (ea2 <= th_a) & (eb2 <= th_b)

    # scale consistency: distance ratio must match octave scale ratio
    # (orientation matches the reference: the FARTHER endpoint sees the
    # feature at a FINER octave, Triangulator.cpp:277-283)
    ca = lie.translation(lie.se3_inverse(T_a))
    cb = lie.translation(lie.se3_inverse(T_b))
    dist_a = jnp.linalg.norm(X - ca, axis=1)
    dist_b = jnp.linalg.norm(X - cb, axis=1)
    ratio_dist = dist_a / jnp.maximum(dist_b, 1e-9)
    ratio_oct = scales[Lb] / scales[La]
    factor = 1.5 * scales[1] if scales.shape[0] > 1 else 1.8
    scale_ok = (ratio_dist < ratio_oct * factor) & (
        ratio_dist * factor > ratio_oct
    )

    valid = matched & tri_ok & front & chi_ok & scale_ok
    return {
        "match_b": jnp.where(valid, best_idx, -1),
        "point": X,
        "valid": valid,
        "far_away": valid & far_away,
        "n_new": jnp.sum(valid),
    }


# vmapped fan-out over neighbor pairs: feats_b/T_b/free_b get a leading dim
triangulate_pairs_batch = jax.jit(
    jax.vmap(
        triangulate_pair,
        in_axes=(None, 0, None, 0, None, 0, None, None, None, None),
    )
)


def stereo_depth_parallax(bf, fx, depth):
    """cos of the stereo measurement's own parallax angle (numpy oracle
    helper for tests): cos(2 atan2(baseline/2, depth))."""
    import numpy as np

    return np.cos(2.0 * np.arctan2((bf / fx) / 2.0, depth))

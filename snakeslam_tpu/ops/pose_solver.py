"""Robust pose-only Gauss-Newton solvers + RANSAC PnP, jit-compiled.

JAX replacement for saiga's ``RobustPoseOptimization`` /
``RobustSmoothPoseOptimization`` (reference: Snake/Tracking/PoseRefinement.h:
9-10,102-103) and ``P3PRansac`` (reference: Snake/Tracking/TrackingCoarse.cpp:
410-422).  All residuals for a frame are evaluated as one batched array; the
6x6 normal equations are built with einsum reductions and solved
densely.  Outlier classification between GN rounds mirrors the reference's
chi2 thresholds (mono 2.1 px / stereo 2.3 px, Snake/System/SnakeGlobal.h:
145-146) applied to scale-weighted residuals.

Conventions:
  - Poses are world->camera SE3 (4, 4) matrices.
  - Update is left-multiplicative: T <- exp(delta) @ T.
  - `weight` per observation = 1/scale(octave) (sqrt of inverse sigma^2,
    matching PoseRefinement.h:52-53).
  - Stereo observations carry a right-image x coordinate (u_r); mono
    observations have u_r < 0 and use 2D residuals only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops.linalg import solve6x6_psd


class PoseObs(NamedTuple):
    """Fixed-size observation block for pose-only optimization (M slots)."""

    points: jax.Array   # (M, 3) world points
    uv: jax.Array       # (M, 2) measured pixels
    right: jax.Array    # (M,) measured right-image x; < 0 => mono
    weight: jax.Array   # (M,) = 1/scale(octave)
    mask: jax.Array     # (M,) bool valid slot


def _residuals_jacobians(T, obs: PoseObs, cam: Pinhole, bf):
    """Per-observation residuals (M, 3) and Jacobians (M, 3, 6).

    Third residual row is the stereo disparity term, zeroed for mono obs.
    """
    pc = lie.transform_points(T, obs.points)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = z > 1e-4
    zs = jnp.where(z_ok, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - bf * iz

    has_stereo = obs.right > 0
    r = jnp.stack(
        [u - obs.uv[:, 0], v - obs.uv[:, 1],
         jnp.where(has_stereo, ur - obs.right, 0.0)],
        axis=1,
    )

    # d(pc)/d(delta) with left perturbation: [I | -hat(pc)]  (M, 3, 6)
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    dpc = jnp.stack(
        [
            jnp.stack([ones, zeros, zeros, zeros, z, -y], axis=1),
            jnp.stack([zeros, ones, zeros, -z, zeros, x], axis=1),
            jnp.stack([zeros, zeros, ones, y, -x, zeros], axis=1),
        ],
        axis=1,
    )
    # projection Jacobian rows (M, 3, 3): du/dpc, dv/dpc, dur/dpc
    Jp = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], axis=1),
            jnp.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], axis=1),
            jnp.stack([cam.fx * iz, zeros, (-cam.fx * x + bf) * iz2], axis=1),
        ],
        axis=1,
    )
    J = Jp @ dpc  # (M, 3, 6)
    J = jnp.where(has_stereo[:, None, None],
                  J, J.at[:, 2, :].set(0.0))
    valid = obs.mask & z_ok
    return r, J, valid, has_stereo


def _chi2(r, obs: PoseObs, has_stereo):
    """Scale-weighted squared error per observation: |w * r|^2 (stereo uses
    all 3 rows, mono the first 2)."""
    w2 = obs.weight**2
    e2 = jnp.where(has_stereo, jnp.sum(r * r, axis=1),
                   r[:, 0] ** 2 + r[:, 1] ** 2)
    return w2 * e2


def robust_pose_refine(
    T_init: jax.Array,
    obs: PoseObs,
    cam: Pinhole,
    bf: jax.Array,
    chi2_mono: float = 2.1**2,
    chi2_stereo: float = 2.3**2,
    outer_iters: int = 4,
    inner_iters: int = 3,
    prior_T: jax.Array | None = None,
    prior_weight_rotation: jax.Array | float = 0.0,
    prior_weight_translation: jax.Array | float = 0.0,
    damping: float = 1e-5,
):
    """Robust pose-only GN with interleaved outlier classification.

    Structure mirrors saiga's RobustPoseOptimization: `outer_iters` rounds of
    (GN on current inliers with Huber kernel) -> (re-classify outliers by
    chi2).  The optional motion prior adds a 6-dof residual
    log(T @ prior_T^-1) with split rotation/translation weights
    (RobustSmoothPoseOptimization; weights from
    Snake/Tracking/StatePredictor.cpp:150-151).

    Returns (T_refined, inlier_mask (M,), n_inliers).
    """
    use_prior = prior_T is not None
    if not use_prior:
        prior_T = jnp.eye(4, dtype=T_init.dtype)
    w_rot = jnp.asarray(prior_weight_rotation, dtype=T_init.dtype)
    w_trans = jnp.asarray(prior_weight_translation, dtype=T_init.dtype)
    prior_T_inv = lie.se3_inverse(prior_T)

    delta_huber_mono = jnp.sqrt(chi2_mono)
    delta_huber_stereo = jnp.sqrt(chi2_stereo)

    def gn_step(T, inlier):
        r, J, valid, has_stereo = _residuals_jacobians(T, obs, cam, bf)
        w = obs.weight
        # Huber on the weighted residual norm
        e = jnp.sqrt(_chi2(r, obs, has_stereo) + 1e-12)
        delta_h = jnp.where(has_stereo, delta_huber_stereo, delta_huber_mono)
        huber = jnp.minimum(1.0, delta_h / e)
        w_total = jnp.where(valid & inlier, w * w * huber, 0.0)
        H = jnp.einsum("mki,m,mkj->ij", J, w_total, J)
        b = jnp.einsum("mki,m,mk->i", J, w_total, r)
        if use_prior:
            # residual log(T * prior^-1): J ~ I6 near the prior
            r_p = lie.se3_log(T @ prior_T_inv)
            w_p = jnp.concatenate(
                [jnp.full((3,), w_trans), jnp.full((3,), w_rot)]
            ).astype(T.dtype)
            H = H + jnp.diag(w_p)
            b = b + w_p * r_p
        H = H + damping * jnp.eye(6, dtype=T.dtype)
        # closed-form 6x6 block solve: fuses into the GN step instead of an
        # LU custom call, whose fixed cost dominates this tiny solve
        delta = solve6x6_psd(H, b)
        return lie.orthonormalize(lie.se3_exp(-delta) @ T)

    def outer(carry):
        T, inlier = carry
        for _ in range(inner_iters):
            T = gn_step(T, inlier)
        r, J, valid, has_stereo = _residuals_jacobians(T, obs, cam, bf)
        chi2 = _chi2(r, obs, has_stereo)
        th = jnp.where(has_stereo, chi2_stereo, chi2_mono)
        inlier = valid & (chi2 <= th)
        return T, inlier

    # the iteration counts are small static values, so the rounds UNROLL:
    # inside the window-track scan a lax loop would pay per-iteration
    # control overhead hundreds of times per window, and unrolling lets
    # XLA fuse across GN steps (measured: the while-op overhead was the
    # single largest slice of window_track device time)
    carry = (lie.orthonormalize(T_init), obs.mask)
    for _ in range(outer_iters):
        carry = outer(carry)
    T, inlier = carry
    return T, inlier, jnp.sum(inlier)


# ---------------------------------------------------------------------------
# RANSAC PnP (DLT-6 hypotheses + GN polish)
# ---------------------------------------------------------------------------

def _dlt_pnp(points: jax.Array, bearings: jax.Array):
    """Direct linear transform pose from >=6 2D-3D correspondences.

    Args:
      points: (S, 3) world points; bearings: (S, 2) normalized image coords.
    Returns (4, 4) world->camera pose (orthogonalized).
    """
    S = points.shape[0]
    X = jnp.concatenate([points, jnp.ones((S, 1), dtype=points.dtype)], axis=1)
    zeros = jnp.zeros_like(X)
    u = bearings[:, 0:1]
    v = bearings[:, 1:2]
    rows_u = jnp.concatenate([X, zeros, -u * X], axis=1)
    rows_v = jnp.concatenate([zeros, X, -v * X], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # (2S, 12)
    # null vector of A via smallest right singular vector
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    p = Vt[-1].reshape(3, 4)
    # fix sign & scale: det(R-part) > 0 and unit rotation via SVD projection
    M = p[:, :3]
    Um, Dm, Vmt = jnp.linalg.svd(M)
    scale = jnp.mean(Dm)
    R = Um @ Vmt
    detR = jnp.linalg.det(R)
    R = R * detR  # flip if reflection (det = -1)
    t = p[:, 3] / scale * detR
    # cheirality fix: majority of points must be in front
    pc_z = (points @ R.T + t)[:, 2]
    flip = jnp.sum(pc_z > 0) < (S / 2)
    R = jnp.where(flip, -R, R)
    t = jnp.where(flip, -t, t)
    return lie.se3(R, t)


def pnp_ransac(
    points: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    cam: Pinhole,
    key: jax.Array,
    n_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_threshold_px: float = 4.0,
    min_depth: float = 1e-3,
):
    """Batched RANSAC PnP.

    Replacement for the reference's P3PRansac fallback tracking
    (Snake/Tracking/TrackingCoarse.cpp:416-422; 250 OMP-parallel iterations
    there -> vmapped hypothesis batch here).  Hypotheses use 6-point DLT; the
    winner should be polished with `robust_pose_refine`.

    Returns (best_T, inlier_mask, n_inliers).
    """
    M = points.shape[0]
    bearings = cam.unproject_pixels(uv)

    # weighted sampling without masked entries: sample indices from valid set
    # via Gumbel top-k trick per hypothesis
    logits = jnp.where(mask, 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (n_hypotheses, M), minval=1e-9, maxval=1.0)
    ))
    _, sample_idx = jax.lax.top_k(logits[None, :] + gumbel, sample_size)

    def solve_one(idx):
        return _dlt_pnp(points[idx], bearings[idx])

    Ts = jax.vmap(solve_one)(sample_idx)  # (H, 4, 4)

    # score all hypotheses against all points
    pc = jnp.einsum("hij,mj->hmi", Ts[:, :3, :3], points) + Ts[:, None, :3, 3]
    z = pc[..., 2]
    zs = jnp.where(z > min_depth, z, 1.0)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (z > min_depth) & (err2 < inlier_threshold_px**2) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    return Ts[best], inl[best], scores[best]


def pnp_refine_np(obs_pts, obs_uv, cam, bf, key, n_hypotheses: int = 256,
                  bucket: int = 256):
    """Host front door: PnP RANSAC + robust refine on a shape-bucketed pad.

    Recovery paths (relocalization, brute-force re-track) call PnP with
    that attempt's exact match count — every new count would compile a
    fresh executable, and losses tend to happen in bursts.  Pads to
    ``bucket`` multiples (mask=False rows are inert in both solvers) so
    all attempts share one compile per bucket.

    Returns (n0, T, inlier (n,) bool np, n_inl) with n = len(obs_pts)."""
    import numpy as np

    n = len(obs_pts)
    p = -(-max(n, 1) // bucket) * bucket
    pts = np.zeros((p, 3), dtype=np.float32)
    pts[:n] = obs_pts
    uv = np.zeros((p, 2), dtype=np.float32)
    uv[:n] = obs_uv
    n0, T, inlier, n_inl = _pnp_refine_jit(
        jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(np.arange(p) < n),
        cam, jnp.float32(bf), key, n_hypotheses)
    return int(n0), T, np.asarray(inlier)[:n], int(n_inl)


@functools.partial(jax.jit, static_argnames=("n_hypotheses",))
def _pnp_refine_jit(pts, uv, mask, cam, bf, key, n_hypotheses):
    T0, _, n0 = pnp_ransac(pts, uv, mask, cam, key,
                           n_hypotheses=n_hypotheses)
    obs = PoseObs(
        points=pts, uv=uv,
        right=jnp.full(pts.shape[0], -1.0, dtype=jnp.float32),
        weight=jnp.ones(pts.shape[0], dtype=jnp.float32), mask=mask,
    )
    T, inlier, n_inl = robust_pose_refine(T0, obs, cam, bf)
    return n0, T, inlier, n_inl

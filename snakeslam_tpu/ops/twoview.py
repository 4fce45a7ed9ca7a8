"""Two-view reconstruction: 8-point essential RANSAC, homography RANSAC,
pose recovery, and the epipolar distance helpers.

JAX replacement for saiga's ``TwoViewReconstruction[EightPoint]`` and
``HomographyRansac`` (reference: Snake/Tracking/Initialization/
MonoInitializer.h:10-11,147-152 and MonoInitializer.cpp:134-263), and for
``EssentialMatrix`` / ``EpipolarDistanceSquared`` (reference:
Snake/LocalMapping/Triangulator.cpp:9,159).  Hypotheses are solved as one
batched SVD; scoring is a dense (H, N) evaluation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.ops.triangulation import triangulate_homogeneous


# ---------------------------------------------------------------------------
# epipolar geometry helpers
# ---------------------------------------------------------------------------

def essential_matrix(T12: jax.Array) -> jax.Array:
    """E from relative pose T12 = T1 @ T2^-1 mapping cam2 -> cam1.

    Convention: x1^T E x2 = 0 for normalized homogeneous coords.
    With T_12 = (R, t) taking points from cam2 to cam1: E = [t]x R.
    """
    R = T12[..., :3, :3]
    t = T12[..., :3, 3]
    return lie.hat(t) @ R


def epipolar_distance_squared(E: jax.Array, xn1: jax.Array, xn2: jax.Array):
    """Symmetric epipolar (Sampson-free, line-distance) squared error.

    xn1, xn2: (..., 2) normalized coords with x1^T E x2 = 0 convention.
    Returns squared distance of x1 to line E x2 plus x2 to line E^T x1,
    averaged (same as saiga's EpipolarDistanceSquared usage).
    """
    ones = jnp.ones(xn1.shape[:-1] + (1,), dtype=xn1.dtype)
    h1 = jnp.concatenate([xn1, ones], axis=-1)
    h2 = jnp.concatenate([xn2, ones], axis=-1)
    l1 = h2 @ jnp.swapaxes(E, -1, -2)  # line in image 1
    l2 = h1 @ E                        # line in image 2
    val = jnp.sum(h1 * l1, axis=-1)
    d1 = val**2 / jnp.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    d2 = val**2 / jnp.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    return 0.5 * (d1 + d2)


# ---------------------------------------------------------------------------
# 8-point essential + pose recovery
# ---------------------------------------------------------------------------

def _eight_point(xn1: jax.Array, xn2: jax.Array,
                 weights: jax.Array | None = None) -> jax.Array:
    """Essential matrix from >=8 normalized correspondences.

    Solves min |A e| (optionally row-weighted/masked) then projects onto the
    essential manifold (singular values (1, 1, 0)).
    """
    x1, y1 = xn1[:, 0], xn1[:, 1]
    x2, y2 = xn2[:, 0], xn2[:, 1]
    o = jnp.ones_like(x1)
    # x1^T E x2 = 0 rows, e row-major
    A = jnp.stack(
        [x1 * x2, x1 * y2, x1, y1 * x2, y1 * y2, y1, x2, y2, o], axis=1
    )
    if weights is not None:
        AtA = A.T @ (A * weights[:, None])
    else:
        AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    E = V[:, 0].reshape(3, 3)
    U, _, Vt = jnp.linalg.svd(E)
    return U @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], dtype=E.dtype)) @ Vt


def decompose_essential(E: jax.Array):
    """E -> 4 candidate relative poses T12 (cam2->cam1), |t| = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    U = U * jnp.sign(d)  # make R proper
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return jnp.stack(
        [lie.se3(R1, t), lie.se3(R1, -t), lie.se3(R2, t), lie.se3(R2, -t)]
    )


def essential_ransac(
    xn1: jax.Array,
    xn2: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    n_hypotheses: int = 256,
    threshold: float = 1.5e-5,
):
    """Batched 8-point RANSAC on normalized correspondences.

    threshold is a squared epipolar distance in normalized coords
    (1.5e-5 ~ (1.7px / 450px focal)^2, the usual mono-init gate).

    Returns (E_best, inlier_mask, n_inliers).
    """
    N = xn1.shape[0]
    logits = jnp.where(mask, 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (n_hypotheses, N), minval=1e-9, maxval=1.0)
    ))
    _, sample_idx = jax.lax.top_k(logits[None, :] + gumbel, 8)

    Es = jax.vmap(lambda idx: _eight_point(xn1[idx], xn2[idx]))(sample_idx)
    d2 = jax.vmap(lambda E: epipolar_distance_squared(E, xn1, xn2))(Es)
    inl = (d2 < threshold) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    E, inliers = Es[best], inl[best]

    # polish: re-solve the 8-point system on the full inlier set (2 rounds)
    def refine(_, carry):
        E, inliers = carry
        E = _eight_point(xn1, xn2, weights=inliers.astype(xn1.dtype))
        d2 = epipolar_distance_squared(E, xn1, xn2)
        return E, (d2 < threshold) & mask

    E, inliers = jax.lax.fori_loop(0, 2, refine, (E, inliers))
    return E, inliers, jnp.sum(inliers)


def recover_pose_from_essential(
    E: jax.Array,
    xn1: jax.Array,
    xn2: jax.Array,
    inliers: jax.Array,
    min_parallax_cos: float = 0.99998,
):
    """Choose the relative pose among the 4 E-decompositions by cheirality.

    Triangulates all inlier matches under each candidate; picks the pose
    maximizing points in front of both cameras with finite parallax.

    Frame convention here: camera 1 at identity; candidate T2 = T12^-1 is the
    world->cam2 pose.  Returns (T2 (4,4), points (N,3), good_mask (N,)).
    """
    cands = decompose_essential(E)  # T12: cam2->cam1

    T1 = jnp.eye(4, dtype=E.dtype)

    def eval_cand(T12):
        T2 = lie.se3_inverse(T12)  # world(=cam1) -> cam2
        X = triangulate_homogeneous(
            jnp.broadcast_to(T1, (xn1.shape[0], 4, 4)),
            jnp.broadcast_to(T2, (xn1.shape[0], 4, 4)),
            xn1,
            xn2,
        )
        z1 = X[..., 2]
        z2 = lie.transform_points(T2, X)[..., 2]
        # parallax: rays from the two camera centers
        c2 = lie.translation(lie.se3_inverse(T2))
        r1 = X
        r2 = X - c2
        pcos = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
        )
        good = inliers & (z1 > 0) & (z2 > 0) & (pcos < min_parallax_cos)
        return jnp.sum(good), T2, X, good

    scores, T2s, Xs, goods = jax.vmap(eval_cand)(cands)
    best = jnp.argmax(scores)
    return T2s[best], Xs[best], goods[best]


# ---------------------------------------------------------------------------
# homography RANSAC (planar degeneracy test for mono init)
# ---------------------------------------------------------------------------

def _dlt_homography(xn1: jax.Array, xn2: jax.Array) -> jax.Array:
    """H from 4 correspondences (xn1 = H xn2), normalized coords."""
    x1, y1 = xn1[:, 0], xn1[:, 1]
    x2, y2 = xn2[:, 0], xn2[:, 1]
    o = jnp.ones_like(x1)
    z = jnp.zeros_like(x1)
    r1 = jnp.stack([x2, y2, o, z, z, z, -x1 * x2, -x1 * y2, -x1], axis=1)
    r2 = jnp.stack([z, z, z, x2, y2, o, -y1 * x2, -y1 * y2, -y1], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (8, 9)
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    return V[:, 0].reshape(3, 3)


def homography_ransac(
    xn1: jax.Array,
    xn2: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    n_hypotheses: int = 128,
    threshold: float = 2e-5,
):
    """Batched 4-point homography RANSAC; returns (H, inlier_mask, count).

    Used as the reference uses HomographyRansac: reject mono initialization
    when the scene is planar/rotation-only (high homography-inlier ratio,
    MonoInitializer.cpp:250-263).
    """
    N = xn1.shape[0]
    logits = jnp.where(mask, 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (n_hypotheses, N), minval=1e-9, maxval=1.0)
    ))
    _, sample_idx = jax.lax.top_k(logits[None, :] + gumbel, 4)
    Hs = jax.vmap(lambda idx: _dlt_homography(xn1[idx], xn2[idx]))(sample_idx)

    ones = jnp.ones((N, 1), dtype=xn1.dtype)
    h2 = jnp.concatenate([xn2, ones], axis=1)

    def score(H):
        p = h2 @ H.T
        w = jnp.where(jnp.abs(p[:, 2]) < 1e-12, 1e-12, p[:, 2])
        proj = p[:, :2] / w[:, None]
        return jnp.sum((proj - xn1) ** 2, axis=1)

    d2 = jax.vmap(score)(Hs)
    inl = (d2 < threshold) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    return Hs[best], inl[best], scores[best]

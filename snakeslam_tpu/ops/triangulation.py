"""Batched two-view triangulation (homogeneous DLT).

JAX replacement for saiga's ``TriangulateHomogeneous``
(reference: Snake/LocalMapping/Triangulator.cpp:10,220).  Each candidate
match triangulates independently — a (B, 4, 4) batched SVD/eigen solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie


def triangulate_homogeneous(T1: jax.Array, T2: jax.Array, xn1: jax.Array,
                            xn2: jax.Array) -> jax.Array:
    """DLT triangulation in normalized camera coordinates.

    Args:
      T1, T2: (..., 4, 4) world->camera poses.
      xn1, xn2: (..., 2) normalized image coords in camera 1 / 2.
    Returns:
      (..., 3) world points (may be behind either camera; callers gate).
    """
    P1 = T1[..., :3, :]  # (..., 3, 4)
    P2 = T2[..., :3, :]
    rows = jnp.stack(
        [
            xn1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            xn1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            xn2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            xn2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # (..., 4, 4)
    # inhomogeneous DLT: fix w = 1 (finite points; far points come out
    # large and the callers' chi2/parallax/scale gates handle them) and
    # solve the 3x3 normal equations min ||A3 x + b|| in closed form.
    # A batched 4x4 eigh lowers to an iterative solver; the cofactor
    # solve is pure elementwise arithmetic and fuses with the rest of the
    # program.
    A3 = rows[..., :3]                         # (..., 4, 3)
    b = rows[..., 3]                           # (..., 4)
    N = jnp.swapaxes(A3, -1, -2) @ A3          # (..., 3, 3)
    g = -jnp.einsum("...ki,...k->...i", A3, b)  # (..., 3)
    n00, n01, n02 = N[..., 0, 0], N[..., 0, 1], N[..., 0, 2]
    n11, n12, n22 = N[..., 1, 1], N[..., 1, 2], N[..., 2, 2]
    c00 = n11 * n22 - n12 * n12
    c01 = n02 * n12 - n01 * n22
    c02 = n01 * n12 - n02 * n11
    c11 = n00 * n22 - n02 * n02
    c12 = n01 * n02 - n00 * n12
    c22 = n00 * n11 - n01 * n01
    det = n00 * c00 + n01 * c01 + n02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    x = (c00 * g[..., 0] + c01 * g[..., 1] + c02 * g[..., 2]) * inv_det
    y = (c01 * g[..., 0] + c11 * g[..., 1] + c12 * g[..., 2]) * inv_det
    z = (c02 * g[..., 0] + c12 * g[..., 1] + c22 * g[..., 2]) * inv_det
    return jnp.stack([x, y, z], axis=-1)


def depths_in_cameras(T1, T2, Xw):
    """Depths of world points in both cameras (for cheirality gates)."""
    z1 = lie.transform_points(T1, Xw)[..., 2]
    z2 = lie.transform_points(T2, Xw)[..., 2]
    return z1, z2


def reprojection_error_normalized(T, Xw, xn):
    """Squared reprojection error in normalized coords."""
    pc = lie.transform_points(T, Xw)
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    return jnp.sum((proj - xn) ** 2, axis=-1), z


def parallax_cos(T1, T2, Xw):
    """Cosine of the ray parallax angle at each point."""
    c1 = lie.translation(lie.se3_inverse(T1))
    c2 = lie.translation(lie.se3_inverse(T2))
    r1 = Xw - c1[..., None, :] if Xw.ndim > c1.ndim else Xw - c1
    r2 = Xw - c2[..., None, :] if Xw.ndim > c2.ndim else Xw - c2
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    return jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)

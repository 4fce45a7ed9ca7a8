"""Small-matrix linear algebra for SLAM problem sizes.

XLA lowers ``jnp.linalg.inv`` / ``jnp.linalg.solve`` to LU custom calls
whose fixed overhead can dwarf the arithmetic at SLAM problem sizes (their
cost on the GPU is not measured yet).  Every normal-equation matrix in
this codebase is symmetric positive (semi-)definite after damping, so the
closed-form adjugate (3x3) and Cholesky (anything bigger) fuse with the
surrounding program and are at least as stable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 3, 3) matrices via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def solve3x3(A: jax.Array, b: jax.Array) -> jax.Array:
    """(..., 3, 3) @ x = (..., 3) via the closed-form inverse."""
    return (inv3x3(A) @ b[..., None])[..., 0]


def solve6x6_psd(H: jax.Array, b: jax.Array) -> jax.Array:
    """Closed-form (..., 6, 6) PSD solve via 3x3 block Schur complement.

    Pure elementwise arithmetic (adjugate 3x3 inverses), so it fuses into
    the surrounding XLA computation — unlike the Cholesky/LU custom calls
    whose fixed launch overhead dominates a single 6x6 solve.  This is the
    per-frame pose-GN step solve inside the window-track scan, where it
    runs hundreds of times per window.
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    A_inv = inv3x3(A)
    BtAi = jnp.swapaxes(B, -1, -2) @ A_inv          # B^T A^-1
    S = D - BtAi @ B
    x2 = (inv3x3(S) @ (b2 - (BtAi @ b1[..., None])[..., 0])[..., None])[..., 0]
    x1 = (A_inv @ (b1 - (B @ x2[..., None])[..., 0])[..., None])[..., 0]
    return jnp.concatenate([x1, x2], axis=-1)


def solve_psd(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for symmetric positive-definite A via Cholesky.

    b may be (..., N) or (..., N, K); A is (..., N, N).
    """
    L = jnp.linalg.cholesky(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
    return x[..., 0] if vec else x

"""Sim3/SE3 registration RANSAC from 3D-3D correspondences.

JAX replacement for saiga's ``RegistrationProjectRANSAC`` used in
loop-closure geometric verification (reference: Snake/LoopClosing/
LoopDetector.cpp:148-206): batched minimal Horn/Umeyama hypotheses over
matched map-point pairs, scored by 3D consistency, then polished on the
inlier set.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def umeyama_jax(src: jax.Array, dst: jax.Array, weights: jax.Array,
                with_scale: bool = True):
    """Weighted Umeyama alignment dst ~ s R src + t (differentiable/batched).

    Args:
      src, dst: (N, 3); weights: (N,) >= 0.
    Returns (s, R (3,3), t (3,)).
    """
    w = weights / jnp.maximum(jnp.sum(weights), 1e-9)
    mu_s = jnp.einsum("n,ni->i", w, src)
    mu_d = jnp.einsum("n,ni->i", w, dst)
    xs = src - mu_s
    xd = dst - mu_d
    cov = jnp.einsum("n,ni,nj->ij", w, xd, xs)
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], dtype=src.dtype)).at[2, 2].set(
        jnp.sign(det)
    )
    R = U @ S @ Vt
    if with_scale:
        var_s = jnp.einsum("n,ni,ni->", w, xs, xs)
        s = jnp.sum(D * jnp.diag(S)) / jnp.maximum(var_s, 1e-12)
    else:
        s = jnp.ones((), dtype=src.dtype)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "with_scale"))
def sim3_ransac(
    src: jax.Array,          # (N, 3) points in source frame
    dst: jax.Array,          # (N, 3) corresponding points in target frame
    mask: jax.Array,         # (N,)
    key: jax.Array,
    n_hypotheses: int = 128,
    threshold: float = 0.1,  # 3D consistency threshold (target units)
    with_scale: bool = True,
):
    """Returns (s, R, t, inlier_mask, n_inliers) with dst ~ s R src + t."""
    N = src.shape[0]
    logits = jnp.where(mask, 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (n_hypotheses, N), minval=1e-9, maxval=1.0)
    ))
    _, sample_idx = jax.lax.top_k(logits[None, :] + gumbel, 3)

    def solve_one(idx):
        w = jnp.ones(3, dtype=src.dtype)
        return umeyama_jax(src[idx], dst[idx], w, with_scale=with_scale)

    s_h, R_h, t_h = jax.vmap(solve_one)(sample_idx)
    pred = s_h[:, None, None] * jnp.einsum("hij,nj->hni", R_h, src) \
        + t_h[:, None, :]
    err = jnp.linalg.norm(pred - dst[None], axis=-1)
    inl = (err < threshold) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)

    # polish on the inlier set (2 rounds)
    def refine(_, carry):
        s, R, t, inliers = carry
        s, R, t = umeyama_jax(src, dst, inliers.astype(src.dtype),
                              with_scale=with_scale)
        pred = s * (src @ R.T) + t
        err = jnp.linalg.norm(pred - dst, axis=-1)
        return s, R, t, (err < threshold) & mask

    s, R, t, inliers = jax.lax.fori_loop(
        0, 2, refine, (s_h[best], R_h[best], t_h[best], inl[best])
    )
    return s, R, t, inliers, jnp.sum(inliers)

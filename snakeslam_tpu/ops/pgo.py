"""Pose-graph optimization over SE3 or Sim3, jit-compiled Gauss-Newton.

JAX replacement for EigenRecursive's ``PGORec`` / ``PGOSim3Rec``
(reference: Snake/LoopClosing/LoopClosingPGO.cpp:7-10,120-150): vertices are
keyframe poses, edges are relative-pose measurements (spanning tree +
covisibility + loop closure); the Sim3 variant absorbs monocular scale
drift.  The normal equations are assembled densely by scatter-adding
per-edge blocks (the graph is small: V <= ~1000) and solved with one dense
factorization — batched block work instead of sparse recursion.

Conventions: poses are world->camera (Sim3 poses carry sR); measurement
edge_T approximates T_j @ T_i^-1; residual = log(T_j T_i^-1 edge_T^-1);
update is T <- exp(delta) @ T.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.ops.linalg import solve3x3, solve_psd


class PoseGraph(NamedTuple):
    poses: jax.Array       # (V, 4, 4)
    fixed: jax.Array       # (V,) bool
    valid: jax.Array       # (V,) bool
    edge_i: jax.Array      # (E,) int32
    edge_j: jax.Array      # (E,) int32
    edge_T: jax.Array      # (E, 4, 4) measured relative pose
    edge_weight: jax.Array  # (E,)
    edge_valid: jax.Array  # (E,)


def sim3_adjoint(S: jax.Array) -> jax.Array:
    """Adjoint of Sim3 for tangent order (v, w, sigma): (..., 7, 7)."""
    s = lie.sim3_scale(S)
    R = lie.sim3_rotation(S)
    t = S[..., :3, 3]
    sR = s[..., None, None] * R
    tR = lie.hat(t) @ R
    z3 = jnp.zeros_like(R)
    top = jnp.concatenate([sR, tR, -t[..., :, None]], axis=-1)
    mid = jnp.concatenate(
        [z3, R, jnp.zeros_like(t)[..., :, None]], axis=-1
    )
    bot = jnp.concatenate(
        [jnp.zeros_like(t), jnp.zeros_like(t),
         jnp.ones_like(s)[..., None]], axis=-1
    )[..., None, :]
    return jnp.concatenate([top, mid, bot], axis=-2)


@functools.partial(jax.jit, static_argnames=("iterations", "use_sim3"))
def solve_pgo(graph: PoseGraph, iterations: int = 20,
              use_sim3: bool = False, damping: float = 1e-6):
    """Gauss-Newton on the pose graph. Returns (poses, final_cost)."""
    V = graph.poses.shape[0]
    D = 7 if use_sim3 else 6
    dtype = graph.poses.dtype
    free = (graph.valid & (~graph.fixed)).astype(dtype)

    log_fn = lie.sim3_log if use_sim3 else lie.se3_log
    exp_fn = lie.sim3_exp if use_sim3 else lie.se3_exp
    inv_fn = lie.sim3_inverse if use_sim3 else lie.se3_inverse
    adj_fn = sim3_adjoint if use_sim3 else _se3_adjoint

    edge_T_inv = inv_fn(graph.edge_T)
    i = jnp.clip(graph.edge_i, 0, V - 1)
    j = jnp.clip(graph.edge_j, 0, V - 1)
    w = jnp.where(graph.edge_valid, graph.edge_weight, 0.0)

    def residuals(poses):
        Ti = poses[i]
        Tj = poses[j]
        rel = Tj @ inv_fn(Ti)
        r = log_fn(rel @ edge_T_inv)
        return r, rel

    def gn_iter(_, carry):
        poses, cost = carry
        r, rel = residuals(poses)
        # J wrt delta_j ~ I; wrt delta_i = -Ad(rel)
        Jj = jnp.broadcast_to(jnp.eye(D, dtype=dtype), (r.shape[0], D, D))
        Ji = -adj_fn(rel)

        Hii = jnp.einsum("eki,e,ekl->eil", Ji, w, Ji)
        Hjj = jnp.einsum("eki,e,ekl->eil", Jj, w, Jj)
        Hij = jnp.einsum("eki,e,ekl->eil", Ji, w, Jj)
        gi = jnp.einsum("eki,e,ek->ei", Ji, w, r)
        gj = jnp.einsum("eki,e,ek->ei", Jj, w, r)

        H = jnp.zeros((V * V, D * D), dtype=dtype)
        pair_ii = i * V + i
        pair_jj = j * V + j
        pair_ij = i * V + j
        pair_ji = j * V + i
        H = H.at[pair_ii].add(Hii.reshape(-1, D * D))
        H = H.at[pair_jj].add(Hjj.reshape(-1, D * D))
        H = H.at[pair_ij].add(Hij.reshape(-1, D * D))
        H = H.at[pair_ji].add(
            jnp.swapaxes(Hij, -1, -2).reshape(-1, D * D)
        )
        g = jnp.zeros((V, D), dtype=dtype)
        g = g.at[i].add(gi)
        g = g.at[j].add(gj)

        H = H.reshape(V, V, D, D)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        diag_boost = (1.0 - free)[:, None, None] * jnp.eye(D, dtype=dtype)
        H = H.at[jnp.arange(V), jnp.arange(V)].add(
            diag_boost + damping * jnp.eye(D, dtype=dtype)
        )
        g = g * free[:, None]

        Hd = jnp.swapaxes(H, 1, 2).reshape(V * D, V * D)
        delta = -solve_psd(Hd, g.reshape(-1)).reshape(V, D)
        delta = delta * free[:, None]
        new_poses = jax.vmap(lambda d, T: exp_fn(d) @ T)(delta, poses)
        if not use_sim3:
            new_poses = lie.orthonormalize(new_poses)
        r2, _ = residuals(new_poses)
        new_cost = jnp.sum(w * jnp.sum(r2 * r2, axis=-1))
        accept = new_cost < cost
        poses = jnp.where(accept, new_poses, poses)
        cost = jnp.where(accept, new_cost, cost)
        return poses, cost

    r0, _ = residuals(graph.poses)
    cost0 = jnp.sum(w * jnp.sum(r0 * r0, axis=-1))
    poses, cost = jax.lax.fori_loop(
        0, iterations, gn_iter, (graph.poses, cost0)
    )
    return poses, cost


def _se3_adjoint(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = lie.hat(t) @ R
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)

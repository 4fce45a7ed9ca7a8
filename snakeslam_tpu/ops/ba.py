"""Bundle adjustment: Levenberg-Marquardt with point marginalization (Schur).

JAX replacement for the EigenRecursive solver family the reference
uses — ``BARec`` / ``BARecRel`` / ``BAPointOnly`` / ``BAPoseOnly``
(reference: Snake/Optimizer/LocalBundleAdjustment.h:10-11,86-91 and
Snake/Optimizer/GlobalBundleAdjustment.cpp:11-12,103-123) — including the
IMU relative-pose-constraint factors between consecutive keyframes
(LocalBundleAdjustment.cpp:295-347).

Design (device-first, not a port):
  * The sparse problem is stored in a fixed-shape per-point layout:
    each of P point slots carries up to M observation slots
    (camera index, uv, right-x, weight, valid).  Everything is dense
    einsum/segment_sum arithmetic — no dynamic sparsity.
  * Points are marginalized exactly: per-point 3x3 Hessians are inverted in
    closed batch form, and the reduced camera system S (6C x 6C, C <= a few
    hundred for this problem class) is built densely by scatter-adding the
    (cam_i, cam_j) 6x6 blocks over all per-point observation pairs.  A dense
    Cholesky/LU solve of S replaces the reference's recursive Schur + PCG —
    a 6C x 6C dense solve is regular matrix work, where sparse iteration is
    a chain of small dependent steps.
  * Levenberg-Marquardt with branchless accept/reject (lax.fori_loop).

Conventions match ops/pose_solver.py: poses are world->camera, update is
T <- exp(delta) @ T, residual = proj(T x) - uv with stereo third row.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops.linalg import inv3x3, solve3x3, solve_psd

import functools


class BAProblem(NamedTuple):
    """Fixed-shape BA problem: C camera slots, P point slots, M obs/point."""

    cam_pose: jax.Array      # (C, 4, 4) world->camera
    cam_fixed: jax.Array     # (C,) bool — held constant (incl. gauge)
    cam_valid: jax.Array     # (C,) bool
    points: jax.Array        # (P, 3)
    point_valid: jax.Array   # (P,) bool
    obs_cam: jax.Array       # (P, M) int32 camera slot of each obs
    obs_uv: jax.Array        # (P, M, 2)
    obs_right: jax.Array     # (P, M) right-image x; < 0 => mono
    obs_weight: jax.Array    # (P, M) = 1/scale(octave)
    obs_valid: jax.Array     # (P, M) bool
    # relative pose constraints (IMU rpc): residual log(T_j T_i^-1 M^-1)
    rpc_i: jax.Array         # (R,) int32
    rpc_j: jax.Array         # (R,) int32
    rpc_T: jax.Array         # (R, 4, 4) measured T_j @ T_i^-1
    rpc_weight: jax.Array    # (R, 6) per-axis weights (trans3, rot3)
    rpc_valid: jax.Array     # (R,) bool


import numpy as _np


@functools.partial(jax.jit, static_argnames=("C", "P", "M", "R"))
def _unflatten_problem(flat: jax.Array, C: int, P: int, M: int, R: int):
    o = 0

    def take(n, shape, dtype=jnp.float32):
        nonlocal o
        x = flat[o:o + n].reshape(shape)
        o += n
        if dtype is jnp.float32:
            return x
        if dtype is jnp.bool_:
            return x > 0.5
        return x.astype(dtype)

    return BAProblem(
        cam_pose=take(C * 16, (C, 4, 4)),
        cam_fixed=take(C, (C,), jnp.bool_),
        cam_valid=take(C, (C,), jnp.bool_),
        points=take(P * 3, (P, 3)),
        point_valid=take(P, (P,), jnp.bool_),
        obs_cam=take(P * M, (P, M), jnp.int32),
        obs_uv=take(P * M * 2, (P, M, 2)),
        obs_right=take(P * M, (P, M)),
        obs_weight=take(P * M, (P, M)),
        obs_valid=take(P * M, (P, M), jnp.bool_),
        rpc_i=take(R, (R,), jnp.int32),
        rpc_j=take(R, (R,), jnp.int32),
        rpc_T=take(R * 16, (R, 4, 4)),
        rpc_weight=take(R * 6, (R, 6)),
        rpc_valid=take(R, (R,), jnp.bool_),
    )


def problem_to_device(cam_pose, cam_fixed, cam_valid, points, point_valid,
                      obs_cam, obs_uv, obs_right, obs_weight, obs_valid,
                      rpc_i, rpc_j, rpc_T, rpc_weight,
                      rpc_valid) -> BAProblem:
    """Host numpy arrays -> device BAProblem through ONE flat f32 upload.

    Sixteen small jnp.asarray transfers cost sixteen transfer latencies;
    one concatenated buffer plus a jitted unflatten costs one.
    int/bool fields ride as f32 (ids < 2^24, exact)."""
    f = _np.float32
    flat = _np.concatenate([
        _np.ascontiguousarray(cam_pose, f).ravel(),
        cam_fixed.astype(f), cam_valid.astype(f),
        _np.ascontiguousarray(points, f).ravel(),
        point_valid.astype(f),
        obs_cam.astype(f).ravel(),
        _np.ascontiguousarray(obs_uv, f).ravel(),
        obs_right.astype(f).ravel(), obs_weight.astype(f).ravel(),
        obs_valid.astype(f).ravel(),
        rpc_i.astype(f), rpc_j.astype(f),
        _np.ascontiguousarray(rpc_T, f).ravel(),
        _np.ascontiguousarray(rpc_weight, f).ravel(),
        rpc_valid.astype(f),
    ])
    return _unflatten_problem(
        jnp.asarray(flat), cam_pose.shape[0], points.shape[0],
        obs_cam.shape[1], len(rpc_i),
    )


def empty_rpc(dtype=jnp.float32):
    return dict(
        rpc_i=jnp.zeros((1,), dtype=jnp.int32),
        rpc_j=jnp.zeros((1,), dtype=jnp.int32),
        rpc_T=jnp.eye(4, dtype=dtype)[None],
        rpc_weight=jnp.zeros((1, 6), dtype=dtype),
        rpc_valid=jnp.zeros((1,), dtype=bool),
    )


def se3_adjoint(T: jax.Array) -> jax.Array:
    """Adjoint of SE3 for (v, w) tangent ordering: (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = lie.hat(t) @ R
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# residuals / jacobians
# ---------------------------------------------------------------------------

def _point_residuals(problem: BAProblem, cam: Pinhole, bf, cam_pose, points):
    """Residuals r (P, M, 3), camera Jacobians A (P, M, 3, 6), point
    Jacobians B (P, M, 3, 3), validity (P, M)."""
    P, M = problem.obs_cam.shape
    cidx = jnp.clip(problem.obs_cam, 0, cam_pose.shape[0] - 1)
    T = cam_pose[cidx]                      # (P, M, 4, 4)
    pc = (T[..., :3, :3] @ points[:, None, :, None])[..., 0] + T[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_ok = z > 1e-4
    zs = jnp.where(z_ok, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - bf * iz
    has_stereo = problem.obs_right > 0
    r = jnp.stack(
        [u - problem.obs_uv[..., 0], v - problem.obs_uv[..., 1],
         jnp.where(has_stereo, ur - problem.obs_right, 0.0)],
        axis=-1,
    )
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    # d pc / d delta_cam = [I | -hat(pc)]
    dpc = jnp.stack(
        [
            jnp.stack([ones, zeros, zeros, zeros, z, -y], axis=-1),
            jnp.stack([zeros, ones, zeros, -z, zeros, x], axis=-1),
            jnp.stack([zeros, zeros, ones, y, -x, zeros], axis=-1),
        ],
        axis=-2,
    )  # (P, M, 3, 6)
    Jp = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], axis=-1),
            jnp.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], axis=-1),
            jnp.stack([cam.fx * iz, zeros, (-cam.fx * x + bf) * iz2], axis=-1),
        ],
        axis=-2,
    )  # (P, M, 3, 3)
    stereo_scale = jnp.where(has_stereo, 1.0, 0.0)
    Jp = Jp.at[..., 2, :].multiply(stereo_scale[..., None])
    r = r.at[..., 2].multiply(stereo_scale)
    A = Jp @ dpc
    B = Jp @ T[..., :3, :3]
    valid = (
        problem.obs_valid
        & problem.point_valid[:, None]
        & z_ok
        & (problem.obs_cam >= 0)
    )
    return r, A, B, valid, has_stereo


def _obs_chi2(r, weight, has_stereo):
    e2 = jnp.where(has_stereo, jnp.sum(r * r, axis=-1),
                   r[..., 0] ** 2 + r[..., 1] ** 2)
    return weight**2 * e2


def _rpc_residuals(problem: BAProblem, cam_pose):
    """IMU relative-pose residual per constraint: log(T_j T_i^-1 M^-1)."""
    Ti = cam_pose[jnp.clip(problem.rpc_i, 0, cam_pose.shape[0] - 1)]
    Tj = cam_pose[jnp.clip(problem.rpc_j, 0, cam_pose.shape[0] - 1)]
    rel = Tj @ lie.se3_inverse(Ti)
    r = lie.se3_log(rel @ lie.se3_inverse(problem.rpc_T))
    # J wrt delta_j ~ I (left perturbation, small residual);
    # J wrt delta_i = -Ad(rel)
    Jj = jnp.broadcast_to(jnp.eye(6, dtype=r.dtype), r.shape[:-1] + (6, 6))
    Ji = -se3_adjoint(rel)
    return r, Ji, Jj


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

@jax.jit
def ba_cost(problem: BAProblem, cam: Pinhole, bf, cam_pose, points,
            huber_delta_mono, huber_delta_stereo):
    r, A, B, valid, has_stereo = _point_residuals(
        problem, cam, bf, cam_pose, points
    )
    chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
    delta_h = jnp.where(has_stereo, huber_delta_stereo, huber_delta_mono)
    # Huber cost
    e = jnp.sqrt(chi2 + 1e-12)
    c = jnp.where(e <= delta_h, chi2, 2 * delta_h * e - delta_h**2)
    cost = jnp.sum(jnp.where(valid, c, 0.0))
    rr, _, _ = _rpc_residuals(problem, cam_pose)
    cost_rpc = jnp.sum(
        jnp.where(problem.rpc_valid[:, None], problem.rpc_weight * rr * rr, 0.0)
    )
    return cost + cost_rpc


# ---------------------------------------------------------------------------
# Schur pair scatter
# ---------------------------------------------------------------------------

_SCHUR_SCATTER_MAX_BYTES = 64 << 20


def _schur_pair_scatter(Y, Z, cidx, C):
    """sum_p Y_pm (Hpp^-1 Y_pn)^T scattered into the (C*C+1, 36) pair table.

    One-shot when the (P, M, M, 6, 6) temporary is small (LBA buckets);
    chunked over point slots when it would exceed ~64 MB (GBA-scale P).
    """
    P, M = cidx.shape
    dtype = Y.dtype

    def scatter_chunk(Yk, Zk, ck):
        blk = jnp.einsum("pmik,pnkj->pmnij", Yk, Zk)
        ci = ck[:, :, None]
        cj = ck[:, None, :]
        pair = jnp.where((ci < C) & (cj < C), ci * C + cj, C * C).reshape(-1)
        return jax.ops.segment_sum(
            blk.reshape(-1, 36), pair, num_segments=C * C + 1
        )

    if P * M * M * 36 * 4 <= _SCHUR_SCATTER_MAX_BYTES:
        return scatter_chunk(Y, Z, cidx)[: C * C]

    Q = max(1, _SCHUR_SCATTER_MAX_BYTES // (M * M * 36 * 4))
    n_chunks = -(-P // Q)
    pad = n_chunks * Q - P
    Yp = jnp.pad(Y, ((0, pad), (0, 0), (0, 0), (0, 0)))
    Zp = jnp.pad(Z, ((0, pad), (0, 0), (0, 0), (0, 0)))
    cp = jnp.pad(cidx, ((0, pad), (0, 0)), constant_values=C)

    def body(k, S_acc):
        Yk = jax.lax.dynamic_slice_in_dim(Yp, k * Q, Q)
        Zk = jax.lax.dynamic_slice_in_dim(Zp, k * Q, Q)
        ck = jax.lax.dynamic_slice_in_dim(cp, k * Q, Q)
        return S_acc + scatter_chunk(Yk, Zk, ck)

    S = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros((C * C + 1, 36), dtype=dtype)
    )
    return S[: C * C]


# ---------------------------------------------------------------------------
# the LM solver
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("iterations", "huber_mono", "huber_stereo",
                     "lm_lambda0", "optimize_points"),
)
def solve_ba(
    problem: BAProblem,
    cam: Pinhole,
    bf: jax.Array,
    iterations: int = 3,
    huber_mono: float = 2.1,
    huber_stereo: float = 2.3,
    lm_lambda0: float = 1e-4,
    optimize_points: bool = True,
):
    """Levenberg-Marquardt BA with exact point marginalization.

    Returns (cam_pose, points, final_cost).
    With optimize_points=False this degenerates to motion-only BA over the
    window (all points constant).
    """
    C = problem.cam_pose.shape[0]
    dtype = problem.cam_pose.dtype
    free = (problem.cam_valid & (~problem.cam_fixed)).astype(dtype)

    def build_normal_eqs(cam_pose, points, lam):
        r, A, B, valid, has_stereo = _point_residuals(
            problem, cam, bf, cam_pose, points
        )
        chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
        delta_h = jnp.where(has_stereo, huber_stereo, huber_mono)
        e = jnp.sqrt(chi2 + 1e-12)
        huber = jnp.minimum(1.0, delta_h / e)
        w = jnp.where(valid, problem.obs_weight**2 * huber, 0.0)  # (P, M)
        # Huber cost at the CURRENT iterate, from the same residual pass —
        # the LM loop below needs it and a separate ba_cost() call would
        # repeat the whole projection/Jacobian sweep (the dominant cost of
        # one iteration at LBA shapes)
        rho = jnp.where(e <= delta_h, chi2, 2 * delta_h * e - delta_h**2)
        cost_cur = jnp.sum(jnp.where(valid, rho, 0.0))

        P, M = w.shape
        # per-point 3x3 Hessian, damped
        Hpp = jnp.einsum("pmki,pm,pmkj->pij", B, w, B)
        Hpp = Hpp + (lam * jnp.maximum(
            jnp.diagonal(Hpp, axis1=1, axis2=2), 1e-8
        ))[:, :, None] * jnp.eye(3, dtype=dtype)[None]
        Hpp = Hpp + 1e-9 * jnp.eye(3, dtype=dtype)[None]
        # closed-form batched 3x3 inverse instead of XLA's LU path (see
        # ops/linalg.py)
        Hpp_inv = inv3x3(Hpp)

        # gradients
        g_p = jnp.einsum("pmki,pm,pmk->pi", B, w, r)             # (P, 3)
        g_c_obs = jnp.einsum("pmki,pm,pmk->pmi", A, w, r)        # (P, M, 6)
        Hcc_obs = jnp.einsum("pmki,pm,pmkj->pmij", A, w, A)      # (P, M, 6, 6)
        Y = jnp.einsum("pmki,pm,pmkj->pmij", A, w, B)            # (P, M, 6, 3)

        cidx = jnp.where(valid, problem.obs_cam, C)  # C = drop bucket
        flat_c = cidx.reshape(-1)
        g_c = jax.ops.segment_sum(
            g_c_obs.reshape(-1, 6), flat_c, num_segments=C + 1
        )[:C]
        Hcc = jax.ops.segment_sum(
            Hcc_obs.reshape(-1, 36), flat_c, num_segments=C + 1
        )[:C].reshape(C, 6, 6)

        # reduced gradient: g_c - sum_pm Y (Hpp^-1 g_p)
        hg = jnp.einsum("pij,pj->pi", Hpp_inv, g_p)              # (P, 3)
        red = jnp.einsum("pmij,pj->pmi", Y, hg)                  # (P, M, 6)
        g_hat = g_c - jax.ops.segment_sum(
            red.reshape(-1, 6), flat_c, num_segments=C + 1
        )[:C]

        # reduced camera system S: scatter (cam_m, cam_m') 6x6 blocks via a
        # batched einsum + segment_sum.  The (Q, M, M, 6, 6) temporary is
        # ~19 MB at the largest LBA bucket (one shot, Q = P); at GBA scale
        # (P bucketed from the whole map) it would be hundreds of MB, so
        # the scatter runs chunked over point slots above a size threshold
        # — the chunk loop costs a few extra passes only on the big,
        # compute-bound problems where it doesn't matter.
        Z = jnp.einsum("pij,pmkj->pmik", Hpp_inv, Y)             # (P, M, 3, 6)
        S = _schur_pair_scatter(Y, Z, cidx, C).reshape(C, C, 6, 6)
        S = -S
        S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc)

        # rpc factors
        rr, Ji, Jj = _rpc_residuals(problem, cam_pose)
        cost_cur = cost_cur + jnp.sum(jnp.where(
            problem.rpc_valid[:, None], problem.rpc_weight * rr * rr, 0.0))
        wr = jnp.where(problem.rpc_valid[:, None], problem.rpc_weight, 0.0)
        i = jnp.clip(problem.rpc_i, 0, C - 1)
        j = jnp.clip(problem.rpc_j, 0, C - 1)
        Hii = jnp.einsum("rki,rk,rkj->rij", Ji, wr, Ji)
        Hjj = jnp.einsum("rki,rk,rkj->rij", Jj, wr, Jj)
        Hij = jnp.einsum("rki,rk,rkj->rij", Ji, wr, Jj)
        gi = jnp.einsum("rki,rk,rk->ri", Ji, wr, rr)
        gj = jnp.einsum("rki,rk,rk->ri", Jj, wr, rr)
        S = S.at[i, i].add(Hii)
        S = S.at[j, j].add(Hjj)
        S = S.at[i, j].add(Hij)
        S = S.at[j, i].add(jnp.swapaxes(Hij, -1, -2))
        g_hat = g_hat.at[i].add(gi)
        g_hat = g_hat.at[j].add(gj)

        # camera damping + fix constant cameras
        diagS = jnp.diagonal(S[jnp.arange(C), jnp.arange(C)], axis1=1, axis2=2)
        S = S.at[jnp.arange(C), jnp.arange(C)].add(
            (lam * jnp.maximum(diagS, 1e-8))[:, :, None]
            * jnp.eye(6, dtype=dtype)[None]
        )
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S = S.at[jnp.arange(C), jnp.arange(C)].add(
            jnp.eye(6, dtype=dtype)[None] * (1.0 - free)[:, None, None]
        )
        g_hat = g_hat * free[:, None]

        S_dense = jnp.swapaxes(S, 1, 2).reshape(6 * C, 6 * C)
        return S_dense, g_hat.reshape(-1), Hpp_inv, Y, g_p, cidx, cost_cur

    def apply_step(cam_pose, points, S_dense, g_hat, Hpp_inv, Y, g_p, cidx):
        # S is symmetric positive definite after damping: Cholesky instead
        # of the LU lowering (see ops/linalg.py)
        delta_c = -solve_psd(
            S_dense + 1e-8 * jnp.eye(S_dense.shape[0], dtype=dtype),
            g_hat,
        ).reshape(C, 6)
        delta_c = delta_c * free[:, None]
        new_cam = jax.vmap(
            lambda d, T: lie.orthonormalize(lie.se3_exp(d) @ T)
        )(delta_c, cam_pose)
        if optimize_points:
            # back-substitute: delta_p = -Hpp^-1 (g_p + sum_m Y^T delta_c)
            dc = delta_c[jnp.clip(cidx, 0, C - 1)]
            dc = jnp.where((cidx < C)[..., None], dc, 0.0)
            ytd = jnp.einsum("pmij,pmi->pj", Y, dc)
            delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, g_p + ytd)
            new_points = jnp.where(
                problem.point_valid[:, None], points + delta_p, points
            )
        else:
            new_points = points
        return new_cam, new_points

    # ONE residual/Jacobian pass per iteration: the cost of the current
    # iterate falls out of the same pass that builds the normal equations,
    # so the classic LM trial-step/rollback (two passes per iteration) is
    # replaced by always-step + running-best.  The best evaluated iterate
    # is returned, so the result is never worse than classic LM's guarded
    # output; a diverged step just wastes one damped iteration (rare at
    # LBA/GBA shapes — Huber-weighted, well-conditioned).
    def lm_iter(_, carry):
        cam_pose, points, lam, prev_cost, best_cam, best_pts, best_cost = carry
        S_dense, g_hat, Hpp_inv, Y, g_p, cidx, cost_cur = build_normal_eqs(
            cam_pose, points, lam
        )
        improved = cost_cur < best_cost
        best_cam = jnp.where(improved, cam_pose, best_cam)
        best_pts = jnp.where(improved, points, best_pts)
        best_cost = jnp.where(improved, cost_cur, best_cost)
        lam = jnp.where(cost_cur <= prev_cost, lam * 0.5, lam * 4.0)
        new_cam, new_points = apply_step(
            cam_pose, points, S_dense, g_hat, Hpp_inv, Y, g_p, cidx
        )
        return (new_cam, new_points, lam, cost_cur,
                best_cam, best_pts, best_cost)

    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    # iterations+1 passes: the extra pass evaluates the last step's cost
    # (its own step is discarded by the best selection)
    _, _, _, _, cam_pose, points, cost = jax.lax.fori_loop(
        0, iterations + 1, lm_iter,
        (problem.cam_pose, problem.points, jnp.asarray(lm_lambda0, dtype),
         big, problem.cam_pose, problem.points, big),
    )
    return cam_pose, points, cost


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "huber_mono", "huber_stereo"),
)
def solve_point_only(
    problem: BAProblem,
    cam: Pinhole,
    bf: jax.Array,
    iterations: int = 4,
    huber_mono: float = 2.1,
    huber_stereo: float = 2.3,
):
    """Point-only BA (cameras constant) — BAPointOnly parity
    (reference: GlobalBundleAdjustment.cpp:103-123).  Independent per-point
    3x3 GN solves, fully batched."""
    dtype = problem.points.dtype

    def it(_, points):
        r, A, B, valid, has_stereo = _point_residuals(
            problem, cam, bf, problem.cam_pose, points
        )
        chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
        delta_h = jnp.where(has_stereo, huber_stereo, huber_mono)
        e = jnp.sqrt(chi2 + 1e-12)
        huber = jnp.minimum(1.0, delta_h / e)
        w = jnp.where(valid, problem.obs_weight**2 * huber, 0.0)
        Hpp = jnp.einsum("pmki,pm,pmkj->pij", B, w, B)
        Hpp = Hpp + 1e-6 * jnp.eye(3, dtype=dtype)[None]
        g_p = jnp.einsum("pmki,pm,pmk->pi", B, w, r)
        delta = -solve3x3(Hpp, g_p)
        has_obs = jnp.sum(w, axis=1) > 0
        return jnp.where(
            (problem.point_valid & has_obs)[:, None], points + delta, points
        )

    points = jax.lax.fori_loop(0, iterations, it, problem.points)
    return points


@functools.partial(
    jax.jit, static_argnames=("chi2_mono", "chi2_stereo")
)
def classify_outliers(
    problem: BAProblem,
    cam: Pinhole,
    bf: jax.Array,
    cam_pose: jax.Array,
    points: jax.Array,
    chi2_mono: float = 2.1**2,
    chi2_stereo: float = 2.3**2,
):
    """Observation-level chi2 outlier mask (True = outlier), mirroring the
    reference's post-solve classification (LocalBundleAdjustment.cpp:369-412)."""
    r, _, _, valid, has_stereo = _point_residuals(
        problem, cam, bf, cam_pose, points
    )
    chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
    th = jnp.where(has_stereo, chi2_stereo, chi2_mono)
    return valid & (chi2 > th)

"""Synthetic pose-refine problems and the fused-kernel parity check
(fixtures for tests and chip_smoke.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine

# tolerances of the fused kernel against the XLA solver: the kernel sums
# in another order and orthonormalizes once at the end instead of after
# every step, so poses agree to ~1e-6 in practice; 2e-4 leaves room for
# the f32 reduction order of a GPU
POSE_ATOL = 2e-4
MIN_INLIER_AGREEMENT = 0.99


def make_pose_problem(seed: int = 0, N: int = 1024, n_outliers: int = 60,
                      stereo: bool = True):
    """A perturbed pose with N observations, a third of them mono when
    ``stereo``, ``n_outliers`` gross outliers and 40 masked slots.
    Returns (T0, obs, cam, bf, T_gt)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N, 3)) * np.array([4, 3, 5]) + [0, 0, 12]
    cam = Pinhole(fx=jnp.float32(450.0), fy=jnp.float32(451.0),
                  cx=jnp.float32(370.0), cy=jnp.float32(240.0))
    bf = jnp.float32(48.0)
    xi = jnp.asarray(rng.normal(size=6) * [0.1, 0.1, 0.1, 0.02, 0.02, 0.02],
                     dtype=jnp.float32)
    T_gt = np.asarray(lie.se3_exp(xi))
    pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    u = 450.0 * pc[:, 0] / pc[:, 2] + 370.0
    v = 451.0 * pc[:, 1] / pc[:, 2] + 240.0
    uv = np.stack([u, v], 1) + rng.normal(size=(N, 2)) * 0.3
    right = (u - 48.0 / pc[:, 2]) + rng.normal(size=N) * 0.3
    if not stereo:
        right = np.full(N, -1.0)
    else:
        right[rng.choice(N, N // 3, replace=False)] = -1.0
    out_idx = rng.choice(N, n_outliers, replace=False)
    uv[out_idx] += rng.normal(size=(n_outliers, 2)) * 40.0
    mask = np.ones(N, dtype=bool)
    mask[rng.choice(N, 40, replace=False)] = False
    obs = PoseObs(
        points=jnp.asarray(pts, dtype=jnp.float32),
        uv=jnp.asarray(uv, dtype=jnp.float32),
        right=jnp.asarray(right, dtype=jnp.float32),
        weight=jnp.asarray(rng.uniform(0.5, 1.0, N), dtype=jnp.float32),
        mask=jnp.asarray(mask),
    )
    dxi = jnp.asarray(
        rng.normal(size=6) * [0.02, 0.02, 0.02, 5e-3, 5e-3, 5e-3],
        dtype=jnp.float32)
    T0 = jnp.asarray(np.asarray(lie.se3_exp(dxi)) @ T_gt, dtype=jnp.float32)
    return T0, obs, cam, bf, T_gt


def compare_fused_with_xla(N: int, stereo: bool, interpret: bool,
                           seed: int = 3, outer_iters: int = 2,
                           inner_iters: int = 2) -> dict:
    """Run the fused kernel and the XLA solver (float32 matmuls at
    "highest") on one problem; return the pose difference, the
    translation errors against ground truth, inlier counts and agreement."""
    from snakeslam_tpu.ops.pose_pallas import pose_refine_fused

    T0, obs, cam, bf, T_gt = make_pose_problem(seed=seed, N=N,
                                               stereo=stereo)
    with jax.default_matmul_precision("highest"):
        T_ref, inl_ref, n_ref = robust_pose_refine(
            T0, obs, cam, bf, outer_iters=outer_iters,
            inner_iters=inner_iters)
    T_f, inl_f, n_f = pose_refine_fused(
        T0, obs.points, obs.uv, obs.right, obs.weight, obs.mask, cam, bf,
        outer_iters=outer_iters, inner_iters=inner_iters,
        interpret=interpret)
    T_ref, T_f = np.asarray(T_ref), np.asarray(T_f)
    return dict(
        max_abs_diff=float(np.abs(T_f - T_ref).max()),
        err_t_ref=float(np.linalg.norm(T_ref[:3, 3] - T_gt[:3, 3])),
        err_t_fused=float(np.linalg.norm(T_f[:3, 3] - T_gt[:3, 3])),
        n_ref=int(n_ref), n_fused=int(n_f),
        agreement=float((np.asarray(inl_ref) == np.asarray(inl_f)).mean()),
    )


def check_fused_parity(r: dict) -> None:
    """Raise AssertionError unless a compare_fused_with_xla result is
    within the stated tolerances (explicit raises: also under -O)."""
    fails = [f"{k} {r[k]}" for k in ("err_t_ref", "err_t_fused")
             if not r[k] < 2e-3]
    if not r["max_abs_diff"] <= POSE_ATOL:
        fails.append(f"max |dT| {r['max_abs_diff']} > {POSE_ATOL}")
    if abs(r["n_ref"] - r["n_fused"]) > max(3, r["n_ref"] // 100):
        fails.append(f"inliers {r['n_fused']} vs {r['n_ref']}")
    if not r["agreement"] > MIN_INLIER_AGREEMENT:
        fails.append(f"inlier agreement {r['agreement']}")
    if fails:
        raise AssertionError("; ".join(fails))

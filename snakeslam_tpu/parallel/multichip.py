"""Multi-device execution: device mesh + sharded matching/BA steps.

The reference is a single-process system with no distributed backend
(SURVEY.md §2.3); its intra-op OpenMP parallelism maps onto XLA batching on
one device.  For multi-device scaling this module shards the two
embarrassingly-point-parallel workloads over a 1-D ``dp`` mesh axis via
``jax.shard_map`` with XLA collectives (NCCL on GPUs, which reach each
other all to all, so the mesh follows the algorithm alone):

  * Hamming matching: local-map points sharded over ``dp``; each device
    matches its point shard against the (replicated) frame features; the
    conflict-resolving commit runs on the gathered result.
  * Bundle adjustment: points + observations sharded over ``dp``; each
    device builds its partial reduced camera system (Schur) and gradient;
    one ``psum`` across devices yields the global 6Cx6C system, solved
    replicated;
    point back-substitution stays local to each shard.

This is the honest parallel decomposition of BA: cameras are the shared
small state (replicated), points are the big independent state (sharded) —
the psum moves only O(C^2) data regardless of the point count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops import ba as BA
from snakeslam_tpu.ops.descriptors import hamming_matrix
from snakeslam_tpu.ops.linalg import inv3x3, solve_psd


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("dp",))


# ---------------------------------------------------------------------------
# sharded Hamming matching
# ---------------------------------------------------------------------------

def sharded_hamming_topk(mesh: Mesh):
    """Returns a jitted fn: (point_bits (P, 256) sharded, frame_bits (N, 256)
    replicated) -> (best_dist (P,), best_idx (P,)) sharded."""

    def local(pb, fb):
        H = hamming_matrix(pb, fb)
        return jnp.min(H, axis=1), jnp.argmin(H, axis=1).astype(jnp.int32)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P(None, None)),
        out_specs=(P("dp"), P("dp")),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# sharded BA training step
# ---------------------------------------------------------------------------

def sharded_ba_step(mesh: Mesh, cam: Pinhole, bf, n_iters: int = 1,
                    lam: float = 1e-4):
    """One (or more) Gauss-Newton BA iteration(s) with points sharded on dp.

    The per-point arrays of the BAProblem are sharded on their leading axis;
    camera state is replicated.  Per iteration: local Schur pieces ->
    psum(S, g) -> replicated dense solve -> local point back-substitution.
    """

    def step(problem: BA.BAProblem):
        C = problem.cam_pose.shape[0]
        dtype = problem.cam_pose.dtype
        free = (problem.cam_valid & (~problem.cam_fixed)).astype(dtype)

        def one_iter(_, carry):
            cam_pose, points = carry
            r, A, Bj, valid, has_stereo = BA._point_residuals(
                problem, cam, bf, cam_pose, points
            )
            chi2 = BA._obs_chi2(r, problem.obs_weight, has_stereo)
            delta_h = jnp.where(has_stereo, 2.3, 2.1)
            e = jnp.sqrt(chi2 + 1e-12)
            huber = jnp.minimum(1.0, delta_h / e)
            w = jnp.where(valid, problem.obs_weight**2 * huber, 0.0)

            Pp, M = w.shape
            Hpp = jnp.einsum("pmki,pm,pmkj->pij", Bj, w, Bj)
            Hpp = Hpp + (lam + 1e-6) * jnp.eye(3, dtype=dtype)[None]
            Hpp_inv = inv3x3(Hpp)
            g_p = jnp.einsum("pmki,pm,pmk->pi", Bj, w, r)
            g_c_obs = jnp.einsum("pmki,pm,pmk->pmi", A, w, r)
            Hcc_obs = jnp.einsum("pmki,pm,pmkj->pmij", A, w, A)
            Y = jnp.einsum("pmki,pm,pmkj->pmij", A, w, Bj)

            cidx = jnp.where(valid, problem.obs_cam, C)
            flat_c = cidx.reshape(-1)
            g_c = jax.ops.segment_sum(
                g_c_obs.reshape(-1, 6), flat_c, num_segments=C + 1
            )[:C]
            Hcc = jax.ops.segment_sum(
                Hcc_obs.reshape(-1, 36), flat_c, num_segments=C + 1
            )[:C].reshape(C, 6, 6)
            hg = jnp.einsum("pij,pj->pi", Hpp_inv, g_p)
            red = jnp.einsum("pmij,pj->pmi", Y, hg)
            g_hat = g_c - jax.ops.segment_sum(
                red.reshape(-1, 6), flat_c, num_segments=C + 1
            )[:C]
            Z = jnp.einsum("pij,pmkj->pmik", Hpp_inv, Y)
            # one batched scatter for all (m, m') camera-pair blocks (same
            # rationale as ops/ba.py: a single segment_sum beats M
            # sequential passes on this latency-bound problem)
            blk = jnp.einsum("pmik,pnkj->pmnij", Y, Z)
            ci = cidx[:, :, None]
            cj = cidx[:, None, :]
            pair = jnp.where(
                (ci < C) & (cj < C), ci * C + cj, C * C
            ).reshape(-1)
            S = jax.ops.segment_sum(
                blk.reshape(-1, 36), pair, num_segments=C * C + 1
            )[: C * C]
            S = -S.reshape(C, C, 6, 6)
            S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc)

            # >>> the collective: reduce partial systems across shards <<<
            S = jax.lax.psum(S, "dp")
            g_hat = jax.lax.psum(g_hat, "dp")

            # IMU relative-pose (rpc) factors: camera-only terms over the
            # replicated rpc arrays, added once AFTER the psum so a sharded
            # visual-inertial problem keeps its IMU constraints (parity with
            # the single-chip solve_ba)
            rr, Ji, Jj = BA._rpc_residuals(problem, cam_pose)
            wr = jnp.where(problem.rpc_valid[:, None], problem.rpc_weight,
                           0.0)
            ri = jnp.clip(problem.rpc_i, 0, C - 1)
            rj = jnp.clip(problem.rpc_j, 0, C - 1)
            Hii = jnp.einsum("rki,rk,rkj->rij", Ji, wr, Ji)
            Hjj = jnp.einsum("rki,rk,rkj->rij", Jj, wr, Jj)
            Hij = jnp.einsum("rki,rk,rkj->rij", Ji, wr, Jj)
            S = S.at[ri, ri].add(Hii)
            S = S.at[rj, rj].add(Hjj)
            S = S.at[ri, rj].add(Hij)
            S = S.at[rj, ri].add(jnp.swapaxes(Hij, -1, -2))
            g_hat = g_hat.at[ri].add(jnp.einsum("rki,rk,rk->ri", Ji, wr, rr))
            g_hat = g_hat.at[rj].add(jnp.einsum("rki,rk,rk->ri", Jj, wr, rr))

            diagS = jnp.diagonal(
                S[jnp.arange(C), jnp.arange(C)], axis1=1, axis2=2
            )
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
            delta_c = -solve_psd(
                S_dense + 1e-8 * jnp.eye(6 * C, dtype=dtype),
                g_hat.reshape(-1),
            ).reshape(C, 6) * free[:, None]

            new_cam = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(
                delta_c, cam_pose
            )
            # local point back-substitution on this shard
            dc = delta_c[jnp.clip(cidx, 0, C - 1)]
            dc = jnp.where((cidx < C)[..., None], dc, 0.0)
            ytd = jnp.einsum("pmij,pmi->pj", Y, dc)
            delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, g_p + ytd)
            new_points = jnp.where(
                problem.point_valid[:, None], points + delta_p, points
            )
            return new_cam, new_points

        cam_pose, points = jax.lax.fori_loop(
            0, n_iters, one_iter, (problem.cam_pose, problem.points)
        )
        return cam_pose, points

    pt_specs = BA.BAProblem(
        cam_pose=P(None, None, None),
        cam_fixed=P(None),
        cam_valid=P(None),
        points=P("dp", None),
        point_valid=P("dp"),
        obs_cam=P("dp", None),
        obs_uv=P("dp", None, None),
        obs_right=P("dp", None),
        obs_weight=P("dp", None),
        obs_valid=P("dp", None),
        rpc_i=P(None),
        rpc_j=P(None),
        rpc_T=P(None, None, None),
        rpc_weight=P(None, None),
        rpc_valid=P(None),
    )
    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(pt_specs,),
        out_specs=(P(None, None, None), P("dp", None)),
    )
    return jax.jit(fn)


def shard_problem(problem: BA.BAProblem, mesh: Mesh) -> BA.BAProblem:
    """Place a BAProblem on the mesh with per-point arrays sharded on dp."""
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return BA.BAProblem(
        cam_pose=put(problem.cam_pose, P(None, None, None)),
        cam_fixed=put(problem.cam_fixed, P(None)),
        cam_valid=put(problem.cam_valid, P(None)),
        points=put(problem.points, P("dp", None)),
        point_valid=put(problem.point_valid, P("dp")),
        obs_cam=put(problem.obs_cam, P("dp", None)),
        obs_uv=put(problem.obs_uv, P("dp", None, None)),
        obs_right=put(problem.obs_right, P("dp", None)),
        obs_weight=put(problem.obs_weight, P("dp", None)),
        obs_valid=put(problem.obs_valid, P("dp", None)),
        rpc_i=put(problem.rpc_i, P(None)),
        rpc_j=put(problem.rpc_j, P(None)),
        rpc_T=put(problem.rpc_T, P(None, None, None)),
        rpc_weight=put(problem.rpc_weight, P(None, None)),
        rpc_valid=put(problem.rpc_valid, P(None)),
    )

"""Neighbor fusion: merge duplicate map points across covisible keyframes.

Replacement for the reference's MapSearcher/NeighbourSearch + the
MappingORBMatcher Fuse overloads (reference: Snake/LocalMapping/
NeighbourSearch.cpp:23-226, MappingORBMatcher.cpp:252-545): bidirectional
projection of map points into covisible keyframes' feature sets; a hit on a
feature that already has a point merges the two (keep the better-observed
one), a hit on a free feature adds an observation.  The projection search is
the jitted dense matcher (ops/matching.search_by_projection_fine); the
commit pass is host-side map surgery.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.map.kf_pool import pool_features
from snakeslam_tpu.map.slam_map import SlamMap
from snakeslam_tpu.ops import matching as M
from snakeslam_tpu.ops.descriptors import unpack_bits_np
from snakeslam_tpu.system.settings import Settings
from snakeslam_tpu.tracking.staging import kf_features_cached


@functools.partial(jax.jit, static_argnames=("levels", "th"))
def _fuse_search_single(lm, feats, pose, cam, bf, bounds, scales,
                        log_sf, levels: int, th: float = 1.0):
    """Jitted single-target projection search (the backward fuse pass —
    eager execution would dispatch each op over the device link).  ``th``
    scales the projection window: 1.0 for steady-state neighbor fusion,
    4.0 for post-loop SearchAndFuse where corrected poses still carry the
    pose-graph residual (the reference uses the same widened radius,
    LoopClosing.cpp SearchAndFuse -> Fuse(..., 4.0))."""
    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=levels)
    out = M.search_by_projection_fine(
        lm, feats, pose, cam, bf,
        (bounds[0], bounds[1], bounds[2], bounds[3]), st,
        feat_free=feats.valid, th=th, ratio=0.9,
    )
    return out["feat_point"]


FUSE_NB = 16  # fixed forward fan-out width (n_neighbors=15 + pad): one
              # compiled program regardless of covisible count


def _unpack_fuse_stage(stage):
    """stage: ONE (FUSE_NB*17 + 17,) f32 staging buffer for a whole fuse
    cycle — neighbor poses, neighbor pool slots, this KF's pose + slot —
    so both fuse directions cost a single H2D transfer."""
    o = FUSE_NB * 16
    poses = stage[:o].reshape(FUSE_NB, 4, 4)
    nb_slots = jax.lax.bitcast_convert_type(stage[o:o + FUSE_NB], jnp.int32)
    kf_pose = stage[o + FUSE_NB:o + FUSE_NB + 16].reshape(4, 4)
    kf_slot = jax.lax.bitcast_convert_type(stage[o + FUSE_NB + 16],
                                           jnp.int32)
    return poses, nb_slots, kf_pose, kf_slot


def _pack_fuse_stage(poses_np, nb_slots_np, kf_pose_np, kf_slot):
    stage = np.empty(FUSE_NB * 17 + 17, dtype=np.float32)
    o = FUSE_NB * 16
    stage[:o] = np.asarray(poses_np, np.float32).reshape(-1)
    stage[o:o + FUSE_NB] = np.asarray(nb_slots_np, np.int32).view(np.float32)
    stage[o + FUSE_NB:o + FUSE_NB + 16] = np.asarray(
        kf_pose_np, np.float32).reshape(-1)
    stage[o + FUSE_NB + 16] = np.int32(kf_slot).view(np.float32)
    return stage


@functools.partial(jax.jit, static_argnames=("levels",))
def _fuse_pool_batch(pool_arrays, stage, lm, cam, bf, bounds,
                     scales, log_sf, levels: int):
    """vmapped projection search over keyframe-pool rows: one device call
    for all target keyframes, with the neighbor feature gather fused into
    the program (map/kf_pool.py — no eager stacks, no re-uploads)."""
    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=levels)
    poses, nb_slots, _, _ = _unpack_fuse_stage(stage)

    def one(slot, pose):
        feats = pool_features(pool_arrays, slot)
        out = M.search_by_projection_fine(
            lm, feats, pose, cam, bf,
            (bounds[0], bounds[1], bounds[2], bounds[3]), st,
            feat_free=feats.valid, th=1.0, ratio=0.9,
        )
        return out["feat_point"]

    return jax.vmap(one)(nb_slots, poses)


@functools.partial(jax.jit, static_argnames=("levels",))
def _fuse_pool_single(pool_arrays, stage, lm, cam, bf, bounds,
                      scales, log_sf, levels: int):
    """Backward fuse pass against one pool row (neighbor points into the
    new keyframe)."""
    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=levels)
    _, _, pose, slot = _unpack_fuse_stage(stage)
    feats = pool_features(pool_arrays, slot)
    out = M.search_by_projection_fine(
        lm, feats, pose, cam, bf,
        (bounds[0], bounds[1], bounds[2], bounds[3]), st,
        feat_free=feats.valid, th=1.0, ratio=0.9,
    )
    return out["feat_point"]


class MapSearcher:
    def __init__(self, settings: Settings, smap: SlamMap):
        self.s = settings
        self.map = smap
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy)
        self.bf = jnp.float32(settings.bf)
        pyr = ScalePyramid.create(settings.fd_levels, settings.fd_scale_factor)
        self.scales = jnp.asarray(pyr.scales)
        self.log_sf = jnp.float32(pyr.log_scale_factor)
        self.bounds = (0.0, 0.0, float(settings.width), float(settings.height))
        # device-resident constant: re-creating it per dispatch costs one
        # H2D transfer each time
        self.bounds_dev = jnp.asarray(self.bounds, dtype=jnp.float32)

    # ------------------------------------------------------------------

    def _fuse_points_into_kf(self, point_ids: np.ndarray, kf: int,
                             staged=None, th: float = 1.0) -> int:
        """Project `point_ids` into keyframe `kf` and merge/link hits."""
        smap = self.map
        if len(point_ids) == 0:
            return 0
        if staged is None:
            staged = smap.device_mirror().gather(
                point_ids, self.s.local_map_slots
            )
        lm, ids = staged
        feats = kf_features_cached(smap, kf, self.s.feature_slots)
        fp = _fuse_search_single(
            lm, feats, jnp.asarray(smap.kf_pose[kf], dtype=jnp.float32),
            self.cam, self.bf, self.bounds_dev,
            self.scales, self.log_sf, int(self.scales.shape[0]), th=th,
        )
        return self._commit_fuse(np.asarray(fp), ids, kf)

    def _commit_fuse(self, feat_point: np.ndarray, ids: np.ndarray,
                     kf: int, gen: np.ndarray | None = None) -> int:
        smap = self.map
        if not smap.kf_valid[kf]:
            return 0
        n = int(smap.kf_n_feat[kf])
        fused = 0
        for f in np.nonzero(feat_point[:n] >= 0)[0]:
            slot = feat_point[f]
            p = int(ids[slot])
            if not smap.pt_valid[p]:
                continue
            if gen is not None and smap.pt_alloc_gen[p] != gen[slot]:
                continue  # slot recycled since dispatch
            existing = smap.kf_obs[kf, f]
            if existing == p:
                continue
            if existing >= 0:
                # duplicate: keep the better-observed point
                # (MappingORBMatcher.cpp Fuse semantics)
                if smap.pt_n_obs[existing] >= smap.pt_n_obs[p]:
                    smap.replace_point(p, int(existing))
                else:
                    smap.replace_point(int(existing), p)
                fused += 1
            else:
                if (smap.pt_obs_kf[p] == kf).any():
                    continue  # already observed elsewhere in this KF
                smap.add_observation(kf, int(f), p)
                fused += 1
        return fused

    # ------------------------------------------------------------------

    def process(self, kf: int, n_neighbors: int = 15) -> int:
        """Bidirectional fuse of `kf` against its best covisible neighbors
        (NeighbourSearch.cpp:23-53).

        Snapshot-once -> search-both -> commit-both: both directions search
        the same pre-commit map snapshot and their device work is dispatched
        back-to-back before the single blocking readback, so one fuse pass
        costs one host<->device round trip and never re-syncs the point
        mirror mid-insert (the reference's lock-free compute under snapshot
        + guarded commit, NeighbourSearch.cpp:55-101)."""
        disp = self.dispatch(kf, n_neighbors)
        if disp is None:
            return 0
        arrays, ctx = disp
        from snakeslam_tpu.utils.fetch import fetch_list

        return self.commit(kf, fetch_list(arrays), ctx)

    def dispatch(self, kf: int, n_neighbors: int = 15):
        """Async half: stage + dispatch both fuse directions, no blocking.
        Returns ([device arrays], ctx) or None."""
        smap = self.map
        ids, w = smap.covisible_keyframes(kf, min_weight=1)
        neighbors = [int(k) for k in ids[:min(n_neighbors, FUSE_NB)]]
        if not neighbors:
            return None
        mirror = smap.device_mirror()
        pool = smap.kf_feature_pool(self.s.feature_slots)
        kf_pts = smap.keyframe_points(kf)
        # forward: this KF's points into ALL neighbors in ONE vmapped call,
        # padded to the fixed FUSE_NB width so exactly one program ever
        # compiles (pad-row results are never committed)
        # bucket the point-snapshot width (1024/2048/.../local_map_slots):
        # the projection search scales with it, a single keyframe rarely
        # observes more than ~1.5k points, and each bucket compiles once
        def _bucket(n):
            # pinned mode (pin_local_map_bucket): ONE compiled fuse program
            # for the whole run — dynamic growth would recompile the
            # vmapped search mid-run, which costs far more than the padded
            # rows (the search is batched mask arithmetic)
            if getattr(self.s, "pin_local_map_bucket", False):
                return self.s.local_map_slots
            b = 1024
            while b < n:
                b *= 2
            return min(b, self.s.local_map_slots)

        # ONE staging upload covers both fuse directions
        padded = neighbors + [neighbors[-1]] * (FUSE_NB - len(neighbors))
        stage = jnp.asarray(_pack_fuse_stage(
            smap.kf_pose[padded], pool.slots_for(padded),
            smap.kf_pose[kf], pool.slots_for([kf])[0],
        ))
        fp_fwd = ids_f = None
        if len(kf_pts):
            lm_f, ids_f = mirror.gather(kf_pts, _bucket(len(kf_pts)))
            fp_fwd = _fuse_pool_batch(
                pool.arrays, stage, lm_f,
                self.cam, self.bf, self.bounds_dev,
                self.scales, self.log_sf, int(self.scales.shape[0]),
            )
        # backward: all neighbor points into this KF (same snapshot)
        nb_pts = np.unique(np.concatenate(
            [smap.keyframe_points(nb) for nb in neighbors]
        ))
        nb_pts = nb_pts[smap.pt_valid[nb_pts]]
        fp_bwd = ids_b = None
        if len(nb_pts):
            lm_b, ids_b = mirror.gather(nb_pts, _bucket(len(nb_pts)))
            fp_bwd = _fuse_pool_single(
                pool.arrays, stage, lm_b,
                self.cam, self.bf, self.bounds_dev,
                self.scales, self.log_sf, int(self.scales.shape[0]),
            )
        arrays = [x for x in (fp_fwd, fp_bwd) if x is not None]
        if not arrays:
            return None
        # gen stamps: the pipelined flush commits one cycle late, and a
        # point slot recycled in between would alias an unrelated new point
        # (pt_valid alone cannot tell — the NEW point is valid too)
        ctx = dict(neighbors=neighbors, ids_f=ids_f, ids_b=ids_b,
                   gen_f=(smap.pt_alloc_gen[ids_f].copy()
                          if ids_f is not None else None),
                   gen_b=(smap.pt_alloc_gen[ids_b].copy()
                          if ids_b is not None else None),
                   has_fwd=fp_fwd is not None, has_bwd=fp_bwd is not None)
        return arrays, ctx

    def commit(self, kf: int, fetched: list, ctx: dict) -> int:
        """Host commit half: merge/link duplicates from fetched results."""
        smap = self.map
        fused = 0
        fetched = list(fetched)
        if ctx["has_fwd"]:
            fp_all = fetched.pop(0)
            for bi, nb in enumerate(ctx["neighbors"]):
                fused += self._commit_fuse(fp_all[bi], ctx["ids_f"], nb,
                                           gen=ctx.get("gen_f"))
        if ctx["has_bwd"]:
            fused += self._commit_fuse(fetched.pop(0), ctx["ids_b"], kf,
                                       gen=ctx.get("gen_b"))
        smap.state += 1
        return fused

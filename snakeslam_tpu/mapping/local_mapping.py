"""Local mapping: keyframe insertion and map maintenance.

Host orchestration mirroring the reference's LocalMapping::Process fan-out
hub (reference: Snake/LocalMapping/LocalMapping.cpp:37-117):
ProcessNewKeyFrame (observation association + stereo point insertion,
:144-265), MapPointCulling (:267-313), CreateNewMapPoints (triangulation vs
top-10 covisible, :317-329 -> Triangulator), then the back-end fan-out (LBA
etc.).  In deterministic mode everything runs inline in insertion order, the
equivalent of the reference's async=false configuration (README.md:53-65).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.map.slam_map import FrameData, SlamMap
from snakeslam_tpu.ops.descriptors import hamming_np, unpack_bits_np
import functools

import jax

from snakeslam_tpu.map.kf_pool import pool_features
from snakeslam_tpu.ops.depth_grid import keyframe_depth_grid
from snakeslam_tpu.ops.triangulate_pairs import triangulate_pair
from snakeslam_tpu.system.settings import InputType, Settings
from snakeslam_tpu.tracking.staging import kf_features_cached, pad_frame_features
from snakeslam_tpu.utils.fetch import fetch_list, fetch_np


TRI_NB = 10  # fixed neighbor fan-out width (LocalMapping.cpp:317-329);
             # a single compiled program regardless of covisible count


def _pack_tri_stage(free_a, free_b, T_a_np, T_b_np, slots, th_depth, grid):
    """ONE f32 staging buffer for a whole triangulation dispatch — free
    masks, poses, pool slots, depth grid — a single H2D transfer instead
    of eight."""
    n_slots = free_a.shape[0]
    parts = [
        free_a.astype(np.float32),
        free_b.astype(np.float32).reshape(-1),
        np.asarray(T_a_np, np.float32).reshape(-1),
        np.asarray(T_b_np, np.float32).reshape(-1),
        np.asarray(slots, np.int32).view(np.float32),
        np.float32([th_depth]),
        np.asarray(grid, np.float32).reshape(-1),
    ]
    return np.concatenate(parts)


def _unpack_tri_stage(stage, n_slots: int, grid_shape: tuple):
    o = 0
    free_a = stage[o:o + n_slots] > 0.5; o += n_slots
    free_b = (stage[o:o + TRI_NB * n_slots] > 0.5).reshape(TRI_NB, n_slots)
    o += TRI_NB * n_slots
    T_a = stage[o:o + 16].reshape(4, 4); o += 16
    T_b = stage[o:o + TRI_NB * 16].reshape(TRI_NB, 4, 4); o += TRI_NB * 16
    slots = jax.lax.bitcast_convert_type(
        stage[o:o + TRI_NB + 1], jnp.int32); o += TRI_NB + 1
    th_depth = stage[o]; o += 1
    grid = stage[o:o + grid_shape[0] * grid_shape[1]].reshape(grid_shape)
    return free_a, free_b, T_a, T_b, slots, th_depth, grid


@functools.partial(
    jax.jit,
    static_argnames=("feature_distance", "epipolar_distance", "error_mono",
                     "bounds_wh", "n_slots", "grid_shape"),
)
def _triangulate_pool(pool_arrays, stage, cam, bf, scales, inv_sigma2,
                      feature_distance: int, epipolar_distance: float,
                      error_mono: float, bounds_wh: tuple,
                      n_slots: int, grid_shape: tuple):
    """Jitted vmapped pair triangulation over keyframe-pool rows: the
    keyframe feature tables live in device memory (map/kf_pool.py); only
    slot indices, free masks, poses, and the small depth-completion grid
    are uploaded per dispatch (packed as ONE buffer), and the neighbor
    gather fuses into the one compiled program."""
    free_a, free_b, T_a, T_b, slots, th_depth, grid_a = _unpack_tri_stage(
        stage, n_slots, grid_shape)
    a_slot, b_slots = slots[0], slots[1:]
    feats_a = pool_features(pool_arrays, a_slot)
    feats_b = jax.vmap(lambda s: pool_features(pool_arrays, s))(b_slots)

    def fn(fb, frb, Tb):
        return triangulate_pair(
            feats_a, fb, free_a, frb, T_a, Tb, cam, bf, scales, inv_sigma2,
            feature_distance=feature_distance,
            epipolar_distance=epipolar_distance,
            error_mono=error_mono,
            grid_a=grid_a, bounds_wh=bounds_wh, th_depth=th_depth,
        )

    return jax.vmap(fn)(feats_b, free_b, T_b)


class LocalMapper:
    def __init__(self, settings: Settings, smap: SlamMap, lba=None,
                 backends=None, imu_solver=None):
        self.s = settings
        self.map = smap
        self.lba = lba
        self.imu_solver = imu_solver
        self.backends = backends or []  # further queues (simplification, ...)
        from snakeslam_tpu.mapping.fusion import MapSearcher

        self.map_searcher = MapSearcher(settings, smap)
        self.recent_points: list[tuple[int, int]] = []  # (pt, created_at_kf)
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy)
        self.bf = jnp.float32(settings.bf)
        self.scales = jnp.asarray(self.pyramid.scales)
        self.inv_sigma2 = jnp.asarray(self.pyramid.inv_sigma2)
        self._last_kf_frame_id = -10
        self._deferred: list[tuple[int, FrameData]] = []

    def on_map_initialized(self, kf: int):
        self._last_kf_frame_id = self.map.kf_frame_id[kf]

    # ------------------------------------------------------------------
    # keyframe insertion gates (KeyframeInserter.cpp:27-66)
    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: FrameData, prev_kf: int,
                        defer: bool = False) -> int:
        """defer=True runs only the cheap synchronous part (allocation,
        observation association, stereo points, IMU edge binding) and
        queues the heavy back-ends (triangulation, fusion, LBA, loop
        detection) for flush_deferred() — the windowed runner calls that
        after dispatching the next window so back-end work overlaps the
        device scan (the reference's async LocalMapping thread,
        LocalMapping.cpp:25-35, expressed as deterministic deferral)."""
        if frame.frame_id - self._last_kf_frame_id < 1:
            return -1
        n_inl = int((frame.matches >= 0).sum())
        if n_inl < 30:
            return -1
        kf = self.map.allocate_keyframe(frame)
        self.map.kf_prev[kf] = prev_kf
        if prev_kf >= 0:
            self.map.kf_next[prev_kf] = kf
        frame.is_keyframe = True
        frame.ref_kf = kf
        frame.rel_to_ref = np.eye(4)  # the frame IS the keyframe
        frame.ref_frame_id = int(frame.frame_id)
        self._last_kf_frame_id = frame.frame_id
        self.process_sync(kf, frame)
        if defer:
            self._deferred.append((kf, frame))
        else:
            self.process_deferred(kf, frame)
        return kf

    def flush_deferred(self) -> int:
        """Run queued back-end work (see insert_keyframe(defer=True)),
        software-pipelined: cycle k+1's device work is dispatched BEFORE
        cycle k's blocking commit, so every commit's fetch overlaps the
        next cycle's device execution.  Cycle k+1 then triangulates/solves
        against a one-cycle-stale snapshot — exactly the staleness the
        reference's async back-end threads produce (README.md:61-65), and
        commit_deferred's per-element guards were built for it.  If cycle
        k's commit rebases the whole map (loop correction), the in-flight
        k+1 cycle was computed in the old basis: it is dropped and re-run
        (rare — once per closed loop)."""
        n = 0
        prev = None          # in-flight token
        while self._deferred:
            kf, frame = self._deferred.pop(0)
            if not self.map.kf_valid[kf]:
                n += 1
                continue
            tok = self.dispatch_deferred(kf)
            if prev is not None:
                self.commit_deferred_checked(prev)
            prev = tok
            n += 1
        if prev is not None:
            self.commit_deferred_checked(prev)
        return n

    def commit_deferred_checked(self, tok: dict):
        """Commit a pipelined cycle, re-running it from scratch if a
        whole-map rebase (loop correction / VI-init transform) landed
        after its dispatch — its device results are in the old basis."""
        if getattr(self.map, "n_transforms", 0) != tok["n_transforms"]:
            kf = tok["kf"]
            if self.map.kf_valid[kf]:
                self.process_deferred(kf, None)
            return
        self.commit_deferred(tok)

    # ------------------------------------------------------------------
    # the fan-out hub (LocalMapping.cpp:37-117)
    # ------------------------------------------------------------------

    def process(self, kf: int, frame: FrameData):
        self.process_sync(kf, frame)
        self.process_deferred(kf, frame)

    def process_sync(self, kf: int, frame: FrameData):
        self._associate_observations(kf, frame)
        if self.s.input_type != InputType.Mono:
            self._insert_stereo_points(kf, frame)
        self.map.update_spanning_tree_parent(kf)
        self.map.compute_median_depth(kf)
        # IMU edge binding consumes the pending sample window and must run
        # at insertion order (before later frames feed more samples)
        if self.imu_solver is not None:
            self.imu_solver.process_new_keyframe(kf, int(self.map.kf_prev[kf]))

    def process_deferred(self, kf: int, frame: FrameData):
        token = self.dispatch_deferred(kf)
        self.commit_deferred(token)

    def dispatch_deferred(self, kf: int) -> dict:
        """Async half of the per-keyframe back-end cycle: triangulation,
        bidirectional neighbor fusion (MapSearcher, LocalMapping.cpp:70-80),
        and the local BA dispatch back-to-back against the same pre-commit
        snapshot (points triangulated this round are re-fused by the
        deferred mapper's MapSearch pass, DeferredMapper.cpp:167-178; the
        one-keyframe LBA lag matches the reference's async LBA which reads
        whatever map state its worker thread sees).  Returns a token for
        commit_deferred; the caller may keep tracking on the current
        snapshot while the device works — the reference's async deployment
        mode (README.md:61-65) expressed as a device pipeline."""
        self._cull_recent_points(kf)
        tri = self._tri_dispatch(kf)
        fuse = (self.map_searcher.dispatch(kf)
                if self.map_searcher is not None else None)
        ba = None
        if self.lba is not None:
            if hasattr(self.lba, "dispatch"):
                ba = self.lba.dispatch(kf)
            else:
                # async_lba mode: the worker-thread queue runs whole LBA
                # cycles itself (AsyncLBA, system/pipeline.py)
                self.lba.add(kf)
        arrays = []
        if tri is not None:
            arrays += [tri[0]["valid"], tri[0]["match_b"], tri[0]["point"]]
        if fuse is not None:
            arrays += fuse[0]
        if ba is not None:
            arrays += ba[0]
        for a in arrays:
            a.copy_to_host_async()
        return dict(kf=kf, tri=tri, fuse=fuse, ba=ba, arrays=arrays,
                    n_transforms=getattr(self.map, "n_transforms", 0))

    def commit_deferred(self, token: dict):
        """Blocking half: one batched readback, then host commits."""
        kf = token["kf"]
        if not self.map.kf_valid[kf]:
            return
        tri, fuse, ba = token["tri"], token["fuse"], token["ba"]
        fetched = fetch_list(token["arrays"])
        if tri is not None:
            self._tri_commit(kf, fetched[0], fetched[1],
                             fetched[2].astype(np.float64), tri[1])
            del fetched[:3]
        if fuse is not None:
            nf = len(fuse[0])
            self.map_searcher.commit(kf, fetched[:nf], fuse[1])
            del fetched[:nf]
        self.map.update_points_bulk(self.map.keyframe_points(kf),
                                    only_dirty=True)
        if ba is not None:
            self.lba.commit(kf, fetched, ba[1], check_state=False)
        if self.imu_solver is not None:
            self.imu_solver.update_map()
        for b in self.backends:
            b.add(kf)

    # ------------------------------------------------------------------

    def _associate_observations(self, kf: int, frame: FrameData):
        """ProcessNewKeyFrame association + descriptor-distance dedup
        (LocalMapping.cpp:160-217), vectorized: dead-point drop, duplicate
        arbitration (two features matched to one point keep the closer
        descriptor), then one bulk observation insert."""
        smap = self.map
        idx = np.nonzero(frame.matches >= 0)[0]
        if len(idx) == 0:
            return
        pts = frame.matches[idx].astype(np.int64)
        dead = ~smap.pt_valid[pts]
        if dead.any():
            frame.matches[idx[dead]] = -1
            idx, pts = idx[~dead], pts[~dead]
            if len(idx) == 0:
                return
        uniq, counts = np.unique(pts, return_counts=True)
        if (counts > 1).any():
            keep = np.ones(len(idx), dtype=bool)
            for p in uniq[counts > 1]:
                cand = np.nonzero(pts == p)[0]
                d = hamming_np(smap.pt_desc[p][None],
                               frame.descriptors[idx[cand]])[0]
                lose = cand[cand != cand[int(d.argmin())]]
                keep[lose] = False
                frame.matches[idx[lose]] = -1
            idx, pts = idx[keep], pts[keep]
        ok = smap.add_observations_bulk(kf, idx, pts)
        if not ok.all():
            frame.matches[idx[~ok]] = -1  # observation slot overflow

    def _insert_stereo_points(self, kf: int, frame: FrameData):
        """Create map points for unmatched depth features, fully vectorized
        (LocalMapping.cpp:220-254)."""
        smap = self.map
        T = smap.kf_pose[kf]
        Rinv = T[:3, :3].T
        cam_pos = -Rinv @ T[:3, 3]
        fx, fy, cx, cy = self.s.fx, self.s.fy, self.s.cx, self.s.cy
        sel = np.nonzero((frame.depth > 0) & (frame.matches < 0))[0]
        if len(sel) == 0:
            return
        z = frame.depth[sel]
        pc = np.stack([
            (frame.uv[sel, 0] - cx) / fx * z,
            (frame.uv[sel, 1] - cy) / fy * z,
            z,
        ], axis=1)
        wp = pc @ Rinv.T + cam_pos
        normals = cam_pos - wp
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                              1e-9)
        pts = smap.allocate_points_bulk(
            wp, frame.descriptors[sel], kf, np.linalg.norm(pc, axis=1),
            frame.octave[sel], normals,
        )
        smap.add_observations_bulk(kf, sel, pts)
        frame.matches[sel] = pts
        self.recent_points.extend((int(p), kf) for p in pts)

    def _cull_recent_points(self, kf: int):
        """Found-ratio / observation-count culling (LocalMapping.cpp:267-313)."""
        smap = self.map
        min_matches = 2 if self.s.input_type == InputType.Mono else 3
        kept = []
        kf_seq = {int(k): n for n, k in enumerate(smap.valid_keyframes())}
        cur = kf_seq.get(kf, len(kf_seq))
        for pt, created_kf in self.recent_points:
            if not smap.pt_valid[pt]:
                continue
            age = cur - kf_seq.get(created_kf, 0)
            found_ratio = smap.pt_found[pt] / max(smap.pt_visible[pt], 1)
            if found_ratio < 0.25:
                smap.erase_point(pt)
            elif age >= 2 and smap.pt_n_obs[pt] <= min_matches:
                smap.erase_point(pt)
            elif age >= 3:
                pass  # graduated
            else:
                kept.append((pt, created_kf))
        self.recent_points = kept

    # ------------------------------------------------------------------

    def _kf_frame_features(self, kf: int):
        """Wrap a keyframe's stored features as a padded FrameData view."""
        smap = self.map
        n = int(smap.kf_n_feat[kf])
        fd = FrameData(
            frame_id=int(smap.kf_frame_id[kf]),
            timestamp=float(smap.kf_timestamp[kf]),
            uv=smap.kf_feat_uv[kf, :n].astype(np.float64),
            octave=smap.kf_feat_octave[kf, :n].astype(np.int32),
            angle=smap.kf_feat_angle[kf, :n],
            descriptors=smap.kf_feat_desc[kf, :n],
            right=smap.kf_feat_right[kf, :n].astype(np.float64),
            depth=smap.kf_feat_depth[kf, :n].astype(np.float64),
        )
        return fd

    def _triangulate_new_points(self, kf: int, num_neighbors: int = 10,
                                feature_distance: int = 50,
                                epipolar_distance: float = 4.0,
                                error_mono: float = 2.1):
        """CreateNewMapPoints: triangulate vs top covisible KFs
        (LocalMapping.cpp:317-329, Triangulator.cpp:15-111)."""
        disp = self._tri_dispatch(kf, num_neighbors, feature_distance,
                                  epipolar_distance, error_mono)
        if disp is None:
            return 0
        out, ctx = disp
        valid_all, match_all, pts_all = fetch_np(
            out["valid"], out["match_b"], out["point"]
        )
        return self._tri_commit(kf, valid_all, match_all,
                                pts_all.astype(np.float64), ctx)

    def _tri_dispatch(self, kf: int, num_neighbors: int = 10,
                      feature_distance: int = 50,
                      epipolar_distance: float = 4.0,
                      error_mono: float = 2.1):
        """Async half of triangulation: stage + dispatch, no blocking."""
        smap = self.map
        ids, w = smap.covisible_keyframes(kf, min_weight=15)
        neighbors = ids[:min(num_neighbors, TRI_NB)]
        if len(neighbors) == 0:
            return None
        n_slots = self.s.feature_slots
        free_a = np.zeros(n_slots, dtype=bool)
        na = int(smap.kf_n_feat[kf])
        free_a[:na] = smap.kf_obs[kf, :na] < 0

        # one vmapped device call over all neighbor pairs (the reference
        # OMP-parallelizes per pair, Triangulator.cpp:42-47).  The batch is
        # padded to the fixed TRI_NB width so exactly one program ever
        # compiles; pad rows get free_b = all-False (no candidates).
        n_actual = len(neighbors)
        padded = list(int(n) for n in neighbors)
        padded += [padded[-1]] * (TRI_NB - n_actual)
        pool = smap.kf_feature_pool(n_slots)
        slots = pool.slots_for([kf] + padded)
        free_b = np.zeros((TRI_NB, n_slots), dtype=bool)
        for i, nb in enumerate(neighbors):
            nbn = int(smap.kf_n_feat[nb])
            free_b[i, :nbn] = smap.kf_obs[nb, :nbn] < 0
        # depth-completion grid: a depth prior per free feature lets the
        # kernel retry epipolar-ambiguous matches in a projection window
        # (ComputeDepthMap, Triangulator.cpp:296-373; the reference
        # restricts the guided pass to the top-3 neighbors for CPU cost —
        # all pairs get it here, it is mask arithmetic on the device)
        grid = keyframe_depth_grid(smap, kf, self.s.width, self.s.height)

        stage = jnp.asarray(_pack_tri_stage(
            free_a, free_b, smap.kf_pose[kf], smap.kf_pose[padded],
            slots, self.s.th_depth, grid,
        ))
        out = _triangulate_pool(
            pool.arrays, stage, self.cam, self.bf, self.scales,
            self.inv_sigma2,
            feature_distance=feature_distance,
            epipolar_distance=epipolar_distance,
            error_mono=error_mono,
            bounds_wh=(float(self.s.width), float(self.s.height)),
            n_slots=n_slots, grid_shape=tuple(grid.shape),
        )
        return out, dict(neighbors=neighbors, free_a=free_a)

    def _tri_commit(self, kf: int, valid_all, match_all, pts_all, ctx):
        """Host commit half of triangulation (drift-compensated in the
        reference, Triangulator.cpp:52-109; here the map is only mutated by
        the same serialized worker, so poses cannot drift mid-flight)."""
        smap = self.map
        if not smap.kf_valid[kf]:
            return 0  # culled since dispatch (pipelined flush)
        neighbors = ctx["neighbors"]
        free_a = ctx["free_a"]
        # vectorized commit: collect accepted candidates per neighbor
        # (earlier neighbors claim features first, Triangulator.cpp:52-109),
        # then one bulk allocation + per-keyframe bulk observation links
        sel_i: list[np.ndarray] = []
        sel_j: list[np.ndarray] = []
        sel_nb: list[int] = []
        sel_wp: list[np.ndarray] = []
        # re-check freeness at COMMIT time: the pipelined fuse/association
        # passes may have linked some of these feature slots since dispatch
        # — bulk-adding over them would silently clobber the existing link
        free_now = free_a & (smap.kf_obs[kf, :len(free_a)] < 0)
        for bi, nb in enumerate(int(n) for n in neighbors):
            cand = np.nonzero(valid_all[bi] & free_now)[0]
            if len(cand) == 0:
                continue
            j = match_all[bi][cand]
            ok = smap.kf_obs[nb, j] < 0
            # a neighbor feature may win multiple rows; keep the first
            _, first = np.unique(j, return_index=True)
            keep = np.zeros(len(j), dtype=bool)
            keep[first] = True
            cand, j = cand[ok & keep], j[ok & keep]
            if len(cand) == 0:
                continue
            free_now[cand] = False
            sel_i.append(cand)
            sel_j.append(j)
            sel_nb.append(nb)
            sel_wp.append(pts_all[bi][cand])
        if not sel_i:
            return 0
        all_i = np.concatenate(sel_i)
        wps = np.concatenate(sel_wp)
        cam_pos = -smap.kf_pose[kf][:3, :3].T @ smap.kf_pose[kf][:3, 3]
        normals = cam_pos[None, :] - wps
        depths = np.linalg.norm(normals, axis=1)
        normals = normals / np.maximum(depths, 1e-9)[:, None]
        ids = smap.allocate_points_bulk(
            wps, smap.kf_feat_desc[kf, all_i], kf, depths,
            smap.kf_feat_octave[kf, all_i], normals,
        )
        smap.add_observations_bulk(kf, all_i, ids)
        off = 0
        for cand, j, nb in zip(sel_i, sel_j, sel_nb):
            smap.add_observations_bulk(nb, j, ids[off:off + len(cand)])
            off += len(cand)
        self.recent_points.extend((int(p), kf) for p in ids)
        return len(ids)

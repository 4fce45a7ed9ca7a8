"""Local bundle adjustment driver: window selection, packing, write-back.

Host side of the reference's LocalBundleAdjustment
(reference: Snake/Optimizer/LocalBundleAdjustment.cpp): window = up to 15
covisible + 15 temporally previous keyframes plus fixed boundary keyframes
observing shared points (:94-184), solve (3 LM iterations, :353-366),
chi2 outlier classification and erase (:369-412), commit with a map-state
conflict check (:463-499).  The solve itself is the jitted dense-Schur LM in
ops/ba.py with fixed (C, P, M) slots so it compiles once.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.map.slam_map import SlamMap
from snakeslam_tpu.ops import ba as BA
from snakeslam_tpu.optim.packing import (
    erase_outlier_observations,
    pack_observations,
)
from snakeslam_tpu.system.settings import Settings

F32 = np.float32


class LocalBA:
    def __init__(self, settings: Settings, smap: SlamMap, imu_solver=None):
        self.imu_solver = imu_solver
        self.s = settings
        self.map = smap
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy)
        self.bf = jnp.float32(settings.bf)
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        self.n_runs = 0

    def add(self, kf: int):
        """Queue interface (delay 0, synchronous in deterministic mode —
        DelayedParallelMapOptimization with delay 0,
        LocalBundleAdjustment.cpp:23-24)."""
        self.run(kf)

    # ------------------------------------------------------------------

    def select_window(self, kf: int):
        """Window KFs (optimized) + boundary KFs (fixed)
        (LocalBundleAdjustment.cpp:94-184)."""
        smap = self.map
        ids, w = smap.covisible_keyframes(kf, min_weight=1)
        window = [kf] + [int(k) for k in ids[:15]]
        # previous keyframes along the temporal chain
        cur = kf
        for _ in range(15):
            prev = smap.kf_prev[cur]
            if prev < 0 or not smap.kf_valid[prev]:
                break
            if prev not in window:
                window.append(int(prev))
            cur = prev
        window = window[: self.s.lba_cam_slots - 8]  # leave room for boundary

        # points observed by the window
        pts = np.unique(np.concatenate(
            [smap.keyframe_points(k) for k in window]
        )) if window else np.array([], dtype=np.int64)
        pts = pts[smap.pt_valid[pts]]
        if len(pts) > self.s.lba_point_slots:
            pts = pts[: self.s.lba_point_slots]

        # boundary: other KFs observing those points -> fixed
        obs_kfs = smap.pt_obs_kf[pts].ravel()
        obs_kfs = np.unique(obs_kfs[obs_kfs >= 0])
        in_window = np.zeros(smap.max_keyframes, dtype=bool)
        in_window[window] = True
        boundary = [int(k) for k in obs_kfs if not in_window[k]]
        boundary = boundary[: self.s.lba_cam_slots - len(window)]
        return window, boundary, pts

    def pack(self, window, boundary, pts):
        smap = self.map
        C = self.s.lba_cam_slots
        # bucket the point-slot padding (powers of two up to the configured
        # cap): the solve is jit-cached per bucket, and transfer + compute
        # scale with the bucket size, not the worst case
        # floor at slots/4 so the bucket ladder has at most 3 rungs: mid-run
        # bucket growth recompiles the whole solve, which costs far more
        # than the extra padded rows on a batched problem
        P = self.s.lba_point_slots
        p_bucket = max(1024, self.s.lba_point_slots // 4)
        while p_bucket < len(pts):
            p_bucket *= 2
        P = min(p_bucket, self.s.lba_point_slots)
        M = self.s.lba_obs_slots
        cams = window + boundary

        cam_pose = np.tile(np.eye(4, dtype=F32), (C, 1, 1))
        cam_fixed = np.ones(C, dtype=bool)
        cam_valid = np.zeros(C, dtype=bool)
        cam_pose[: len(cams)] = smap.kf_pose[cams]
        cam_valid[: len(cams)] = True
        cam_fixed[: len(window)] = False
        # gauge: boundary KFs are the fixed anchors (like the reference);
        # with no boundary, hold the oldest window KF fixed
        if len(boundary) == 0 and len(window) > 1:
            cam_fixed[len(window) - 1] = True

        slot_of_kf = np.full(smap.max_keyframes, -1, dtype=np.int32)
        slot_of_kf[cams] = np.arange(len(cams), dtype=np.int32)

        points = np.zeros((P, 3), dtype=F32)
        point_valid = np.zeros(P, dtype=bool)
        npts = len(pts)
        points[:npts] = smap.pt_pos[pts]
        point_valid[:npts] = True

        obs = pack_observations(smap, pts, slot_of_kf, P, M,
                                self.pyramid.inv_scales)

        # IMU relative-rotation constraints between consecutive window KFs
        # (LocalBundleAdjustment.cpp:295-347)
        R_slots = C
        rpc_i = np.zeros(R_slots, dtype=np.int32)
        rpc_j = np.zeros(R_slots, dtype=np.int32)
        rpc_T = np.tile(np.eye(4, dtype=F32), (R_slots, 1, 1))
        rpc_w = np.zeros((R_slots, 6), dtype=F32)
        rpc_valid = np.zeros(R_slots, dtype=bool)
        if self.imu_solver is not None:
            rpc = self.imu_solver.rpc_for_window(window)
            if rpc:
                for r, (ki, kj, T, w_t, w_r) in enumerate(rpc[:R_slots]):
                    rpc_i[r] = slot_of_kf[ki]
                    rpc_j[r] = slot_of_kf[kj]
                    rpc_T[r] = T
                    rpc_w[r, :3] = w_t
                    rpc_w[r, 3:] = w_r
                    rpc_valid[r] = True

        # one flat H2D upload for the whole problem (16 fields): small
        # transfers cost per transfer, not per byte
        problem = BA.problem_to_device(
            cam_pose, cam_fixed, cam_valid, points, point_valid,
            obs["obs_cam"], obs["obs_uv"], obs["obs_right"],
            obs["obs_weight"], obs["obs_valid"],
            rpc_i, rpc_j, rpc_T, rpc_w, rpc_valid,
        )
        # identity stamps for the guarded commit: the pipelined flush
        # commits one cycle late, and both pools recycle slots — a pose or
        # position written to a recycled slot would clobber an unrelated
        # new keyframe/point (pt_valid/kf_valid alone cannot tell)
        aux = dict(cams=cams, pts=pts, n_window=len(window),
                   cam_fids=smap.kf_frame_id[cams].copy(),
                   pts_gen=smap.pt_alloc_gen[pts].copy(), **obs)
        return problem, aux

    # ------------------------------------------------------------------

    def run(self, kf: int, iterations: int = 3):
        """Snapshot -> solve -> guarded commit (the reference's async-safe
        protocol: pack under the lock, solve lock-free, commit under the
        lock with a mapState conflict check — LocalBundleAdjustment.cpp:
        75-500).  In deterministic mode the lock is uncontended."""
        disp = self.dispatch(kf, iterations)
        if disp is None:
            return
        from snakeslam_tpu.utils.fetch import fetch_list

        # one batched round trip for all three result arrays
        self.commit(kf, fetch_list(disp[0]), disp[1], check_state=True)

    def dispatch(self, kf: int, iterations: int = 3):
        """Async half: snapshot + pack + dispatch the solve, no blocking.
        Returns ([device arrays], ctx) or None."""
        smap = self.map
        with smap.lock:
            if not smap.kf_valid[kf]:
                return None
            window, boundary, pts = self.select_window(kf)
            if len(window) < 2 or len(pts) < 20:
                return None
            state_before = smap.state
            problem, aux = self.pack(window, boundary, pts)

        # device solve runs without the map lock
        cam_pose, points, cost = BA.solve_ba(
            problem, self.cam, self.bf, iterations=iterations
        )
        outliers = BA.classify_outliers(
            problem, self.cam, self.bf, cam_pose, points
        )
        aux["state_before"] = state_before
        return [cam_pose, points, outliers], aux

    def commit(self, kf: int, fetched, aux, check_state: bool = True):
        """Guarded write-back.  check_state=False is the serialized-worker
        mode: the only mutations since pack were this worker's own
        triangulation/fusion commits (one-cycle lag, the reference's async
        LBA behaves identically), so per-element guards below replace the
        whole-map conflict drop."""
        smap = self.map
        cam_pose, points, outliers = fetched
        with smap.lock:
            if check_state and smap.state != aux["state_before"]:
                # optimistic-concurrency drop on concurrent modification
                return
            cam_pose = cam_pose.astype(np.float64)
            points = points.astype(np.float64)
            win = aux["cams"][: aux["n_window"]]
            # a degenerate window (e.g. during blackout recovery: few
            # shared points, near-singular Schur) can diverge to NaN —
            # never commit a non-finite pose/point (the reference's solver
            # reports success flags; here finiteness is the guard)
            cam_ok = np.isfinite(cam_pose[: len(win)]).all(axis=(1, 2))
            win_arr = np.asarray(win)
            # identity guard: skip slots culled or recycled since pack
            cam_ok &= (smap.kf_valid[win_arr]
                       & (smap.kf_frame_id[win_arr]
                          == aux["cam_fids"][: len(win)]))
            win_arr = win_arr[cam_ok]
            smap.kf_pose[win_arr] = cam_pose[: len(win)][cam_ok]
            pts_arr = np.asarray(aux["pts"])
            live = smap.pt_valid[pts_arr]
            live &= smap.pt_alloc_gen[pts_arr] == aux["pts_gen"]
            pt_new = points[: len(pts_arr)]
            live &= np.isfinite(pt_new).all(axis=1)
            smap.pt_pos[pts_arr[live]] = pt_new[live]

            erase_outlier_observations(
                smap, aux["pts"], outliers, aux["obs_kf_id"],
                aux["obs_feat"], aux["obs_valid"],
            )
            smap.state += 1
            self.n_runs += 1

"""Global bundle adjustment + outlier removal over the whole map.

Host side of the reference's GlobalBundleAdjustment (reference:
Snake/Optimizer/GlobalBundleAdjustment.cpp): FullBA holds the latest
keyframe constant so asynchronous tracking survives (:376-378), PointBA
optimizes points only (:103-123), and Map::removeOutliers erases
high-residual observations (Snake/Map/Map.cpp:486-501).

Shapes are bucketed to powers of two so the jitted solver recompiles only
when the map crosses a size bucket.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.map.slam_map import MAX_OBS, SlamMap
from snakeslam_tpu.ops import ba as BA
from snakeslam_tpu.optim.packing import (
    erase_outlier_observations,
    pack_observations,
)
from snakeslam_tpu.system.settings import Settings

F32 = np.float32


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


import functools

import jax


@jax.jit
def _realign_batch(Ts, obs, cam, bf):
    """Jitted vmapped pose-only refinement (eager vmap would re-trace
    per invocation and dispatch op-by-op)."""
    from snakeslam_tpu.ops.pose_solver import robust_pose_refine

    return jax.vmap(
        lambda T, o: robust_pose_refine(T, o, cam, bf)
    )(Ts, obs)


@functools.partial(jax.jit, static_argnames=("levels",))
def _rematch_batch(lm, feats_stack, poses, cam, bf, bounds, scales, log_sf,
                   levels: int):
    """Jitted vmapped projection re-match for intermediate frames."""
    from snakeslam_tpu.ops import matching as M

    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=levels)

    def one(feats, pose):
        out = M.search_by_projection_fine(
            lm, feats, pose, cam, bf,
            (bounds[0], bounds[1], bounds[2], bounds[3]), st,
            feat_free=feats.valid, th=2.0, ratio=0.9,
        )
        return out["feat_point"]

    return jax.vmap(one)(feats_stack, poses)


class GlobalBA:
    def __init__(self, settings: Settings, smap: SlamMap, imu_solver=None):
        self.s = settings
        self.map = smap
        self.imu_solver = imu_solver
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy)
        self.bf = jnp.float32(settings.bf)
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        # multi-device: with n_devices > 1 FullBA runs through the sharded
        # dp-mesh solver — points/observations sharded over the mesh, the
        # reduced camera system psum'ed across devices (parallel/multichip.py)
        self._mesh = None
        self._sharded_fns: dict = {}
        n_devices = getattr(settings, "n_devices", 1)
        if n_devices > 1:
            if len(jax.devices()) < n_devices:
                raise ValueError(
                    f"n_devices={n_devices} but only {len(jax.devices())} "
                    f"devices exist")
            from snakeslam_tpu.parallel import multichip as MC

            self._mesh = MC.make_mesh(n_devices)

    def _sharded_full_ba(self, problem, iterations: int):
        from snakeslam_tpu.parallel import multichip as MC

        fn = self._sharded_fns.get(iterations)
        if fn is None:
            fn = MC.sharded_ba_step(self._mesh, self.cam, self.bf,
                                    n_iters=iterations)
            self._sharded_fns[iterations] = fn
        return fn(MC.shard_problem(problem, self._mesh))

    # ------------------------------------------------------------------

    def pack_full(self, obs_slots: int = 16):
        smap = self.map
        kfs = smap.valid_keyframes()
        kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
        pts = smap.valid_points()
        C = _bucket(len(kfs))
        P = _bucket(len(pts), minimum=256)
        M = obs_slots

        cam_slot = {int(k): i for i, k in enumerate(kfs)}
        cam_pose = np.tile(np.eye(4, dtype=F32), (C, 1, 1))
        cam_fixed = np.ones(C, dtype=bool)
        cam_valid = np.zeros(C, dtype=bool)
        cam_pose[: len(kfs)] = smap.kf_pose[kfs]
        cam_valid[: len(kfs)] = True
        cam_fixed[: len(kfs)] = False
        # gauge: first KF fixed; latest KF constant (GBA:376-378)
        cam_fixed[0] = True
        cam_fixed[len(kfs) - 1] = True

        points = np.zeros((P, 3), dtype=F32)
        point_valid = np.zeros(P, dtype=bool)
        points[: len(pts)] = smap.pt_pos[pts]
        point_valid[: len(pts)] = True

        slot_of_kf = np.full(smap.max_keyframes, -1, dtype=np.int32)
        slot_of_kf[kfs] = np.arange(len(kfs), dtype=np.int32)
        obs = pack_observations(smap, pts, slot_of_kf, P, M,
                                self.pyramid.inv_scales)

        # IMU relative-pose constraints over the whole keyframe chain
        # (GlobalBundleAdjustment.cpp:427-481)
        rpc_i = np.zeros(1, dtype=np.int32)
        rpc_j = np.zeros(1, dtype=np.int32)
        rpc_T = np.tile(np.eye(4, dtype=F32), (1, 1, 1))
        rpc_w = np.zeros((1, 6), dtype=F32)
        rpc_valid = np.zeros(1, dtype=bool)
        if self.imu_solver is not None:
            rpc = self.imu_solver.rpc_for_window([int(k) for k in kfs])
            if rpc:
                R = C
                rpc_i = np.zeros(R, dtype=np.int32)
                rpc_j = np.zeros(R, dtype=np.int32)
                rpc_T = np.tile(np.eye(4, dtype=F32), (R, 1, 1))
                rpc_w = np.zeros((R, 6), dtype=F32)
                rpc_valid = np.zeros(R, dtype=bool)
                for r, (ki, kj, T, w_t, w_r) in enumerate(rpc[:R]):
                    rpc_i[r] = slot_of_kf[ki]
                    rpc_j[r] = slot_of_kf[kj]
                    rpc_T[r] = T
                    rpc_w[r, :3] = w_t
                    rpc_w[r, 3:] = w_r
                    rpc_valid[r] = True

        problem = BA.problem_to_device(
            cam_pose, cam_fixed, cam_valid, points, point_valid,
            obs["obs_cam"], obs["obs_uv"], obs["obs_right"],
            obs["obs_weight"], obs["obs_valid"],
            rpc_i, rpc_j, rpc_T, rpc_w, rpc_valid,
        )
        aux = dict(kfs=kfs, pts=pts, **obs)
        return problem, aux

    # ------------------------------------------------------------------

    def full_ba(self, iterations: int = 5):
        smap = self.map
        if smap.n_keyframes < 2 or smap.n_points < 20:
            return
        problem, aux = self.pack_full()
        if self._mesh is not None:
            cam_pose, points = self._sharded_full_ba(problem, iterations)
            cost = float("nan")
        else:
            cam_pose, points, cost = BA.solve_ba(
                problem, self.cam, self.bf, iterations=iterations
            )
        cam_pose = np.asarray(cam_pose, dtype=np.float64)
        points = np.asarray(points, dtype=np.float64)
        smap.kf_pose[aux["kfs"]] = cam_pose[: len(aux["kfs"])]
        smap.pt_pos[aux["pts"]] = points[: len(aux["pts"])]
        smap.state += 1
        return float(cost)

    def point_ba(self, iterations: int = 4):
        smap = self.map
        if smap.n_points < 10:
            return
        problem, aux = self.pack_full()
        points = np.asarray(
            BA.solve_point_only(problem, self.cam, self.bf,
                                iterations=iterations),
            dtype=np.float64,
        )
        smap.pt_pos[aux["pts"]] = points[: len(aux["pts"])]
        smap.state += 1

    def realign_intermediate_frames(self, frames):
        """Pose-only refinement of all tracked (non-keyframe) frames against
        the final map — RealignIntermiediateFrames parity
        (GlobalBundleAdjustment.cpp:124-329).  Frames are batched and solved
        with a vmapped robust pose GN in one device dispatch."""
        import jax

        from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine

        smap = self.map
        N = self.s.feature_slots
        batch_T, batch_obs, out_frames = [], [], []
        for f in frames:
            if f.pose_cw is None or f.matches is None or f.is_keyframe:
                continue
            m = (f.matches >= 0) & smap.pt_valid[np.maximum(f.matches, 0)]
            if m.sum() < 10:
                continue
            n = min(f.n, N)
            pts = np.zeros((N, 3), dtype=F32)
            uv = np.zeros((N, 2), dtype=F32)
            right = np.full(N, -1.0, dtype=F32)
            w = np.ones(N, dtype=F32)
            mask = np.zeros(N, dtype=bool)
            sel = np.nonzero(m[:n])[0]
            pts[sel] = smap.pt_pos[f.matches[sel]]
            uv[:n] = f.uv[:n]
            right[:n] = f.right[:n]
            inv_scale = self.pyramid.inv_scales
            w[:n] = inv_scale[np.clip(f.octave[:n], 0, len(inv_scale) - 1)]
            mask[sel] = True
            # start from the pose composed through the reference keyframe:
            # after a loop correction the stored absolute pose is in the
            # pre-correction basis and the GN would start a basin away
            T0 = f.pose_cw
            if (f.rel_to_ref is not None and f.ref_kf >= 0
                    and smap.kf_valid[f.ref_kf]
                    and smap.kf_frame_id[f.ref_kf] == f.ref_frame_id):
                T0 = f.rel_to_ref @ smap.kf_pose[f.ref_kf]
            batch_T.append(T0.astype(F32))
            batch_obs.append((pts, uv, right, w, mask))
            out_frames.append(f)
        if not out_frames:
            return 0
        obs = PoseObs(
            points=jnp.asarray(np.stack([o[0] for o in batch_obs])),
            uv=jnp.asarray(np.stack([o[1] for o in batch_obs])),
            right=jnp.asarray(np.stack([o[2] for o in batch_obs])),
            weight=jnp.asarray(np.stack([o[3] for o in batch_obs])),
            mask=jnp.asarray(np.stack([o[4] for o in batch_obs])),
        )
        Ts = jnp.asarray(np.stack(batch_T))
        refined, inl, n_inl = _realign_batch(Ts, obs, self.cam, self.bf)
        refined = np.asarray(refined, dtype=np.float64)
        n_inl = np.asarray(n_inl)
        for i, f in enumerate(out_frames):
            if n_inl[i] >= 10:
                f.pose_cw = refined[i]
                if (f.ref_kf >= 0 and smap.kf_valid[f.ref_kf]
                        and smap.kf_frame_id[f.ref_kf] == f.ref_frame_id):
                    f.capture_rel(smap.kf_pose[f.ref_kf],
                                  smap.kf_frame_id[f.ref_kf])
                else:
                    # reference culled: the realigned absolute pose (solved
                    # against the FINAL map) is the authoritative estimate —
                    # composing through a cull-time anchor rel would
                    # resurrect whatever error got the reference culled
                    f.rel_to_ref = None
        return len(out_frames)

    def rematch_intermediate(self, frames, max_group: int = 32):
        """Re-match non-keyframe frames against the final map before the
        pose-only realign — RematchIntermiediate parity
        (System.cpp:269-303).  Frames sharing a reference keyframe are
        vmapped through the projection matcher in one device call."""
        import jax

        from snakeslam_tpu.map.slam_map import SlamMap  # noqa: F401
        from snakeslam_tpu.ops import matching as M
        from snakeslam_tpu.tracking.staging import pad_frame_features

        smap = self.map
        N = self.s.feature_slots
        P = self.s.local_map_slots
        st = M.ScaleTables(
            scales=jnp.asarray(self.pyramid.scales),
            log_scale_factor=jnp.float32(self.pyramid.log_scale_factor),
            levels=self.pyramid.levels,
        )
        bounds = (0.0, 0.0, float(self.s.width), float(self.s.height))

        def search_batch(lm, feats_stack, poses):
            return _rematch_batch(
                lm, feats_stack, poses, self.cam, self.bf,
                jnp.asarray(bounds, dtype=jnp.float32),
                st.scales, st.log_scale_factor, int(st.levels),
            )

        # group by reference keyframe
        groups: dict[int, list] = {}
        for f in frames:
            if (f.is_keyframe or f.pose_cw is None or f.ref_kf < 0
                    or not smap.kf_valid[f.ref_kf]):
                continue
            groups.setdefault(int(f.ref_kf), []).append(f)

        n_rematched = 0
        for ref, fs in groups.items():
            ids, _ = smap.covisible_keyframes(ref, min_weight=15)
            kfs = [ref] + [int(k) for k in ids[:10]]
            pts = np.unique(np.concatenate(
                [smap.keyframe_points(k) for k in kfs]
            ))
            pts = pts[smap.pt_valid[pts]][:P]
            if len(pts) < 20:
                continue
            lm, lm_ids = smap.device_mirror().gather(pts, P)
            for chunk_start in range(0, len(fs), max_group):
                chunk = fs[chunk_start:chunk_start + max_group]
                feats = [pad_frame_features(f, N) for f in chunk]
                feats_stack = jax.tree.map(
                    lambda *xs: jnp.stack(xs), *feats
                )
                poses = jnp.asarray(
                    np.stack([f.pose_cw for f in chunk]), dtype=jnp.float32
                )
                fp = np.asarray(search_batch(lm, feats_stack, poses))
                for i, f in enumerate(chunk):
                    assign = fp[i][: f.n].astype(np.int64)
                    matches = np.full(f.n, -1, dtype=np.int64)
                    sel = assign >= 0
                    matches[sel] = lm_ids[assign[sel]]
                    if sel.sum() >= 10:
                        f.matches = matches
                        n_rematched += 1
        return n_rematched

    def remove_outliers(self, factor: float = 0.75):
        """Erase observations with chi2 above factor * threshold^2
        (System.cpp:202-205 uses 0.75 * th^2 before the final BA)."""
        smap = self.map
        problem, aux = self.pack_full()
        out = np.asarray(BA.classify_outliers(
            problem, self.cam, self.bf, problem.cam_pose, problem.points,
            chi2_mono=factor * 2.1**2, chi2_stereo=factor * 2.3**2,
        ))
        removed = erase_outlier_observations(
            smap, aux["pts"], out, aux["obs_kf_id"], aux["obs_feat"],
            aux["obs_valid"],
        )
        smap.state += 1
        return removed

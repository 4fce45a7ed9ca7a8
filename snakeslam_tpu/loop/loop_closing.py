"""Loop closing: detection, Sim3 verification, and global correction.

Host orchestration mirroring the reference's LoopClosing + LoopDetector +
LoopClosingPGO (reference: Snake/LoopClosing/LoopClosing.cpp:29-59 process
loop + cool-down, LoopDetector.cpp:45-145 candidate gating + temporal
consistency, :148-375 Sim3 geometric verification, LoopClosing.cpp:184-447
CorrectLoop, LoopClosingPGO.cpp:16-263 essential-graph optimization).

The compute-heavy pieces are the jitted kernels: BoW scoring (ops/bow),
descriptor matching (ops/matching), Sim3 registration RANSAC
(ops/sim3_solver), and the Sim3 pose-graph GN (ops/pgo).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.loop.keyframe_database import KeyframeDatabase
from snakeslam_tpu.map.slam_map import SlamMap, transform_pose_cw
from snakeslam_tpu.ops import bow as BOW
from snakeslam_tpu.ops import matching as M
from snakeslam_tpu.ops.pgo import PoseGraph, solve_pgo
from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine
from snakeslam_tpu.ops.sim3_solver import sim3_ransac
from snakeslam_tpu.system.settings import InputType, Settings
from snakeslam_tpu.tracking.staging import kf_features_cached, snapshot_points

MIN_LOOP_KF_GAP = 10        # candidate must be this many KFs older
COOLDOWN_KFS = 4            # LoopClosing.cpp:29-59
MIN_SIM3_INLIERS = 20
MIN_POSE_REF_INLIERS = 30   # LoopDetector.cpp:287
MIN_CLOSE_POINTS = 30       # LoopDetector.cpp:310
MIN_SCALE_INLIERS = 15      # LoopDetector.cpp:351
MIN_TOTAL_MATCHES = 40      # LoopDetector.cpp:449


@jax.jit
def _verify_search_refine(lm, feat, T0, cam, bf, bounds, st):
    """Guided projection re-search of loop points into the current keyframe
    at the corrected pose + robust pose refinement (the reference's
    post-RANSAC verification core, LoopDetector.cpp:272-290:
    SearchByProjectionFrameToKeyframe(radius 5, th 50) + RefinePoseWithMatches).

    Returns (T_refined, assign, inlier_mask, n_inliers, range_m, depth_meas).
    """
    out = M.search_by_projection_fine(
        lm, feat, T0, cam, bf, bounds, st,
        feat_free=feat.valid, th=5.0, ratio=1.0, feature_error=50,
    )
    assign = out["feat_point"]
    matched = assign >= 0
    P = lm.position.shape[0]
    pidx = jnp.clip(assign, 0, P - 1)
    inv_scales = 1.0 / st.scales
    obs = PoseObs(
        points=lm.position[pidx], uv=feat.uv, right=feat.right,
        weight=inv_scales[jnp.clip(feat.octave, 0, st.levels - 1)],
        mask=matched,
    )
    T1, inlier, n_inl = robust_pose_refine(
        T0, obs, cam, bf, outer_iters=3, inner_iters=3)
    inlier = inlier & matched
    # range (norm) of each matched loop point in the refined frame — the
    # reference's per-point scale consensus uses (pose * p).norm()
    # (LoopDetector.cpp:332-334)
    pc = lie.transform_points(T1, lm.position[pidx])
    rng = jnp.linalg.norm(pc, axis=-1)
    # measured stereo depth for the close-point gate (mono features carry
    # right < 0 -> depth -1, always "close", LoopDetector.cpp:294-314)
    depth_meas = jnp.where(
        feat.right > 0,
        bf / jnp.maximum(feat.uv[:, 0] - feat.right, 1e-3),
        -1.0,
    )
    return T1, assign, inlier, n_inl, rng, depth_meas


class LoopClosing:
    def __init__(self, settings: Settings, smap: SlamMap,
                 database: KeyframeDatabase, gba=None, tracker=None):
        self.s = settings
        self.map = smap
        self.db = database
        self.gba = gba
        self.tracker = tracker
        self.use_scale = settings.input_type == InputType.Mono
        self.last_loop_kf = -COOLDOWN_KFS
        self.prev_candidates: set[int] = set()
        self.consistency_count = 0
        self.n_loops_closed = 0
        self.key = jax.random.PRNGKey(settings.random_seed + 7)
        self._searcher = None
        # device-side config for the geometric verification re-search
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy)
        self.bf = jnp.float32(settings.bf)
        self.bounds = (jnp.float32(0.0), jnp.float32(0.0),
                       jnp.float32(settings.width),
                       jnp.float32(settings.height))
        pyr = ScalePyramid.create(settings.fd_levels,
                                  settings.fd_scale_factor)
        self.st = M.ScaleTables(
            scales=jnp.asarray(pyr.scales),
            log_scale_factor=jnp.float32(pyr.log_scale_factor),
            levels=pyr.levels,
        )

    def _map_searcher(self):
        """Lazily built projection-fusion helper for SearchAndFuse."""
        if self._searcher is None:
            from snakeslam_tpu.mapping.fusion import MapSearcher
            self._searcher = MapSearcher(self.s, self.map)
        return self._searcher

    # ------------------------------------------------------------------

    def add(self, kf: int):
        self.process(kf)

    def process(self, kf: int):
        """Detect + correct, then register the KF in the database."""
        try:
            if self.map.n_keyframes >= MIN_LOOP_KF_GAP:
                hit = self._detect(kf)
                if hit is not None:
                    cand, s, R, t, pairs = hit
                    self._correct_loop(kf, cand, s, R, t, pairs)
                    self.n_loops_closed += 1
                    self.last_loop_kf = kf
        finally:
            self.db.add(kf)

    # ------------------------------------------------------------------

    def _detect(self, kf: int):
        smap = self.map
        kf_seq = {int(k): i for i, k in enumerate(smap.valid_keyframes())}
        if kf_seq.get(kf, 0) - kf_seq.get(self.last_loop_kf, -10**9) < COOLDOWN_KFS:
            return None

        # adaptive min score: min BoW similarity to the covisible group
        # (LoopDetector.cpp:45-103)
        cov, _ = smap.covisible_keyframes(kf, min_weight=15)
        if len(cov) == 0:
            return None
        v_kf = self.db.vectors[kf] if self.db.present[kf] else None
        w_kf = self.db.words.get(kf)
        if v_kf is None or not v_kf.any():
            n = int(smap.kf_n_feat[kf])
            w_kf, v_kf = self.db.compute_frame_vector(
                smap.kf_feat_desc[kf, :n])
            w_kf = np.unique(w_kf)
        cov_present = [c for c in cov if self.db.present[c]]
        if not cov_present:
            return None
        # host-side L1 score (vectors are host-resident; see
        # keyframe_database.query)
        cov_scores = 1.0 - 0.5 * np.abs(
            v_kf[None] - self.db.vectors[cov_present]
        ).sum(axis=-1)
        min_score = max(float(cov_scores.min()) * 0.8, 0.01)

        # temporal-gap exclusions go in BEFORE the ratio filters so recent
        # keyframes cannot eat the score-ratio budget of true candidates
        too_recent = {
            int(k) for k in smap.valid_keyframes()
            if kf_seq.get(kf, 0) - kf_seq.get(int(k), 0) < MIN_LOOP_KF_GAP
        }
        ids, scores = self.db.detect_loop_candidates(
            kf, min_score, top_n=5, v=v_kf, words=w_kf,
            extra_exclude=too_recent,
        )
        ids = [int(i) for i in ids]
        if not ids:
            self.consistency_count = 0
            self.prev_candidates = set()
            return None

        # temporal consistency >= 2 (LoopDetector.cpp:105-145): a candidate
        # (or its covisible group) must reappear in consecutive detections
        groups = set(ids)
        for i in list(ids):
            c, _ = smap.covisible_keyframes(i, min_weight=15)
            groups |= set(int(x) for x in c)
        consistent = bool(groups & self.prev_candidates)
        self.prev_candidates = groups
        if consistent:
            self.consistency_count += 1
        else:
            self.consistency_count = 1
        if self.consistency_count < 2:
            return None

        # geometric verification against the best candidates
        for cand in ids[:3]:
            hit = self._compute_sim3(kf, int(cand))
            if hit is not None:
                return (int(cand),) + hit
        return None

    def _compute_sim3(self, kf: int, cand: int):
        """Match map points of the two KFs, register Sim3
        (LoopDetector::ComputeSim3, :148-375)."""
        smap = self.map
        pairs = self._match_points(kf, cand)
        if pairs is None or len(pairs[0]) < MIN_SIM3_INLIERS:
            return None
        pts_new, pts_old = pairs  # current-side / loop-side point ids
        src = smap.pt_pos[pts_new]      # drifted current-side coordinates
        dst = smap.pt_pos[pts_old]      # loop-side coordinates
        self.key, sub = jax.random.split(self.key)
        scene_scale = max(float(smap.kf_median_depth[kf]), 1.0)
        # pad to a shape bucket: the pair count varies per candidate and
        # unpadded shapes would recompile the RANSAC per pair
        npairs = len(src)
        pad = -(-npairs // 256) * 256
        srcp = np.zeros((pad, 3), dtype=np.float32)
        srcp[:npairs] = src
        dstp = np.zeros((pad, 3), dtype=np.float32)
        dstp[:npairs] = dst
        s, R, t, inl, n = sim3_ransac(
            jnp.asarray(srcp), jnp.asarray(dstp),
            jnp.asarray(np.arange(pad) < npairs), sub,
            threshold=0.05 * scene_scale,
            with_scale=self.use_scale,
        )
        from snakeslam_tpu.utils.fetch import fetch_list

        s, R, t, inl, n = fetch_list([s, R, t, inl, n])  # one round trip
        if int(n) < MIN_SIM3_INLIERS:
            return None
        inl = inl[:npairs]
        return self._verify_sim3(
            kf, cand, float(s), R.astype(np.float64), t.astype(np.float64),
            (pts_new[inl], pts_old[inl]))

    def _verify_sim3(self, kf: int, cand: int, s: float, R: np.ndarray,
                     t: np.ndarray, ransac_pairs):
        """Geometric verification of a RANSAC Sim3 hypothesis
        (LoopDetector.cpp:262-374): guided projection re-search of the loop
        keyframe's points into the current keyframe at the corrected pose,
        pose refinement with >= 30 inliers, a close-point count gate, robust
        per-point scale re-estimation (mono), and a total-match gate.
        Returns the refined (s, R, t, pairs) or None when any gate fails."""
        smap = self.map
        T_kf = smap.kf_pose[kf]
        T_corr = transform_pose_cw(T_kf, s, R, t)

        # loop-side points observed by the candidate keyframe
        loop_pts = smap.keyframe_points(cand)
        loop_pts = loop_pts[smap.pt_valid[loop_pts]]
        if len(loop_pts) < MIN_POSE_REF_INLIERS:
            return None
        if getattr(self.s, "pin_local_map_bucket", False):
            bucket = self.s.local_map_slots  # one compiled verify program
        else:
            bucket = 512
            while bucket < min(len(loop_pts), self.s.local_map_slots):
                bucket *= 2
        lm, lm_ids = snapshot_points(smap, loop_pts, bucket)
        feat = kf_features_cached(smap, kf, self.s.feature_slots)

        T1, assign, inlier, n_inl, rng, depth_meas = _verify_search_refine(
            lm, feat, jnp.asarray(T_corr, dtype=jnp.float32),
            self.cam, self.bf, self.bounds, self.st,
        )
        from snakeslam_tpu.utils.fetch import fetch_list

        T1, assign, inlier, n_inl, rng, depth_meas = fetch_list(
            [T1, assign, inlier, n_inl, rng, depth_meas])
        if int(n_inl) < MIN_POSE_REF_INLIERS:
            return None
        nf = int(smap.kf_n_feat[kf])
        inlier = inlier[:nf]
        assign = assign[:nf]
        rng = rng[:nf]
        depth_meas = depth_meas[:nf]

        # close-point gate (LoopDetector.cpp:292-314): mono depth_meas = -1
        # always counts close; stereo needs measured depth <= th_depth
        th_depth = float(self.s.th_depth) if self.s.th_depth > 0 else np.inf
        if int(np.sum(inlier & (depth_meas <= th_depth))) < MIN_CLOSE_POINTS:
            return None
        if int(inlier.sum()) < MIN_TOTAL_MATCHES:
            return None

        s_out = s
        if self.use_scale:
            # robust per-point scale consensus (LoopDetector.cpp:317-357):
            # features with BOTH a current-map observation and a matched
            # loop point vote point_scale = |T1 p_loop| / |T_kf p_cur|
            cur_obs = smap.kf_obs[kf, :nf]
            has_cur = (cur_obs >= 0) & smap.pt_valid[np.maximum(cur_obs, 0)]
            vote = inlier & has_cur
            if vote.any():
                p_cur = smap.pt_pos[cur_obs[vote]]
                z2 = np.linalg.norm(
                    p_cur @ T_kf[:3, :3].T + T_kf[:3, 3], axis=-1)
                point_scale = rng[vote] / np.maximum(z2, 1e-9)
                rel = (np.abs(point_scale - s)
                       / np.maximum(np.abs(point_scale), abs(s)))
                good = rel < 0.1
                if int(good.sum()) < MIN_SCALE_INLIERS:
                    return None
                s_out = float(point_scale[good].mean())
            else:
                return None

        # recover the world similarity that maps the refined pose:
        # transform_pose_cw(T_kf, s', R', t') == T1
        T1 = np.asarray(T1, dtype=np.float64)
        Rn = T1[:3, :3]
        R_out = Rn.T @ T_kf[:3, :3]
        t_out = Rn.T @ (s_out * T_kf[:3, 3] - T1[:3, 3])

        # fusion pairs from the re-search: current-side point <-> loop point
        cur_obs = smap.kf_obs[kf, :nf]
        has_cur = (cur_obs >= 0) & smap.pt_valid[np.maximum(cur_obs, 0)]
        pair_sel = inlier & has_cur
        pts_new = cur_obs[pair_sel]
        pts_old = lm_ids[assign[pair_sel]]
        if len(pts_new) < 3:
            pts_new, pts_old = ransac_pairs
        return (s_out, R_out, t_out, (pts_new, pts_old))

    def _match_points(self, kf: int, cand: int):
        """Descriptor matching between the two KFs' observed map points."""
        smap = self.map

        def kf_points(k):
            n = int(smap.kf_n_feat[k])
            feats = np.nonzero(smap.kf_obs[k, :n] >= 0)[0]
            pts = smap.kf_obs[k, feats]
            ok = smap.pt_valid[pts]
            return pts[ok], smap.kf_feat_desc[k, feats[ok]]

        pts_a, desc_a = kf_points(kf)
        pts_b, desc_b = kf_points(cand)
        if len(pts_a) < 20 or len(pts_b) < 20:
            return None
        # host popcount path: one (keyframe, candidate) pair per call, and
        # a device dispatch would pay a blocking fetch per pair
        idx, dist = M.knn2_ratio_match_packed_np(
            desc_a, desc_b, ratio=0.75, max_dist=50,
        )
        sel = idx >= 0
        return pts_a[sel], pts_b[idx[sel]]

    # ------------------------------------------------------------------

    def _correct_loop(self, kf: int, cand: int, s, R, t, pairs):
        """CorrectLoop (LoopClosing.cpp:184-447): rigid+scale correction of
        the current side, point fusion, essential-graph PGO, global BA."""
        smap = self.map
        state_before = smap.state

        kfs = smap.valid_keyframes()
        kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
        kf_index = {int(k): i for i, k in enumerate(kfs)}
        V = len(kfs)

        # corrected pose of the current keyframe under the world similarity
        # x_old = s R x_new + t applied to the current side
        T_kf_corr = transform_pose_cw(smap.kf_pose[kf], s, R, t)

        # ---- build the essential graph from PRE-correction poses ----
        edges = []
        for i, k in enumerate(kfs):
            prev = smap.kf_prev[k]
            if prev >= 0 and smap.kf_valid[prev]:
                M = smap.kf_pose[k] @ np.linalg.inv(smap.kf_pose[prev])
                edges.append((kf_index[int(prev)], i, M, 1.0))
            cov, w = smap.covisible_keyframes(int(k), min_weight=20)
            for c, wt in zip(cov[:10], w[:10]):
                if int(c) < int(k):
                    M = smap.kf_pose[k] @ np.linalg.inv(smap.kf_pose[c])
                    edges.append((kf_index[int(c)], i, M, 0.5))
        # the loop edge ties cand to the corrected current keyframe
        M_loop = T_kf_corr @ np.linalg.inv(smap.kf_pose[cand])
        edges.append((kf_index[cand], kf_index[kf], M_loop, 4.0))

        E = len(edges)
        use_sim3 = self.use_scale
        poses = smap.kf_pose[kfs].copy()

        # rigidly pre-correct the current covisible group by the measured
        # similarity (LoopClosing.cpp:242-263), then hold both loop
        # endpoints constant in the graph optimization
        group, _ = smap.covisible_keyframes(kf, min_weight=15)
        group = set(int(g) for g in group) | {kf}
        for g in group:
            poses[kf_index[g]] = transform_pose_cw(smap.kf_pose[g], s, R, t)
        fixed = np.zeros(V, dtype=bool)
        fixed[kf_index[cand]] = True
        fixed[kf_index[kf]] = True

        # f64 when the runtime allows it (tests enable x64; the default
        # runtime runs f32) -- asking for f64 under a disabled-x64 runtime warns
        # and truncates anyway, so pick the dtype explicitly
        fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        graph = PoseGraph(
            poses=jnp.asarray(poses, dtype=fdt),
            fixed=jnp.asarray(fixed),
            valid=jnp.ones(V, dtype=bool),
            edge_i=jnp.asarray([e[0] for e in edges], dtype=jnp.int32),
            edge_j=jnp.asarray([e[1] for e in edges], dtype=jnp.int32),
            edge_T=jnp.asarray(np.stack([e[2] for e in edges]), dtype=fdt),
            edge_weight=jnp.asarray([e[3] for e in edges], dtype=fdt),
            edge_valid=jnp.ones(E, dtype=bool),
        )
        new_poses, cost = solve_pgo(graph, iterations=25, use_sim3=use_sim3)
        new_poses = np.asarray(new_poses)

        if smap.state != state_before:
            return

        # ---- write back: poses + points via their reference KF ----
        # each point moves by its reference keyframe's before->after
        # similarity (LoopClosingPGO.cpp:152-263)
        old_poses = smap.kf_pose[kfs].copy()
        scales = (np.asarray(lie.sim3_scale(jnp.asarray(new_poses)))
                  if use_sim3 else np.ones(V))
        for i, k in enumerate(kfs):
            P = new_poses[i]
            if use_sim3:
                sR = P[:3, :3]
                P = P.copy()
                P[:3, :3] = sR / scales[i]
                P[:3, 3] = P[:3, 3] / scales[i]
            smap.kf_pose[k] = P
        # transform points: x' = T_new^-1_se3 * (s_ref * (T_old * x))
        pts = smap.valid_points()
        ref = smap.pt_ref_kf[pts]
        ref_ok = (ref >= 0) & smap.kf_valid[np.maximum(ref, 0)]
        ref_rows = np.array([kf_index.get(int(r), -1) for r in ref])
        usable = ref_ok & (ref_rows >= 0)
        rows = ref_rows[usable]
        p_sel = pts[usable]
        To = old_poses[rows]
        Tn = smap.kf_pose[np.asarray(ref[usable], dtype=int)]
        x = smap.pt_pos[p_sel]
        xc = np.einsum("nij,nj->ni", To[:, :3, :3], x) + To[:, :3, 3]
        xc = xc / scales[rows][:, None]  # undo scale drift in camera space
        Rn = Tn[:, :3, :3]
        tn = Tn[:, :3, 3]
        x_new = np.einsum("nji,nj->ni", Rn, xc - tn)
        smap.pt_pos[p_sel] = x_new
        smap.state += 1

        # ---- fuse duplicate loop points ----
        pts_new, pts_old = pairs
        for a, b in zip(pts_new, pts_old):
            if smap.pt_valid[a] and smap.pt_valid[b] and a != b:
                smap.replace_point(int(a), int(b))

        # ---- SearchAndFuse (LoopClosing.cpp:141-145): project each
        # side's map points into the other side's (now-corrected)
        # keyframes and merge every duplicate.  The registration pairs
        # above only couple the ~hundred Sim3 inliers; without this dense
        # fusion the two sides stay almost observation-disjoint and the
        # final FullBA can slide the weakly-coupled block away from the
        # PGO solution.
        searcher = self._map_searcher()
        if searcher is not None:
            cand_group, _ = smap.covisible_keyframes(cand, min_weight=15)
            cand_group = set(int(g) for g in cand_group) | {cand}
            def side_points(kf_set):
                out = []
                for g in kf_set:
                    out.append(smap.keyframe_points(int(g)))
                if not out:
                    return np.array([], dtype=np.int64)
                pts = np.unique(np.concatenate(out))
                return pts[smap.pt_valid[pts]]
            cur_pts = side_points(group)
            loop_pts = side_points(cand_group)
            for g in group:
                searcher._fuse_points_into_kf(loop_pts, int(g), th=4.0)
            for g in cand_group:
                searcher._fuse_points_into_kf(cur_pts, int(g), th=4.0)
            smap.update_points_bulk(np.concatenate([cur_pts, loop_pts]))

        # ---- final polish (RunGBA, LoopClosing.cpp:517-560) ----
        # Order matters: a strong point-only pass first makes the point
        # cloud consistent with the pose-graph solution, and the outlier
        # prune removes the cross-seam observations that still disagree —
        # feeding the joint FullBA a self-consistent state.  Running the
        # joint BA directly on the post-PGO map can drag the loop-seam
        # keyframes into a nearby (wrong) basin: the reference avoids this
        # the same way, point updates first, then joint refinement.
        if self.gba is not None:
            self.gba.point_ba(iterations=10)
            self.gba.remove_outliers()
            self.gba.full_ba(iterations=3)

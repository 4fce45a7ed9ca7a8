"""Windowed tracking driver: a speculative device pipeline.

Runs steady-state tracking W frames per compiled scan (see
models/window_step.py) with up to ``depth`` windows in flight at once.
Windows chain their scan carry (pose / velocity / keyframe-decision
state) **on device**, so dispatching window k+1 needs no host round
trip; results are pulled back with batched async D2H copies (one blocking
fetch syncs a whole window).  The keyframe decision runs
in-scan against a carried virtual-keyframe state, so speculation stays
valid across keyframe boundaries — the host inserts the real keyframe
(and runs the mapping back-ends) when it consumes the window that
contains it, then restarts the chain on a refreshed local-map snapshot.
This is the reference's async deployment mode re-shaped for an
accelerator: tracking runs ahead on a slightly stale map while mapping
catches up (README.md:61-65, DelayedParallelMapOptimization.h).

Falls back to the per-frame Tracker path for initialization, failures,
and recovery.  Deterministic: dispatch/consume order is a pure function
of the input sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.map.slam_map import FrameData
from snakeslam_tpu.models.window_step import (
    POSE_REFINES,
    default_pose_refine,
    make_dec_state,
    pack_frames_np,
    window_track,
)
from snakeslam_tpu.system.settings import InputType
from snakeslam_tpu.tracking.tracker import TrackingState


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def gyro_delta_rotation(omega: np.ndarray, dt: np.ndarray,
                        bg: np.ndarray) -> np.ndarray:
    """Body-frame relative rotation dR = prod exp((w - bg) dt) over the
    frame's gyro samples (host-side; a handful of 3x3 products)."""
    dR = np.eye(3)
    for w, h in zip(omega, dt):
        dR = dR @ _rodrigues((w - bg) * h)
    return dR


@dataclass
class _InFlight:
    start: int                    # absolute index of the window's 1st frame
    batch: list                   # the (unpadded) FrameData list
    outs: object                  # device futures
    assign: object
    vis: object
    fnd: object
    lm_ids: np.ndarray
    lm_gen: np.ndarray            # pt_alloc_gen of lm_ids at snapshot time
    copied: bool = field(default=False)

    def start_copy(self):
        if not self.copied:
            for a in (self.outs, self.assign, self.vis, self.fnd):
                a.copy_to_host_async()
            self.copied = True

    def fetch(self):
        self.start_copy()
        return (np.asarray(self.outs), np.asarray(self.assign),
                np.asarray(self.vis), np.asarray(self.fnd))


class WindowedRunner:
    def __init__(self, system, window: int = 64, two_stage: bool = True,
                 depth: int = 4, async_backends: bool | None = None,
                 pose_refine: str | None = None):
        self.system = system
        self.tracker = system.tracker
        self.window = window
        self.two_stage = two_stage
        self.depth = max(1, depth)
        if pose_refine is None:
            pose_refine = default_pose_refine(jax.default_backend())
        if pose_refine not in POSE_REFINES:
            raise ValueError(f"pose_refine must be one of {POSE_REFINES}, "
                             f"got {pose_refine!r}")
        self.pose_refine = pose_refine
        self.n_device_calls = 0
        self.imu_solver = getattr(system, "imu_solver", None)
        if self.imu_solver is not None:
            # visual-inertial runs cap the speculation depth: every extra
            # in-flight window extends how long tracking runs on a stale
            # pre-keyframe snapshot, and mono-VI scale drift compounds with
            # that staleness until the VI init inherits a distorted map
            # (measured on the synthetic mono-VI orbit: depth 4 -> Sim3 ATE
            # 0.167 m, depth 3 -> 0.008 m).  Stereo/RGBD have absolute
            # scale and keep the deeper pipeline.
            self.depth = min(self.depth, 3)
        # async mode (the reference's async=true deployment setting,
        # README.md:61-65): keyframe insertion + mapping back-ends run on
        # ONE worker thread so their blocking fetches overlap the window
        # pipeline; all map mutation stays serialized on that thread.
        # Deterministic mode (default) runs everything inline.
        if async_backends is None:
            async_backends = bool(getattr(system.s, "async_mode", False))
        self.async_backends = async_backends
        self._pool = None
        self._pending = []
        self._backend_token = None
        if async_backends:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="snake-backend")

    # -- serialized map-mutation executor --------------------------------

    def _submit(self, fn, *args):
        if self._pool is None:
            return fn(*args)
        self._pending.append(self._pool.submit(fn, *args))
        return None

    # -- inline-mode back-end pipeline -----------------------------------
    # The keyframe cycles (triangulation + fusion + LBA) of a consumed
    # window are dispatched back to back and commit at a fixed point two
    # window fetches later, with no scan window dispatched meanwhile (see
    # _run_chain), so the dispatch/commit order is a pure function of the
    # input sequence.  The async worker thread runs the same cycles
    # off-thread.

    def _dispatch_backend_cycles(self):
        t = self.tracker
        lm = t.local_mapper
        while lm._deferred:
            kf, frame = lm._deferred.pop(0)
            if not t.map.kf_valid[kf]:
                continue
            # software-pipeline dense-keyframe windows: dispatch this
            # cycle's device work BEFORE the previous cycle's blocking
            # commit, so the commit's fetch overlaps this cycle's device
            # execution (one-cycle-stale snapshots, the reference's async
            # back-end staleness; rebases are caught by the token's
            # n_transforms guard, local_mapping.commit_deferred_checked)
            prev, self._backend_token = self._backend_token, None
            self._backend_token = lm.dispatch_deferred(kf)
            if prev is not None:
                lm.commit_deferred_checked(prev)
            if self.imu_solver is not None:
                # visual-inertial: the commit can move the whole map (VI
                # init stages apply gravity/scale transforms) — it must
                # land before any later window is consumed, so the cycle
                # stays synchronous (the reference's IMU solver also runs
                # on the mapping thread, ImuStateSolver.cpp)
                self._commit_backend()

    def _commit_backend(self) -> bool:
        tok = getattr(self, "_backend_token", None)
        if tok is None:
            return False
        self._backend_token = None
        self.tracker.local_mapper.commit_deferred_checked(tok)
        return True

    def _drain(self):
        """Wait until all queued map work has completed."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._commit_backend()

    def _idle(self) -> bool:
        """Async mode: True once all queued back-end work has completed
        (no determinism claim there)."""
        if not self._pending:
            return True
        if all(f.done() for f in self._pending):
            for f in self._pending:
                f.result()   # surface worker exceptions
            self._pending = []
            return True
        return False

    def _use_imu(self) -> bool:
        sol = self.imu_solver
        return sol is not None and sol.gyro_initialized

    def _attach_imu_prediction(self, batch):
        """Gyro-predicted camera-frame relative rotation per frame
        (prediction input for the scan; TrackingCoarse.cpp:322-327)."""
        sol = self.imu_solver
        R_cb = sol.R_cb
        for f in batch:
            if getattr(f, "imu_dR_cam", None) is not None:
                continue
            if f.imu_omega is None or not len(f.imu_omega):
                f.imu_dR_cam = np.eye(3)
                continue
            dR = gyro_delta_rotation(f.imu_omega, f.imu_dt, sol.bg)
            f.imu_dR_cam = R_cb @ dR.T @ R_cb.T

    # ------------------------------------------------------------------

    def _initial_dec_state(self) -> np.ndarray:
        t = self.tracker
        smap = t.map
        kf = t.last_kf
        kf_pts = smap.keyframe_points(kf)
        min_obs = 2 if smap.n_keyframes <= 2 else 3
        last_kf_matches = max(int((smap.pt_n_obs[kf_pts] >= min_obs).sum()), 1)
        T = smap.kf_pose[kf]
        center = -T[:3, :3].T @ T[:3, 3]
        viewdir = T[:3, :3].T @ np.array([0.0, 0.0, 1.0])
        med = smap.kf_median_depth[kf] or smap.compute_median_depth(kf)
        frames_since = (int(t.last_frame.frame_id)
                        - int(smap.kf_frame_id[kf]))
        return make_dec_state(last_kf_matches, smap.kf_timestamp[kf],
                              center, viewdir, max(med, 1e-3), frames_since)

    def _local_map(self):
        t = self.tracker
        lf = t.last_frame
        matched = (lf.matches[lf.matches >= 0]
                   if lf is not None and lf.matches is not None
                   else np.array([], dtype=np.int64))
        if t.map.state == t._fine_cache_state and t._fine_cache[0] is not None:
            return t._fine_cache
        # (cache invalid from here on)
        # bucket the snapshot padding (powers of two): the scan's compute
        # scales with the snapshot size, and each bucket compiles once
        uniq = np.unique(matched)
        n_live = int(self.tracker.map.pt_valid.sum())
        if getattr(self.system.s, "pin_local_map_bucket", False):
            bucket = self.system.s.local_map_slots
        else:
            bucket = max(1024, self.system.s.local_map_slots // 8)
            while bucket < min(n_live + 256, self.system.s.local_map_slots):
                bucket *= 2
            bucket = min(bucket, self.system.s.local_map_slots)
        lm, ids = t._fine_local_map(uniq, n_slots=bucket)
        if lm is None:
            return None, None, None
        # gen stamps captured at snapshot time: consumes of windows that
        # tracked against this snapshot drop matches whose point slot was
        # recycled (erase + reallocate) while the window was in flight
        gen = t.map.pt_alloc_gen[ids].copy()
        t._fine_cache = (lm, ids, gen)
        t._fine_cache_state = t.map.state
        return lm, ids, gen

    # ------------------------------------------------------------------

    def run(self, frames: list[FrameData]) -> int:
        i = 0
        n = len(frames)
        t = self.tracker
        while i < n:
            if t.state != TrackingState.OK or t.last_frame is None \
                    or t.last_frame.pose_cw is None:
                self._drain()
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            self._drain()
            lm, lm_ids, lm_gen = self._local_map()
            if lm is None:
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            i = self._run_chain(frames, i, lm, lm_ids, lm_gen)
        self._drain()
        t.local_mapper.flush_deferred()
        return n

    # ------------------------------------------------------------------

    def _dispatch(self, frames, start, W, lm, lm_ids, lm_gen, carry, scal):
        t = self.tracker
        s = self.system.s
        Ns = s.feature_slots
        batch = frames[start:start + W]
        actual = len(batch)
        if self._use_imu():
            self._attach_imu_prediction(batch)
        padded = batch
        while len(padded) < W:  # pad to the compiled width
            padded = padded + [padded[-1]]
        buf = pack_frames_np(padded, Ns)
        self.n_device_calls += 1
        med = getattr(self, "_med_override", -1.0)
        self._med_override = -1.0
        outs, assign, vis, fnd, carry_out = window_track(
            lm, jax.device_put(buf),
            carry[0], carry[1], carry[2], carry[3],
            t.cam, t.bf, t.bounds, t.scales, t.log_sf,
            t.coarse_radius, t.fine_th,
            n_valid_frames=jnp.int32(actual),
            med_override=jnp.float32(med),
            n_slots=Ns, two_stage=self.two_stage, use_imu=self._use_imu(),
            pose_refine=self.pose_refine, **scal,
        )
        item = _InFlight(start=start, batch=batch, outs=outs, assign=assign,
                         vis=vis, fnd=fnd, lm_ids=lm_ids, lm_gen=lm_gen)
        return item, carry_out

    def _run_chain(self, frames, i, lm, lm_ids, lm_gen) -> int:
        """Dispatch chained windows speculatively from frame i; returns the
        index of the first frame NOT consumed.

        The chain is continuous: a keyframe does NOT break it.  Windows
        are consumed one at a time, in order.  When a window containing a
        keyframe is consumed, the mapping back-ends are dispatched (their
        device work overlaps the windows still in flight), they commit two
        window fetches later, and the refreshed local-map snapshot is
        swapped into all FUTURE dispatches — the windows already in flight
        keep tracking on the slightly stale snapshot.  Inline mode
        dispatches no new window while that commit is pending.  The chain
        only ends on tracking failure, a whole-map rebase (loop
        correction), a snapshot bucket-size change (would recompile), or
        end of input."""
        t = self.tracker
        n = len(frames)
        W = self.window
        scal = dict(
            kfi_target=jnp.float32(t.s.kfi_target_matches),
            is_stereo=jnp.asarray(
                t.s.input_type == InputType.Stereo, dtype=bool),
            th_depth=jnp.float32(t.s.th_depth),
        )
        carry = (
            jnp.asarray(t.last_frame.pose_cw, dtype=jnp.float32),
            jnp.asarray(t.velocity, dtype=jnp.float32),
            jnp.asarray(self._initial_dec_state()),
            jnp.zeros((), dtype=bool),
        )
        self._med_override = -1.0  # fresh dec_state already carries med
        bucket = int(lm.position.shape[0])

        inflight: list[_InFlight] = []
        next_i = i
        stop_dispatch = False
        failed_at = -1
        transforms_before = getattr(t.map, "n_transforms", 0)

        refresh_in = 0   # countdown of blocking fetch points until commit
        refresh_pending = False

        def top_up():
            nonlocal next_i, carry
            # inline mode holds dispatch while a keyframe's back-end cycle
            # is pending: the next windows then track the refreshed
            # snapshot (the new keyframe's points) instead of another
            # pipeline depth of frames on the stale one, while the device
            # works through the windows already in flight.  In async mode
            # a pending cycle does NOT block dispatch (the reference's
            # async-mode staleness, README.md:61-65).
            hold = refresh_pending and self._pool is None
            while (not stop_dispatch and not hold and next_i < n
                   and len(inflight) < self.depth):
                item, carry = self._dispatch(
                    frames, next_i, W, lm, lm_ids, lm_gen, carry, scal)
                next_i += len(item.batch)
                inflight.append(item)
                # start the D2H copy at DISPATCH time: the copy is queued
                # behind the scan on device, so by consume time it has
                # usually landed host-side and the blocking fetch is free
                item.start_copy()

        top_up()
        consumed_to = i
        while inflight:
            item = inflight.pop(0)
            outs, assign, vis, fnd = item.fetch()

            def do_refresh():
                """Commit the pending cycle + swap the refreshed snapshot.
                Returns True when the chain must restart (map rebase)."""
                nonlocal refresh_pending, stop_dispatch, lm, lm_ids, lm_gen, carry
                refresh_pending = False
                self._commit_backend()
                if getattr(t.map, "n_transforms", 0) != transforms_before:
                    # a loop correction / VI-init transform re-based the
                    # map: already-consumed poses were rebased by the
                    # tracker's transform listener, but in-flight windows
                    # were computed in the old basis — discard them and
                    # restart the chain
                    inflight.clear()
                    stop_dispatch = True
                    return True
                # swap the refreshed snapshot into future dispatches; a
                # bucket change would recompile the scan, so end the chain
                # instead and let run() start a fresh one
                new_lm, new_ids, new_gen = self._local_map()
                if new_lm is None:
                    stop_dispatch = True
                elif int(new_lm.position.shape[0]) != bucket:
                    stop_dispatch = True
                else:
                    lm, lm_ids, lm_gen = new_lm, new_ids, new_gen
                    # refresh the carried median scene depth (the in-scan
                    # virtual-keyframe reset cannot recompute it) — folded
                    # into the NEXT dispatch's compiled program instead of
                    # an eager .at[].set (one more dispatch)
                    med = t.map.kf_median_depth[t.last_kf] \
                        or t.map.compute_median_depth(t.last_kf)
                    self._med_override = max(med, 1e-3)
                # on stop_dispatch the fetched window is still consumed
                # below; top_up() dispatches nothing and run() restarts
                return False

            if refresh_in > 0:
                refresh_in -= 1
            if (refresh_pending and refresh_in == 0
                    and (self._pool is None or self._idle())):
                # deterministic commit point: TWO blocking window fetches
                # after the cycle's dispatch — the cycle's device work is
                # queued behind the windows already in flight, so
                # committing at the first fetch would still block on the
                # device queue.  A fixed point in the consume schedule,
                # never a wall-clock poll (async mode also waits for its
                # worker).
                if do_refresh():
                    break
            r = self._consume(item, outs, assign, vis, fnd)
            if r is not None and r is not True and r < 0:
                # tracking failed inside this window at frame -(r+1)
                failed_at = -(r + 1)
                inflight.clear()
                break
            consumed_to = item.start + len(item.batch)
            if r:
                # run the mapping back-ends: pipelined dispatch inline,
                # queued on the worker thread in async mode — either way
                # their device time overlaps the in-flight windows; the
                # commit + snapshot refresh happen at the deterministic
                # point after the NEXT blocking window fetch (above)
                if self._pool is None:
                    self._dispatch_backend_cycles()
                else:
                    self._submit(t.local_mapper.flush_deferred)
                refresh_in = 2
                refresh_pending = True
                if self.imu_solver is not None and self._pool is None:
                    # VI commits are synchronous (they can rescale the
                    # whole map, see _dispatch_backend_cycles): refresh the
                    # snapshot and run the rebase check IMMEDIATELY so no
                    # window is dispatched or consumed against a rescaled
                    # map in the old basis
                    if do_refresh():
                        break
            top_up()
            if not inflight and refresh_pending and self._pool is None:
                # nothing left in flight to queue behind: commit now and
                # go on dispatching on the refreshed snapshot
                if do_refresh():
                    break
                top_up()

        if failed_at >= 0:
            self._drain()
            t.local_mapper.flush_deferred()
            self.system.process_frame(frames[failed_at])
            return failed_at + 1
        self._drain()
        t.local_mapper.flush_deferred()
        return consumed_to

    def _consume(self, item: _InFlight, outs, assign, vis, fnd):
        """Apply one window's results to host state.

        Returns None (clean, no KF), True (>=1 KF inserted), or a negative
        number -(abs_index+1) when tracking failed at abs_index."""
        t = self.tracker
        lm_ids = item.lm_ids
        inserted = False
        # vectorized over the window: match-id translation and pose
        # unpacking cost one numpy pass instead of one per frame
        a_all = assign.astype(np.int64)
        safe = np.clip(a_all, 0, max(len(lm_ids) - 1, 0))
        # drop matches whose point slot was recycled while this window was
        # in flight (erase + reallocate gives the slot a new alloc gen):
        # a stale slot->id translation would alias an unrelated NEW point,
        # poisoning keyframe observations with ~100 px associations
        fresh = t.map.pt_alloc_gen[lm_ids[safe]] == item.lm_gen[safe]
        matches_all = np.where((a_all >= 0) & fresh, lm_ids[safe], -1)
        poses = outs[:, :16].reshape(-1, 4, 4).astype(np.float64)
        prev_pose = (t.last_tracked_frame.pose_cw
                     if t.last_tracked_frame is not None else None)

        def _update_velocity(n_done):
            # only the post-window velocity is ever read (chain carries run
            # on device), so one update replaces the per-frame chain
            if n_done >= 2:
                t.velocity = poses[n_done - 1] @ np.linalg.inv(
                    poses[n_done - 2])
            elif n_done == 1 and prev_pose is not None:
                t.velocity = poses[0] @ np.linalg.inv(prev_pose)

        for w, frame in enumerate(item.batch):
            row = outs[w]
            if row[19] > 0.5:   # stopped before this frame
                _update_velocity(w)
                return -(item.start + w + 1)
            if row[17] < 0.5:   # not ok
                # stats up to the failure are already summed in vis/fnd for
                # active frames only; commit them before bailing
                self._submit(self._commit_stats, item, vis, fnd)
                _update_velocity(w)
                return -(item.start + w + 1)
            if self.imu_solver is not None:
                # keep keyframe-edge preintegration windows complete
                # (serialized with the back-end worker's update_map)
                self._submit(self.imu_solver.add_frame_samples, frame)
            frame.pose_cw = poses[w]
            frame.matches = matches_all[w, : frame.n].copy()
            frame.outlier = np.zeros(frame.n, dtype=bool)
            if self._pool is None:
                frame.ref_kf = t.last_kf
                frame.capture_rel(t.map.kf_pose[t.last_kf],
                                  t.map.kf_frame_id[t.last_kf])
            else:
                # async mode: last_kf is written by the worker thread during
                # queued insertions — read it there too, serialized after
                # any insertion queued for an earlier frame
                self._submit(self._set_ref_kf, frame)
            t.last_tracked_frame = frame
            t.last_frame = frame
            t.trajectory.append(frame)
            self.system.n_frames += 1
            if row[18] > 0.5:   # need_kf
                if self._pool is None:
                    kf = t.local_mapper.insert_keyframe(frame, t.last_kf,
                                                        defer=True)
                    if kf >= 0:
                        t.last_kf = kf
                        inserted = True
                else:
                    self._submit(self._insert_kf_task, frame)
                    inserted = True
        _update_velocity(len(item.batch))
        self._submit(self._commit_stats, item, vis, fnd)
        return True if inserted else None

    def _set_ref_kf(self, frame):
        frame.ref_kf = self.tracker.last_kf
        frame.capture_rel(self.tracker.map.kf_pose[frame.ref_kf],
                          self.tracker.map.kf_frame_id[frame.ref_kf])

    def _insert_kf_task(self, frame):
        """Worker-thread keyframe insertion (async mode)."""
        t = self.tracker
        kf = t.local_mapper.insert_keyframe(frame, t.last_kf, defer=True)
        if kf >= 0:
            t.last_kf = kf

    def _commit_stats(self, item, vis, fnd):
        """Per-frame integer visible/found sums (reference per-frame
        IncreaseVisible/IncreaseFound so the found_ratio < 0.25 cull rule
        keeps its meaning across windows).  Slots recycled since the
        window's snapshot are skipped — their counts belong to a point
        that no longer exists."""
        t = self.tracker
        lm_ids = item.lm_ids
        nlm = len(lm_ids)
        fresh = t.map.pt_alloc_gen[lm_ids] == item.lm_gen
        ids = lm_ids[fresh]
        np.add.at(t.map.pt_visible, ids,
                  vis[:nlm][fresh].astype(t.map.pt_visible.dtype))
        np.add.at(t.map.pt_found, ids,
                  fnd[:nlm][fresh].astype(t.map.pt_found.dtype))

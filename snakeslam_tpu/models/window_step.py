"""Windowed tracking megastep: a device-side scan over a batch of frames.

The deterministic-evaluation throughput path.  Every *blocking*
host<->device interaction stalls the pipeline, while async dispatch and
async D2H copies overlap device work — so the design rule here is "never
make the host wait":

  * one window = W frames tracked sequentially in ONE compiled
    ``lax.scan`` (predict -> match -> robust GN -> keyframe decision);
  * the scan carry (pose, velocity, keyframe-decision state) is returned
    as device arrays, so the NEXT window chains directly on device with
    no host round trip;
  * the keyframe decision is evaluated *in-scan* against a carried
    "virtual keyframe" state: when the decision fires the scan keeps
    tracking and simply resets the decision state (time / center /
    viewdir / match count) to the current frame, so speculatively
    dispatched follow-up windows stay valid — the host inserts the real
    keyframe when it consumes the results, exactly the reference's
    async-mode semantics where tracking runs ahead of mapping
    (README.md:61-65, Snake/System/DelayedParallelMapOptimization.h);
  * per-frame outputs are compact (24 f32 + N int16 assignments) and are
    fetched with ``copy_to_host_async`` so one round trip syncs a whole
    window's results.

The scan only *stops* (carries state through unchanged) when tracking
fails (< 25 inliers) — the host then falls back to the per-frame path
(brute-force recovery, Snake/Tracking/TrackingCoarse.cpp:343-512).

Frame payloads travel as ONE flat f32 buffer (descriptor bit planes are
bitcast) — a single async H2D transfer per window.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.core import lie
from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.ops import matching as M
from snakeslam_tpu.ops.pose_pallas import pose_refine_fused
from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine

# packed frame layout (per frame, all f32):
#   uv (N,2) | right (N,) | octave (N,) | angle (N,) | packed desc (N,8
#   f32-bitcast of 32 uint8) | n_valid (1) | timestamp (1) | dR_imu (9)
# Descriptors travel PACKED (32 B) and are unpacked to bit planes on device:
# the H2D link is bandwidth-bound, so the window buffer is ~13 f32/feature.
# dR_imu is the gyro-predicted camera-frame relative rotation from the
# previous frame (identity when no IMU) — the reference's IMU-based pose
# prediction in coarse tracking (Snake/Tracking/TrackingCoarse.cpp:322-327).
FRAME_SCALARS = 2 + 9

# the scan's robust pose refine: "fused" is the one-launch Pallas kernel
# on the Triton route (ops/pose_pallas.py, compiled for a GPU), "xla" the
# plain ops/pose_solver.robust_pose_refine
POSE_REFINES = ("xla", "fused")


def default_pose_refine(backend: str) -> str:
    """The scan's pose refine for a JAX backend: the fused kernel where
    Triton compiles it (a GPU), XLA everywhere else."""
    return "fused" if backend == "gpu" else "xla"

# keyframe-decision carry vector layout (see kf_decision below):
#   [0] last-KF match count  [1] last-KF timestamp  [2:5] last-KF camera
#   center  [5:8] last-KF view direction  [8] median scene depth
#   [9] frames since last KF
DEC_SIZE = 10


def frame_buffer_width(n_slots: int) -> int:
    return n_slots * (2 + 1 + 1 + 1 + 8) + FRAME_SCALARS


def _pack_one_np(f, n_slots: int) -> np.ndarray:
    """Pack one FrameData into its (K,) f32 row (cached on the frame).

    The cache is invalid when the gyro prediction (imu_dR_cam) attached or
    changed after the row was first packed — a failed chain re-dispatches
    frames whose prediction the runner refreshed, and a stale identity dR
    would silently disable the IMU prediction for those frames."""
    cache = getattr(f, "_packed_row", None)
    dR = getattr(f, "imu_dR_cam", None)
    if (cache is not None and cache.shape[0] == frame_buffer_width(n_slots)
            and getattr(f, "_packed_dR", None) is dR):
        return cache
    n = min(f.n, n_slots)
    row = np.zeros(frame_buffer_width(n_slots), dtype=np.float32)
    o = 0
    row[o:o + n * 2] = np.asarray(f.uv[:n], np.float32).ravel()
    o += n_slots * 2
    row[o:o + n] = f.right[:n]
    row[o + n:o + n_slots] = -1.0
    o += n_slots
    row[o:o + n] = f.octave[:n]
    o += n_slots
    row[o:o + n] = f.angle[:n]
    o += n_slots
    row[o:o + n * 8] = np.ascontiguousarray(
        f.descriptors[:n], dtype=np.uint8).view(np.float32).ravel()
    o += n_slots * 8
    row[o] = n
    row[o + 1] = f.timestamp
    row[o + 2:o + 11] = (np.eye(3, dtype=np.float32).ravel()
                         if dR is None
                         else np.asarray(dR, np.float32).ravel())
    f._packed_row = row
    f._packed_dR = dR
    return row


def pack_frames_np(frames, n_slots: int) -> np.ndarray:
    """Host-side packing of FrameData list -> (W, K) f32 buffer.

    Rows are cached per frame, so window-tail padding (the same frame
    repeated) and retry re-dispatches pack for free; the batch assembles
    with one np.stack."""
    return np.stack([_pack_one_np(f, n_slots) for f in frames])


def make_dec_state(last_kf_matches: float, last_kf_time: float,
                   last_kf_center: np.ndarray, last_kf_viewdir: np.ndarray,
                   median_depth: float, frames_since_kf: int) -> np.ndarray:
    """Host-side construction of the keyframe-decision carry vector."""
    dec = np.zeros(DEC_SIZE, dtype=np.float32)
    dec[0] = last_kf_matches
    dec[1] = last_kf_time
    dec[2:5] = last_kf_center
    dec[5:8] = last_kf_viewdir
    dec[8] = median_depth
    dec[9] = frames_since_kf
    return dec


def _unpack_frame(buf: jax.Array, n_slots: int) -> M.FrameFeatures:
    o = 0
    uv = buf[o:o + n_slots * 2].reshape(n_slots, 2); o += n_slots * 2
    right = buf[o:o + n_slots]; o += n_slots
    octave = buf[o:o + n_slots].astype(jnp.int32); o += n_slots
    angle = buf[o:o + n_slots]; o += n_slots
    packed_desc = jax.lax.bitcast_convert_type(
        buf[o:o + n_slots * 8].reshape(n_slots, 8), jnp.uint8
    ).reshape(n_slots, 32)
    from snakeslam_tpu.ops.descriptors import unpack_bits

    bits = unpack_bits(packed_desc).astype(jnp.int8)
    o += n_slots * 8
    n_valid = buf[o].astype(jnp.int32)
    ts = buf[o + 1]
    dR_imu = buf[o + 2:o + 11].reshape(3, 3)
    valid = jnp.arange(n_slots) < n_valid
    return M.FrameFeatures(uv=uv, right=right, octave=octave, angle=angle,
                           desc_bits=bits, valid=valid), ts, dR_imu


@functools.partial(jax.jit, static_argnames=("n_slots", "two_stage", "use_imu",
                                             "pose_refine"))
def window_track(
    lm: M.LocalMapPoints,
    frames_buf: jax.Array,        # (W, K) packed frames
    T_last: jax.Array,            # (4, 4) pose of the previous frame
    velocity: jax.Array,          # (4, 4) camera-space motion model
    dec_state: jax.Array,         # (DEC_SIZE,) keyframe-decision carry
    stopped_in: jax.Array,        # () bool: chain already failed upstream
    cam: Pinhole,
    bf: jax.Array,
    image_bounds: jax.Array,      # (4,)
    scales: jax.Array,
    log_scale_factor: jax.Array,
    coarse_radius: jax.Array,
    fine_th: jax.Array,
    kfi_target: jax.Array,        # () target matches (static per run)
    is_stereo: jax.Array,         # () bool
    th_depth: jax.Array,          # () close-point threshold
    n_valid_frames: jax.Array,    # () unpadded window length
    med_override: jax.Array | None = None,  # () refreshed median depth
    n_slots: int = 1024,
    two_stage: bool = True,
    use_imu: bool = False,
    pose_refine: str = "xla",
):
    """Track up to W frames against one local-map snapshot.

    ``pose_refine`` picks the pose refine implementation (POSE_REFINES).

    Returns ``(outs, assign, vis, fnd, carry)`` where
      outs   (W, 24) f32: [0:16] pose, [16] n_inliers, [17] ok,
             [18] need_kf, [19] stopped-before-this-frame, [20:24] reserved
      assign (W, N) int16: local-map index per feature (-1 = unmatched)
      vis    (P,) i32: per-point visible counts summed over tracked frames
      fnd    (P,) i32: per-point found counts summed over tracked frames
      carry  (T, velocity, dec_state, stopped): device arrays for chaining
             the next window with no host round trip.
    """
    st = M.ScaleTables(scales=scales, log_scale_factor=log_scale_factor,
                       levels=scales.shape[0])
    bounds = (image_bounds[0], image_bounds[1],
              image_bounds[2], image_bounds[3])
    P = lm.position.shape[0]
    inv_scales = 1.0 / scales

    if pose_refine not in POSE_REFINES:
        raise ValueError(f"pose_refine must be one of {POSE_REFINES}, "
                         f"got {pose_refine!r}")

    def _refine(T0, obs, outer_iters, inner_iters):
        # "fused": the whole robust GN (sweeps + chi2 re-classification +
        # SE3 updates) in ONE kernel launch; "xla": the plain solver, which
        # keeps bit-reproducibility with the per-frame tracker
        if pose_refine == "fused":
            return pose_refine_fused(
                T0, obs.points, obs.uv, obs.right, obs.weight, obs.mask,
                cam, bf, outer_iters=outer_iters, inner_iters=inner_iters)
        return robust_pose_refine(T0, obs, cam, bf,
                                  outer_iters=outer_iters,
                                  inner_iters=inner_iters)

    def track_one(T_pred, frame):
        if two_stage:
            # coarse: prediction-radius matching against the snapshot
            outc = M.search_by_projection_coarse(
                lm, frame, T_pred, cam, bf, bounds, st,
                feat_free=frame.valid, th=coarse_radius, feature_error=75,
                use_rotation_hist=False,
            )
            assign_c = outc["feat_point"]
            matched_c = assign_c >= 0
            pidx = jnp.clip(assign_c, 0, P - 1)
            obs = PoseObs(
                points=lm.position[pidx], uv=frame.uv, right=frame.right,
                weight=inv_scales[jnp.clip(frame.octave, 0, st.levels - 1)],
                mask=matched_c,
            )
            T1, _, n1 = _refine(T_pred, obs, 1, 3)
            # fine: tighter radius from the refined pose
            outf = M.search_by_projection_fine(
                lm, frame, T1, cam, bf, bounds, st,
                feat_free=frame.valid & (~matched_c), th=fine_th, ratio=0.8,
            )
            assign_f = outf["feat_point"]
            matched = matched_c | (assign_f >= 0)
            assign = jnp.where(matched_c, assign_c, assign_f)
        else:
            # single-stage: prediction is excellent within a window, so one
            # wider fine search replaces coarse+fine (half the GN steps)
            T1 = T_pred
            outf = M.search_by_projection_fine(
                lm, frame, T_pred, cam, bf, bounds, st,
                feat_free=frame.valid, th=2.0 * fine_th, ratio=0.8,
            )
            assign = outf["feat_point"]
            matched = assign >= 0
        pidx = jnp.clip(assign, 0, P - 1)
        obs = PoseObs(
            points=lm.position[pidx], uv=frame.uv, right=frame.right,
            weight=inv_scales[jnp.clip(frame.octave, 0, st.levels - 1)],
            mask=matched,
        )
        T2, inlier, n2 = _refine(T1, obs, 2, 2)
        assign = jnp.where(inlier, assign, -1)
        visible = outf["visible"]
        found = jnp.zeros((P,), dtype=jnp.float32).at[
            jnp.where(assign >= 0, assign, P)
        ].add(1.0, mode="drop")[:P]
        return T2, assign, n2, visible.astype(jnp.float32), found

    def kf_decision(T, n_inl, ts, frame, assign, dec):
        """KeyframeDecision.cpp rules evaluated on device against the
        carried (virtual) last-keyframe state."""
        last_kf_matches = dec[0]
        last_kf_time = dec[1]
        last_kf_center = dec[2:5]
        last_kf_viewdir = dec[5:8]
        median_depth = dec[8]
        frames_since_kf = dec[9] + 1.0

        current = n_inl
        # stereo close-point rule
        close = (assign >= 0) & (frame.right > 0)
        depth_est = jnp.where(frame.right > 0,
                              bf / jnp.maximum(frame.uv[:, 0] - frame.right,
                                               1e-3), 1e9)
        close = close & (depth_est <= th_depth)
        n_close = jnp.sum(close)
        n_nonclose = jnp.sum((assign >= 0)) - n_close
        need_stereo = is_stereo & (n_close < 90) & (n_nonclose > 60)
        current = jnp.where(is_stereo, current - n_nonclose, current)

        target_ratio = current.astype(jnp.float32) / kfi_target
        kf_ratio = current.astype(jnp.float32) / jnp.maximum(
            last_kf_matches, 1.0
        )
        time_rule = (ts - last_kf_time) >= 0.5

        cam_center = -(T[:3, :3].T @ T[:3, 3])
        baseline = jnp.linalg.norm(cam_center - last_kf_center)
        trans_angle = jnp.degrees(jnp.arctan2(
            baseline / 2.0, jnp.maximum(median_depth, 1e-6)
        ))
        viewdir = T[:3, :3].T @ jnp.asarray([0.0, 0.0, 1.0], dtype=T.dtype)
        rot_angle = jnp.degrees(jnp.arccos(jnp.clip(
            jnp.sum(viewdir * last_kf_viewdir), -1.0, 1.0
        )))

        super_bad = current < 50
        bad = (current < 60) | (target_ratio < 0.5) | (kf_ratio < 0.6)
        very_good = target_ratio >= 1.3
        good = (target_ratio >= 0.8) | (kf_ratio > 2.0)
        geometry = (trans_angle > 1.0) | (rot_angle > 15.0)
        geometry_bad = bad & ((trans_angle > 1.0) | (rot_angle > 10.0))
        # slow-translation rule (KeyframeDecision.cpp:152): many frames
        # since the last KF with nontrivial translation angle
        frames_rule = (frames_since_kf > 30) & (trans_angle > 0.5)

        need = time_rule | need_stereo
        need = need | (~super_bad & ~very_good
                       & (frames_rule
                          | jnp.where(good, False, geometry) | geometry_bad))
        # virtual-keyframe reset: subsequent frames in this (and chained)
        # windows measure their decision against the new keyframe.  The
        # match count is approximated by the current inlier count and the
        # median depth is carried (the host refreshes both when the chain
        # restarts after the real insertion).
        dec_fired = jnp.concatenate([
            jnp.stack([n_inl.astype(jnp.float32), ts]),
            cam_center, viewdir,
            jnp.stack([median_depth, jnp.float32(0.0)]),
        ]).astype(dec.dtype)
        dec_pass = dec.at[9].set(frames_since_kf)
        return need, jnp.where(need, dec_fired, dec_pass)

    def scan_body(carry, xs):
        frame_buf, w_idx = xs
        T_last_c, vel, dec, stopped = carry
        frame, ts, dR_imu = _unpack_frame(frame_buf, n_slots)
        T_pred = vel @ T_last_c
        if use_imu:
            # gyro-predicted rotation, constant-velocity translation
            # (reference TrackingCoarse.cpp:322-327 prediction split)
            T_pred = lie.orthonormalize(
                T_pred.at[:3, :3].set(dR_imu @ T_last_c[:3, :3])
            )
        T, assign, n_inl, visible, found = track_one(T_pred, frame)
        ok = n_inl >= 25
        padded = w_idx >= n_valid_frames  # duplicated tail padding
        active = (~stopped) & ok & (~padded)
        need_kf, dec_next = kf_decision(T, n_inl, ts, frame, assign, dec)
        need_kf = need_kf & active
        new_dec = jnp.where(active, dec_next, dec)
        # motion model update only while actively tracking; orthonormalized
        # so f32 composition defects cannot compound across the window
        new_vel = jnp.where(
            active, lie.orthonormalize(T @ lie.se3_inverse(T_last_c)), vel
        )
        new_T = jnp.where(active, T, T_last_c)
        stop_after = stopped | ((~ok) & (~padded))
        out = jnp.concatenate([
            T.reshape(-1),
            jnp.stack([
                n_inl.astype(jnp.float32),
                ok.astype(jnp.float32),
                need_kf.astype(jnp.float32),
                stopped.astype(jnp.float32),
            ]),
            jnp.zeros((4,), dtype=jnp.float32),
        ])
        vis = jnp.where(active, visible, 0.0)
        fnd = jnp.where(active, found, 0.0)
        assign_out = jnp.where(active, assign, -1).astype(jnp.int16)
        return ((new_T, new_vel, new_dec, stop_after),
                (out, assign_out, vis, fnd))

    # median-depth refresh folded into the compiled program: the host sets
    # med_override > 0 after a keyframe commit instead of mutating the
    # carried dec_state with an eager .at[].set (one more dispatch)
    if med_override is not None:
        dec_state = dec_state.at[8].set(
            jnp.where(med_override > 0, med_override, dec_state[8]))

    init = (T_last, velocity, dec_state, stopped_in)
    W = frames_buf.shape[0]
    carry_out, (outs, assign, vis, fnd) = jax.lax.scan(
        scan_body, init, (frames_buf, jnp.arange(W, dtype=jnp.int32))
    )
    return (outs, assign,
            jnp.sum(vis, axis=0).astype(jnp.int32),
            jnp.sum(fnd, axis=0).astype(jnp.int32),
            carry_out)

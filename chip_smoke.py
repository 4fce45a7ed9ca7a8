"""Smoke test of the SLAM pipeline on one GPU, at EuRoC width.

Drives the system's two main paths once through the entry points a user
calls, on stereo frames rendered from a seed (752x480, 1000 ORB features,
4 levels, scale 1.2, 1024 feature slots, full back-ends):

  (a) device   fail unless JAX's first device is a GPU; print the card's
               name and power limit, the JAX version, XLA_FLAGS and the
               compile-cache directory
  (b) kernels  the fused pose-refine kernel, compiled for the card, against
               the XLA solver at 1024 and 2048 slots, stereo and mono
  (c) per-frame path (the CLI's): RawFrames -> frontend.input.Input ->
               SlamSystem.run, 60 frames at 20 Hz
  (d) throughput path: frontend.pixels.PixelFrameSequence ->
               tracking.windowed.WindowedRunner(two_stage=True), 160 frames
               at 200 Hz, window 32
  (e) memory   peak device bytes in use

``--four-cards`` runs only the sharded path on four GPUs and what it is
compared with: GlobalBA.full_ba with n_devices=4 against n_devices=1 on
one map, the sharded BA step on four devices against one, and
sharded_hamming_topk against the unsharded Hamming argmin.

Every phase raises on failure; the last line of standard output is one
JSON object, printed only when every phase passed.

Run from the repository root:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# ATE bounds (metres, SE3-aligned RMSE against the rendered ground truth).
# A CPU rehearsal of the same seeds gives 0.0182 m on the per-frame path
# and 0.0553 m on the windowed path; the bounds leave room for the GPU's
# other summation order, which can change keypoint and match choices.
PER_FRAME_ATE_M = 0.06
WINDOWED_ATE_M = 0.15

# GlobalBA on four devices (sharded Gauss-Newton) against one device (the
# single-device solver): the two solvers converge to the same optimum, but
# not along the same path (2.5e-4 m apart on four virtual CPU devices)
GBA_POINT_TOL_M = 5e-3
# the same sharded step on four devices against one: only the psum order
# of the reduced camera system differs (2.7e-5 m on four virtual CPU
# devices)
SHARDED_STEP_TOL_M = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A gate: raise (also under ``python -O``) when it does not hold."""
    if not ok:
        raise RuntimeError(f"gate failed: {msg}")


def phase_device(count: int = 1) -> None:
    import jax

    from snakeslam_tpu.utils.device import card_lines, check_gpu

    check_gpu(jax.devices(), count)
    for ln in card_lines():
        log(f"[device] card: {ln}")
    log(f"[device] jax {jax.__version__}; devices: "
        f"{[d.device_kind for d in jax.devices()]}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")


def phase_kernels() -> None:
    from snakeslam_tpu.utils.pose_fixtures import (
        MIN_INLIER_AGREEMENT,
        POSE_ATOL,
        check_fused_parity,
        compare_fused_with_xla,
    )

    for n in (1024, 2048):
        for stereo in (True, False):
            r = compare_fused_with_xla(n, stereo, interpret=False)
            log(f"[kernels] pose_refine_fused N={n} "
                f"{'stereo' if stereo else 'mono'}: max|dT| "
                f"{r['max_abs_diff']:.3e} (tol {POSE_ATOL:.0e}), inlier "
                f"agreement {r['agreement']:.4f} (> {MIN_INLIER_AGREEMENT}), "
                f"n_inl {r['n_fused']} vs {r['n_ref']}; reference XLA at "
                f"float32 'highest'")
            check_fused_parity(r)


def euroc_settings(world):
    """EuRoC-width stereo settings with full back-ends (the widths of
    configs/euroc_stereo.ini), without IMU: the frames are rendered."""
    from snakeslam_tpu.frontend.synthetic_source import apply_world_to_settings
    from snakeslam_tpu.system.settings import InputType, Settings

    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.fd_features = 1000
    s.feature_slots = 1024
    s.local_map_slots = 4096
    s.lba_cam_slots = 32
    s.lba_point_slots = 8192
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    return s


def render_stereo(n_frames: int, fps: float, arc: float, seed: int = 13):
    """Rendered 752x480 uint8 stereo pairs on an inward orbit; returns
    (world, left, right, timestamps, gt poses)."""
    from snakeslam_tpu.utils.render_world import render_sequence
    from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory

    world = SyntheticWorld(n_points=2600, seed=seed)
    L, R, ts, gt = [], [], [], []
    for t, T_cw, left, right in render_sequence(
            world, orbit_trajectory(n_frames, radius=7.0, arc=arc, fps=fps)):
        L.append(np.clip(left, 0, 255).astype(np.uint8))
        R.append(np.clip(right, 0, 255).astype(np.uint8))
        ts.append(t)
        gt.append(T_cw)
    return world, np.stack(L), np.stack(R), ts, gt


class RenderedStereoDataset:
    """Rendered stereo pairs as a dataset of RawFrames (what the dataset
    loaders yield to frontend.input.Input)."""

    calib = None   # the settings already carry the rendering camera

    def __init__(self, left, right, timestamps):
        self.left, self.right, self.ts = left, right, timestamps

    def __len__(self):
        return len(self.ts)

    def __iter__(self):
        from snakeslam_tpu.frontend.datasets import RawFrame

        for i, t in enumerate(self.ts):
            yield RawFrame(frame_id=i, timestamp=float(t),
                           gray=self.left[i], right=self.right[i])


def phase_per_frame(n_frames: int = 60) -> dict:
    from snakeslam_tpu.frontend.input import Input
    from snakeslam_tpu.system.slam import SlamSystem

    # 0.4 rad of a 7 m orbit in 3 s: ~1 m/s, a brisk EuRoC-like pace
    # that keeps inserting keyframes
    world, L, R, ts, gt = render_stereo(n_frames, fps=20.0, arc=0.4)
    settings = euroc_settings(world)
    inp = Input(settings, dataset=RenderedStereoDataset(L, R, ts))
    system = SlamSystem(settings)
    system.frame_listeners.append(
        lambda f: setattr(f, "gt_pose_cw", gt[f.frame_id]))
    t0 = time.perf_counter()
    system.run(iter(inp))
    wall = time.perf_counter() - t0
    tracked = len(system.tracker.trajectory)
    n_kf = int(system.map.n_keyframes)
    n_inserted = sum(bool(f.is_keyframe) for f in system.tracker.trajectory)
    ate, _, _ = system.ate_against_gt(with_scale=False)
    log(f"[per-frame] {tracked}/{n_frames} tracked, {n_inserted} keyframes "
        f"inserted, {n_kf} after simplification and the final BA, "
        f"{int(system.map.n_points)} points, ATE {ate:.4f} m "
        f"(bound {PER_FRAME_ATE_M}), {wall:.1f} s incl. compilation")
    check(tracked >= 0.9 * n_frames, f"tracked {tracked}/{n_frames}")
    check(n_kf >= 2, f"{n_kf} keyframes")
    check(ate < PER_FRAME_ATE_M, f"ATE {ate}")
    return dict(tracked=tracked, keyframes=n_kf, ate_m=ate)


def phase_windowed(n_frames: int = 160, window: int = 32) -> dict:
    from snakeslam_tpu.frontend.pixels import PixelFrameSequence
    from snakeslam_tpu.system.slam import SlamSystem
    from snakeslam_tpu.tracking.windowed import WindowedRunner

    world, L, R, ts, gt = render_stereo(n_frames, fps=200.0,
                                        arc=1.2 * n_frames / 400.0)
    settings = euroc_settings(world)
    system = SlamSystem(settings)
    seq = PixelFrameSequence(settings, L, R, ts, gt, chunk=window)
    runner = WindowedRunner(system, window=window, two_stage=True)
    t0 = time.perf_counter()
    runner.run(seq)
    wall = time.perf_counter() - t0
    tracked = len(system.tracker.trajectory)
    n_kf = int(system.map.n_keyframes)
    ate, _, _ = system.ate_against_gt(with_scale=False)
    log(f"[windowed] pose refine in the scan: {runner.pose_refine}")
    log(f"[windowed] {tracked}/{n_frames} tracked, {n_kf} keyframes, "
        f"{runner.n_device_calls} scan dispatches, ATE {ate:.4f} m "
        f"(bound {WINDOWED_ATE_M}), {wall:.1f} s incl. compilation")
    check(tracked == n_frames, f"tracked {tracked}/{n_frames}")
    check(n_kf > 1, f"{n_kf} keyframes")
    check(ate < WINDOWED_ATE_M, f"ATE {ate}")
    return dict(tracked=tracked, keyframes=n_kf, ate_m=ate)


def phase_memory() -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"[memory] peak_bytes_in_use={peak}")


def _gba_run(n_devices: int, n_kf: int, n_pts: int):
    from snakeslam_tpu.optim.gba import GlobalBA
    from snakeslam_tpu.system.settings import InputType, Settings
    from snakeslam_tpu.utils.ba_fixtures import make_gba_map

    s = Settings()
    s.input_type = InputType.Mono
    s.enable_imu = False
    s.n_devices = n_devices
    smap, ids = make_gba_map(s, n_feat=n_pts, n_kf=n_kf, n_pts=n_pts)
    gba = GlobalBA(s, smap)
    gba.full_ba(iterations=5)
    kfs = smap.valid_keyframes()
    return smap.pt_pos[ids].copy(), smap.kf_pose[kfs].copy()


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp

    from snakeslam_tpu.core.camera import Pinhole
    from snakeslam_tpu.ops.descriptors import hamming_matrix
    from snakeslam_tpu.parallel import multichip as MC
    from snakeslam_tpu.utils.ba_fixtures import make_synthetic_ba_problem

    devices = jax.devices()[:4]
    mesh4 = MC.make_mesh(devices=devices)
    mesh1 = MC.make_mesh(devices=devices[:1])

    # GlobalBA.full_ba, four devices against one, on one map
    n_kf, n_pts = 24, 4096
    pts4, poses4 = _gba_run(4, n_kf, n_pts)
    pts1, poses1 = _gba_run(1, n_kf, n_pts)
    d_pts = float(np.abs(pts4 - pts1).max())
    d_pose = float(np.abs(poses4 - poses1).max())
    log(f"[four-cards] GlobalBA.full_ba {n_kf} keyframes x {n_pts} points: "
        f"n_devices=4 vs 1 max|dpoint| {d_pts:.3e} m (tol "
        f"{GBA_POINT_TOL_M:.0e}), max|dpose| {d_pose:.3e}")
    check(d_pts < GBA_POINT_TOL_M, f"GBA max|dpoint| {d_pts}")

    # the sharded BA step on four devices against the same step on one
    problem, _, _ = make_synthetic_ba_problem(C=16, P=8192, M=8, seed=0)
    cam = Pinhole.create(458.654, 457.296, 367.215, 248.375)
    bf = jnp.float32(458.654 * 0.11)
    out = {}
    for name, mesh in (("4", mesh4), ("1", mesh1)):
        sharded = MC.shard_problem(problem, mesh)
        if name == "4":
            shard_devs = {s.device for s in sharded.points.addressable_shards}
            shard_rows = {s.data.shape[0]
                          for s in sharded.points.addressable_shards}
            log(f"[four-cards] points sharded over {len(shard_devs)} "
                f"devices, {shard_rows} rows each")
            check(shard_devs == set(devices), f"shards on {shard_devs}")
            check(shard_rows == {problem.points.shape[0] // 4},
                  f"rows per shard {shard_rows}")
        step = MC.sharded_ba_step(mesh, cam, bf, n_iters=5)
        cam_pose, points = step(sharded)
        if name == "4":
            out_devs = {s.device for s in points.addressable_shards}
            check(out_devs == set(devices), f"result on {out_devs}")
        out[name] = (np.asarray(cam_pose), np.asarray(points))
    d_step = float(np.abs(out["4"][1] - out["1"][1]).max())
    d_cam = float(np.abs(out["4"][0] - out["1"][0]).max())
    log(f"[four-cards] sharded BA step 16 cams x 8192 points, 5 iters: "
        f"4 devices vs 1 max|dpoint| {d_step:.3e} m (tol "
        f"{SHARDED_STEP_TOL_M:.0e}), max|dcam| {d_cam:.3e}")
    check(d_step < SHARDED_STEP_TOL_M, f"sharded step max|dpoint| {d_step}")

    # sharded Hamming top-1 against the unsharded matrix argmin
    rng = np.random.default_rng(0)
    pb = jnp.asarray(rng.integers(0, 2, size=(4096, 256)).astype(np.int8))
    fb = jnp.asarray(rng.integers(0, 2, size=(1024, 256)).astype(np.int8))
    d, idx = MC.sharded_hamming_topk(mesh4)(pb, fb)
    d_devs = {s.device for s in d.addressable_shards}
    check(d_devs == set(devices), f"distances on {d_devs}")
    H = hamming_matrix(pb, fb)
    d_ref = np.asarray(jnp.min(H, axis=1))
    i_ref = np.asarray(jnp.argmin(H, axis=1))
    n_dist = int((np.asarray(d) != d_ref).sum())
    n_idx = int((np.asarray(idx) != i_ref).sum())
    log(f"[four-cards] sharded_hamming_topk 4096 points x 1024 features: "
        f"{n_dist} distance and {n_idx} index mismatches (tol 0)")
    check(n_dist == 0 and n_idx == 0, f"{n_dist} / {n_idx} mismatches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import snakeslam_tpu  # noqa: F401  (sets the compile cache first)
    import jax

    t0 = time.perf_counter()
    if args.four_cards:
        phase_device(count=4)
        phase_four_cards()
        count = 4
    else:
        phase_device()
        phase_kernels()
        phase_per_frame()
        phase_windowed()
        phase_memory()
        count = len(jax.devices())
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fused pose-refine kernel against the XLA solver, on the device.

Three comparisons, each run in turns (xla, fused, fused, xla) in one
process so both implementations see the same card and clocks:

  1. the refine alone: a chain of 32 dependent (2x2) refines at 1024 and
     2048 slots, for the kernel at 4, 8 and 16 warps;
  2. the tracking scan (models/window_step.window_track, two-stage) at
     W=128 frames and 2048 snapshot slots: device ms/frame;
  3. end to end: bench.py's smooth workload (400 frames, window 128)
     through WindowedRunner, tracked frames/s.

Prints one JSON line per measurement.  Run from the repository root:
    python scripts/compare_pose_refine.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from snakeslam_tpu.core.camera import Pinhole  # noqa: E402
from snakeslam_tpu.models.window_step import (  # noqa: E402
    make_dec_state,
    pack_frames_np,
    window_track,
)
from snakeslam_tpu.ops import matching as M  # noqa: E402
from snakeslam_tpu.ops.pose_pallas import pose_refine_fused  # noqa: E402
from snakeslam_tpu.ops.pose_solver import robust_pose_refine  # noqa: E402
from snakeslam_tpu.utils.pose_fixtures import make_pose_problem  # noqa: E402

ORDER = ("xla", "fused", "fused", "xla")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def best_time(fn, reps: int, rounds: int = 5) -> float:
    """Best-of-rounds seconds per call of ``fn`` chained ``reps`` times
    (fn takes and returns the chain state), synced with
    block_until_ready."""
    state = fn(None)
    jax.block_until_ready(state)
    best = float("inf")
    for _ in range(rounds):
        s = state
        t0 = time.perf_counter()
        for _ in range(reps):
            s = fn(s)
        jax.block_until_ready(s)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def refine_alone():
    K = 32
    for n in (1024, 2048):
        T0, obs, cam, bf, _ = make_pose_problem(seed=3, N=n)

        def chain(refine):
            @jax.jit
            def run(T):
                def body(Tc, _):
                    return refine(Tc), None
                return jax.lax.scan(body, T, None, length=K)[0]
            return lambda s: run(T0 if s is None else s)

        impls = {
            "xla": chain(lambda T: robust_pose_refine(
                T, obs, cam, bf, outer_iters=2, inner_iters=2)[0]),
        }
        for w in (4, 8, 16):
            impls[f"fused_w{w}"] = chain(
                lambda T, w=w: pose_refine_fused(
                    T, obs.points, obs.uv, obs.right, obs.weight, obs.mask,
                    cam, bf, outer_iters=2, inner_iters=2, num_warps=w)[0])
        for name in ("xla", "fused_w4", "fused_w8", "fused_w16",
                     "fused_w16", "fused_w8", "fused_w4", "xla"):
            dt = best_time(impls[name], reps=10) / K
            emit(what="refine_alone", n_slots=n, impl=name,
                 us_per_refine=dt * 1e6)


def scan_level(W: int = 128, N: int = 1024, P: int = 2048, levels: int = 4):
    rng = np.random.default_rng(0)
    lm = M.LocalMapPoints(
        position=jnp.asarray(rng.normal(size=(P, 3)) * 5 + [0, 0, 10],
                             dtype=jnp.float32),
        normal=jnp.asarray(rng.normal(size=(P, 3)), dtype=jnp.float32),
        desc_bits=jnp.asarray(rng.integers(0, 2, (P, 256)), dtype=jnp.int8),
        ref_depth=jnp.asarray(rng.uniform(5, 15, P), dtype=jnp.float32),
        ref_level=jnp.asarray(rng.integers(0, levels, P), dtype=jnp.int32),
        angle=jnp.asarray(rng.uniform(0, 360, P), dtype=jnp.float32),
        valid=jnp.ones((P,), dtype=bool),
    )
    # frames that see the snapshot: features are projections of snapshot
    # points (so the matcher and the GN have real work), with noise
    pos = np.asarray(lm.position)
    bits = np.asarray(lm.desc_bits).astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")

    class F:
        pass

    frames = []
    for _ in range(W):
        sel = rng.choice(P, N, replace=False)
        pc = pos[sel]
        f = F()
        f.n = N
        f.uv = np.stack([458.0 * pc[:, 0] / pc[:, 2] + 367.0,
                         457.0 * pc[:, 1] / pc[:, 2] + 248.0], 1
                        ).astype(np.float32) + rng.normal(0, 0.5, (N, 2))
        f.right = (f.uv[:, 0] - 47.9 / pc[:, 2]).astype(np.float32)
        f.octave = np.zeros(N, np.float32)
        f.angle = np.asarray(lm.angle)[sel]
        f.descriptors = packed[sel]
        f.timestamp = 0.0
        f.imu_dR_cam = None
        frames.append(f)
    buf = jnp.asarray(pack_frames_np(frames, N))
    cam = Pinhole(fx=jnp.float32(458.0), fy=jnp.float32(457.0),
                  cx=jnp.float32(367.0), cy=jnp.float32(248.0))
    carry0 = (jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32),
              jnp.asarray(make_dec_state(300, 0.0, np.zeros(3),
                                         np.array([0, 0, 1.0]), 10.0, 0)),
              jnp.zeros((), dtype=bool))
    scales = jnp.asarray([1.2 ** i for i in range(levels)], jnp.float32)

    def scan(impl):
        def run(c):
            c = carry0 if c is None else c
            out = window_track(
                lm, buf, c[0], c[1], c[2], c[3], cam, jnp.float32(47.9),
                jnp.asarray([0.0, 0.0, 752.0, 480.0], jnp.float32), scales,
                jnp.float32(np.log(1.2)), jnp.float32(15.0),
                jnp.float32(2.0), kfi_target=jnp.float32(160.0),
                is_stereo=jnp.asarray(True), th_depth=jnp.float32(25.0),
                n_valid_frames=jnp.int32(W), n_slots=N, two_stage=True,
                use_imu=False, pose_refine=impl)
            return out[4]
        return run

    impls = {k: scan(k) for k in ("xla", "fused")}
    for name in ORDER:
        dt = best_time(impls[name], reps=4)
        emit(what="scan", window=W, snapshot_slots=P, feature_slots=N,
             impl=name, ms_per_frame=dt * 1e3 / W)


def end_to_end(n_frames: int = 400, window: int = 128):
    from snakeslam_tpu.tracking.windowed import WindowedRunner

    for impl in ("xla", "fused"):  # warm both: compiles every program
        system, frames = bench._build_smooth(123, 48, False)
        for f in frames:
            f.timestamp = f.frame_id / 10.0
        WindowedRunner(system, window=window, pose_refine=impl).run(frames)
    for impl in ORDER:
        system, frames = bench._build_smooth(7, n_frames, False)
        runner = WindowedRunner(system, window=window, pose_refine=impl)
        t0 = time.perf_counter()
        runner.run(frames)
        wall = time.perf_counter() - t0
        rmse, _, _ = system.ate_against_gt(with_scale=False)
        emit(what="end_to_end", workload="smooth", frames=n_frames,
             window=window, impl=impl,
             fps=len(system.tracker.trajectory) / wall,
             tracked=len(system.tracker.trajectory), ate_rmse_m=rmse)


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    d = jax.devices()[0]
    emit(what="device", platform=d.platform, kind=d.device_kind, card=card)
    if d.platform != "gpu":
        raise SystemExit("no GPU: the fused kernel compiles only for a GPU")
    refine_alone()
    scan_level()
    end_to_end()


if __name__ == "__main__":
    main()

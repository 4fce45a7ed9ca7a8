"""Device-time breakdown of the window-track scan at bench shapes.

Times, on the real device (block_until_ready around many reps):
  * the full window_track scan (per-frame ms),
  * the fine projection matcher alone (vmapped over W frames),
  * the Hamming matmul alone,
  * the robust pose GN alone (the reference per-frame iteration count),
and derives achieved TFLOP/s + HBM GB/s for the matcher so the bench's
utilization story is measured, not guessed.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.core.camera import Pinhole
from snakeslam_tpu.models.window_step import (
    frame_buffer_width,
    make_dec_state,
    pack_frames_np,
    window_track,
)
from snakeslam_tpu.ops import matching as M
from snakeslam_tpu.ops.descriptors import hamming_matrix
from snakeslam_tpu.ops.pose_solver import PoseObs, robust_pose_refine

W = 64
N = 1024
P = 2048
LEVELS = 4

rng = np.random.default_rng(0)


def _mk_lm():
    return M.LocalMapPoints(
        position=jnp.asarray(rng.normal(size=(P, 3)) * 5 + [0, 0, 10],
                             dtype=jnp.float32),
        normal=jnp.asarray(rng.normal(size=(P, 3)), dtype=jnp.float32),
        desc_bits=jnp.asarray(rng.integers(0, 2, (P, 256)), dtype=jnp.int8),
        ref_depth=jnp.asarray(rng.uniform(5, 15, P), dtype=jnp.float32),
        ref_level=jnp.asarray(rng.integers(0, LEVELS, P), dtype=jnp.int32),
        angle=jnp.asarray(rng.uniform(0, 360, P), dtype=jnp.float32),
        valid=jnp.ones((P,), dtype=bool),
    )


def _mk_frame():
    class F:
        n = N
        uv = rng.uniform(0, 700, (N, 2)).astype(np.float32)
        right = rng.uniform(0, 700, N).astype(np.float32)
        octave = rng.integers(0, LEVELS, N).astype(np.float32)
        angle = rng.uniform(0, 360, N).astype(np.float32)
        descriptors = rng.integers(0, 256, (N, 32)).astype(np.uint8)
        timestamp = 0.0
        imu_dR_cam = None
    return F()


def timeit(fn, reps=20, warmup=3, rounds=5):
    """Time `fn` amortized over `reps` *chained* calls (the device
    serializes the work through the data dependency), synced with
    block_until_ready.  Takes the BEST of ``rounds`` measurements."""
    out = fn(None)
    for _ in range(warmup):
        out = fn(out)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(out)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / reps


def main():
    cam = Pinhole(fx=jnp.float32(458.0), fy=jnp.float32(457.0),
                  cx=jnp.float32(367.0), cy=jnp.float32(248.0))
    bf = jnp.float32(47.9)
    bounds = jnp.asarray([0.0, 0.0, 752.0, 480.0], dtype=jnp.float32)
    scales = jnp.asarray([1.2 ** i for i in range(LEVELS)], dtype=jnp.float32)
    log_sf = jnp.float32(np.log(1.2))
    lm = _mk_lm()
    frames = [_mk_frame() for _ in range(W)]
    buf = jnp.asarray(pack_frames_np(frames, N))
    carry = (jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32),
             jnp.asarray(make_dec_state(300, 0.0, np.zeros(3),
                                        np.array([0, 0, 1.0]), 10.0, 0)),
             jnp.zeros((), dtype=bool))

    def scan(two_stage, c):
        c = carry if c is None else c
        out = window_track(
            lm, buf, c[0], c[1], c[2], c[3], cam, bf,
            bounds, scales, log_sf, jnp.float32(15.0), jnp.float32(2.0),
            kfi_target=jnp.float32(160.0), is_stereo=jnp.asarray(True),
            th_depth=jnp.float32(25.0), n_valid_frames=jnp.int32(W),
            n_slots=N, two_stage=two_stage, use_imu=False,
        )
        return out[4]  # chained carry

    for two in (False, True):
        dt = timeit(lambda c: scan(two, c), reps=20)
        print(f"scan two_stage={two}: {dt*1e3:.2f} ms/window  "
              f"{dt/W*1e3:.3f} ms/frame", flush=True)

    # isolated stages -------------------------------------------------
    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=LEVELS)
    b4 = (bounds[0], bounds[1], bounds[2], bounds[3])
    f0 = frames[0]
    ff = M.FrameFeatures(
        uv=jnp.asarray(f0.uv), right=jnp.asarray(f0.right),
        octave=jnp.asarray(f0.octave, dtype=jnp.int32),
        angle=jnp.asarray(f0.angle),
        desc_bits=jnp.asarray(
            np.unpackbits(f0.descriptors, axis=-1, bitorder="little"),
            dtype=jnp.int8),
        valid=jnp.ones((N,), dtype=bool),
    )
    T = jnp.eye(4, dtype=jnp.float32)

    K = 32  # inner chain length per dispatch

    @jax.jit
    def fine_chain(T):
        def body(Tc, _):
            fp = M.search_by_projection_fine(
                lm, ff, Tc, cam, bf, b4, st, feat_free=ff.valid,
                th=4.0, ratio=0.8)["feat_point"]
            # fold result back into T so iterations serialize
            Tc = Tc + 1e-12 * jnp.sum(fp).astype(jnp.float32)
            return Tc, None
        return jax.lax.scan(body, T, None, length=K)[0]

    dt = timeit(lambda c: fine_chain(T if c is None else c)) / K
    print(f"fine matcher alone: {dt*1e3:.3f} ms/frame", flush=True)
    flop = 2.0 * P * N * 256
    traffic = 4.0 * P * N * 4  # rough: a few (P,N) f32 intermediates
    print(f"  -> matmul {flop/dt/1e12:.2f} TFLOP/s if matmul-bound; "
          f"{traffic/dt/1e9:.0f} GB/s if 4x(P,N)f32-bound", flush=True)

    @jax.jit
    def ham_chain(a):
        def body(ac, _):
            h = hamming_matrix(ac, ff.desc_bits)
            ac = ac + (jnp.sum(h) % 2).astype(ac.dtype) * 0
            return ac, None
        return jax.lax.scan(body, a, None, length=K)[0]

    dt = timeit(lambda c: ham_chain(lm.desc_bits if c is None else c)) / K
    print(f"hamming matmul alone: {dt*1e3:.3f} ms  "
          f"({flop/dt/1e12:.2f} TFLOP/s)", flush=True)

    obs = PoseObs(
        points=lm.position[jnp.arange(N) % P],
        uv=ff.uv, right=ff.right,
        weight=jnp.ones((N,), dtype=jnp.float32),
        mask=jnp.ones((N,), dtype=bool),
    )

    @jax.jit
    def gn_chain(T):
        def body(Tc, _):
            Tc2 = robust_pose_refine(Tc, obs, cam, bf, outer_iters=2,
                                     inner_iters=2)[0]
            return Tc2, None
        return jax.lax.scan(body, T, None, length=K)[0]

    dt = timeit(lambda c: gn_chain(T if c is None else c)) / K
    print(f"pose GN (2x2) alone: {dt*1e3:.3f} ms/frame", flush=True)

    # unpack stage
    from snakeslam_tpu.models.window_step import _unpack_frame

    @jax.jit
    def unpack_chain(x):
        def body(acc, _):
            f, ts, dR = _unpack_frame(buf[0] + acc * 0, N)
            return acc + f.desc_bits.astype(jnp.float32).sum() * 1e-20, None
        return jax.lax.scan(body, x, None, length=K)[0]

    dt = timeit(lambda c: unpack_chain(jnp.float32(0.0) if c is None else c)) / K
    print(f"frame unpack alone: {dt*1e3:.3f} ms/frame", flush=True)


if __name__ == "__main__":
    main()

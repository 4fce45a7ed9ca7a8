"""Pixels-in batched stereo front-end: one device dispatch per frame chunk.

The per-frame image path (FeatureDetector.detect + Preprocess.stereo_match)
pays a blocking device round trip per image — fine for dataset replay.
This module is the throughput path the reference gets from running
detection on its own thread overlapped with tracking (reference:
Snake/Preprocess/FeatureDetector.cpp:58-80): a whole chunk of stereo pairs
goes through ORB extraction (left+right stacked into ONE batch so every
vmapped stage amortizes over both views), dense masked stereo matching
(Preprocess.cpp:122-242 as one Hamming matrix product per frame), and
on-device descriptor packing — all inside a single jitted program,
fetched with one batched D2H copy.

``StereoPixelSource`` drives it chunk-ahead: dispatch chunk k+1, then
convert chunk k while the device works, so host conversion and transfer
latency hide behind device compute (the scan windows of the tracking
pipeline queue behind the extraction on the same device stream).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.map.slam_map import FrameData
from snakeslam_tpu.ops.descriptors import hamming_matrix
from snakeslam_tpu.ops.orb import extract_orb_batch


def _pack_bits_dev(bits: jax.Array) -> jax.Array:
    """(..., 256) {0,1} -> (..., 32) uint8, bitorder='little' (matches
    ops/descriptors.pack_bits_np / unpack_bits)."""
    w = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8)).astype(jnp.int32)
    b = bits.reshape(bits.shape[:-1] + (32, 8)).astype(jnp.int32)
    return (b * w).sum(axis=-1).astype(jnp.uint8)


def _stereo_gates(uv_l, oct_l, bits_l, val_l, uv_r, oct_r, bits_r, val_r,
                  bf, row_tol, max_disp, max_hamming=60):
    """Dense masked stereo matching for ONE frame (the gates of
    Preprocess.cpp:122-242 as masks over a full Hamming matrix).

    Returns (right_u, depth) per left slot; -1 where unmatched.
    """
    H = hamming_matrix(bits_l, bits_r)                       # (N, N)
    du_row = jnp.abs(uv_l[:, 1][:, None] - uv_r[:, 1][None, :])
    disparity = uv_l[:, 0][:, None] - uv_r[:, 0][None, :]
    oct_ok = jnp.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    cand = ((du_row <= row_tol) & (disparity > 0.1) & (disparity < max_disp)
            & oct_ok & (H <= max_hamming)
            & val_l[:, None] & val_r[None, :])
    Hm = jnp.where(cand, H, 999)
    best = Hm.min(axis=1)
    best_j = Hm.argmin(axis=1)
    matched = best <= max_hamming
    disp = uv_l[:, 0] - uv_r[best_j, 0]
    z = jnp.where(matched & (disp > 0.1), bf / jnp.maximum(disp, 0.1), -1.0)
    right = jnp.where(z > 0, uv_r[best_j, 0], -1.0)
    depth = jnp.where(z > 0, z, -1.0)
    return right, depth


@functools.partial(
    jax.jit,
    static_argnames=("n_features", "levels", "scale_factor", "threshold",
                     "relaxed"),
)
def stereo_frontend_batch(
    imgs_l: jax.Array,
    imgs_r: jax.Array,
    bf: float,
    n_features: int = 1000,
    levels: int = 4,
    scale_factor: float = 1.2,
    threshold: float = 20.0,
    relaxed: bool = False,
):
    """(B, H, W) stereo pairs -> per-frame features + stereo depth.

    Returns (uv, octave, angle, packed_desc, valid, right, depth), all with
    leading B and n_features slots.
    """
    B = imgs_l.shape[0]
    f = extract_orb_batch(
        jnp.concatenate([imgs_l, imgs_r], axis=0).astype(jnp.float32),
        n_features=n_features, levels=levels, scale_factor=scale_factor,
        threshold=threshold,
    )
    fl = jax.tree_util.tree_map(lambda x: x[:B], f)
    fr = jax.tree_util.tree_map(lambda x: x[B:], f)
    row_tol = 2.0 * (2.0 if relaxed else 1.0)
    bf = jnp.asarray(bf, dtype=jnp.float32)
    max_disp = jnp.where(bf > 0, bf / 0.3, 200.0)   # z >= 0.3 m
    right, depth = jax.vmap(
        lambda ul, ol, bl, vl, ur, orr, br, vr: _stereo_gates(
            ul, ol, bl, vl, ur, orr, br, vr, bf, row_tol, max_disp)
    )(fl.uv, fl.octave, fl.desc_bits, fl.valid,
      fr.uv, fr.octave, fr.desc_bits, fr.valid)
    packed = _pack_bits_dev(fl.desc_bits)
    return fl.uv, fl.octave, fl.angle, packed, fl.valid, right, depth


class StereoPixelSource:
    """Chunk-ahead pixel front-end.

    dispatch() queues one chunk's extraction on device and starts the
    async D2H copies; materialize() blocks on a (usually landed) copy and
    builds FrameData.  Callers overlap: dispatch chunk k+1 BEFORE
    materializing chunk k.
    """

    def __init__(self, settings):
        self.s = settings

    def dispatch(self, imgs_l: np.ndarray, imgs_r: np.ndarray):
        s = self.s
        # ship the caller's dtype (uint8 images cost 4x less H2D
        # bandwidth); the jitted program casts on device
        outs = stereo_frontend_batch(
            jax.device_put(np.ascontiguousarray(imgs_l)),
            jax.device_put(np.ascontiguousarray(imgs_r)),
            bf=float(s.bf),
            n_features=int(s.fd_features), levels=int(s.fd_levels),
            scale_factor=float(s.fd_scale_factor),
            threshold=float(s.fd_ini_th_fast),
            relaxed=bool(getattr(s, "fd_relaxed_stereo", False)),
        )
        for a in outs:
            a.copy_to_host_async()
        return outs

    def materialize(self, outs, frame_ids, timestamps) -> list[FrameData]:
        """Block on the chunk's (usually already landed) D2H copies and
        build per-frame FrameData."""
        uv, octave, angle, packed, valid, right, depth = \
            [np.asarray(a) for a in outs]
        frames = []
        for k, (fid, ts) in enumerate(zip(frame_ids, timestamps)):
            m = valid[k]
            frames.append(FrameData(
                frame_id=int(fid), timestamp=float(ts),
                uv=uv[k][m].astype(np.float64),
                octave=octave[k][m].astype(np.int32),
                angle=angle[k][m].astype(np.float32),
                descriptors=packed[k][m],
                right=right[k][m].astype(np.float64),
                depth=depth[k][m].astype(np.float64),
            ))
        return frames


class PixelFrameSequence:
    """A lazy frame list over rendered/loaded stereo images.

    Quacks like ``list[FrameData]`` for WindowedRunner (len, int and slice
    indexing) but materializes frames chunk-by-chunk with ``lookahead``
    extraction chunks in flight on device.  Because the runner dispatches
    scan window k before touching frames for window k+1, extraction chunks
    interleave with scan windows on the device queue and the blocking
    feature fetch overlaps scan execution — the device analog of the
    reference's detection thread running ahead of tracking
    (Snake/Preprocess/FeatureDetector.cpp:58-80).
    """

    def __init__(self, settings, imgs_l: np.ndarray, imgs_r: np.ndarray,
                 timestamps, gt_poses_cw=None, chunk: int = 64,
                 lookahead: int = 2):
        self.src = StereoPixelSource(settings)
        self.imgs_l = imgs_l
        self.imgs_r = imgs_r
        self.timestamps = list(timestamps)
        self.gt = gt_poses_cw
        self.n = len(imgs_l)
        self.chunk = chunk
        self.lookahead = max(1, lookahead)
        self._futs: dict[int, object] = {}    # chunk index -> device outs
        self._done: dict[int, list[FrameData]] = {}
        self._next_dispatch = 0

    def __len__(self):
        return self.n

    def _dispatch_chunk(self, c: int):
        if c in self._futs or c in self._done:
            return
        lo = c * self.chunk
        hi = min(lo + self.chunk, self.n)
        if lo >= hi:
            return
        self._futs[c] = self.src.dispatch(self.imgs_l[lo:hi],
                                          self.imgs_r[lo:hi])

    def _ensure(self, c: int):
        """Materialize chunk c, keeping ``lookahead`` chunks in flight."""
        n_chunks = -(-self.n // self.chunk)
        if c >= n_chunks:
            return
        for d in range(c, min(c + 1 + self.lookahead, n_chunks)):
            self._dispatch_chunk(d)
        if c in self._done:
            return
        outs = self._futs.pop(c)
        lo = c * self.chunk
        hi = min(lo + self.chunk, self.n)
        frames = self.src.materialize(outs, range(lo, hi),
                                      self.timestamps[lo:hi])
        if self.gt is not None:
            for i, f in enumerate(frames):
                f.gt_pose_cw = self.gt[lo + i]
        self._done[c] = frames

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.n)
            out = [self[i] for i in range(lo, hi, step)]
            return out
        if idx < 0:
            idx += self.n
        c = idx // self.chunk
        self._ensure(c)
        return self._done[c][idx - c * self.chunk]

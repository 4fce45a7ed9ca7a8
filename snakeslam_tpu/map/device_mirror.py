"""Device-resident mirror of the map's point table.

The host map (SlamMap) is authoritative; this mirror keeps the per-point
payload (position, normal, descriptor bit planes, scale-region data) in
device memory so per-frame local-map snapshots become a device-side gather
of an id array (a few KB H2D) instead of re-uploading hundreds of KB of
point payload every frame.  The mirror refreshes lazily whenever the map's
generation counter moves — at keyframe rate, not frame rate.

This is the device-side expression of the reference's LocalMap snapshot
cache (reference: Snake/Map/LocalMap.h:83-186 — per-point epoch array for
O(1) dedup; here the dedup/gather runs on device).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from snakeslam_tpu.map.slam_map import SlamMap
from snakeslam_tpu.ops.descriptors import unpack_bits
from snakeslam_tpu.ops.matching import LocalMapPoints


def _bucket(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=())
def _gather_points(table, packed):
    """table: (cap, 16) f32 rows = [pos3 | normal3 | depth | level |
    desc bitcast f32 x8].  ``packed`` is ONE (n_slots, 4) f32 staging
    buffer [id-bits | valid | angle | octave-or-(-1)] — a single H2D
    transfer instead of five small ones (small transfers cost per
    transfer, not per byte)."""
    ids = jax.lax.bitcast_convert_type(packed[:, 0], jnp.int32)
    valid = packed[:, 1] > 0.5
    angle = packed[:, 2]
    octave_override = packed[:, 3].astype(jnp.int32)
    use_override = packed[0, 3] >= 0.0
    idx = jnp.clip(ids, 0, table.shape[0] - 1)
    rows = table[idx]
    lvl = jnp.where(use_override, octave_override,
                    rows[:, 7].astype(jnp.int32))
    # descriptors live packed (32 B) in the mirror — 8x less HBM/H2D —
    # and expand to bit planes on device only for the gathered subset
    desc_packed = jax.lax.bitcast_convert_type(
        rows[:, 8:16], jnp.uint8
    ).reshape(rows.shape[0], 32)
    return LocalMapPoints(
        position=rows[:, :3],
        normal=rows[:, 3:6],
        desc_bits=unpack_bits(desc_packed).astype(jnp.int8),
        ref_depth=rows[:, 6],
        ref_level=lvl,
        angle=angle,
        valid=valid,
    )


class DeviceMapMirror:
    def __init__(self, smap: SlamMap):
        self.map = smap
        self.synced_state = -1
        self.capacity = 0
        self._arrays = None

    def sync(self):
        """Refresh the device copy if the map mutated since last sync."""
        smap = self.map
        if smap.state == self.synced_state and self._arrays is not None:
            return
        n = max(smap._next_pt, 1)
        cap = _bucket(n)
        table = np.empty((cap, 16), dtype=np.float32)
        table[:, :3] = smap.pt_pos[:cap]
        table[:, 3:6] = smap.pt_normal[:cap]
        table[:, 6] = smap.pt_ref_depth[:cap]
        table[:, 7] = smap.pt_ref_level[:cap]
        table[:, 8:16] = np.ascontiguousarray(
            smap.pt_desc[:cap]).view(np.float32)
        self._arrays = jnp.asarray(table)
        self.capacity = cap
        self.synced_state = smap.state

    def gather(self, point_ids: np.ndarray, n_slots: int,
               angles: np.ndarray | None = None,
               octaves: np.ndarray | None = None):
        """Build a LocalMapPoints snapshot on device from host point ids."""
        self.sync()
        ids = np.asarray(point_ids[:n_slots], dtype=np.int32)
        n = len(ids)
        packed = np.zeros((n_slots, 4), dtype=np.float32)
        packed[:n, 0] = ids.view(np.float32) if ids.dtype == np.int32 \
            else ids.astype(np.int32).view(np.float32)
        packed[:n, 1] = 1.0
        if angles is not None:
            packed[:n, 2] = angles[:n]
        if octaves is not None:
            packed[:n, 3] = octaves[:n]
        else:
            packed[:, 3] = -1.0
        lm = _gather_points(self._arrays, jnp.asarray(packed))
        return lm, ids.astype(np.int64)

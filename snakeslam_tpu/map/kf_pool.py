"""Device-resident keyframe feature pool.

The mapping back-ends (triangulation fan-out, bidirectional fusion, loop
verification) repeatedly need the *same* keyframes' feature tables on
device.  Re-staging them per dispatch costs one H2D upload per keyframe
per call, and stacking per-keyframe cached arrays with eager ``jnp.stack``
costs a device dispatch per pytree leaf.  This pool keeps a
fixed-capacity slot table of keyframe feature rows resident in device
memory; consumers pass int32 slot indices into their
jitted programs and gather rows *inside* jit (one fused program, zero
eager ops, a few bytes of H2D per dispatch).

Slots are recycled LRU, so capacity bounds memory (~52 KB/keyframe row at
1024 feature slots) while the working set — the current keyframe plus its
covisible neighbors — always hits.  Keyframe features are immutable, so a
resident row never needs refresh; erasing a keyframe just frees its slot.

This is the device analog of the reference keeping all keyframe
feature vectors in GPU-visible memory (Snake/Map/Keyframe.h holds features
by value; the OMP workers read them in place).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.ops.descriptors import unpack_bits
from snakeslam_tpu.ops.matching import FrameFeatures

F32 = np.float32


@jax.jit
def _set_row(uv, right, octave, angle, desc, valid, i, packed):
    """packed: ONE (S, 14) f32 staging row = [uv2 | right | octave | angle
    | desc-bitcast x8 | valid] — a single H2D transfer per keyframe upload
    instead of six small ones (small transfers cost per transfer, not per
    byte)."""
    S = packed.shape[0]
    desc_r = jax.lax.bitcast_convert_type(
        packed[:, 5:13], jnp.uint8).reshape(S, 32)
    return (
        uv.at[i].set(packed[:, 0:2]),
        right.at[i].set(packed[:, 2]),
        octave.at[i].set(packed[:, 3].astype(jnp.int32)),
        angle.at[i].set(packed[:, 4]),
        desc.at[i].set(desc_r),
        valid.at[i].set(packed[:, 13] > 0.5),
    )


def pool_features(arrays, slot):
    """FrameFeatures view of one pool row (call inside jit; ``slot`` may be
    a traced scalar or an index vector — vmap over it for stacks)."""
    uv, right, octave, angle, desc, valid = arrays
    return FrameFeatures(
        uv=uv[slot], right=right[slot], octave=octave[slot],
        angle=angle[slot],
        desc_bits=unpack_bits(desc[slot]).astype(jnp.int8),
        valid=valid[slot],
    )


class KFFeaturePool:
    def __init__(self, smap, n_slots: int, capacity: int = 128):
        self.map = smap
        self.n_slots = n_slots
        self.capacity = capacity
        S = n_slots
        self.arrays = (
            jnp.zeros((capacity, S, 2), dtype=jnp.float32),          # uv
            jnp.full((capacity, S), -1.0, dtype=jnp.float32),        # right
            jnp.zeros((capacity, S), dtype=jnp.int32),               # octave
            jnp.zeros((capacity, S), dtype=jnp.float32),             # angle
            jnp.zeros((capacity, S, 32), dtype=jnp.uint8),           # desc
            jnp.zeros((capacity, S), dtype=bool),                    # valid
        )
        self._slot_of: dict[int, int] = {}
        self._lru: dict[int, int] = {}   # kf -> tick
        self._tick = 0
        hook = getattr(smap, "on_erase_keyframe", None)
        if hook is not None:
            hook.append(self._on_erase)

    def _on_erase(self, kf: int):
        slot = self._slot_of.pop(int(kf), None)
        if slot is not None:
            self._lru.pop(int(kf), None)

    def _upload(self, kf: int, slot: int):
        smap = self.map
        S = self.n_slots
        n = min(int(smap.kf_n_feat[kf]), S)
        packed = np.zeros((S, 14), dtype=F32)
        packed[:, 2] = -1.0
        packed[:n, 0:2] = smap.kf_feat_uv[kf, :n]
        packed[:n, 2] = smap.kf_feat_right[kf, :n]
        packed[:n, 3] = smap.kf_feat_octave[kf, :n]
        packed[:n, 4] = smap.kf_feat_angle[kf, :n]
        packed[:n, 5:13] = np.ascontiguousarray(
            smap.kf_feat_desc[kf, :n], dtype=np.uint8).view(F32)
        packed[:n, 13] = 1.0
        self.arrays = _set_row(*self.arrays, jnp.int32(slot),
                               jnp.asarray(packed))

    def slots_for(self, kfs) -> np.ndarray:
        """Ensure every keyframe in ``kfs`` is resident; return its slot
        index vector (int32).  Uploads at most len(kfs) rows (one jitted
        scatter each); evicts LRU rows not in ``kfs`` when full."""
        kfs = [int(k) for k in kfs]
        self._tick += 1
        out = np.empty(len(kfs), dtype=np.int32)
        needed = set(kfs)
        for j, kf in enumerate(kfs):
            slot = self._slot_of.get(kf)
            if slot is None:
                if len(self._slot_of) >= self.capacity:
                    victim = min(
                        (k for k in self._slot_of if k not in needed),
                        key=lambda k: self._lru.get(k, 0),
                    )
                    slot = self._slot_of.pop(victim)
                    self._lru.pop(victim, None)
                else:
                    used = set(self._slot_of.values())
                    slot = next(s for s in range(self.capacity)
                                if s not in used)
                self._upload(kf, slot)
                self._slot_of[kf] = slot
            self._lru[kf] = self._tick
            out[j] = slot
        return out

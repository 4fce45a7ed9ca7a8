"""Feature detection module: images -> FrameData, with a disk feature cache.

Mirrors the reference's FeatureDetector module (reference:
Snake/Preprocess/FeatureDetector.{h,cpp}): ORB extraction (the jitted
pipeline in ops/orb.py standing in for ORBExtractor/ORBExtractorGPU,
FeatureDetector.cpp:28-42,113-125) and the feature disk cache
``fd_bufferToFile`` -> ``<dataset>/features/<id>.features``
(FeatureDetector.cpp:94-139) as npz files, which makes reruns deterministic
and fast.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import jax.numpy as jnp

from snakeslam_tpu.map.slam_map import FrameData
from snakeslam_tpu.ops.descriptors import pack_bits_np
from snakeslam_tpu.ops.orb import extract_orb
from snakeslam_tpu.system.settings import Settings
from snakeslam_tpu.utils import native


class FeatureDetector:
    def __init__(self, settings: Settings, cache_dir: str | None = None):
        self.s = settings
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir and settings.fd_buffer_to_file:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _cache_path(self, frame_id: int) -> Path | None:
        if self.cache_dir is None or not self.s.fd_buffer_to_file:
            return None
        return self.cache_dir / f"{frame_id}.features"

    def detect(self, image: np.ndarray, frame_id: int,
               timestamp: float) -> FrameData:
        """Run ORB on a grayscale image (H, W) uint8/float."""
        path = self._cache_path(frame_id)
        if path is not None:
            z = native.read_features(path)
            if z is not None:
                return FrameData(
                    frame_id=frame_id, timestamp=timestamp,
                    uv=z["uv"], octave=z["octave"], angle=z["angle"],
                    descriptors=z["descriptors"],
                    right=np.full(len(z["uv"]), -1.0),
                    depth=np.full(len(z["uv"]), -1.0),
                )
        feats = extract_orb(
            jnp.asarray(np.asarray(image, dtype=np.float32)),
            n_features=self.s.fd_features,
            levels=self.s.fd_levels,
            scale_factor=self.s.fd_scale_factor,
            threshold=float(self.s.fd_ini_th_fast),
        )
        valid = np.asarray(feats.valid)
        uv = np.asarray(feats.uv)[valid].astype(np.float64)
        octave = np.asarray(feats.octave)[valid].astype(np.int32)
        angle = np.asarray(feats.angle)[valid].astype(np.float32)
        desc = pack_bits_np(np.asarray(feats.desc_bits)[valid])
        if path is not None:
            native.write_features(path, uv, octave, angle, desc)
        n = len(uv)
        return FrameData(
            frame_id=frame_id, timestamp=timestamp,
            uv=uv, octave=octave, angle=angle, descriptors=desc,
            right=np.full(n, -1.0), depth=np.full(n, -1.0),
        )

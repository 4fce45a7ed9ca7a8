"""Synthetic BA problems and maps (fixtures for tests, bench, dryrun)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.ops import ba as BA


def make_synthetic_ba_problem(C=8, P=256, M=8, noise_px=0.2, pose_noise=0.01,
                              point_noise=0.05, n_fixed=2, seed=0,
                              fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                              dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(P, 3))
    pts[:, 2] += 14.0
    cams_true = np.stack([
        np.asarray(lie.se3_exp(jnp.asarray(
            np.array([0.4 * c, 0.02 * c, 0.0, 0.0, 0.04 * c, 0.0])
        ))) for c in range(C)
    ]).astype(np.float64)
    obs_cam = np.full((P, M), -1, dtype=np.int32)
    obs_uv = np.zeros((P, M, 2))
    obs_right = np.full((P, M), -1.0)
    obs_valid = np.zeros((P, M), dtype=bool)
    for p in range(P):
        cs = rng.choice(C, size=min(M, C), replace=False)
        for k, c in enumerate(cs):
            T = cams_true[c]
            pc = T[:3, :3] @ pts[p] + T[:3, 3]
            if pc[2] < 0.5:
                continue
            obs_cam[p, k] = c
            obs_uv[p, k] = (
                fx * pc[0] / pc[2] + cx + rng.normal(scale=noise_px),
                fy * pc[1] / pc[2] + cy + rng.normal(scale=noise_px),
            )
            obs_valid[p, k] = True
    cam_noisy = cams_true.copy()
    for c in range(n_fixed, C):
        xi = rng.normal(size=6) * pose_noise
        cam_noisy[c] = np.asarray(
            lie.se3_exp(jnp.asarray(xi))
        ).astype(np.float64) @ cams_true[c]
    fixed = np.zeros(C, dtype=bool)
    fixed[:n_fixed] = True
    problem = BA.BAProblem(
        cam_pose=jnp.asarray(cam_noisy, dtype=dtype),
        cam_fixed=jnp.asarray(fixed),
        cam_valid=jnp.ones(C, dtype=bool),
        points=jnp.asarray(
            pts + rng.normal(scale=point_noise, size=pts.shape), dtype=dtype
        ),
        point_valid=jnp.ones(P, dtype=bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(obs_uv, dtype=dtype),
        obs_right=jnp.asarray(obs_right, dtype=dtype),
        obs_weight=jnp.ones((P, M), dtype=dtype),
        obs_valid=jnp.asarray(obs_valid),
        **{k: (v.astype(dtype) if v.dtype.kind == "f" else v)
           for k, v in BA.empty_rpc().items()},
    )
    return problem, cams_true, pts


def make_gba_map(settings, n_feat: int = 64, n_kf: int = 4, n_pts: int = 48,
                 seed: int = 1):
    """A SlamMap for GlobalBA: n_kf mono keyframes on a line, n_pts
    points (perturbed by 5 cm) seen by every keyframe with exact
    projections.  Needs n_feat >= n_pts.  Returns (map, point ids)."""
    from snakeslam_tpu.map.slam_map import FrameData, SlamMap

    rng = np.random.default_rng(seed)
    s = settings
    smap = SlamMap(max(16, n_kf), max(512, 2 * n_pts), n_feat)

    pts_w = rng.uniform(-4, 4, size=(n_pts, 3)) + np.array([0, 0, 12.0])
    kf_ids = []
    for k in range(n_kf):
        pose = np.eye(4)
        pose[:3, 3] = [0.2 * k, 0.0, 0.0]
        pc = pts_w @ pose[:3, :3].T + pose[:3, 3]
        uv = np.stack([
            s.fx * pc[:, 0] / pc[:, 2] + s.cx,
            s.fy * pc[:, 1] / pc[:, 2] + s.cy,
        ], axis=1)
        frame = FrameData(
            frame_id=k, timestamp=0.1 * k,
            uv=np.zeros((n_feat, 2)), octave=np.zeros(n_feat, np.int32),
            angle=np.zeros(n_feat),
            descriptors=rng.integers(0, 256, (n_feat, 32)).astype(np.uint8),
            right=np.full(n_feat, -1.0), depth=np.full(n_feat, -1.0),
        )
        frame.uv[:n_pts] = uv
        frame.pose_cw = pose
        kf_ids.append(smap.allocate_keyframe(frame))
    ids = smap.allocate_points_bulk(
        pts_w + rng.normal(size=pts_w.shape) * 0.05,
        rng.integers(0, 256, (n_pts, 32)).astype(np.uint8),
        kf_ids[0], np.full(n_pts, 12.0), np.zeros(n_pts, np.int32),
        np.tile(np.array([0, 0, -1.0]), (n_pts, 1)),
    )
    for k in kf_ids:
        smap.add_observations_bulk(k, np.arange(n_pts), ids)
    return smap, ids

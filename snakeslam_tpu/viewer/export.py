"""Viewer interface: decoupled snapshot export.

Replacement for the reference's ViewerInterface contract (reference:
Snake/Map/ViewerInterface.{h,cpp} — ViewerFrame / ViewerMap snapshots built
under the read lock and pushed to the render thread; Snake/Viewer/
SnakeOpenGLViewer.h renders them with OpenGL).  This environment has no
display, so the same snapshots are exported as files: PLY point clouds +
camera frusta for any external viewer, and npz snapshots for notebook /
web-based rendering — the viewer stays decoupled from the pipeline exactly
as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from snakeslam_tpu.map.slam_map import SlamMap
from snakeslam_tpu.utils.png import write_png


@dataclass
class ViewerMapSnapshot:
    """ViewerMap analog (ViewerInterface.h:79-115)."""

    points: np.ndarray          # (P, 3)
    keyframe_poses: np.ndarray  # (K, 4, 4) world->camera
    covis_edges: np.ndarray     # (E, 2) indices into keyframe_poses
    timestamps: np.ndarray


def snapshot_map(smap: SlamMap, min_edge_weight: int = 20) -> ViewerMapSnapshot:
    ks = smap.valid_keyframes()
    ps = smap.valid_points()
    idx = {int(k): i for i, k in enumerate(ks)}
    edges = []
    for k in ks:
        cov, w = smap.covisible_keyframes(int(k), min_weight=min_edge_weight)
        for c in cov:
            if int(c) > int(k):
                edges.append((idx[int(k)], idx[int(c)]))
    return ViewerMapSnapshot(
        points=smap.pt_pos[ps].copy(),
        keyframe_poses=smap.kf_pose[ks].copy(),
        covis_edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        timestamps=smap.kf_timestamp[ks].copy(),
    )


def write_ply(snapshot: ViewerMapSnapshot, path):
    """ASCII PLY: map points (white) + camera centers (green)."""
    centers = np.stack([
        -T[:3, :3].T @ T[:3, 3] for T in snapshot.keyframe_poses
    ]) if len(snapshot.keyframe_poses) else np.zeros((0, 3))
    n = len(snapshot.points) + len(centers)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in snapshot.points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 200 200 200\n")
        for c in centers:
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 0 255 0\n")


def export_viewer_snapshot(smap: SlamMap, out_dir, tag: str = "map"):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    snap = snapshot_map(smap)
    np.savez_compressed(
        out_dir / f"{tag}.npz",
        points=snap.points,
        keyframe_poses=snap.keyframe_poses,
        covis_edges=snap.covis_edges,
        timestamps=snap.timestamps,
    )
    write_ply(snap, out_dir / f"{tag}.ply")
    return snap


@dataclass
class ViewerFrameSnapshot:
    """ViewerFrame analog (ViewerInterface.cpp:15-72): per-frame pose +
    feature overlay, decoupled from the pipeline."""

    frame_id: int
    timestamp: float
    uv: np.ndarray            # (N, 2) keypoints
    matched: np.ndarray       # (N,) bool — has a map-point match
    pose_cw: np.ndarray | None
    gt_pose_cw: np.ndarray | None
    image: np.ndarray | None  # (H, W) grayscale, optional


def snapshot_frame(frame, image: np.ndarray | None = None
                   ) -> ViewerFrameSnapshot:
    """Build the per-frame viewer snapshot from a tracked FrameData."""
    matched = (frame.matches >= 0 if frame.matches is not None
               else np.zeros(frame.n, dtype=bool))
    return ViewerFrameSnapshot(
        frame_id=int(frame.frame_id), timestamp=float(frame.timestamp),
        uv=np.asarray(frame.uv, dtype=np.float64),
        matched=np.asarray(matched, dtype=bool),
        pose_cw=None if frame.pose_cw is None else np.asarray(frame.pose_cw),
        gt_pose_cw=getattr(frame, "gt_pose_cw", None),
        image=image,
    )


def write_frame_overlay(snap: ViewerFrameSnapshot, path,
                        size: tuple | None = None, radius: int = 3):
    """Render the feature-overlay PNG the reference's viewer draws live
    (ViewerFrame::get_image_rgb, ViewerInterface.cpp:15-72): the grayscale
    frame (or a black canvas at ``size``) with map-point matches in green
    and unmatched detections in red."""
    if snap.image is not None:
        base = np.clip(snap.image, 0, 255).astype(np.uint8)
        img = np.repeat(base[:, :, None], 3, axis=2)
    else:
        if size is None:
            w = int(snap.uv[:, 0].max()) + 16 if len(snap.uv) else 64
            h = int(snap.uv[:, 1].max()) + 16 if len(snap.uv) else 48
            size = (w, h)
        img = np.zeros((size[1], size[0], 3), dtype=np.uint8)
    # circle outlines: the pixels of a one-pixel ring of the given radius
    t = np.linspace(0.0, 2.0 * np.pi, max(8 * radius, 8), endpoint=False)
    ring_u, ring_v = radius * np.cos(t), radius * np.sin(t)
    H, W = img.shape[:2]
    for (u, v), m in zip(snap.uv, snap.matched):
        color = (0, 220, 60) if m else (220, 50, 50)
        x = np.rint(u + ring_u).astype(int)
        y = np.rint(v + ring_v).astype(int)
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        img[y[ok], x[ok]] = color
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, img)
    return path


class FrameOverlayWriter:
    """Export a feature-overlay PNG every N tracked frames — the headless
    stand-in for the reference's live viewer frame stream
    (Tracking.cpp:110-118 pushes ViewerFrames from the tracking thread)."""

    def __init__(self, out_dir, every_n: int = 10,
                 size: tuple | None = None):
        self.out_dir = Path(out_dir)
        self.every_n = max(1, int(every_n))
        self.size = size

    def on_frame(self, frame, image: np.ndarray | None = None):
        if int(frame.frame_id) % self.every_n:
            return None
        snap = snapshot_frame(frame, image)
        return write_frame_overlay(
            snap, self.out_dir / f"frame_{int(frame.frame_id):06d}.png",
            size=self.size)

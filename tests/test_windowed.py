"""Windowed tracking: quality parity with the per-frame path."""

import numpy as np
import pytest

from snakeslam_tpu.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu.system.settings import InputType, Settings
from snakeslam_tpu.system.slam import SlamSystem
from snakeslam_tpu.tracking.windowed import WindowedRunner
from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory


@pytest.mark.slow
def test_windowed_matches_per_frame_quality():
    world = SyntheticWorld(n_points=3000, seed=71)
    settings = Settings()
    settings.input_type = InputType.Stereo
    settings.enable_imu = False
    settings.feature_slots = 1024
    settings.local_map_slots = 2048
    settings.lba_cam_slots = 24
    settings.lba_point_slots = 4096
    settings.lba_obs_slots = 8
    settings.th_depth = 25.0
    apply_world_to_settings(world, settings)
    system = SlamSystem(settings)
    frames = list(synthetic_frames(
        world, orbit_trajectory(80, radius=7.0, arc=0.8),
        settings, noise_px=0.3,
    ))
    runner = WindowedRunner(system, window=8)
    runner.run(frames)

    n_tracked = len(system.tracker.trajectory)
    assert n_tracked >= 76, f"windowed tracked only {n_tracked}"
    assert system.map.n_keyframes >= 3
    rmse, scale, n = system.ate_against_gt(with_scale=False)
    assert rmse < 0.02, f"windowed ATE {rmse}"
    # the point of the window path: far fewer device calls than frames
    assert runner.n_device_calls <= len(frames)


def test_point_slot_generation_guard():
    """Recycled point slots must be detectable by stale consumers: erase +
    reallocate bumps pt_alloc_gen, so a snapshot's gen stamps no longer
    match (the SoA analog of the reference's shared_ptr MapPoint identity,
    Map.h:48-77).  Without this, in-flight window consumes alias unrelated
    new points (measured: ~12% garbage observations per keyframe)."""
    from snakeslam_tpu.map.slam_map import SlamMap

    smap = SlamMap(max_keyframes=8, max_points=16, max_features=64)
    desc = np.zeros(32, dtype=np.uint8)
    n = np.array([0.0, 0.0, 1.0])
    p = smap.allocate_point(np.array([1.0, 2.0, 3.0]), desc, 0, 1.0, 0, n)
    snap_gen = smap.pt_alloc_gen[[p]].copy()

    # consumer with a live snapshot: stamps match
    assert (smap.pt_alloc_gen[[p]] == snap_gen).all()

    # slot recycled while "in flight"
    smap.erase_point(p)
    p2 = smap.allocate_point(np.array([9.0, 9.0, 9.0]), desc, 1, 1.0, 0, n)
    assert p2 == p, "free-list should recycle the slot for this scenario"
    assert smap.pt_valid[p]          # the NEW point is valid...
    assert (smap.pt_alloc_gen[[p]] != snap_gen).all(), \
        "...but the gen stamp must expose the recycle"

    # bulk allocation bumps too
    ids = smap.allocate_points_bulk(
        np.zeros((3, 3)), np.zeros((3, 32), dtype=np.uint8), 0,
        np.ones(3), np.zeros(3, dtype=np.int8), np.tile(n, (3, 1)))
    g0 = smap.pt_alloc_gen[ids].copy()
    for i in ids:
        smap.erase_point(int(i))
    ids2 = smap.allocate_points_bulk(
        np.zeros((3, 3)), np.zeros((3, 32), dtype=np.uint8), 0,
        np.ones(3), np.zeros(3, dtype=np.int8), np.tile(n, (3, 1)))
    recycled = np.isin(ids2, ids)
    assert recycled.any()
    assert (smap.pt_alloc_gen[ids] != g0).any()


@pytest.mark.parametrize("backend,want", [("gpu", "fused"), ("cpu", "xla")])
def test_default_pose_refine_by_backend(backend, want):
    """The scan runs the fused Triton kernel only where it compiles."""
    from snakeslam_tpu.models.window_step import default_pose_refine

    assert default_pose_refine(backend) == want


def test_runner_pose_refine_choice():
    """WindowedRunner takes the backend's default (XLA on the CPU test
    backend), accepts an explicit choice and rejects unknown names."""
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    system = SlamSystem(s)
    assert WindowedRunner(system).pose_refine == "xla"
    assert WindowedRunner(system, pose_refine="fused").pose_refine == "fused"
    with pytest.raises(ValueError):
        WindowedRunner(system, pose_refine="pallas")

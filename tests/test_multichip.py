"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from snakeslam_tpu.core import lie
from snakeslam_tpu.ops.descriptors import unpack_bits_np, hamming_np
from snakeslam_tpu.parallel import multichip as MC


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_hamming_matches_local(rng):
    mesh = MC.make_mesh()
    pbits = rng.integers(0, 2, size=(1024, 256)).astype(np.int8)
    fbits = rng.integers(0, 2, size=(512, 256)).astype(np.int8)
    fn = MC.sharded_hamming_topk(mesh)
    d, idx = fn(jnp.asarray(pbits), jnp.asarray(fbits))
    # oracle
    H = (pbits[:, None, :] != fbits[None, :, :]).sum(axis=2)
    assert (np.asarray(d) == H.min(axis=1)).all()
    assert (H[np.arange(1024), np.asarray(idx)] == H.min(axis=1)).all()


@pytest.mark.slow
def test_slam_system_sharded_full_ba(rng):
    """The FULL SlamSystem on the 8-device mesh: settings.n_devices = 8
    routes every finalize FullBA through the sharded dp-mesh solver, and
    the resulting trajectory matches the single-device run."""
    from snakeslam_tpu.frontend.synthetic_source import (
        apply_world_to_settings,
        synthetic_frames,
    )
    from snakeslam_tpu.system.settings import InputType, Settings
    from snakeslam_tpu.system.slam import SlamSystem
    from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory

    def run(n_devices):
        settings = Settings()
        settings.input_type = InputType.Stereo
        settings.enable_imu = False
        settings.n_devices = n_devices
        settings.feature_slots = 1024
        settings.local_map_slots = 2048
        settings.lba_cam_slots = 24
        settings.lba_point_slots = 4096
        settings.lba_obs_slots = 8
        settings.th_depth = 25.0
        world = SyntheticWorld(n_points=2000, seed=3)
        apply_world_to_settings(world, settings)
        system = SlamSystem(settings)
        frames = list(synthetic_frames(
            world, orbit_trajectory(30, radius=7.0, arc=0.8),
            settings, noise_px=0.3,
        ))
        for f in frames:
            system.process_frame(f)
        system.finalize(gba_iterations=3)
        rmse, _, n = system.ate_against_gt(with_scale=False)
        return system, rmse, n

    sys8, rmse8, n8 = run(8)
    # the sharded path was actually engaged
    assert sys8.map.n_keyframes >= 2
    assert rmse8 < 0.05, f"sharded-finalize ATE {rmse8}"

    sys1, rmse1, n1 = run(1)
    assert n8 == n1
    # GN-vs-LM solver difference only: trajectories must agree closely
    assert abs(rmse8 - rmse1) < 5e-3, (rmse8, rmse1)


def test_gba_engages_sharded_path(rng):
    """GlobalBA with n_devices=8 builds the mesh and full_ba runs sharded."""
    from snakeslam_tpu.map.slam_map import SlamMap
    from snakeslam_tpu.optim.gba import GlobalBA
    from snakeslam_tpu.system.settings import Settings

    s = Settings()
    s.n_devices = 8
    smap = SlamMap(64, 4096, 128)
    gba = GlobalBA(s, smap)
    assert gba._mesh is not None and gba._mesh.size == 8


def test_sharded_ba_step_converges(rng):
    # reuse the BA test problem builder
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tba", __file__.replace("test_multichip", "test_ba")
    )
    tba = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tba)

    problem, cams_true, pts_true, _ = tba._make_ba_problem(
        rng, C=8, P=256, M=8, noise_px=0.0
    )
    # cast to f32 (device dtype) for the sharded path
    import jax.numpy as jnp
    from snakeslam_tpu.ops.ba import BAProblem

    problem = BAProblem(*[
        (v.astype(jnp.float32) if v.dtype.kind == "f" else v)
        for v in problem
    ])
    mesh = MC.make_mesh()
    from snakeslam_tpu.core.camera import Pinhole

    cam = Pinhole.create(458.654, 457.296, 367.215, 248.375)
    step = MC.sharded_ba_step(mesh, cam, jnp.float32(458.654 * 0.11),
                              n_iters=5, lam=1e-6)
    sharded = MC.shard_problem(problem, mesh)
    cam_pose, points = step(sharded)
    errs = tba._cam_errs(np.asarray(cam_pose), cams_true)
    assert errs.max() < 1e-3
    assert np.abs(np.asarray(points) - pts_true).max() < 1e-2


def test_gba_raises_when_devices_are_missing():
    """GlobalBA refuses an n_devices larger than the devices that exist
    instead of quietly running on one."""
    from snakeslam_tpu.map.slam_map import SlamMap
    from snakeslam_tpu.optim.gba import GlobalBA
    from snakeslam_tpu.system.settings import Settings

    s = Settings()
    s.n_devices = len(jax.devices()) + 1
    with pytest.raises(ValueError, match="devices"):
        GlobalBA(s, SlamMap(16, 512, 64))

"""Dataset loader + full image-pipeline tests on miniature fixtures.

A synthetic TUM-RGBD sequence is rendered as a translating view of a
textured fronto-parallel plane (geometrically exact for lateral motion at
constant depth), written in the real on-disk format, then run through the
complete stack: PNG -> ORB -> preprocessing -> tracking -> trajectory.
"""

import numpy as np
import pytest
from PIL import Image

from snakeslam_tpu.frontend.datasets import EurocDataset, TumRgbdDataset


W, H = 320, 240
DEPTH_Z = 2.0
FX = FY = 260.0
CX, CY = W / 2, H / 2


def _texture(rng, size=1024):
    tex = np.full((size, size), 120.0)
    for _ in range(400):
        h = rng.integers(6, 30)
        w = rng.integers(6, 30)
        y = rng.integers(0, size - h)
        x = rng.integers(0, size - w)
        tex[y:y + h, x:x + w] = rng.choice([30, 80, 160, 230])
    return tex.astype(np.uint8)


def _make_tum_fixture(tmp_path, rng, n_frames=10, step_m=0.02):
    """Camera translating along +x viewing a plane at z=2."""
    tex = _texture(rng)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = [], [], []
    x0, y0 = 300, 300
    for i in range(n_frames):
        t = i * 0.1
        shift_px = int(round(FX * (i * step_m) / DEPTH_Z))
        crop = tex[y0:y0 + H, x0 + shift_px:x0 + shift_px + W]
        Image.fromarray(crop).save(tmp_path / "rgb" / f"{t:.6f}.png")
        depth = np.full((H, W), DEPTH_Z * 5000, dtype=np.uint16)
        Image.fromarray(depth).save(tmp_path / "depth" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        # camera moves +x in world; TUM gt is camera-in-world
        gt_lines.append(f"{t:.6f} {i * step_m:.6f} 0 0 0 0 0 1")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines))
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines))
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt_lines))
    return tmp_path


def test_tum_loader(tmp_path, rng):
    _make_tum_fixture(tmp_path, rng, n_frames=4)
    ds = TumRgbdDataset(tmp_path)
    frames = list(ds)
    assert len(frames) == 4
    assert frames[0].gray.shape == (H, W)
    assert frames[0].depth is not None
    assert np.isclose(frames[0].depth[100, 100], DEPTH_Z)
    assert ds.gt is not None and len(ds.gt["t"]) == 4


def test_euroc_loader(tmp_path, rng):
    mav = tmp_path / "mav0"
    cam = mav / "cam0"
    (cam / "data").mkdir(parents=True)
    img = _texture(rng)[:H, :W]
    lines = ["#timestamp [ns],filename"]
    for i in range(3):
        ts_ns = 1403636579763555584 + i * 50_000_000
        Image.fromarray(img).save(cam / "data" / f"{ts_ns}.png")
        lines.append(f"{ts_ns},{ts_ns}.png")
    (cam / "data.csv").write_text("\n".join(lines))
    (cam / "sensor.yaml").write_text(
        "intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
        "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n"
        "resolution: [320, 240]\n"
    )
    imu_dir = mav / "imu0"
    imu_dir.mkdir(parents=True)
    imu_lines = ["#ts,wx,wy,wz,ax,ay,az"]
    for k in range(30):
        ts = 1403636579763555584 + k * 5_000_000
        imu_lines.append(f"{ts},0.01,0.0,0.0,0.0,0.0,9.81")
    (imu_dir / "data.csv").write_text("\n".join(imu_lines))

    ds = EurocDataset(tmp_path)
    frames = list(ds)
    assert len(frames) == 3
    assert ds.calib["fx"] == 458.654
    # IMU windows attach to frames after the first
    assert frames[1].imu_omega is not None and len(frames[1].imu_omega) > 0


@pytest.mark.slow
def test_full_image_pipeline_tum(tmp_path, rng):
    """PNG fixture -> CLI main() -> TUM trajectory with small ATE."""
    _make_tum_fixture(tmp_path, rng, n_frames=10, step_m=0.03)
    cfg = tmp_path / "config.ini"
    from snakeslam_tpu.system.settings import InputType, SensorType, Settings

    settings = Settings()
    settings.input_type = InputType.RGBD
    settings.sensor_type = SensorType.TUM_RGBD
    settings.enable_imu = False
    settings.fd_features = 500
    settings.fd_levels = 2
    settings.feature_slots = 512
    settings.local_map_slots = 1024
    settings.lba_cam_slots = 16
    settings.lba_point_slots = 2048
    settings.lba_obs_slots = 8
    settings.fx, settings.fy = FX, FY
    settings.cx, settings.cy = CX, CY
    settings.width, settings.height = W, H
    settings.th_depth = 10.0

    from snakeslam_tpu.frontend.input import Input
    from snakeslam_tpu.system.slam import SlamSystem
    from snakeslam_tpu.frontend.datasets import TumRgbdDataset

    inp = Input(settings, dataset=TumRgbdDataset(tmp_path))
    system = SlamSystem(settings)
    frames = list(inp)
    for f in frames:
        system.process_frame(f)

    n_tracked = len(system.tracker.trajectory)
    assert n_tracked >= 8, f"tracked only {n_tracked}"
    # estimated motion is +x at 0.03 m/frame
    est = [np.linalg.inv(f.pose_cw)[:3, 3] for f in system.tracker.trajectory]
    est = np.array(est)
    dx = np.diff(est[:, 0])
    assert np.abs(np.median(dx) - 0.03) < 0.01
    system.write_trajectories(tmp_path / "out")
    assert (tmp_path / "out" / "trajectory_frames_ba.tum").exists()


def test_playback_pacing(rng):
    """Deployment-mode pacing (Input.cpp:240-303 + ResetTime): frames are
    delivered no faster than playback_fps allows; evaluation mode streams
    as fast as possible."""
    import time

    from snakeslam_tpu.frontend.datasets import RawFrame
    from snakeslam_tpu.frontend.input import Input
    from snakeslam_tpu.system.settings import InputType, Settings

    s = Settings()
    s.input_type = InputType.Mono
    s.width, s.height = 64, 64
    s.fd_features = 32

    def fake_dataset():
        img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
        for i in range(6):
            # native 100 fps timestamps
            yield RawFrame(frame_id=i, timestamp=i * 0.01, gray=img)

    s.dataset.playback_fps = 25.0  # quarter speed -> >= 0.04 s gaps
    s.dataset.playback_paced = True
    inp = Input(s, dataset=fake_dataset())
    t0 = time.perf_counter()
    frames = list(inp.frames())
    paced_wall = time.perf_counter() - t0
    assert len(frames) == 6
    # 5 gaps * 0.04 s = 0.2 s minimum (first frames free)
    assert paced_wall >= 0.12, f"pacing ignored: {paced_wall:.3f}s"

    inp = Input(s, dataset=fake_dataset())
    t0 = time.perf_counter()
    frames = list(inp.frames(paced=False))
    assert len(frames) == 6
    assert time.perf_counter() - t0 < paced_wall


def test_kitti_loader(tmp_path, rng):
    """KITTI odometry layout: stereo pairs, times.txt, calib P0/P1, GT
    poses (datasets.KittiDataset; reference Input supports the same
    layout via saiga's KittiDataset)."""
    from snakeslam_tpu.frontend.datasets import KittiDataset

    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    img = _texture(rng)[:H, :W]
    n = 4
    for i in range(n):
        Image.fromarray(img).save(seq / "image_0" / f"{i:06d}.png")
        Image.fromarray(img).save(seq / "image_1" / f"{i:06d}.png")
    (seq / "times.txt").write_text("\n".join(f"{i * 0.1:.6f}"
                                             for i in range(n)))
    (seq / "calib.txt").write_text(
        "P0: 718.856 0 607.19 0 0 718.856 185.21 0 0 0 1 0\n"
        "P1: 718.856 0 607.19 -386.14 0 718.856 185.21 0 0 0 1 0\n"
    )
    poses = tmp_path / "poses"
    poses.mkdir()
    rows = []
    for i in range(n):
        T = np.hstack([np.eye(3), [[i * 0.5], [0.0], [0.0]]])
        rows.append(" ".join(f"{v:.6e}" for v in T.ravel()))
    (poses / "00.txt").write_text("\n".join(rows))

    ds = KittiDataset(tmp_path, "00")
    frames = list(ds)
    assert len(frames) == n == len(ds)
    assert frames[0].gray.shape == (H, W)
    assert frames[0].right is not None
    assert np.isclose(frames[2].timestamp, 0.2)
    assert np.isclose(ds.calib["fx"], 718.856)
    assert np.isclose(ds.calib["bf"], 386.14)
    assert ds.gt is not None and np.isclose(ds.gt["p"][3, 0], 1.5)
    # start/max_frames windowing
    ds2 = KittiDataset(tmp_path, "00", start=1, max_frames=2)
    assert len(list(ds2)) == 2 == len(ds2)


def test_scannet_loader(tmp_path, rng):
    """ScanNet export layout: color jpgs + millimeter depth pngs +
    intrinsic_depth.txt (datasets.ScannetDataset)."""
    from snakeslam_tpu.frontend.datasets import ScannetDataset

    (tmp_path / "color").mkdir()
    (tmp_path / "depth").mkdir()
    (tmp_path / "intrinsic").mkdir()
    img = _texture(rng)[:H, :W]
    for i in range(3):
        Image.fromarray(img).convert("RGB").save(
            tmp_path / "color" / f"{i}.jpg")
        depth_mm = np.full((H, W), 1500, dtype=np.uint16)
        Image.fromarray(depth_mm).save(tmp_path / "depth" / f"{i}.png")
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 577.87, 577.87, 319.5, 239.5
    np.savetxt(tmp_path / "intrinsic" / "intrinsic_depth.txt", K)

    ds = ScannetDataset(tmp_path, fps=30.0)
    frames = list(ds)
    assert len(frames) == 3 == len(ds)
    assert frames[0].gray.shape == (H, W)
    assert np.isclose(frames[0].depth[50, 50], 1.5)  # mm -> m
    assert np.isclose(frames[1].timestamp, 1 / 30.0)
    assert np.isclose(ds.calib["fx"], 577.87)


def test_zju_loader_and_factory(tmp_path, rng):
    """ZJU-SenseTime ships the EuRoC/ASL layout; the factory must route
    SensorType.ZJU there (datasets.ZjuDataset / create_dataset)."""
    from snakeslam_tpu.frontend.datasets import ZjuDataset, create_dataset
    from snakeslam_tpu.system.settings import SensorType, Settings

    mav = tmp_path / "mav0"
    cam = mav / "cam0"
    (cam / "data").mkdir(parents=True)
    img = _texture(rng)[:H, :W]
    lines = ["#timestamp [ns],filename"]
    for i in range(3):
        ts_ns = 1_000_000_000 + i * 33_000_000
        Image.fromarray(img).save(cam / "data" / f"{ts_ns}.png")
        lines.append(f"{ts_ns},{ts_ns}.png")
    (cam / "data.csv").write_text("\n".join(lines))
    (cam / "sensor.yaml").write_text(
        "intrinsics: [400.0, 400.0, 160.0, 120.0]\n"
        "resolution: [320, 240]\n"
    )

    ds = ZjuDataset(tmp_path)
    assert len(list(ds)) == 3
    assert ds.calib["fx"] == 400.0

    s = Settings()
    s.sensor_type = SensorType.ZJU
    ds2 = create_dataset(s, tmp_path)
    assert isinstance(ds2, ZjuDataset)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_reader_matches_pillow(tmp_path, rng, kind):
    """utils/png.read_png decodes what Pillow writes, bit for bit, and
    to_gray reproduces Pillow's RGB -> L conversion."""
    from snakeslam_tpu.utils.png import read_png, to_gray, write_png

    tex = _texture(rng)[:H, :W]
    if kind == "gray8":
        arr = tex.astype(np.uint8)
    elif kind == "gray16":
        arr = (tex.astype(np.uint16) * 257 + np.arange(W, dtype=np.uint16))
    else:
        arr = np.stack([tex, np.roll(tex, 7, axis=1), 255 - tex],
                       axis=2).astype(np.uint8)
    path = tmp_path / f"{kind}.png"
    Image.fromarray(arr).save(path)
    got = read_png(path)
    assert got.dtype == arr.dtype and got.shape == arr.shape
    assert np.array_equal(got, arr)
    if kind == "rgb8":
        ref = np.asarray(Image.open(path).convert("L"))
        assert np.array_equal(to_gray(got), ref)
    # our own writer round-trips through Pillow and through the reader
    out = write_png(tmp_path / f"{kind}_out.png", arr)
    assert np.array_equal(np.asarray(Image.open(out)), arr)
    assert np.array_equal(read_png(out), arr)

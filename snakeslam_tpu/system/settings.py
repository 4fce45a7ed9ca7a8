"""Settings: INI-backed configuration with per-dataset presets.

Mirrors the reference's ``Settings`` struct and loader semantics
(reference: Snake/System/Settings.h:79-160, Settings.cpp:67-202): INI files
with the same section layout, write-back of missing defaults, per-dataset
hardcoded parameter presets, and the Mono/RGBD/Stereo + sensor enums.
"""

from __future__ import annotations

import configparser
import enum
from dataclasses import dataclass, field, fields
from pathlib import Path


class InputType(enum.IntEnum):
    Mono = 0
    RGBD = 1
    Stereo = 2


class SensorType(enum.IntEnum):
    PRIMESENSE = 0
    SAIGA_RAW = 1
    TUM_RGBD = 2
    ZJU = 3
    EUROC = 4
    KITTI = 5
    SCANNET = 6
    KINECT_AZURE = 7
    SYNTHETIC = 8  # feature-level synthetic dataset (this framework only)


@dataclass
class DatasetParams:
    dataset_dir: str = ""
    playback_fps: float = 30.0
    # deliver frames at wall-clock rate (deployment mode, README.md:61-65);
    # off = as-fast-as-possible evaluation replay
    playback_paced: bool = False
    start_frame: int = 0
    max_frames: int = -1
    ground_truth: str = ""


@dataclass
class Settings:
    # ====== General (Settings.h:83-101) ======
    random_seed: int = 0
    eval_dir: str = "eval_out/"
    out_file_prefix: str = "trajectory"
    async_mode: bool = False
    async_lba: bool = False
    num_tracking_threads: int = 4
    keep_valid_depth_image: bool = False

    # ====== Input ======
    input_type: InputType = InputType.Mono
    sensor_type: SensorType = SensorType.EUROC
    voc_file: str = "ORBvoc.minibow"
    dataset: DatasetParams = field(default_factory=DatasetParams)

    # ====== Feature Detector (Settings.h:112-121) ======
    fd_features: int = 1000
    fd_scale_factor: float = 1.2
    fd_levels: int = 4
    fd_ini_th_fast: int = 20
    fd_min_th_fast: int = 7
    fd_threads: int = 2
    fd_buffer_to_file: bool = False
    fd_relaxed_stereo: bool = True

    # ====== Tracking (Settings.h:124-136) ======
    kfi_target_matches: int = 180
    th_map: int = 140
    initialization_quality: int = 1
    # seeded probabilistic extra/indirect neighbors in the fine local map
    # (TrackingFine.cpp:278-324 parity); off = deterministic top-15 only
    fine_explore: bool = True
    # below this many keyframes a tracking loss clears the map instead of
    # entering recovery/relocalization (Tracking.cpp:200-244)
    reloc_min_keyframes: int = 20

    # ====== IMU (Settings.h:141-156) ======
    enable_imu: bool = True
    weight_gyro_initialization: float = 0.3
    weight_gyro_optimization: float = 100.0
    weight_gyro_tracking: float = 0.2
    weight_acc_optimization: float = 10.0
    weight_acc_tracking: float = 0.1

    # ====== framework capacities (fixed device shapes) ======
    # devices for the sharded global-BA path (parallel/multichip.py):
    # >1 routes GlobalBA.full_ba through the dp-mesh sharded solver
    # (points/observations sharded, camera system psum'ed across devices)
    n_devices: int = 1
    max_keyframes: int = 2048
    max_points: int = 262144
    feature_slots: int = 1024       # device-side feature slot count
    local_map_slots: int = 4096     # fine-tracking local-map point slots
    # pin the windowed runner's snapshot padding to local_map_slots instead
    # of growing it in power-of-two buckets: one scan compile for the whole
    # run and no chain restarts at bucket boundaries (long-run/bench mode;
    # adaptive buckets stay the default so small maps keep smaller scans)
    pin_local_map_bucket: bool = False
    lba_cam_slots: int = 48         # LBA window camera slots
    lba_point_slots: int = 8192
    lba_obs_slots: int = 16         # obs per point within the LBA window

    # derived camera parameters (set by the input module, like the reference's
    # SnakeGlobal intrinsics — Snake/System/SnakeGlobal.h:93-103)
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    width: int = 752
    height: int = 480
    bf: float = 0.0               # baseline * fx (stereo/RGBD)
    th_depth: float = 20.0        # close-point threshold multiplier
    # RGBD depth-map preprocessing (DepthProcessor2 parity,
    # System.cpp:226-241: {dont_care=0, gauss_radius=2, hyst 7..9})
    depth_filter_enable: bool = False
    depth_filter_gauss_radius: int = 2
    depth_filter_hyst_min: float = 7.0
    depth_filter_hyst_max: float = 9.0
    # camera<-body extrinsics (flattened 4x4, row-major); identity when the
    # IMU frame coincides with the camera (the reference's camera_to_body,
    # used at Snake/Tracking/TrackingCoarse.cpp:322-327)
    T_cam_body: tuple = (1.0, 0, 0, 0, 0, 1.0, 0, 0,
                         0, 0, 1.0, 0, 0, 0, 0, 1.0)

    def set_default_parameters_for_dataset(self):
        """Per-dataset preset overrides (reference: Settings.cpp:161-202)."""
        st = self.sensor_type
        if st == SensorType.EUROC:
            self.weight_gyro_optimization = 1000.0
            self.weight_acc_optimization = 400.0
            self.kfi_target_matches = 160
            self.th_map = 140
            self.fd_features = 1000
            self.fd_levels = 4
        elif st == SensorType.KITTI:
            self.fd_features = 2000
            self.fd_levels = 7
            self.enable_imu = False
        elif st in (SensorType.TUM_RGBD, SensorType.SCANNET,
                    SensorType.PRIMESENSE):
            self.enable_imu = False

    # ------------------------------------------------------------------
    # INI round-trip (write-back of defaults like Settings.cpp:67-159)
    # ------------------------------------------------------------------

    _INI_LAYOUT = {
        "Global": ["random_seed", "eval_dir", "out_file_prefix", "async_mode",
                   "async_lba", "num_tracking_threads"],
        "Input": ["input_type", "sensor_type", "voc_file"],
        # fallback calibration: datasets that ship calib files (EuRoC
        # sensor.yaml, KITTI calib.txt) override these at load
        # (frontend/input.py); datasets without them (TUM fixtures,
        # custom rigs) read the INI
        "Camera": ["fx", "fy", "cx", "cy", "width", "height", "bf",
                   "th_depth"],
        "FeatureDetector": ["fd_features", "fd_scale_factor", "fd_levels",
                            "fd_ini_th_fast", "fd_min_th_fast", "fd_threads",
                            "fd_buffer_to_file", "fd_relaxed_stereo"],
        "Tracking": ["kfi_target_matches", "th_map", "initialization_quality"],
        "IMU": ["enable_imu", "weight_gyro_initialization",
                "weight_gyro_optimization", "weight_gyro_tracking",
                "weight_acc_optimization", "weight_acc_tracking"],
        "Capacity": ["n_devices", "max_keyframes", "max_points",
                     "feature_slots", "local_map_slots", "lba_cam_slots",
                     "lba_point_slots", "lba_obs_slots"],
    }
    _DATASET_KEYS = ["dataset_dir", "playback_fps", "playback_paced",
                     "start_frame",
                     "max_frames", "ground_truth"]

    @classmethod
    def from_ini(cls, path: str | Path) -> "Settings":
        s = cls()
        cp = configparser.ConfigParser()
        path = Path(path)
        changed = True
        if path.exists():
            cp.read(path)
            changed = False
        for section, keys in cls._INI_LAYOUT.items():
            if not cp.has_section(section):
                cp.add_section(section)
                changed = True
            for key in keys:
                if cp.has_option(section, key):
                    cur = getattr(s, key)
                    raw = cp.get(section, key)
                    setattr(s, key, _parse(raw, cur))
                else:
                    cp.set(section, key, _fmt(getattr(s, key)))
                    changed = True
        if not cp.has_section("Dataset"):
            cp.add_section("Dataset")
            changed = True
        for key in cls._DATASET_KEYS:
            if cp.has_option("Dataset", key):
                cur = getattr(s.dataset, key)
                setattr(s.dataset, key, _parse(cp.get("Dataset", key), cur))
            else:
                cp.set("Dataset", key, _fmt(getattr(s.dataset, key)))
                changed = True
        if changed:
            # write-back of missing defaults, like the reference
            with open(path, "w") as f:
                cp.write(f)
        return s

    def to_ini(self, path: str | Path):
        cp = configparser.ConfigParser()
        for section, keys in self._INI_LAYOUT.items():
            cp.add_section(section)
            for key in keys:
                cp.set(section, key, _fmt(getattr(self, key)))
        cp.add_section("Dataset")
        for key in self._DATASET_KEYS:
            cp.set("Dataset", key, _fmt(getattr(self.dataset, key)))
        with open(path, "w") as f:
            cp.write(f)


def _fmt(v) -> str:
    if isinstance(v, enum.IntEnum):
        return str(int(v))
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _parse(raw: str, current):
    if isinstance(current, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, InputType):
        return InputType(int(raw))
    if isinstance(current, SensorType):
        return SensorType(int(raw))
    if isinstance(current, int):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    return raw.strip()

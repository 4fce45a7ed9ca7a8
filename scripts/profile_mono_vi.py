"""Profile the mono-VI bench lane: where do its 48 s go?

Runs bench._build_mono_vi + WindowedRunner with wall-clock section probes
monkey-patched around the expensive host calls:

  * window dispatch/fetch (the scan itself)
  * per-frame fallback (system.process_frame — mono init, pre-OK frames)
  * back-end cycles (local_mapping dispatch/commit)
  * VI solver stages (imu_solver process_new_keyframe / update / stages)

Run:  timeout 900 python scripts/profile_mono_vi.py
"""

import sys
import time
from collections import defaultdict

sys.path.insert(0, "/root/repo")

import numpy as np

import bench
from snakeslam_tpu.tracking.windowed import WindowedRunner

SECTIONS = defaultdict(float)
COUNTS = defaultdict(int)


def wrap(obj, name, label):
    orig = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        SECTIONS[label] += time.perf_counter() - t0
        COUNTS[label] += 1
        return out

    setattr(obj, name, timed)


def main():
    window = 16
    t_build0 = time.perf_counter()
    sys_w, frames_w = bench._build_mono_vi(11, 96)
    t_build = time.perf_counter() - t_build0
    print(f"build warm system: {t_build:.1f}s", flush=True)
    t0 = time.perf_counter()
    WindowedRunner(sys_w, window=window, two_stage=True).run(frames_w)
    print(f"warmup run (96 frames): {time.perf_counter() - t0:.1f}s",
          flush=True)

    system, frames = bench._build_mono_vi(7, 240)
    runner = WindowedRunner(system, window=window, two_stage=True)

    wrap(runner, "_dispatch", "window_dispatch")
    wrap(system, "process_frame", "per_frame_fallback")
    lm = None

    # tracker.local_mapper appears after init; patch lazily via runner hooks
    orig_commit = runner._commit_backend

    def commit_timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig_commit(*a, **kw)
        SECTIONS["backend_commit"] += time.perf_counter() - t0
        COUNTS["backend_commit"] += 1
        return out

    runner._commit_backend = commit_timed

    orig_cycles = runner._dispatch_backend_cycles

    def cycles_timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig_cycles(*a, **kw)
        SECTIONS["backend_dispatch"] += time.perf_counter() - t0
        COUNTS["backend_dispatch"] += 1
        return out

    runner._dispatch_backend_cycles = cycles_timed

    if system.imu_solver is not None:
        wrap(system.imu_solver, "process_new_keyframe", "vi_new_kf")
        wrap(system.imu_solver, "update_map", "vi_update_map")

    t0 = time.perf_counter()
    runner.run(frames)
    wall = time.perf_counter() - t0
    print(f"\ntimed run: {wall:.2f}s -> "
          f"{len(system.tracker.trajectory) / wall:.2f} FPS", flush=True)
    print(f"keyframes={system.map.n_keyframes} "
          f"tracked={len(system.tracker.trajectory)}")
    other = wall - sum(SECTIONS.values())
    for k in sorted(SECTIONS, key=SECTIONS.get, reverse=True):
        print(f"  {k:22s} {SECTIONS[k]:7.2f}s  x{COUNTS[k]}")
    print(f"  {'(unattributed)':22s} {other:7.2f}s")


if __name__ == "__main__":
    main()

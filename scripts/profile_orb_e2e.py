"""Per-stage device time of extract_orb_batch on an 8-frame batch.

Two readings of the same 752x480 rendered batch (1024 features, 4 levels):

  1. host clock around block_until_ready: the whole extraction, and the
     level-0 stages (fast, nms, select, orient_brief) jitted alone;
  2. a jax.profiler trace of three extractions, reduced to device time per
     stage: every device event is attributed to the first stage scope
     (ops/orb.extract_orb_batch's jax.named_scope names) found in its
     metadata, and the top kernels are listed with their share.

XLA's command buffers (CUDA graphs) hide which operation a kernel belongs
to, so this script turns them off; its times are therefore those of
individually launched kernels.

Prints JSON lines.  Run from the repository root:
    python scripts/profile_orb_e2e.py [trace_dir]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time
from collections import defaultdict

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_gpu_enable_command_buffer=").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from snakeslam_tpu.ops import orb as O  # noqa: E402
from snakeslam_tpu.utils.render_world import render_frame  # noqa: E402
from snakeslam_tpu.utils.synthetic import (  # noqa: E402
    SyntheticWorld,
    orbit_trajectory,
)

STAGES = ("resize", "fast", "nms", "select", "orient_brief", "compact")
_STAGE_RE = re.compile(r"(?:^|/)(%s)(?:/|$)" % "|".join(STAGES))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def ms_per_call(fn, *args, reps: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def rendered_batch(batch: int = 8) -> jax.Array:
    world = SyntheticWorld(n_points=3000, seed=0)
    imgs = [render_frame(world, T)
            for _, T in orbit_trajectory(batch, radius=7.0, arc=0.5)]
    return jnp.asarray(np.stack(imgs).astype(np.float32))


def device_time_by_stage(trace_dir: str) -> dict:
    """Sum device event durations of a trace by ORB stage scope."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    by_stage = defaultdict(float)
    by_kernel = defaultdict(float)
    lines_seen = {}
    sample = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen[f"{plane.name}:{line.name}"] = len(events)
            # kernel time lives on the stream lines; the "XLA Ops" and
            # module lines repeat it at coarser grain
            if not line.name.startswith("Stream"):
                continue
            if not sample:
                sample = [(ev.name, [(k, str(v)[:200]) for k, v in ev.stats])
                          for ev in events[:3]]
            for ev in events:
                texts = [ev.name] + [str(v) for _, v in ev.stats]
                stage = "other"
                for t in texts:
                    m = _STAGE_RE.search(t)
                    if m:
                        stage = m.group(1)
                        break
                by_stage[stage] += ev.duration_ns
                by_kernel[ev.name] += ev.duration_ns
    total = sum(by_stage.values()) or 1.0
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return dict(
        planes=[p.name for p in pd.planes],
        lines=lines_seen,
        sample_events=sample,
        stage_share={k: v / total for k, v in sorted(by_stage.items())},
        stage_ms_per_call={k: v / 3e6 for k, v in sorted(by_stage.items())},
        top_kernels=[(k, v / 3e6, v / total) for k, v in top],
    )


def main():
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "eval_out", "orb_trace")
    d = jax.devices()[0]
    emit(what="device", platform=d.platform, kind=d.device_kind)
    b = rendered_batch()

    full = jax.jit(lambda x: O.extract_orb_batch(x, n_features=1024))
    emit(what="extract_orb_batch", frames=int(b.shape[0]),
         ms_per_batch=ms_per_call(full, b))

    fast = jax.jit(lambda x: jax.vmap(lambda im: O.fast_score(im, 20.0))(x)[0])
    score = fast(b)
    nms = jax.jit(jax.vmap(O.nms3))
    nscore = nms(score)
    sel = jax.jit(jax.vmap(lambda s: O.select_keypoints(s, 400)))
    uv = sel(nscore)[0]
    ob = jax.jit(jax.vmap(O.orient_and_brief))
    emit(what="level0_stages_ms", fast=ms_per_call(fast, b),
         nms=ms_per_call(nms, score), select=ms_per_call(sel, nscore),
         orient_brief=ms_per_call(ob, b, uv))
    # the FAST stage's memory floor at level 0: read the image, write the
    # score (f32) and corner mask (bool)
    px = int(np.prod(b.shape))
    emit(what="fast_level0_bytes", bytes=px * (4 + 4 + 1))

    jax.block_until_ready(full(b))
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            out = full(b)
        jax.block_until_ready(out)
    emit(what="trace", **device_time_by_stage(trace_dir))


if __name__ == "__main__":
    main()

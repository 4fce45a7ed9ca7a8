"""snakeslam_tpu — a visual-inertial SLAM framework in JAX.

Brand-new JAX/XLA implementation with the capability set of
darglein/Snake-SLAM (see SURVEY.md for the structural analysis of the
reference).  The compute path (feature extraction, matching, pose
optimization, bundle adjustment, IMU solvers) is jit-compiled fixed-shape XLA,
with one Pallas kernel (Triton route) for the tracking scan's pose refine;
the orchestration layer (pipeline stages, map bookkeeping, keyframe-graph
logic) is host-side Python over preallocated numpy arrays, mirroring the
reference's snapshot → lock-free compute → guarded commit idiom (reference:
Snake/Map/LocalMap.h:34-55).

Layout:
  core/      SE3/Sim3 Lie algebra, camera & distortion models, trajectory eval
  ops/       device kernels: ORB, Hamming matching, GN solvers, BA, IMU, BoW
  models/    flagship jittable step functions (tracking megastep, BA step)
  map/       map data model (fixed-capacity keyframe/point pools)
  frontend/  dataset loaders, feature detection, preprocessing
  tracking/  predictor, coarse/fine tracking, keyframe decision, initializers
  mapping/   local mapping, triangulation, neighbor fusion
  optim/     local/global BA drivers, simplification, deferred mapping
  loop/      loop closing, keyframe database, pose-graph optimization
  imu/       IMU state solver state machine, decoupled full solver
  system/    settings, system driver, performance stats, trajectory IO
  parallel/  device mesh / sharding utilities for multi-device execution
  utils/     config, logging, small helpers
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# float32 matmuls default to reduced-precision passes on accelerators (TF32
# on a GPU); the GN/BA normal equations and SE3 chains need true f32.  The
# Hamming matcher opts into bf16 explicitly (exact for 0/1 bit planes), so
# this costs nothing on the hot matching path.
_jax.config.update("jax_default_matmul_precision", "highest")

_REPO_CACHE_DIR = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache"))


def compile_cache_dir(environ) -> str | None:
    """The persistent compile-cache directory to set in code, or None.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself,
    and the process sets no other) and on CPU-only runs (CPU executables
    are specific to the host's instruction set).  Otherwise the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so a fixed
    path is what lets later processes hit it.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if "cpu" in environ.get("JAX_PLATFORMS", "").lower():
        return None
    return _REPO_CACHE_DIR


_cache_dir = compile_cache_dir(_os.environ)
if _cache_dir is not None:
    _os.makedirs(_cache_dir, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

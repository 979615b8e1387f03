"""orb_slam2_comment_tpu — a visual SLAM framework in JAX.

A from-scratch redesign of the capabilities of ORB-SLAM2 (reference:
vigorbird/ORB_SLAM2_comment, C++/pthreads/OpenCV/g2o) as a JAX/XLA/Pallas
framework:

- Feature extraction (oriented multi-scale FAST + rotated binary descriptors)
  as dense, fixed-shape batched kernels (`ops.orb`).
- All data association (the reference's ORBmatcher Hamming searches) as
  masked Hamming-distance matrix ops (bf16 matmuls, `ops.matching`).
- The reference's g2o optimizer stack (pose-only BA, local BA with Schur
  complement on landmarks, Sim3, essential-graph pose optimization) as a
  batched Levenberg–Marquardt solver with autodiff Jacobians (`ops.optim`).
- The Tracking / LocalMapping / LoopClosing pthread pipeline as a functional
  keyframe pipeline over a struct-of-arrays map state (`models.*`).
- Distributed bundle adjustment across a `jax.sharding.Mesh` with
  psum-reduced Schur systems (`parallel.*`).

Reference parity notes cite the C++ source as `<file>:<line>` relative to
the reference repo root.
"""

import os as _os

import jax as _jax

# Geometry/solver math is float32 and relies on exact f32 matmuls (3x3/6x6
# Lie-group and normal-equation blocks). A lower default precision (bf16
# passes, or TF32 on a GPU) destroys SO3 log/exp roundtrips and LM
# convergence. Force full-precision f32 matmuls globally; the FLOP-heavy
# kernels (Hamming matching, Schur outer products) opt into bf16 explicitly
# by casting their inputs, so they keep the fast path where it matters.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the per-frame fused programs take minutes
# to compile per (sensor, resolution, budget) config. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at one fixed
# path inside the checkout, so every run finds what earlier runs stored.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    ))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from orb_slam2_comment_tpu import constants  # noqa: F401,E402

__version__ = "0.1.0"

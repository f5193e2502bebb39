"""hectorgrapher_tpu: continuous-time lidar SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
tu-darmstadt-ros-pkg/hectorgrapher (continuous-time 2D/3D SLAM with
multi-resolution TSDF registration). Not a port: the numeric core is
dense-array, batched, and jit-compiled; host code orchestrates streaming.

Layer map (mirrors reference SURVEY.md section 1):
  common     - time, math, config, device-dependent choices (ref: cartographer/common)
  transform  - SO(3)/SE(3) array ops, interpolation (ref: cartographer/transform)
  sensor     - typed sensor data, voxel filters, collation (ref: cartographer/sensor)
  mapping    - grids, submaps, local SLAM, scan matching, pose graph
               (ref: cartographer/mapping)
  solvers    - damped Gauss-Newton / LM on manifolds, CG (ref: Ceres usage)
  parallel   - jax.sharding mesh utilities for multi-device pose graphs
  io         - checkpoint serialization, points pipeline (ref: cartographer/io)
  metrics    - counters/gauges/histograms (ref: cartographer/metrics)
  evaluation - synthetic scan generation, relation metrics (ref: evaluation/)
"""

import jax as _jax

from hectorgrapher_tpu.common.device import MATMUL_PRECISION as _MATMUL_PRECISION

# The one matmul precision policy (see common/device.py): every float32
# dot the solvers and matchers trace runs at full float32.
_jax.config.update("jax_default_matmul_precision", _MATMUL_PRECISION)

__version__ = "0.1.0"

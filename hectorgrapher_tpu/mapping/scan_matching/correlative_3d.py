"""Real-time correlative scan matching in 3D as one dense kernel.

Replacement for RealTimeCorrelativeScanMatcher3D
(ref: mapping/internal/3d/scan_matching/real_time_correlative_scan_matcher_3d.cc
and internal/scan_matching/real_time_correlative_scan_matcher.cc — full
exhaustive search over discretized (x, y, z, yaw) around the initial
estimate, scored against the high-resolution grid with a translation/
rotation delta penalty).

Uses the same shifted-grid row-gather layout as the 2D kernel: one
contiguous (2k+1)^3-row per (angle, point) instead of scattered element
gathers.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.grids import ProbabilityGrid, cell_index
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import grid_match_scores
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid3, quat_from_yaw, quat_multiply, quat_rotate


class SearchWindow3D(NamedTuple):
    num_angles: int
    angle_step: float
    num_linear: int  # cells per axis


def make_search_window_3d(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
) -> SearchWindow3D:
    angle_step = math.acos(
        max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2)))
    )
    num_angles = int(math.ceil(angular_search_window / angle_step))
    num_linear = int(math.ceil(linear_search_window / resolution))
    return SearchWindow3D(num_angles=num_angles, angle_step=angle_step, num_linear=num_linear)


@functools.partial(jax.jit, static_argnames=("window",))
def match_correlative_3d(
    grid,
    cloud: PointCloud,
    initial_pose: Rigid3,
    window: SearchWindow3D,
    translation_delta_cost_weight,
    rotation_delta_cost_weight,
) -> Tuple[jax.Array, Rigid3]:
    """Exhaustive dense search; yaw-only rotation candidates (the reference
    searches rotations about the gravity-aligned z axis in practice)."""
    scores_field = grid_match_scores(grid)
    nx, ny, nz = scores_field.shape
    res = grid.meta.resolution

    n_th = 2 * window.num_angles + 1
    thetas = (jnp.arange(n_th, dtype=jnp.float32) - window.num_angles) * window.angle_step
    k = window.num_linear
    d = 2 * k + 1

    pts = cloud.positions
    valid = cloud.mask
    n_valid = jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)

    base = quat_rotate(initial_pose.rotation[None, :], pts) + initial_pose.translation[None, :]
    rel = base - initial_pose.translation[None, :]
    yaw_q = quat_from_yaw(thetas)
    rot = quat_rotate(yaw_q[:, None, :], rel[None, :, :]) + initial_pose.translation[None, None, :]
    base_idx = cell_index(grid.meta, rot)  # (T, N, 3)

    # Shifted-field matrix over the EXTENDED cell grid (margin k per
    # side): a point whose base cell is just outside the map still has
    # candidate offsets landing INSIDE it, which must read real grid
    # values (ref: the per-candidate probe in
    # real_time_correlative_scan_matcher_3d.cc; same construction as the
    # 2D matcher's _wide_patch_table). The final all-unknown row serves
    # bases beyond the extended grid.
    ex, eyd, ez = nx + 2 * k, ny + 2 * k, nz + 2 * k
    pad = jnp.pad(scores_field, 2 * k, constant_values=0.1)
    shifts = [
        jax.lax.dynamic_slice(pad, (dx + k, dy + k, dz + k), (ex, eyd, ez)).reshape(-1)
        for dx in range(-k, k + 1)
        for dy in range(-k, k + 1)
        for dz in range(-k, k + 1)
    ]
    gshift = jnp.stack(shifts, axis=-1)
    gshift = jnp.concatenate([gshift, jnp.full((1, d**3), 0.1, gshift.dtype)], axis=0)

    cx = base_idx[..., 0] + k
    cy = base_idx[..., 1] + k
    cz = base_idx[..., 2] + k
    ok = (cx >= 0) & (cx < ex) & (cy >= 0) & (cy < eyd) & (cz >= 0) & (cz < ez)
    flat = jnp.where(ok, (cx * eyd + cy) * ez + cz, ex * eyd * ez)
    rows = jnp.take(gshift, flat, axis=0)  # (T, N, d^3)
    rows = jnp.where(valid[None, :, None], rows, 0.0)
    scores = (jnp.sum(rows, axis=1) / n_valid).reshape(n_th, d, d, d)

    offs = (jnp.arange(d, dtype=jnp.float32) - k) * res
    dist = jnp.sqrt(
        offs[:, None, None] ** 2 + offs[None, :, None] ** 2 + offs[None, None, :] ** 2
    )
    penalty = jnp.exp(
        -(
            (dist[None] * translation_delta_cost_weight
             + jnp.abs(thetas)[:, None, None, None] * rotation_delta_cost_weight)
            ** 2
        )
    )
    scores = scores * penalty

    best = jnp.argmax(scores)
    ti, xi, yi, zi = jnp.unravel_index(best, scores.shape)
    offset = jnp.stack([offs[xi], offs[yi], offs[zi]])
    pose = Rigid3(
        translation=initial_pose.translation + offset,
        rotation=quat_multiply(quat_from_yaw(thetas[ti]), initial_pose.rotation),
    )
    return scores.reshape(-1)[best], pose

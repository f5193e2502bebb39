"""2D range-data insertion as batched scatter updates.

Replacement for:
  * ProbabilityGridRangeDataInserter2D (ref: mapping/2d/
    probability_grid_range_data_inserter_2d.cc — Bresenham ray casting with
    hit/miss odds tables and per-scan update markers)
  * TSDFRangeDataInserter2D (ref: mapping/2d/tsdf_range_data_inserter_2d.cc
    — projective TSDF update along ray or scan normal with weight kernels)

Design: instead of sequential per-cell table updates guarded by a marker
bit, a scan is rasterized into per-cell hit/miss masks via scatter, and the
log-odds update is applied ONCE per cell as a masked elementwise op. This
reproduces the reference's one-update-per-cell-per-scan semantics (the
marker bit) exactly, with hit priority over miss (ref:
range_data_inserter: hits inserted before misses so hits win).

Misses are rasterized by equidistant sampling along each ray at sub-cell
spacing — the dense-array analog of RayToPixelMask's supersampled ray cast
(ref: internal/2d/ray_to_pixel_mask.cc).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping import probability_values as pv
from hectorgrapher_tpu.mapping.grids import (
    ProbabilityGrid,
    TSDFGrid,
    cell_center,
    cell_index,
    flat_index,
)
from hectorgrapher_tpu.sensor.types import PointCloud, RangeData


def _scatter_mask(shape, flat_idx, valid):
    """Boolean grid with True at flat_idx positions where valid."""
    size = 1
    for s in shape:
        size *= s
    grid = jnp.zeros((size + 1,), dtype=bool)  # slot `size` absorbs drops
    grid = grid.at[jnp.where(valid, flat_idx, size)].set(True)
    return grid[:size].reshape(shape)


def _ray_sample_mask(meta, shape, origins, ends, valid, num_samples: int):
    """Rasterize segments origin->end (exclusive of the end cell) into a mask.

    Samples `num_samples` equidistant points strictly inside [0, 1) of each
    segment; sub-cell spacing is the caller's responsibility via
    num_samples >= segment_cells / 0.7.
    """
    # t in (0, 1): avoid t=0 duplicates and t=1 (the hit cell itself).
    t = (jnp.arange(num_samples, dtype=jnp.float32) + 0.5) / num_samples
    # (P, S, D)
    pts = origins[:, None, :] + t[None, :, None] * (ends - origins)[:, None, :]
    idx = cell_index(meta, pts)
    flat = flat_index(idx, shape)
    return _scatter_mask(shape, flat.reshape(-1), jnp.broadcast_to(valid[:, None], flat.shape).reshape(-1))


@functools.partial(jax.jit, static_argnames=("num_samples", "insert_free_space"))
def insert_probability_2d(
    grid: ProbabilityGrid,
    range_data: RangeData,
    hit_log_odds,
    miss_log_odds,
    num_samples: int = 128,
    insert_free_space: bool = True,
) -> ProbabilityGrid:
    """Insert one scan into an occupancy grid.

    (ref: probability_grid_range_data_inserter_2d.cc CastRays+Insert)
    range_data must already be in grid-local frame; z is ignored.
    """
    shape = grid.shape
    origin2 = range_data.origin[:2]

    hits = range_data.returns.positions[:, :2]
    hit_idx = cell_index(grid.meta, hits)
    hit_flat = flat_index(hit_idx, shape)
    hit_mask = _scatter_mask(shape, hit_flat, range_data.returns.mask)

    if insert_free_space:
        origins = jnp.broadcast_to(origin2, hits.shape)
        miss_mask = _ray_sample_mask(grid.meta, shape, origins, hits, range_data.returns.mask, num_samples)
        # Rays to "misses" (no return within range): whole segment is free.
        miss_pts = range_data.misses.positions[:, :2]
        if miss_pts.shape[0] > 0:
            miss_origins = jnp.broadcast_to(origin2, miss_pts.shape)
            end_mask = _scatter_mask(
                shape, flat_index(cell_index(grid.meta, miss_pts), shape), range_data.misses.mask
            )
            miss_mask = (
                miss_mask
                | _ray_sample_mask(grid.meta, shape, miss_origins, miss_pts, range_data.misses.mask, num_samples)
                | end_mask
            )
        miss_mask = miss_mask & ~hit_mask  # hits take priority
    else:
        miss_mask = jnp.zeros(shape, dtype=bool)

    delta = jnp.where(hit_mask, hit_log_odds, 0.0) + jnp.where(miss_mask, miss_log_odds, 0.0)
    new_lo = pv.clamp_log_odds(grid.log_odds + delta)
    touched = hit_mask | miss_mask
    return grid._replace(
        log_odds=jnp.where(touched, new_lo, grid.log_odds),
        known=grid.known | touched,
    )


def make_probability_inserter_2d(options, max_range: float, resolution: float):
    """Bind ProbabilityGridRangeDataInserterOptions2D into a jit-ready fn."""
    hit_lo = math.log(options.hit_probability / (1 - options.hit_probability))
    miss_lo = math.log(options.miss_probability / (1 - options.miss_probability))
    num_samples = max(8, int(max_range / (resolution * 0.7)))

    def insert(grid: ProbabilityGrid, range_data: RangeData) -> ProbabilityGrid:
        return insert_probability_2d(
            grid,
            range_data,
            hit_lo,
            miss_lo,
            num_samples=num_samples,
            insert_free_space=bool(options.insert_free_space),
        )

    return insert


# ---------------------------------------------------------------------------
# 2D normal estimation
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_normal_samples",))
def estimate_normals_2d(
    returns: PointCloud,
    origin,
    sample_radius,
    num_normal_samples: int = 4,
):
    """Normals for a 2D scan, assuming returns sorted by scan angle.

    (ref: mapping/internal/2d/normal_estimation_2d.cc EstimateNormals —
    tangent from neighbors within sample_radius, normal = perpendicular
    oriented toward the sensor origin.)

    Returns (N, 2) unit normals.
    """
    pts = returns.positions[:, :2]
    n = pts.shape[0]
    half = max(1, num_normal_samples // 2)
    tangent = jnp.zeros_like(pts)
    for k in range(1, half + 1):
        nxt = jnp.roll(pts, -k, axis=0)
        prv = jnp.roll(pts, k, axis=0)
        m_next = jnp.roll(returns.mask, -k) & (jnp.linalg.norm(nxt - pts, axis=-1) < sample_radius)
        m_prev = jnp.roll(returns.mask, k) & (jnp.linalg.norm(pts - prv, axis=-1) < sample_radius)
        tangent = tangent + jnp.where(m_next[:, None], nxt - pts, 0.0)
        tangent = tangent + jnp.where(m_prev[:, None], pts - prv, 0.0)
    normal = jnp.stack([-tangent[:, 1], tangent[:, 0]], axis=-1)
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    # Fallback for isolated points: point toward the sensor.
    to_origin = origin[None, :2] - pts
    to_origin = to_origin / jnp.maximum(jnp.linalg.norm(to_origin, axis=-1, keepdims=True), 1e-9)
    normal = jnp.where(norm > 1e-9, normal / jnp.maximum(norm, 1e-9), to_origin)
    # Orient toward origin.
    flip = jnp.sum(normal * to_origin, axis=-1, keepdims=True) < 0
    return jnp.where(flip, -normal, normal)


# ---------------------------------------------------------------------------
# 2D TSDF insertion
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_band_samples", "project_to_normal", "range_exponent"))
def insert_tsdf_2d(
    grid: TSDFGrid,
    range_data: RangeData,
    normals,
    num_band_samples: int,
    project_to_normal: bool,
    range_exponent: int,
    angle_bandwidth,
    distance_bandwidth,
) -> TSDFGrid:
    """Insert one scan into a 2D TSDF.

    (ref: tsdf_range_data_inserter_2d.cc InsertHit:165 + UpdateCell:229 —
    cells along the ray within the truncation band around the hit get a
    weighted-average update; distance optionally projected onto the scan
    normal; weights modulated by range, normal/ray angle, and
    cell-to-hit-distance kernels.)
    """
    shape = grid.shape
    td = grid.truncation_distance
    origin2 = range_data.origin[:2]
    hits = range_data.returns.positions[:, :2]
    valid = range_data.returns.mask

    ray = hits - origin2
    ranges = jnp.linalg.norm(ray, axis=-1)
    ray_dir = ray / jnp.maximum(ranges[:, None], 1e-9)
    valid = valid & (ranges > td)

    # Sample the truncation band [-td, td] along the ray through the hit.
    s = jnp.linspace(-1.0, 1.0, num_band_samples)
    band_pts = hits[:, None, :] + (s[None, :, None] * td) * ray_dir[:, None, :]  # (P,S,2)
    idx = cell_index(grid.meta, band_pts)
    centers = cell_center(grid.meta, idx)

    if project_to_normal:
        # Signed distance of cell center to the surface along the normal
        # (ref: project_sdf_distance_to_scan_normal, :143-163).
        d = jnp.sum((hits[:, None, :] - centers) * normals[:, None, :], axis=-1)
    else:
        d = ranges[:, None] - jnp.linalg.norm(centers - origin2[None, None, :], axis=-1)
    d = jnp.clip(d, -td, td)

    # Update weight (ref: ComputeRangeWeightFactor + angle/distance kernels).
    w = jnp.ones_like(d)
    if range_exponent != 0:
        w = w / jnp.maximum(ranges[:, None], 1e-6) ** range_exponent
    # Gaussian kernel on angle between normal and ray.
    cos_angle = jnp.clip(jnp.abs(jnp.sum(normals * ray_dir, axis=-1)), 0.0, 1.0)
    angle = jnp.arccos(cos_angle)
    w = w * jnp.exp(-(angle[:, None] ** 2) / jnp.maximum(2.0 * angle_bandwidth**2, 1e-9))
    # Gaussian kernel on distance of cell to hit.
    w = w * jnp.exp(-((s[None, :] * td) ** 2) / jnp.maximum(2.0 * distance_bandwidth**2, 1e-9))

    flat = flat_index(idx, shape)
    vmask = jnp.broadcast_to(valid[:, None], flat.shape)
    size = grid.tsd.size
    slot = jnp.where(vmask, flat, size).reshape(-1)
    w_flat = jnp.where(vmask, w, 0.0).reshape(-1)
    wd_flat = jnp.where(vmask, w * d, 0.0).reshape(-1)

    w_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(w_flat)[:size].reshape(shape)
    wd_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(wd_flat)[:size].reshape(shape)

    new_w_raw = grid.weight + w_sum
    new_tsd = jnp.where(
        w_sum > 0,
        (grid.tsd * grid.weight + wd_sum) / jnp.maximum(new_w_raw, 1e-9),
        grid.tsd,
    )
    new_w = jnp.minimum(new_w_raw, grid.max_weight)
    return grid._replace(tsd=new_tsd, weight=new_w)


def make_tsdf_inserter_2d(options, resolution: float):
    """Bind TSDFRangeDataInserterOptions2D into an insert fn."""
    num_band_samples = max(4, int(2.0 * options.truncation_distance / (resolution * 0.5)))

    def insert(grid: TSDFGrid, range_data: RangeData) -> TSDFGrid:
        normals = estimate_normals_2d(
            range_data.returns,
            range_data.origin,
            options.normal_estimation_options.sample_radius,
            num_normal_samples=int(options.normal_estimation_options.num_normal_samples),
        )
        return insert_tsdf_2d(
            grid,
            range_data,
            normals,
            num_band_samples=num_band_samples,
            project_to_normal=bool(options.project_sdf_distance_to_scan_normal),
            range_exponent=int(options.update_weight_range_exponent),
            angle_bandwidth=options.update_weight_angle_scan_normal_to_ray_kernel_bandwidth,
            distance_bandwidth=options.update_weight_distance_cell_to_hit_kernel_bandwidth,
        )

    return insert

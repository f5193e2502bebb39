"""Voxel filters as static-shape JAX ops.

(ref: cartographer/sensor/internal/voxel_filter.h:34-49 — keep one point per
voxel via hashed integer cell; adaptive_voxel_filter.h:49-92 — search voxel
edge length until >= min_num_points survive.)

Design: instead of a hash set, points are keyed by their integer cell
coordinates, sorted by key, and the first point of each key run survives.
Output keeps the input capacity with an updated validity mask, so shapes
stay static under jit. Determinism: the surviving point of a voxel is the
one with the lowest (key, index) order, independent of input order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.sensor.types import PointCloud, TimedPointCloud


# Plain int (promoted inside traced code): no device work at import time.
_INVALID_CELL = 1 << 24


def _cell_coords(positions, mask, resolution):
    """Integer cell coordinates (N, 3) in int32; invalid points get a
    sentinel so they sort to the end. int32 keeps the filter device-friendly
    (no x64 requirement); range +-2^23 cells is far beyond the reference's
    +-8192 (hybrid_grid.h:40-45)."""
    cells = jnp.floor(positions / resolution).astype(jnp.int32)
    return jnp.where(mask[..., None], cells, _INVALID_CELL)


def _dedup_order(cells):
    """Lexicographic sort order plus first-occurrence mask per voxel."""
    order = jnp.lexsort((cells[:, 2], cells[:, 1], cells[:, 0]))
    s = cells[order]
    first = jnp.concatenate(
        [jnp.array([True]), jnp.any(s[1:] != s[:-1], axis=-1)]
    )
    return order, first


@functools.partial(jax.jit, static_argnames=())
def voxel_filter(cloud: PointCloud, resolution) -> PointCloud:
    """Keep one point per voxel of edge `resolution` (ref: voxel_filter.h)."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    new_mask = first & cloud.mask[order]
    return PointCloud(positions=cloud.positions[order], mask=new_mask)


@jax.jit
def voxel_filter_count(cloud: PointCloud, resolution):
    """Number of surviving points without materializing the output."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    valid = cloud.mask[order]
    return jnp.sum(first & valid)


@functools.partial(jax.jit, static_argnames=("min_num_points", "num_bisections"))
def adaptive_voxel_filter_length(
    cloud: PointCloud,
    max_length,
    min_num_points: int,
    max_range,
    num_bisections: int = 10,
):
    """Find the voxel edge length used by the adaptive filter.

    Mirrors sensor/internal/adaptive_voxel_filter.h:49-92: restrict to
    points within max_range; if filtering at max_length keeps >=
    min_num_points, use max_length; otherwise halve until enough survive,
    then bisect between [length, 2*length] for the largest length that
    still keeps min_num_points.
    """
    in_range = cloud.mask & (jnp.linalg.norm(cloud.positions, axis=-1) <= max_range)
    ranged = PointCloud(cloud.positions, in_range)
    total = jnp.sum(in_range)

    def count(length):
        return voxel_filter_count(ranged, length)

    def halve_cond(state):
        length, c = state
        return (c < min_num_points) & (length > 1e-3)

    def halve_body(state):
        length, _ = state
        new_length = length / 2.0
        return new_length, count(new_length)

    c0 = count(max_length)
    length, c = jax.lax.while_loop(halve_cond, halve_body, (jnp.asarray(max_length, jnp.float32), c0))

    # Bisect in [length, 2*length): low always satisfies the count.
    def bisect_body(_, bounds):
        low, high = bounds
        mid = 0.5 * (low + high)
        ok = count(mid) >= min_num_points
        return jnp.where(ok, mid, low), jnp.where(ok, high, mid)

    low, high = jax.lax.fori_loop(0, num_bisections, bisect_body, (length, 2.0 * length))
    # If even max_length keeps enough points (or the cloud is tiny), use it.
    use_max = (c0 >= min_num_points) | (total <= min_num_points)
    return jnp.where(use_max, max_length, low)


def adaptive_voxel_filter(cloud: PointCloud, options) -> PointCloud:
    """(ref: adaptive_voxel_filter.h AdaptiveVoxelFilter::Filter)

    options: AdaptiveVoxelFilterOptions(max_length, min_num_points, max_range).
    """
    in_range = cloud.mask & (jnp.linalg.norm(cloud.positions, axis=-1) <= options.max_range)
    ranged = PointCloud(cloud.positions, in_range)
    length = adaptive_voxel_filter_length(
        cloud, options.max_length, int(options.min_num_points), options.max_range
    )
    filtered = voxel_filter(ranged, length)
    # Already-sparse clouds pass through UNFILTERED (ref:
    # adaptive_voxel_filter.h:49-52) — filtering them at max_length would
    # starve the matcher exactly when data is scarcest.
    sparse = jnp.sum(in_range) <= options.min_num_points
    return PointCloud(
        positions=jnp.where(sparse, ranged.positions, filtered.positions),
        mask=jnp.where(sparse, ranged.mask, filtered.mask),
    )


@jax.jit
def voxel_filter_timed(cloud: TimedPointCloud, resolution) -> TimedPointCloud:
    """Voxel filter preserving per-point times."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    new_mask = first & cloud.mask[order]
    return TimedPointCloud(
        positions=cloud.positions[order], times=cloud.times[order], mask=new_mask
    )


def adaptive_voxel_filter_timed(cloud: TimedPointCloud, options) -> TimedPointCloud:
    """Adaptive voxel filter preserving per-point times (needed by the
    per-point-unwarping CT path, ref: optimizing_local_trajectory_builder
    PointCloudSet high/low_resolution_filtered_points keep TimedPoints)."""
    in_range = cloud.mask & (jnp.linalg.norm(cloud.positions, axis=-1) <= options.max_range)
    base = PointCloud(cloud.positions, in_range)
    length = adaptive_voxel_filter_length(
        base, options.max_length, int(options.min_num_points), options.max_range
    )
    filtered = voxel_filter_timed(TimedPointCloud(cloud.positions, cloud.times, in_range), length)
    # Already-sparse clouds pass through UNFILTERED, mirroring the untimed
    # variant (ref: adaptive_voxel_filter.h:49-52): voxel-filtering at
    # max_length would drop co-voxel points exactly when data is scarcest.
    sparse = jnp.sum(in_range) <= options.min_num_points
    return TimedPointCloud(
        positions=jnp.where(sparse, cloud.positions, filtered.positions),
        times=jnp.where(sparse, cloud.times, filtered.times),
        mask=jnp.where(sparse, in_range, filtered.mask),
    )


def compact_timed_cloud(cloud: TimedPointCloud, capacity: int) -> TimedPointCloud:
    """compact_cloud for timed clouds."""
    idx = jnp.argsort(~cloud.mask, stable=True)
    positions = cloud.positions[idx]
    times = cloud.times[idx]
    mask = cloud.mask[idx]
    n = cloud.positions.shape[0]
    if capacity <= n:
        return TimedPointCloud(positions[:capacity], times[:capacity], mask[:capacity])
    pad = capacity - n
    return TimedPointCloud(
        jnp.concatenate([positions, jnp.zeros((pad, 3), positions.dtype)]),
        jnp.concatenate([times, jnp.zeros((pad,), times.dtype)]),
        jnp.concatenate([mask, jnp.zeros((pad,), bool)]),
    )


def compact_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Move valid points to the front (stable) and truncate/pad to capacity.

    Host-callable (jit-compatible); used to shrink adaptive-filter outputs
    to the fixed per-cloud budget.
    """
    idx = jnp.argsort(~cloud.mask, stable=True)
    positions = cloud.positions[idx]
    mask = cloud.mask[idx]
    n = cloud.positions.shape[0]
    if capacity <= n:
        return PointCloud(positions[:capacity], mask[:capacity])
    pad = capacity - n
    return PointCloud(
        jnp.concatenate([positions, jnp.zeros((pad, 3), positions.dtype)]),
        jnp.concatenate([mask, jnp.zeros((pad,), bool)]),
    )

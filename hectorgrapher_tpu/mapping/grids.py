"""Dense grid map representations.

Replacement for the reference's grid structures:
  * Grid2D / ProbabilityGrid / TSDF2D (ref: mapping/2d/grid_2d.h,
    probability_grid.h, tsdf_2d.h)
  * HybridGrid / HybridGridTSDF sparse voxel trees (ref: mapping/3d/
    hybrid_grid.h, hybrid_grid_tsdf.h)

Design (SURVEY.md section 7, "Arrays, not trees"): submap grids are
fixed-extent dense arrays. The reference already bounds submaps spatially
and retires them after 2*num_range_data scans, so a dense array per submap
is affordable and turns every grid op into a vectorized tensor op. The
uint16 quantization of the reference is a memory optimization we can add
later (int16 storage + f32 compute); numerics here are float32.

Conventions (deliberately simpler than the reference's inverted
MapLimits axes):
  * A grid covers the cube centered at the submap-local origin.
  * cell_index i = floor((p - min_corner) / resolution), per axis.
  * cell_center = min_corner + (i + 0.5) * resolution.
  * 2D arrays are indexed [ix, iy]; 3D arrays [ix, iy, iz].

Occupancy is stored as log-odds + known mask (see probability_values.py);
TSDF as (tsd, weight) pairs where weight == 0 marks unknown cells
(matching hybrid_grid_tsdf.h where default weight is 0).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping import probability_values as pv


class GridMeta(NamedTuple):
    """Static geometry of a dense grid. Kept as a separate aux pytree leaf
    set so jitted functions treat resolution/size as traced scalars."""

    resolution: jax.Array  # scalar f32
    min_corner: jax.Array  # (2,) or (3,) f32: position of cell (0,0[,0]) corner


def make_meta(resolution: float, size_cells: Tuple[int, ...], center=None) -> GridMeta:
    dims = len(size_cells)
    half = jnp.asarray([s * resolution / 2.0 for s in size_cells], dtype=jnp.float32)
    c = jnp.zeros((dims,), jnp.float32) if center is None else jnp.asarray(center, jnp.float32)
    return GridMeta(resolution=jnp.asarray(resolution, jnp.float32), min_corner=c - half)


def cell_index(meta: GridMeta, points):
    """Float position (..., D) -> integer cell index (..., D).

    Always computed in float32 so host (x64) and device (f32) callers
    agree on boundary cells.
    """
    p = jnp.asarray(points, jnp.float32)
    return jnp.floor((p - meta.min_corner) / meta.resolution).astype(jnp.int32)


def cell_center(meta: GridMeta, indices):
    return meta.min_corner + (indices.astype(jnp.float32) + 0.5) * meta.resolution


def in_bounds(indices, shape) -> jax.Array:
    ok = jnp.ones(indices.shape[:-1], dtype=bool)
    for d, s in enumerate(shape):
        ok &= (indices[..., d] >= 0) & (indices[..., d] < s)
    return ok


def flat_index(indices, shape):
    """Row-major linear index; out-of-bounds mapped to size (drop slot)."""
    ok = in_bounds(indices, shape)
    flat = jnp.zeros(indices.shape[:-1], dtype=jnp.int32)
    for d, s in enumerate(shape):
        flat = flat * s + jnp.clip(indices[..., d], 0, s - 1)
    size = 1
    for s in shape:
        size *= s
    return jnp.where(ok, flat, size)


# ---------------------------------------------------------------------------
# Occupancy grids (2D and 3D share the representation)
# ---------------------------------------------------------------------------


class ProbabilityGrid(NamedTuple):
    """Occupancy grid: log-odds + known mask.

    (ref: mapping/2d/probability_grid.h and mapping/3d/hybrid_grid.h —
    both become this, with ndim 2 or 3.)
    """

    log_odds: jax.Array  # (nx, ny[, nz]) f32
    known: jax.Array  # same shape, bool
    meta: GridMeta

    @property
    def shape(self):
        return self.log_odds.shape

    def probability(self):
        """Occupancy probability; unknown cells read MIN_PROBABILITY
        (ref: probability_values.h kUnknownProbabilityValue semantics in
        scan matching: unknown -> kMinProbability)."""
        p = pv.probability_from_log_odds(self.log_odds)
        return jnp.where(self.known, pv.clamp_probability(p), pv.MIN_PROBABILITY)


def make_probability_grid(resolution: float, size_cells: Tuple[int, ...], center=None) -> ProbabilityGrid:
    return ProbabilityGrid(
        log_odds=jnp.zeros(size_cells, jnp.float32),
        known=jnp.zeros(size_cells, bool),
        meta=make_meta(resolution, size_cells, center),
    )


# ---------------------------------------------------------------------------
# TSDF grids
# ---------------------------------------------------------------------------


class TSDFGrid(NamedTuple):
    """Truncated signed distance grid with per-cell weights.

    (ref: mapping/2d/tsdf_2d.h, mapping/3d/hybrid_grid_tsdf.h). weight == 0
    means unknown; tsd of unknown cells reads as +truncation_distance
    outside. truncation_distance is carried for interpolation/matching.
    """

    tsd: jax.Array  # (nx, ny[, nz]) f32
    weight: jax.Array  # same shape f32
    truncation_distance: jax.Array  # scalar f32
    max_weight: jax.Array  # scalar f32
    meta: GridMeta

    @property
    def shape(self):
        return self.tsd.shape


STORAGE_DTYPES = {
    "float32": jnp.float32,
    "float16": jnp.float16,
    "bfloat16": jnp.bfloat16,
    # uint16: reference-parity quantized storage (see quantize_tsdf_grid).
    # Active grids still compute in f32; "uint16" quantizes on submap
    # finish (the reference quantizes always — divergence: f32
    # compute avoids decode/encode per insert, uint16 halves the memory of
    # the long-lived finished submaps that dominate the footprint).
    "uint16": jnp.uint16,
}

# ---------------------------------------------------------------------------
# uint16 quantized storage (ref: mapping/probability_values.h:64-92 and
# mapping/2d/tsd_value_converter.h:33-73 — a bounded float range mapped
# linearly onto [1, 32767] with code 0 reserved for "unknown"; we keep 16
# bits since the reference's update-marker bit is obviated by the masked
# single-update-per-scan inserters).
# ---------------------------------------------------------------------------

_QUANT_LEVELS = 65534  # codes 1..65535 span the value range; 0 = unknown


def _encode_u16(values, lo, hi, known):
    """Linear [lo, hi] -> uint16 codes 1..65535; unknown -> 0."""
    t = jnp.clip((values - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
    code = (jnp.round(t * _QUANT_LEVELS) + 1.0).astype(jnp.uint16)
    return jnp.where(known, code, jnp.zeros_like(code))


def _decode_u16(codes, lo, hi, unknown_value):
    t = (codes.astype(jnp.float32) - 1.0) / _QUANT_LEVELS
    v = lo + t * (hi - lo)
    return jnp.where(codes > 0, v, unknown_value)


def quantize_tsdf_grid(grid: "TSDFGrid") -> "TSDFGrid":
    """f32 (tsd, weight) -> uint16 codes. tsd spans [-td, +td]; weight spans
    [0, max_weight]; weight code 0 keeps the weight==0-is-unknown invariant."""
    if grid.tsd.dtype == jnp.uint16:
        return grid
    td = grid.truncation_distance
    known = grid.weight > 0
    return grid._replace(
        tsd=_encode_u16(grid.tsd.astype(jnp.float32), -td, td, known),
        weight=_encode_u16(grid.weight.astype(jnp.float32), 0.0, grid.max_weight, known),
    )


def dequantize_tsdf_grid(grid: "TSDFGrid") -> "TSDFGrid":
    if grid.tsd.dtype != jnp.uint16:
        return grid
    td = grid.truncation_distance
    return grid._replace(
        tsd=_decode_u16(grid.tsd, -td, td, td),
        weight=_decode_u16(grid.weight, 0.0, grid.max_weight, 0.0),
    )


def quantize_probability_grid(grid: "ProbabilityGrid") -> "ProbabilityGrid":
    """f32 log-odds + known mask -> one uint16 code plane (probability in
    [MIN, MAX] mapped to 1..65535, 0 = unknown), carried in log_odds with
    known packed as code > 0."""
    if grid.log_odds.dtype == jnp.uint16:
        return grid
    p = pv.clamp_probability(pv.probability_from_log_odds(grid.log_odds))
    codes = _encode_u16(p, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY, grid.known)
    return grid._replace(log_odds=codes, known=grid.known)


def dequantize_probability_grid(grid: "ProbabilityGrid") -> "ProbabilityGrid":
    if grid.log_odds.dtype != jnp.uint16:
        return grid
    p = _decode_u16(grid.log_odds, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY, 0.5)
    return grid._replace(log_odds=pv.log_odds(jnp.clip(p, 1e-6, 1 - 1e-6)), known=grid.known)


def ensure_f32_grid(grid):
    """Dequantize uint16-coded grids; pass f32/f16/bf16 grids through
    (consumers upcast after gathering)."""
    if isinstance(grid, TSDFGrid):
        return dequantize_tsdf_grid(grid)
    if isinstance(grid, ProbabilityGrid) and grid.log_odds.dtype == jnp.uint16:
        return dequantize_probability_grid(grid)
    return grid


def grid_nbytes(grid) -> int:
    """Storage bytes of a grid's cell arrays (for the memory benchmark)."""
    if isinstance(grid, TSDFGrid):
        return grid.tsd.nbytes + grid.weight.nbytes
    return grid.log_odds.nbytes + grid.known.nbytes


def make_tsdf_grid(
    resolution: float,
    size_cells: Tuple[int, ...],
    truncation_distance: float,
    max_weight: float,
    center=None,
    dtype=jnp.float32,
) -> TSDFGrid:
    """dtype: storage precision of the dense arrays. The reference packs
    cells into uint16 via TSDValueConverter (hybrid_grid_tsdf.h); here the
    memory/bandwidth option is float16/bfloat16 storage with float32
    compute (kernels upcast after gathering)."""
    return TSDFGrid(
        tsd=jnp.full(size_cells, truncation_distance, dtype),
        weight=jnp.zeros(size_cells, dtype),
        truncation_distance=jnp.asarray(truncation_distance, jnp.float32),
        max_weight=jnp.asarray(max_weight, jnp.float32),
        meta=make_meta(resolution, size_cells, center),
    )

"""Differentiable grid interpolation for scan matching.

Replacement for Ceres's BiCubicInterpolator over 2D grids
(ref: internal/2d/scan_matching/occupied_space_cost_function_2d.cc:47-74)
and the trilinear InterpolatedGrid/InterpolatedTSDF wrappers
(ref: internal/3d/scan_matching/interpolated_grid.h, interpolated_tsdf.h,
interpolated_multi_resolution_tsdf.h).

All functions map float positions to interpolated values with JAX-autodiff
gradients, batched over points. Out-of-bounds reads clamp to the border
value, matching the reference's GridArrayAdapter padding with
kMaxCorrespondenceCost / max TSD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.grids import GridMeta, ProbabilityGrid, TSDFGrid


def _cubic_weights(t):
    """Catmull-Rom cubic convolution weights for offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t3 + 2 * t2 - t)
    w1 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w2 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _cubic_weights_and_derivs(t):
    """Catmull-Rom weights and their d/dt, for analytic Jacobians."""
    t2 = t * t
    t3 = t2 * t
    w = jnp.stack(
        [
            0.5 * (-t3 + 2 * t2 - t),
            0.5 * (3 * t3 - 5 * t2 + 2),
            0.5 * (-3 * t3 + 4 * t2 + t),
            0.5 * (t3 - t2),
        ],
        axis=-1,
    )
    dw = jnp.stack(
        [
            0.5 * (-3 * t2 + 4 * t - 1),
            0.5 * (9 * t2 - 10 * t),
            0.5 * (-9 * t2 + 8 * t + 1),
            0.5 * (3 * t2 - 2 * t),
        ],
        axis=-1,
    )
    return w, dw


def gather_rows_2d(field: "PreparedField2D", points):
    """One contiguous 16-tap row gather per point at world xy positions.

    Returns (N, 16) f32 rows; out-of-grid bases hit the pad row. Split out
    from interp_prepared_2d so solvers can carry the rows across LM
    iterations (the base cell — hence the rows — only changes when the
    pose moves, so one gather per accepted trial suffices)."""
    nx, ny = field.dims[0], field.dims[1]
    u = (points - field.meta.min_corner) / field.meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    ok = (i0[..., 0] >= 0) & (i0[..., 0] < nx) & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
    flat = jnp.where(ok, i0[..., 0] * ny + i0[..., 1], nx * ny)
    return field.patches[flat].astype(jnp.float32)


def _patch_matrix_2d(values, pad_value, taps):
    """(nx*ny + 1, T) matrix of shifted copies: row c holds values at
    c + tap for each tap, border/overflow reads = pad_value; the appended
    last row is all pad_value for out-of-grid bases.

    Layout (same as the correlative matcher): interpolation taps
    become ONE contiguous row gather instead of T scattered element
    gathers. The matrix is loop-invariant in GN solves, so XLA hoists its
    construction out of the iteration loop.
    """
    nx, ny = values.shape
    lo = min(t[0] for t in taps + [(0, 0)])
    hi = max(t[0] for t in taps + [(0, 0)])
    pad = max(-lo, hi, 1)
    padded = jnp.pad(values, pad, constant_values=pad_value)
    cols = [
        jax.lax.dynamic_slice(padded, (pad + dx, pad + dy), (nx, ny)).reshape(-1)
        for dx, dy in taps
    ]
    m = jnp.stack(cols, axis=-1)
    return jnp.concatenate([m, jnp.full((1, len(taps)), pad_value, values.dtype)], axis=0)


_BICUBIC_TAPS_2D = [(dx, dy) for dx in range(-1, 3) for dy in range(-1, 3)]


def interp_bicubic_2d(values, meta: GridMeta, points, pad_value):
    """Bicubic interpolation of a 2D array at world positions (..., 2).

    values: (nx, ny) array. Out-of-grid reads return pad_value.
    """
    nx, ny = values.shape
    # Continuous cell coordinates: cell centers at integer coordinates.
    u = (points - meta.min_corner) / meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0

    wx = _cubic_weights(frac[..., 0])  # (..., 4)
    wy = _cubic_weights(frac[..., 1])
    w = (wx[..., :, None] * wy[..., None, :]).reshape(points.shape[:-1] + (16,))

    patches = _patch_matrix_2d(values, pad_value, _BICUBIC_TAPS_2D)
    ok = (i0[..., 0] >= 0) & (i0[..., 0] < nx) & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
    flat = jnp.where(ok, i0[..., 0] * ny + i0[..., 1], nx * ny)
    rows = patches[flat].astype(jnp.float32)  # (..., 16) contiguous
    return jnp.sum(rows * w, axis=-1)


def interp_bilinear_2d(values, meta: GridMeta, points, pad_value):
    nx, ny = values.shape
    u = (points - meta.min_corner) / meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    out = jnp.zeros(points.shape[:-1], values.dtype)
    for dx in range(2):
        ix = i0[..., 0] + dx
        ok_x = (ix >= 0) & (ix < nx)
        ixc = jnp.clip(ix, 0, nx - 1)
        wx = jnp.where(dx == 0, 1.0 - frac[..., 0], frac[..., 0])
        for dy in range(2):
            iy = i0[..., 1] + dy
            ok = ok_x & (iy >= 0) & (iy < ny)
            iyc = jnp.clip(iy, 0, ny - 1)
            wy = jnp.where(dy == 0, 1.0 - frac[..., 1], frac[..., 1])
            v = jnp.where(ok, values[ixc, iyc], pad_value)
            out = out + wx * wy * v
    return out


def _patch_matrix_3d(values, pad_value):
    """(nx*ny*nz + 1, 8) shifted-copy matrix for the trilinear taps."""
    nx, ny, nz = values.shape
    padded = jnp.pad(values, ((0, 1), (0, 1), (0, 1)), constant_values=pad_value)
    cols = [
        jax.lax.dynamic_slice(padded, (dx, dy, dz), (nx, ny, nz)).reshape(-1)
        for dx in range(2)
        for dy in range(2)
        for dz in range(2)
    ]
    m = jnp.stack(cols, axis=-1)
    return jnp.concatenate([m, jnp.full((1, 8), pad_value, values.dtype)], axis=0)


def interp_trilinear_3d(values, meta: GridMeta, points, pad_value):
    """Trilinear interpolation of a 3D array at world positions (..., 3).

    (ref: interpolated_grid.h InterpolatedGrid::GetProbability — trilinear
    with autodiff-compatible types.) Uses one contiguous 8-wide row gather
    per point (see _patch_matrix_2d).
    """
    nx, ny, nz = values.shape
    u = (points - meta.min_corner) / meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = jnp.stack([1.0 - fx, fx], axis=-1)
    wy = jnp.stack([1.0 - fy, fy], axis=-1)
    wz = jnp.stack([1.0 - fz, fz], axis=-1)
    w = (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).reshape(
        points.shape[:-1] + (8,)
    )

    patches = _patch_matrix_3d(values, pad_value)
    ok = (
        (i0[..., 0] >= 0) & (i0[..., 0] < nx)
        & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
        & (i0[..., 2] >= 0) & (i0[..., 2] < nz)
    )
    flat = jnp.where(ok, (i0[..., 0] * ny + i0[..., 1]) * nz + i0[..., 2], nx * ny * nz)
    rows = patches[flat].astype(jnp.float32)
    return jnp.sum(rows * w, axis=-1)


# ---------------------------------------------------------------------------
# Typed wrappers
# ---------------------------------------------------------------------------


def probability_at_2d(grid: ProbabilityGrid, points, bicubic: bool = True):
    """Occupancy probability at world xy positions; unknown/outside -> 0.1."""
    from hectorgrapher_tpu.mapping import probability_values as pv

    prob = grid.probability()
    fn = interp_bicubic_2d if bicubic else interp_bilinear_2d
    return fn(prob, grid.meta, points, pv.MIN_PROBABILITY)


def tsd_at_2d(grid: TSDFGrid, points, bicubic: bool = True):
    """(tsd, weight) at world xy positions; unknown/outside -> (td, 0)."""
    fn = interp_bicubic_2d if bicubic else interp_bilinear_2d
    tsd = fn(grid.tsd, grid.meta, points, grid.truncation_distance)
    w = fn(grid.weight, grid.meta, points, 0.0)
    return tsd, w


def probability_at_3d(grid: ProbabilityGrid, points):
    from hectorgrapher_tpu.mapping import probability_values as pv

    return interp_trilinear_3d(grid.probability(), grid.meta, points, pv.MIN_PROBABILITY)


def tsd_at_3d(grid: TSDFGrid, points):
    tsd = interp_trilinear_3d(grid.tsd, grid.meta, points, grid.truncation_distance)
    w = interp_trilinear_3d(grid.weight, grid.meta, points, 0.0)
    return tsd, w


def tsd_at_3d_weighted(grid: TSDFGrid, points):
    """Weight-aware TSD interpolation: cells with zero weight do not pull
    the estimate toward the +td prior (ref: interpolated_multi_resolution_
    tsdf.h:38-58 weight-aware lerp). Returns (tsd, weight)."""
    wsum = interp_trilinear_3d(grid.weight, grid.meta, points, 0.0)
    wtsd = interp_trilinear_3d(grid.weight * grid.tsd, grid.meta, points, 0.0)
    tsd = jnp.where(wsum > 1e-6, wtsd / jnp.maximum(wsum, 1e-6), grid.truncation_distance)
    return tsd, wsum


# ---------------------------------------------------------------------------
# Prepared (pre-materialized) interpolators
# ---------------------------------------------------------------------------
#
# The patch matrices are loop-invariant across solver iterations, but XLA
# does not hoist their construction out of lax.scan bodies; rebuilding a
# ~30 MB matrix per LM iteration dominated the CT window solve. Preparing
# them ONCE per solve removes that traffic.


from typing import NamedTuple

# -- z-segment row layout for the 3D prepared interpolators ------------------
#
# A naive (N, 8) trilinear tap table interleaves taps per cell, which
# needs a minor-dim relayout of the whole grid per CT window solve, so the
# table instead keeps z — the grid's natural minor dim — in the lanes:
#
#   TSDF row (x*ny + y)*nseg + k, lanes [0, 64)  = weight  [z = 63k .. 63k+63]
#                                 lanes [64, 128) = w * tsd [same z window]
#
# Segments overlap by one z so (z, z+1) always land in ONE row; a point's
# trilinear stencil is 4 gathered rows (2x2 xy neighbors) covering BOTH
# fields, and the z taps are two lanes selected in-register (iota one-hot).
# Building the table is pure lane-aligned slicing — no interleave. Probability grids use one field with 127-z rows.

_TSDF_SEG = 63  # z values per TSDF row segment (z window of 64 incl. +1)
_PROB_SEG = 127  # z values per probability row segment


class PreparedTsdf3D(NamedTuple):
    """Weight-aware TSDF interpolator, z-segment fused-field table."""

    table: jax.Array  # (nx*ny*nseg + 1, 128); last row all-zero (unknown)
    meta: GridMeta
    dims: jax.Array  # (4,) int32: nx, ny, nz, nseg
    truncation_distance: jax.Array


class PreparedProb3D(NamedTuple):
    table: jax.Array  # (nx*ny*nseg + 1, 128); last row = pad probability
    meta: GridMeta
    dims: jax.Array  # (4,) int32


def _segment_plane(values, seg: int, lanes: int):
    """(nx, ny, nz) -> (nx*ny*nseg, lanes) rows of overlapping z windows:
    row (x*ny+y)*nseg + k holds values[x, y, seg*k : seg*k + lanes] (zero
    beyond nz). Minor dim stays z throughout — no interleaving relayout."""
    nx, ny, nz = values.shape
    nseg = -(-nz // seg)
    padded = jnp.pad(
        values.astype(jnp.float32),
        ((0, 0), (0, 0), (0, (nseg - 1) * seg + lanes - nz)),
    )
    segs = jnp.stack(
        [padded[:, :, k * seg : k * seg + lanes] for k in range(nseg)], axis=2
    )  # (nx, ny, nseg, lanes)
    return segs.reshape(nx * ny * nseg, lanes), nseg


def prepare_tsdf_3d(grid: TSDFGrid) -> PreparedTsdf3D:
    w = grid.weight.astype(jnp.float32)
    w_rows, nseg = _segment_plane(w, _TSDF_SEG, 64)
    wtsd_rows, _ = _segment_plane(w * grid.tsd.astype(jnp.float32), _TSDF_SEG, 64)
    table = jnp.concatenate([w_rows, wtsd_rows], axis=1)
    table = jnp.concatenate([table, jnp.zeros((1, 128), jnp.float32)], axis=0)
    return PreparedTsdf3D(
        table=table,
        meta=grid.meta,
        dims=jnp.asarray(tuple(grid.tsd.shape) + (nseg,), jnp.int32),
        truncation_distance=grid.truncation_distance,
    )


def prepare_prob_3d(grid: ProbabilityGrid) -> PreparedProb3D:
    from hectorgrapher_tpu.mapping import probability_values as pv

    prob = grid.probability()
    rows, nseg = _segment_plane(prob, _PROB_SEG, 128)
    # z-pad slots beyond nz must read MIN_PROBABILITY, not 0.
    nx, ny, nz = prob.shape
    lane_z = jax.lax.broadcasted_iota(jnp.int32, (nx * ny * nseg, 128), 1)
    seg_k = (jax.lax.broadcasted_iota(jnp.int32, (nx * ny * nseg, 128), 0) % nseg)
    valid = seg_k * _PROB_SEG + lane_z < nz
    rows = jnp.where(valid, rows, pv.MIN_PROBABILITY)
    table = jnp.concatenate(
        [rows, jnp.full((1, 128), pv.MIN_PROBABILITY, jnp.float32)], axis=0
    )
    return PreparedProb3D(
        table=table,
        meta=grid.meta,
        dims=jnp.asarray(tuple(prob.shape) + (nseg,), jnp.int32),
    )


def _stencil_3d(prepared, points, seg: int):
    """Base-cell decomposition for the z-segment layout.

    Returns (rows, zoff, frac, ok): rows (..., 4) table row indices of the
    2x2 xy neighborhood (pad row when out of grid), zoff (...,) lane of z
    within the row, frac (..., 3)."""
    nx, ny, nz = prepared.dims[0], prepared.dims[1], prepared.dims[2]
    nseg = prepared.dims[3]
    u = (points - prepared.meta.min_corner) / prepared.meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    ok = (
        (i0[..., 0] >= 0) & (i0[..., 0] < nx - 1)
        & (i0[..., 1] >= 0) & (i0[..., 1] < ny - 1)
        & (i0[..., 2] >= 0) & (i0[..., 2] < nz - 1)
    )
    # Interior-only stencil (the reference's interpolators likewise clamp
    # at the border); boundary cells fall to the pad row = unknown.
    ix = jnp.clip(i0[..., 0], 0, nx - 2)
    iy = jnp.clip(i0[..., 1], 0, ny - 2)
    iz = jnp.clip(i0[..., 2], 0, nz - 2)
    k = iz // seg
    zoff = iz - k * seg
    pad_row = nx * ny * nseg
    base = (ix * ny + iy) * nseg + k
    rows = jnp.stack(
        [base, base + nseg, base + ny * nseg, base + (ny + 1) * nseg], axis=-1
    )  # (dx, dy) = (0,0), (0,1), (1,0), (1,1)
    rows = jnp.where(ok[..., None], rows, pad_row)
    return rows, zoff, frac, ok


def gather_rows_3d(prepared, points):
    """Gather the (..., 4, 128) stencil rows at world positions (lets
    solvers carry rows across LM iterations, see gather_rows_2d)."""
    seg = _TSDF_SEG if isinstance(prepared, PreparedTsdf3D) else _PROB_SEG
    rows, _, _, _ = _stencil_3d(prepared, points, seg)
    return prepared.table[rows]


def _xy_mix(rows, frac):
    """Blend the 4 stencil rows by the xy bilinear weights -> (..., 128)."""
    fx, fy = frac[..., 0], frac[..., 1]
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w10 = fx * (1.0 - fy)
    w11 = fx * fy
    return (
        w00[..., None] * rows[..., 0, :]
        + w01[..., None] * rows[..., 1, :]
        + w10[..., None] * rows[..., 2, :]
        + w11[..., None] * rows[..., 3, :]
    )


def _z_pick(mixed, zoff, fz, lane_base):
    """Select (1-fz, fz) at lanes (lane_base+zoff, +1) of (..., 128)."""
    lanes = jax.lax.broadcasted_iota(jnp.int32, mixed.shape, mixed.ndim - 1)
    z0 = lane_base + zoff[..., None]
    win = jnp.where(lanes == z0, 1.0 - fz[..., None], 0.0) + jnp.where(
        lanes == z0 + 1, fz[..., None], 0.0
    )
    return jnp.sum(mixed * win, axis=-1)


def tsdf_interp_from_rows(prepared: PreparedTsdf3D, rows, zoff, frac):
    """(w, wtsd) trilinear sums from carried stencil rows."""
    mixed = _xy_mix(rows, frac)
    fz = frac[..., 2]
    w = _z_pick(mixed, zoff, fz, 0)
    wtsd = _z_pick(mixed, zoff, fz, 64)
    return w, wtsd


def interp_tsdf_prepared(prepared: PreparedTsdf3D, points):
    """(tsd, weight) with the weight-aware lerp (ref: interpolated_multi_
    resolution_tsdf.h:38-58)."""
    rows, zoff, frac, _ = _stencil_3d(prepared, points, _TSDF_SEG)
    w, wtsd = tsdf_interp_from_rows(prepared, prepared.table[rows], zoff, frac)
    tsd = jnp.where(w > 1e-6, wtsd / jnp.maximum(w, 1e-6), prepared.truncation_distance)
    return tsd, w


def interp_prob_prepared(prepared: PreparedProb3D, points):
    rows, zoff, frac, _ = _stencil_3d(prepared, points, _PROB_SEG)
    mixed = _xy_mix(prepared.table[rows], frac)
    return _z_pick(mixed, zoff, frac[..., 2], 0)


def _field_and_dfrac(rows, zoff, frac, lane_base):
    """One field's trilinear value (...,) and d/dfrac (..., 3) from the
    (..., 4, 128) stencil rows. Identical to autodiff: the gathered rows
    are constants and floor() has zero derivative."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    mixed = _xy_mix(rows, frac)
    # d mixed / dfx and /dfy are xy-difference blends of the same rows.
    gy = (1.0 - fy)[..., None]
    hy = fy[..., None]
    gx = (1.0 - fx)[..., None]
    hx = fx[..., None]
    mixed_dx = gy * (rows[..., 2, :] - rows[..., 0, :]) + hy * (rows[..., 3, :] - rows[..., 1, :])
    mixed_dy = gx * (rows[..., 1, :] - rows[..., 0, :]) + hx * (rows[..., 3, :] - rows[..., 2, :])
    val = _z_pick(mixed, zoff, fz, lane_base)
    dx = _z_pick(mixed_dx, zoff, fz, lane_base)
    dy = _z_pick(mixed_dy, zoff, fz, lane_base)
    # d/dfz: window derivative is (-1, +1) at (z0, z0+1).
    lanes = jax.lax.broadcasted_iota(jnp.int32, mixed.shape, mixed.ndim - 1)
    z0 = lane_base + zoff[..., None]
    dwin = jnp.where(lanes == z0, -1.0, 0.0) + jnp.where(lanes == z0 + 1, 1.0, 0.0)
    dz = jnp.sum(mixed * dwin, axis=-1)
    return val, jnp.stack([dx, dy, dz], axis=-1)


def tsdf_value_and_dfrac(prepared: PreparedTsdf3D, rows, points):
    """Weight-gated match value (..., ) + d/dfrac (..., 3) from carried
    stencil rows (the gn_3d carried-rows LM path)."""
    _, zoff, frac, _ = _stencil_3d(prepared, points, _TSDF_SEG)
    w, dw = _field_and_dfrac(rows, zoff, frac, 0)
    wtsd, dwtsd = _field_and_dfrac(rows, zoff, frac, 64)
    gate = w > 1e-6
    safe = jnp.maximum(w, 1e-6)
    val = jnp.where(gate, wtsd / safe, 0.0)
    dval = jnp.where(
        gate[..., None],
        (dwtsd * safe[..., None] - wtsd[..., None] * dw) / (safe * safe)[..., None],
        0.0,
    )
    return val, dval


def prob_value_and_dfrac(prepared: PreparedProb3D, rows, points):
    """(1 - probability) match value + d/dfrac from carried stencil rows."""
    _, zoff, frac, _ = _stencil_3d(prepared, points, _PROB_SEG)
    p, dp = _field_and_dfrac(rows, zoff, frac, 0)
    return 1.0 - p, -dp


def prepare_grid_3d(grid):
    """Prepare a TSDFGrid or ProbabilityGrid for repeated interpolation."""
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    if isinstance(grid, TSDFGrid):
        return prepare_tsdf_3d(grid)
    return prepare_prob_3d(grid)


def value_at_prepared_3d(prepared, points):
    """Match-cost field value: weight-gated TSD or (1 - probability)."""
    if isinstance(prepared, PreparedTsdf3D):
        rows, zoff, frac, _ = _stencil_3d(prepared, points, _TSDF_SEG)
        wsum, wtsd = tsdf_interp_from_rows(prepared, prepared.table[rows], zoff, frac)
        return jnp.where(wsum > 1e-6, wtsd / jnp.maximum(wsum, 1e-6), 0.0)
    return 1.0 - interp_prob_prepared(prepared, points)


class PreparedField2D(NamedTuple):
    """One 2D field ready for bicubic row-gather interpolation."""

    patches: jax.Array  # (nx*ny + 1, 16)
    meta: GridMeta
    dims: jax.Array  # (2,) int32


def prepare_field_2d(values, meta: GridMeta, pad_value) -> PreparedField2D:
    return PreparedField2D(
        patches=_patch_matrix_2d(values, pad_value, _BICUBIC_TAPS_2D),
        meta=meta,
        dims=jnp.asarray(values.shape, jnp.int32),
    )


def prepare_field_2d_wide(
    values, meta: GridMeta, pad_value, slack: int, lanes: int | None = None
) -> PreparedField2D:
    """Bicubic patch matrix widened by `slack` cells per side: row c holds
    the (4+2*slack)^2 neighborhood at c + (-1-slack .. 2+slack)^2.

    One wide row per point replaces a 16-tap row per lookup: it serves EVERY bicubic
    lookup whose base cell lies within `slack` cells of c, which lets the
    GN solver gather once and run all LM iterations from carried rows."""
    nx, ny = values.shape
    w = 4 + 2 * slack
    lo = 1 + slack  # window starts at base cell - (1 + slack)
    hi = 2 + slack
    # Two-stage shifted stack (see correlative_2d._wide_patch_table): 2*w
    # slice kernels + one relayout; both w^2 separate slices and an im2col
    # conv are far slower. Channel order is (dx, dy) row-major.
    padded = jnp.pad(
        values.astype(jnp.float32), ((lo, hi), (lo, hi)), constant_values=pad_value
    )
    xs = jnp.stack([padded[dx : dx + nx, :] for dx in range(w)])  # (w, nx, ny+w)
    xy = jnp.stack([xs[:, :, dy : dy + ny] for dy in range(w)], axis=1)
    table = xy.transpose(2, 3, 0, 1).reshape(nx * ny, w * w)
    table = jnp.concatenate(
        [table, jnp.full((1, w * w), pad_value, jnp.float32)], axis=0
    )
    if lanes is not None and lanes > w * w:
        # Zero-filled spare lanes up to a caller's row width; in-envelope
        # interpolation weights there are zero.
        table = jnp.pad(table, ((0, 0), (0, lanes - w * w)))
    return PreparedField2D(
        patches=table,
        meta=meta,
        dims=jnp.asarray(values.shape, jnp.int32),
    )


def interp_prepared_2d(field: PreparedField2D, points):
    nx, ny = field.dims[0], field.dims[1]
    u = (points - field.meta.min_corner) / field.meta.resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    wx = _cubic_weights(frac[..., 0])
    wy = _cubic_weights(frac[..., 1])
    w = (wx[..., :, None] * wy[..., None, :]).reshape(points.shape[:-1] + (16,))
    ok = (i0[..., 0] >= 0) & (i0[..., 0] < nx) & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
    flat = jnp.where(ok, i0[..., 0] * ny + i0[..., 1], nx * ny)
    rows = field.patches[flat].astype(jnp.float32)
    return jnp.sum(rows * w, axis=-1)


def prepare_probability_2d(grid: ProbabilityGrid) -> PreparedField2D:
    from hectorgrapher_tpu.mapping import probability_values as pv

    return prepare_field_2d(grid.probability(), grid.meta, pv.MIN_PROBABILITY)


class PreparedTsdf2D(NamedTuple):
    tsd_field: PreparedField2D
    weight_field: PreparedField2D


def prepare_tsdf_2d(grid: TSDFGrid) -> PreparedTsdf2D:
    return PreparedTsdf2D(
        tsd_field=prepare_field_2d(grid.tsd, grid.meta, grid.truncation_distance),
        weight_field=prepare_field_2d(grid.weight, grid.meta, 0.0),
    )

"""3D range-data insertion kernels.

Replacement for:
  * OccupancyGridRangeDataInserter3D (ref: mapping/3d/
    range_data_inserter_3d.cc — per-hit odds update + last-N free-space
    voxels along each ray)
  * TSDFRangeDataInserter3D (ref: mapping/3d/tsdf_range_data_inserter_3d.cc
    — the HectorGrapher core: TSDF integration with structured-cloud
    normals (CLOUD_STRUCTURE, :503), normal-directed truncation-band
    updates (InsertHitWithNormal, :197), ray-directed updates (InsertHit,
    :294) with exponential weight drop-off behind the surface (:333-341),
    weighted-average cell update (UpdateCell, :725), insertion_ratio
    subsampling.)

Design: all per-point loops become batched array ops; the sequential
weighted-average UpdateCell is replaced by scatter-add of (sum w, sum w*d)
followed by one combined update — algebraically identical to applying the
reference's UpdateCell sequentially for every sample of the scan (the
running weighted mean is order-independent), except that the weight cap is
applied once at scan end rather than mid-scan.
"""

from __future__ import annotations

import functools

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


def insertion_ratio_mask(valid, ratio: float):
    """Deterministic subsampling: keep point when the running kept-count
    stays <= ratio * processed-count (ref: tsdf_range_data_inserter_3d.cc
    :503-519 insertion_ratio gate), vectorized over the valid sequence."""
    if ratio >= 1.0:
        return valid
    c = jnp.cumsum(valid.astype(jnp.int32))  # processed count including self
    kept_before = jnp.floor(ratio * (c - 1).astype(jnp.float32))
    kept_incl = jnp.floor(ratio * c.astype(jnp.float32))
    return valid & (kept_incl > kept_before)


# ---------------------------------------------------------------------------
# Occupancy 3D
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_free_space_voxels",))
def insert_probability_3d(
    grid: ProbabilityGrid,
    range_data: RangeData,
    hit_log_odds,
    miss_log_odds,
    num_free_space_voxels: int = 2,
) -> ProbabilityGrid:
    """(ref: range_data_inserter_3d.cc Insert + InsertMissesIntoGrid)

    Hits: one odds update per hit cell. Misses: only the last
    `num_free_space_voxels` sample positions before each hit. Hits take
    priority over misses in the same scan.
    """
    shape = grid.shape
    hits = range_data.returns.positions
    valid = range_data.returns.mask
    origin = range_data.origin

    hit_idx = cell_index(grid.meta, hits)
    hit_mask = _scatter_mask3(shape, flat_index(hit_idx, shape), valid)

    if num_free_space_voxels > 0:
        origin_cell = cell_index(grid.meta, origin[None, :])[0]
        delta = hit_idx - origin_cell[None, :]
        num_samples = jnp.max(jnp.abs(delta), axis=-1)  # (P,)
        # positions max(0, n-k) .. n-1  ->  cells origin + delta * pos / n
        offsets = jnp.arange(num_free_space_voxels, dtype=jnp.int32)  # (K,)
        pos = num_samples[:, None] - num_free_space_voxels + offsets[None, :]
        pos_valid = (pos >= 0) & (pos < num_samples[:, None]) & valid[:, None]
        n_safe = jnp.maximum(num_samples, 1)[:, None, None]
        miss_cells = origin_cell[None, None, :] + (
            delta[:, None, :] * pos[:, :, None]
        ) // n_safe
        miss_mask = _scatter_mask3(
            shape, flat_index(miss_cells, shape).reshape(-1), pos_valid.reshape(-1)
        )
        miss_mask = miss_mask & ~hit_mask
    else:
        miss_mask = jnp.zeros(shape, dtype=bool)

    delta_lo = jnp.where(hit_mask, hit_log_odds, 0.0) + jnp.where(miss_mask, miss_log_odds, 0.0)
    touched = hit_mask | miss_mask
    return grid._replace(
        log_odds=jnp.where(touched, pv.clamp_log_odds(grid.log_odds + delta_lo), grid.log_odds),
        known=grid.known | touched,
    )


def _scatter_mask3(shape, flat_idx, valid):
    size = 1
    for s in shape:
        size *= s
    grid = jnp.zeros((size + 1,), dtype=bool)
    grid = grid.at[jnp.where(valid, flat_idx, size)].set(True)
    return grid[:size].reshape(shape)


def make_probability_inserter_3d(options):
    """Bind ProbabilityGridRangeDataInserterOptions3D."""
    import math

    hit_lo = math.log(options.hit_probability / (1 - options.hit_probability))
    miss_lo = math.log(options.miss_probability / (1 - options.miss_probability))

    def insert(grid: ProbabilityGrid, range_data: RangeData) -> ProbabilityGrid:
        return insert_probability_3d(
            grid, range_data, hit_lo, miss_lo, num_free_space_voxels=int(options.num_free_space_voxels)
        )

    return insert


# ---------------------------------------------------------------------------
# Structured-cloud normals (CLOUD_STRUCTURE)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("width", "vertical_stride", "horizontal_stride"))
def structured_cloud_normals(
    cloud: PointCloud,
    origin,
    width: int,
    vertical_stride: int = 1,
    horizontal_stride: int = 5,
    resolution=0.1,
):
    """Surface normals from an organized cloud's neighbor structure.

    (ref: tsdf_range_data_inserter_3d.cc:503-607 CLOUD_STRUCTURE — for
    each point, search index offsets FARTHEST-FIRST (the reference
    decrements from the stride toward 0) up to +-vertical_stride
    (adjacent points) and +-horizontal_stride*width (adjacent scan
    lines) for a neighbor whose range differs by < resolution/0.05,
    falling back to the point itself at offset 0; the normal is the
    normalized cross product of the two neighbor differences, gated on
    the two indices per axis being distinct.)

    Returns (normals (N, 3), normal_valid (N,)).
    """
    pts = cloud.positions
    n = pts.shape[0]
    r = jnp.linalg.norm(pts - origin[None, :], axis=-1)
    max_range_delta = resolution / 0.05

    def find_neighbor(offsets):
        """First valid offset per point (offsets tried farthest-first,
        as in the reference); falls back to the point's OWN index —
        offset 0 — so a one-sided hit yields a one-sided difference and
        a no-hit axis is rejected by the i_upper != i_lower gate."""
        base = jnp.arange(n, dtype=jnp.int32)
        best = base
        found = jnp.zeros((n,), dtype=bool)
        for off in offsets:
            j = base + off
            ok = (j >= 0) & (j < n)
            jc = jnp.clip(j, 0, n - 1)
            ok = ok & cloud.mask[jc] & (jnp.abs(r - r[jc]) <= max_range_delta)
            best = jnp.where(~found & ok, j, best)
            found = found | ok
        return best, found

    up_offsets = list(range(vertical_stride, 0, -1))
    down_offsets = [-o for o in up_offsets]
    h = max(1, horizontal_stride) * max(1, width)
    right_offsets = list(range(h, 0, -max(1, width)))
    left_offsets = [-o for o in right_offsets]

    i_vu, f_vu = find_neighbor(up_offsets)
    i_vl, f_vl = find_neighbor(down_offsets)
    i_hu, f_hu = find_neighbor(right_offsets)
    i_hl, f_hl = find_neighbor(left_offsets)

    p_vu, p_vl = pts[i_vu], pts[i_vl]
    p_hu, p_hl = pts[i_hu], pts[i_hl]
    dv = p_vl - p_vu
    dh = p_hl - p_hu
    normal = jnp.cross(dh, dv)
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    ok = (
        cloud.mask
        & (f_vu | f_vl)
        & (f_hu | f_hl)
        & (i_vu != i_vl)
        & (i_hu != i_hl)
        & (norm[:, 0] > 1e-9)
    )
    normal = normal / jnp.maximum(norm, 1e-9)
    return normal, ok


# ---------------------------------------------------------------------------
# TSDF 3D
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_band_samples", "use_normals"))
def insert_tsdf_3d(
    grid: TSDFGrid,
    hits,
    valid,
    origin,
    normals,
    num_band_samples: int,
    use_normals: bool,
    weight_epsilon,
    weight_sigma,
) -> TSDFGrid:
    """Core TSDF integration.

    With use_normals (ref InsertHitWithNormal :197): the truncation band
    is swept along the normal through the hit; update distance is
    (cell_center - hit) . normal (sign chosen so the free side is
    positive).

    Without (ref InsertHit :294): the band is swept along the ray;
    update distance is range - |cell_center - origin| with exponential
    weight drop-off behind the surface (:333-341).
    """
    shape = grid.shape
    td = grid.truncation_distance
    ray = hits - origin[None, :]
    ranges = jnp.linalg.norm(ray, axis=-1)
    ray_dir = ray / jnp.maximum(ranges[:, None], 1e-9)
    valid = valid & (ranges > td)

    s = jnp.linspace(-1.0, 1.0, num_band_samples)  # band parameter

    if use_normals:
        # Orient the normal against the ray (:210-211).
        nd = jnp.where(jnp.sum(normals * ray, axis=-1) > 0, -1.0, 1.0)
        n_oriented = nd[:, None] * normals
        band_pts = hits[:, None, :] + (s[None, :, None] * td) * n_oriented[:, None, :]
        idx = cell_index(grid.meta, band_pts)
        centers = cell_center(grid.meta, idx)
        d = jnp.sum((centers - hits[:, None, :]) * n_oriented[:, None, :], axis=-1)
        d = jnp.clip(d, -td, td)
        w = jnp.ones_like(d)
    else:
        band_pts = hits[:, None, :] + (s[None, :, None] * td) * ray_dir[:, None, :]
        idx = cell_index(grid.meta, band_pts)
        centers = cell_center(grid.meta, idx)
        d = ranges[:, None] - jnp.linalg.norm(centers - origin[None, None, :], axis=-1)
        d = jnp.clip(d, -td, td)
        nd_norm = d / td
        w = jnp.where(
            nd_norm < -weight_epsilon,
            jnp.exp(-weight_sigma * (-nd_norm - weight_epsilon) ** 2),
            1.0,
        )

    flat = flat_index(idx, shape)
    vmask = jnp.broadcast_to(valid[:, None], flat.shape)
    size = grid.tsd.size
    slot = jnp.where(vmask, flat, size).reshape(-1)
    w_flat = jnp.where(vmask, w, 0.0).reshape(-1)
    wd_flat = jnp.where(vmask, w * d, 0.0).reshape(-1)

    w_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(w_flat)[:size].reshape(shape)
    wd_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(wd_flat)[:size].reshape(shape)

    tsd32 = grid.tsd.astype(jnp.float32)
    wgt32 = grid.weight.astype(jnp.float32)
    new_w_raw = wgt32 + w_sum
    new_tsd = jnp.where(
        w_sum > 0,
        (tsd32 * wgt32 + wd_sum) / jnp.maximum(new_w_raw, 1e-9),
        tsd32,
    )
    return grid._replace(
        tsd=new_tsd.astype(grid.tsd.dtype),
        weight=jnp.minimum(new_w_raw, grid.max_weight).astype(grid.weight.dtype),
    )


@functools.partial(
    jax.jit, static_argnames=("width", "num_layers", "bary_samples")
)
def insert_tsdf_3d_triangles(
    grid: TSDFGrid,
    cloud: PointCloud,
    origin,
    width: int,
    num_layers: int,
    bary_samples: int = 6,
    max_edge=1.0,
) -> TSDFGrid:
    """TRIANGLE_FILL_IN: rasterize triangles between adjacent rays.

    (ref: tsdf_range_data_inserter_3d.cc:83-195 InsertTriangle/
    RasterTriangle — each quad of the organized cloud forms two triangles;
    truncation-band layers are offset along the triangle normal and each
    layer is rasterized into the TSDF with distance = layer offset +
    cell-to-plane distance.)

    Schedule: instead of per-row scanline walks, every triangle is
    sampled on a fixed barycentric grid per layer and the updates are
    scatter-accumulated (weighted average, same UpdateCell algebra).
    """
    shape = grid.shape
    td = grid.truncation_distance
    res = grid.meta.resolution
    pts = cloud.positions
    n = pts.shape[0]
    rows = n // width

    # Quad corners p00=(r,c) p01=(r,c+1) p10=(r+1,c) p11=(r+1,c+1).
    idx = jnp.arange((rows - 1) * (width - 1))
    r = idx // (width - 1)
    c = idx % (width - 1)
    i00 = r * width + c
    i01 = i00 + 1
    i10 = i00 + width
    i11 = i10 + 1

    def tri_arrays(a, b, cc):
        v0, v1, v2 = pts[a], pts[b], pts[cc]
        valid = cloud.mask[a] & cloud.mask[b] & cloud.mask[cc]
        e = jnp.maximum(
            jnp.linalg.norm(v1 - v0, axis=-1),
            jnp.maximum(jnp.linalg.norm(v2 - v0, axis=-1), jnp.linalg.norm(v2 - v1, axis=-1)),
        )
        valid = valid & (e < max_edge)
        nrm = jnp.cross(v1 - v0, v2 - v0)
        nn = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
        valid = valid & (nn[:, 0] > 1e-9)
        nrm = nrm / jnp.maximum(nn, 1e-9)
        # Orient toward the sensor (ref: normal.dot(origin - v0) >= 0).
        flip = jnp.sum(nrm * (origin[None, :] - v0), axis=-1) < 0
        nrm = jnp.where(flip[:, None], -nrm, nrm)
        return v0, v1, v2, nrm, valid

    tA = tri_arrays(i00, i01, i10)
    tB = tri_arrays(i01, i11, i10)
    v0 = jnp.concatenate([tA[0], tB[0]])
    v1 = jnp.concatenate([tA[1], tB[1]])
    v2 = jnp.concatenate([tA[2], tB[2]])
    nrm = jnp.concatenate([tA[3], tB[3]])
    valid = jnp.concatenate([tA[4], tB[4]])

    # Barycentric sample grid (a, b), a + b <= 1.
    lin = (jnp.arange(bary_samples, dtype=jnp.float32) + 0.5) / bary_samples
    aa, bb = jnp.meshgrid(lin, lin, indexing="ij")
    bary_ok = (aa + bb) <= 1.0
    aa = aa.reshape(-1)
    bb = bb.reshape(-1)
    bary_ok = bary_ok.reshape(-1)

    # Layers along the normal (ref: i in [-rel_td, rel_td] * resolution).
    half = num_layers // 2
    offsets = (jnp.arange(num_layers, dtype=jnp.float32) - half) * res

    # (T, L, B, 3) sample points.
    base = (
        v0[:, None, :]
        + aa[None, :, None] * (v1 - v0)[:, None, :]
        + bb[None, :, None] * (v2 - v0)[:, None, :]
    )  # (T, B, 3)
    q = base[:, None, :, :] + offsets[None, :, None, None] * nrm[:, None, None, :]
    cell = cell_index(grid.meta, q)
    centers = cell_center(grid.meta, cell)
    d = jnp.sum((centers - v0[:, None, None, :]) * nrm[:, None, None, :], axis=-1)
    d = jnp.clip(d, -td, td)

    flat = flat_index(cell, shape)
    ok = jnp.broadcast_to(valid[:, None, None] & bary_ok[None, None, :], flat.shape)
    size = grid.tsd.size
    slot = jnp.where(ok, flat, size).reshape(-1)
    w_flat = jnp.where(ok, 1.0, 0.0).reshape(-1)
    wd_flat = jnp.where(ok, d, 0.0).reshape(-1)
    w_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(w_flat)[:size].reshape(shape)
    wd_sum = jnp.zeros((size + 1,), jnp.float32).at[slot].add(wd_flat)[:size].reshape(shape)

    tsd32 = grid.tsd.astype(jnp.float32)
    wgt32 = grid.weight.astype(jnp.float32)
    new_w_raw = wgt32 + w_sum
    new_tsd = jnp.where(
        w_sum > 0,
        (tsd32 * wgt32 + wd_sum) / jnp.maximum(new_w_raw, 1e-9),
        tsd32,
    )
    return grid._replace(
        tsd=new_tsd.astype(grid.tsd.dtype),
        weight=jnp.minimum(new_w_raw, grid.max_weight).astype(grid.weight.dtype),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def knn_pca_normals(points, valid, origin, k: int = 16, radius: float = 0.4):
    """k-NN PCA surface normals: the dense equivalent of the
    reference's PCL/OPEN3D backends (ref: tsdf_range_data_inserter_3d.cc
    :405-489 — Open3D EstimateNormals with KDTreeSearchParamHybrid(radius,
    max_nn): per-point covariance over hybrid radius/k-NN neighborhoods,
    normal = smallest-eigenvalue eigenvector, oriented toward the sensor).

    KD-trees are pointer-chasing and a poor fit for batched device code; for padded clouds
    (P <= a few thousand) the dense (P, P) distance matrix + lax.top_k is
    one fused matmul-friendly program.

    points: (P, 3), valid: (P,), origin: (3,).
    Returns (normals (P, 3), ok (P,)) — ok requires >= 3 in-radius
    neighbors (a degenerate neighborhood has no defined normal).
    """
    p = points.shape[0]
    big = jnp.asarray(1e30, points.dtype)
    d2 = jnp.sum((points[:, None, :] - points[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(valid[None, :] & valid[:, None], d2, big)
    neg, idx = jax.lax.top_k(-d2, min(k, p))  # (P, k) nearest incl. self
    nbr = points[idx]  # (P, k, 3)
    w = ((-neg) <= radius * radius) & valid[idx] & valid[:, None]
    n = jnp.maximum(jnp.sum(w, axis=-1), 1).astype(points.dtype)[:, None]
    mean = jnp.sum(jnp.where(w[..., None], nbr, 0.0), axis=1) / n
    centered = jnp.where(w[..., None], nbr - mean[:, None, :], 0.0)
    cov = jnp.einsum("pki,pkj->pij", centered, centered) / n[..., None]
    _, eigvecs = jnp.linalg.eigh(cov)  # ascending eigenvalues
    normal = eigvecs[..., 0]  # (P, 3) smallest-eigenvalue direction
    to_sensor = origin[None, :] - points
    flip = jnp.sum(normal * to_sensor, axis=-1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)
    ok = valid & (jnp.sum(w, axis=-1) >= 3)
    return normal, ok


def make_tsdf_inserter_3d(options, resolution: float):
    """Bind TSDFRangeDataInserterOptions3D into an insert fn.

    options.normal_computation_method selects the normal backend:
    CLOUD_STRUCTURE uses organized-cloud neighbors (the config default,
    ref trajectory_builder_3d.lua:89); KNN_PCA is the unorganized-cloud
    backend (PCL/OPEN3D in the reference, ref :405-489) via dense k-NN
    PCA; anything else falls back to ray-directed updates (InsertHit
    path).
    """
    td = options.relative_truncation_distance * resolution
    num_band_samples = max(4, int(2.0 * options.relative_truncation_distance / 0.5) + 1)
    use_normals = options.normal_computation_method == "CLOUD_STRUCTURE"
    use_knn = options.normal_computation_method in ("KNN_PCA", "PCL", "OPEN3D")
    use_triangles = options.normal_computation_method == "TRIANGLE_FILL_IN"
    num_layers = 2 * int(round(options.relative_truncation_distance)) + 1

    def insert(grid: TSDFGrid, range_data: RangeData) -> TSDFGrid:
        hits = range_data.returns.positions
        valid = range_data.returns.mask
        r = jnp.linalg.norm(hits - range_data.origin[None, :], axis=-1)
        valid = valid & (r >= options.min_range) & (r <= options.max_range)
        valid = insertion_ratio_mask(valid, float(options.insertion_ratio))
        if use_triangles and range_data.width > 0:
            masked = range_data.returns._replace(mask=valid)
            return insert_tsdf_3d_triangles(
                grid,
                masked,
                range_data.origin,
                width=range_data.width,
                num_layers=num_layers,
            )
        if use_normals and range_data.width > 0:
            normals, n_ok = structured_cloud_normals(
                range_data.returns,
                range_data.origin,
                width=range_data.width,
                vertical_stride=int(options.normal_computation_vertical_stride),
                horizontal_stride=int(options.normal_computation_horizontal_stride),
                resolution=resolution,
            )
            return insert_tsdf_3d(
                grid, hits, valid & n_ok, range_data.origin, normals,
                num_band_samples=num_band_samples, use_normals=True,
                weight_epsilon=options.weight_function_epsilon,
                weight_sigma=options.weight_function_sigma,
            )
        if use_knn:
            normals, n_ok = knn_pca_normals(
                hits, valid, range_data.origin,
                k=int(options.normal_estimate_max_nn),
                radius=float(options.normal_estimate_radius),
            )
            return insert_tsdf_3d(
                grid, hits, valid & n_ok, range_data.origin, normals,
                num_band_samples=num_band_samples, use_normals=True,
                weight_epsilon=options.weight_function_epsilon,
                weight_sigma=options.weight_function_sigma,
            )
        dummy_normals = jnp.zeros_like(hits)
        return insert_tsdf_3d(
            grid, hits, valid, range_data.origin, dummy_normals,
            num_band_samples=num_band_samples, use_normals=False,
            weight_epsilon=options.weight_function_epsilon,
            weight_sigma=options.weight_function_sigma,
        )

    return insert

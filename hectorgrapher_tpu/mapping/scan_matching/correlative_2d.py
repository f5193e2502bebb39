"""Real-time correlative scan matching in 2D as one dense kernel.

Replacement for RealTimeCorrelativeScanMatcher2D
(ref: internal/2d/scan_matching/real_time_correlative_scan_matcher_2d.cc,
correlative_scan_matcher_2d.cc SearchParameters). The reference loops over
candidates with early discretization; here the full (theta, dx, dy)
score volume is evaluated as one batched gather + matmul reduction - the
"batch, don't queue" design from SURVEY.md section 7.

Score of a candidate = mean occupancy probability at the transformed hit
cells, down-weighted by exp(-(|t|*w_t + |theta|*w_r)^2) exactly as the
reference's candidate penalty. Out-of-map cells score the unknown-cell
probability 0.1 per CELL, matching the reference's Grid2D::GetProbability
on out-of-bounds indices.

Design (the hot loop is bound by the number of gathered rows, not their
width): the angular step is chosen so the farthest scan
point moves at most one cell between adjacent angles (SearchParameters
ctor). Therefore the discretized cell of any point differs by at most
+-HALF cells (per axis) between an angle and the middle angle of its
group of ANGLE_GROUP angles. One gather of an 11x11 "wide patch" row,
centered at the middle angle's cell, serves the 7x7 score patches of all
ANGLE_GROUP angles - a 5x cut in gather rows. Per-angle extraction is a
delta-grouped one-hot matmul: rows are summed per (angle-in-group,
cell-delta) bucket, and each bucket's 7x7 sub-window of the 11x11 sum is
added into the score volume with a static slice.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.grids import ProbabilityGrid, cell_index
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2, rot2

# Number of adjacent angle candidates sharing one gathered wide-patch row.
# Must be odd; HALF = ANGLE_GROUP // 2 is the max per-axis cell delta
# between a group member's discretized cell and the group center's
# (one cell per angle step, by the SearchParameters step construction).
ANGLE_GROUP = 5

_UNKNOWN = 0.1  # probability reported for never-observed / out-of-map cells


class SearchWindow2D(NamedTuple):
    """Static search geometry (shapes must be known at trace time)."""

    num_angles: int
    angle_step: float
    num_linear: int  # cells per side: offsets in [-num_linear, num_linear]


def make_search_window(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
) -> SearchWindow2D:
    """(ref: correlative_scan_matcher_2d.cc SearchParameters ctor —
    angular step such that the farthest point moves at most one cell.)"""
    angle_step = math.acos(max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2))))
    num_angles = int(math.ceil(angular_search_window / angle_step))
    num_linear = int(math.ceil(linear_search_window / resolution))
    return SearchWindow2D(num_angles=num_angles, angle_step=angle_step, num_linear=num_linear)


def _wide_patch_table(prob: jax.Array, k: int, half: int) -> jax.Array:
    """Shifted-copy table over the EXTENDED cell grid.

    Row for extended cell e=(c+margin) holds the map value at every offset
    a in [-margin, margin]^2 from absolute cell c, where margin = k + half;
    cells outside the real grid read the unknown-cell probability. A final
    all-unknown row serves cells beyond the extended grid (any candidate
    cell reachable from them is out of map, so the flat row is exact).
    """
    nx, ny = prob.shape
    m = k + half
    pw = 2 * m + 1
    padded = jnp.pad(prob, 2 * m, constant_values=_UNKNOWN).astype(jnp.bfloat16)
    ex, ey = nx + 2 * m, ny + 2 * m
    # Two-stage shifted stack: pw x-slices then pw y-slices (2*pw kernels
    # + one relayout) instead of pw^2 separate strided-slice kernels or an
    # im2col conv. Channel order is (a, b) row-major, matching the flat
    # lane layout the combine matrix assumes.
    xs = jnp.stack([padded[dx : dx + ex, :] for dx in range(pw)])  # (pw, ex, ny+4m)
    xy = jnp.stack(
        [xs[:, :, dy : dy + ey] for dy in range(pw)], axis=1
    )  # (pw_a, pw_b, ex, ey)
    table = xy.transpose(2, 3, 0, 1).reshape(ex * ey, pw * pw)
    return jnp.concatenate(
        [table, jnp.full((1, pw * pw), _UNKNOWN, jnp.bfloat16)], axis=0
    )


@functools.lru_cache(maxsize=None)
def _combine_matrix(k: int, half: int):
    """Static (gsz^2 * pw^2, d^2) 0/1 matrix: entry [(j, a, b), (dx, dy)]
    is 1 iff wide-patch lane (a, b) holds the candidate cell for score
    offset (dx, dy) under group delta j, i.e. a = dx+k+deltax+half and
    b = dy+k+deltay+half. Returned as numpy (a jit-trace constant): a
    device array here would capture the enclosing trace via the cache."""
    import numpy as np

    gsz = 2 * half + 1
    d = 2 * k + 1
    pw = d + 2 * half
    s = np.zeros((gsz * gsz, pw, pw, d, d), np.float32)
    for jx in range(gsz):
        for jy in range(gsz):
            for dx in range(d):
                for dy in range(d):
                    s[jx * gsz + jy, jx + dx, jy + dy, dx, dy] = 1.0
    return s.reshape(gsz * gsz * pw * pw, d * d)


def _window_geometry(window: SearchWindow2D):
    """Static geometry shared by the per-match and batched matchers."""
    k = window.num_linear
    gsz = ANGLE_GROUP
    half = gsz // 2
    m = k + half
    pw = 2 * m + 1
    n_th = 2 * window.num_angles + 1
    n_groups = -(-n_th // gsz)
    return k, gsz, half, m, pw, n_th, n_groups


def _candidate_thetas(window: SearchWindow2D):
    """Angle offsets for all (padded) candidate slots. Padded slots repeat
    the last real angle: their cells coincide with a real slot's, keeping
    every delta within the +-half bound."""
    _, gsz, _, _, _, n_th, n_groups = _window_geometry(window)
    slot = jnp.minimum(jnp.arange(n_groups * gsz), n_th - 1)
    return (slot.astype(jnp.float32) - window.num_angles) * window.angle_step


def _prep_candidates(meta, pts, initial_pose, window: SearchWindow2D, nx, ny):
    """XLA prep: (flat (G, N) gather indices, delta_lin (T, N) group deltas)."""
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    n_pts = pts.shape[0]
    angles = initial_pose.angle + _candidate_thetas(window)
    # Rotate cloud for every angle candidate: (T, N, 2)
    rotated = rot2(angles[:, None], pts[None, :, :]) + initial_pose.translation[None, None, :]
    base_idx = cell_index(meta, rotated)  # (T, N, 2) int32
    centers = base_idx.reshape(n_groups, gsz, n_pts, 2)[:, half]  # (G, N, 2)
    # Cell delta of each angle vs its group center; the step construction
    # bounds it by `half` per axis (clip guards padded/degenerate clouds).
    delta = jnp.clip(
        base_idx.reshape(n_groups, gsz, n_pts, 2) - centers[:, None], -half, half
    ).reshape(n_groups * gsz, n_pts, 2)
    delta_lin = (delta[..., 0] + half) * gsz + (delta[..., 1] + half)  # (T, N)
    ex, ey = nx + 2 * m, ny + 2 * m
    cx = centers[..., 0] + m
    cy = centers[..., 1] + m
    in_ext = (cx >= 0) & (cx < ex) & (cy >= 0) & (cy < ey)
    flat = jnp.where(in_ext, cx * ey + cy, ex * ey)  # (G, N)
    return flat, delta_lin


def _scores_from_prep(table, flat, delta_lin, valid, n_valid, window: SearchWindow2D):
    """Raw (t_pad, d, d) score volume from prepped gather indices/deltas."""
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    d = 2 * k + 1
    t_pad = n_groups * gsz
    n_pts = flat.shape[-1]
    rows = jnp.take(table, flat, axis=0)  # (G, N, pw*pw) bf16

    # delta-grouped one-hot reduction as a matmul: bucket[g, l, j, :] =
    # sum of rows whose angle g*gsz+l saw cell delta j.
    onehot = (
        delta_lin.reshape(n_groups, gsz, 1, n_pts)
        == jnp.arange(gsz * gsz, dtype=jnp.int32).reshape(1, 1, gsz * gsz, 1)
    )
    weights = (onehot & valid[None, None, None, :]).astype(jnp.bfloat16)
    bucket = jax.lax.dot_general(
        weights.reshape(n_groups, gsz * gsz * gsz, n_pts),
        rows,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # (G, gsz*gsz^2, pw*pw), kept flat for the combine matmul below

    # Each bucket's 7x7 window sits at a static offset inside the 11x11
    # wide patch: candidate cell = center + delta + (dx, dy). One matmul
    # against a static 0/1 selection matrix collapses (delta, wide-lane)
    # pairs onto (dx, dy) score lanes in a single pass over the bucket.
    return jax.lax.dot_general(
        bucket.reshape(n_groups * gsz, gsz * gsz * pw * pw),
        _combine_matrix(k, half),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(t_pad, d, d) / n_valid


@functools.partial(jax.jit, static_argnames=("window",))
def match_correlative_2d(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    window: SearchWindow2D,
    translation_delta_cost_weight,
    rotation_delta_cost_weight,
) -> Tuple[jax.Array, Rigid2]:
    """Exhaustive dense search around initial_pose.

    cloud: points in tracking frame (xy used). Returns (score, pose).
    """
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # a just-finished submap may be uint16
    prob = grid.probability()
    nx, ny = prob.shape
    res = grid.meta.resolution

    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    d = 2 * k + 1
    t_pad = n_groups * gsz
    thetas = _candidate_thetas(window)
    angles = initial_pose.angle + thetas

    pts = cloud.positions[:, :2]
    valid = cloud.mask
    n_pts = pts.shape[0]
    n_valid = jnp.maximum(jnp.sum(valid), 1)

    table = _wide_patch_table(prob, k, half)  # (ex*ey+1, pw*pw)

    flat, delta_lin = _prep_candidates(grid.meta, pts, initial_pose, window, nx, ny)
    scores = _scores_from_prep(table, flat, delta_lin, valid, n_valid, window)

    # Candidate penalty (ref: real_time_correlative_scan_matcher_2d.cc:140-146).
    offs = jnp.arange(-k, k + 1, dtype=jnp.int32)
    dxy = offs.astype(jnp.float32) * res
    dist = jnp.sqrt(dxy[:, None] ** 2 + dxy[None, :] ** 2)  # (Dx, Dy)
    penalty = jnp.exp(
        -(
            (dist[None, :, :] * translation_delta_cost_weight
             + jnp.abs(thetas)[:, None, None] * rotation_delta_cost_weight)
            ** 2
        )
    )
    scores = scores * penalty
    # Padded angle slots duplicate real scores; exclude them from argmax.
    scores = jnp.where((jnp.arange(t_pad) < n_th)[:, None, None], scores, -1.0)

    best = jnp.argmax(scores)
    ti, xi, yi = jnp.unravel_index(best, scores.shape)
    best_pose = Rigid2(
        translation=initial_pose.translation + jnp.stack([dxy[xi], dxy[yi]]),
        angle=angles[ti],
    )
    return scores.reshape(-1)[best], best_pose


def score_volume_dense(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    window: SearchWindow2D,
) -> jax.Array:
    """Straightforward per-cell scoring of the full (theta, dx, dy) volume
    (no penalty). Reference semantics spelled out one candidate cell at a
    time - the cross-check oracle for the grouped matcher."""
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)
    prob = grid.probability()
    nx, ny = prob.shape
    n_th = 2 * window.num_angles + 1
    k = window.num_linear
    thetas = (jnp.arange(n_th, dtype=jnp.float32) - window.num_angles) * window.angle_step
    angles = initial_pose.angle + thetas
    pts = cloud.positions[:, :2]
    valid = cloud.mask
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    rotated = rot2(angles[:, None], pts[None, :, :]) + initial_pose.translation[None, None, :]
    base_idx = cell_index(grid.meta, rotated)  # (T, N, 2)
    out = []
    for dx in range(-k, k + 1):
        row = []
        for dy in range(-k, k + 1):
            cell = base_idx + jnp.array([dx, dy])
            ok = (
                (cell[..., 0] >= 0)
                & (cell[..., 0] < nx)
                & (cell[..., 1] >= 0)
                & (cell[..., 1] < ny)
            )
            v = prob[
                jnp.clip(cell[..., 0], 0, nx - 1), jnp.clip(cell[..., 1], 0, ny - 1)
            ]
            v = jnp.where(ok, v, _UNKNOWN)
            row.append(jnp.sum(jnp.where(valid[None, :], v, 0.0), axis=1) / n_valid)
        out.append(jnp.stack(row, axis=-1))
    return jnp.stack(out, axis=1)  # (T, Dx, Dy)


@functools.partial(jax.jit, static_argnames=("window",))
def match_correlative_2d_batched(
    grid: ProbabilityGrid,
    clouds: PointCloud,
    initial_poses: Rigid2,
    window: SearchWindow2D,
    translation_delta_cost_weight,
    rotation_delta_cost_weight,
):
    """Batched exhaustive search over B independent (cloud, pose) pairs
    against one grid: `match_correlative_2d` vmapped over the batch."""
    return jax.vmap(
        lambda c, p: match_correlative_2d(
            grid, c, p, window,
            translation_delta_cost_weight, rotation_delta_cost_weight,
        )
    )(clouds, initial_poses)

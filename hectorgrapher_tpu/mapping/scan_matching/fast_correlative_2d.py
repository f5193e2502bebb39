"""Loop-closure scan matching in 2D: dense coarse-to-fine with top-k.

Replacement for FastCorrelativeScanMatcher2D
(ref: internal/2d/scan_matching/fast_correlative_scan_matcher_2d.{h,cc} —
PrecomputationGrid2D max-pool stack (:49) + depth-first branch-and-bound
(:112)). Same math, different schedule (SURVEY.md section 7 #3): the
max-pool pyramid provides the identical admissible upper bounds; instead
of data-dependent recursion we evaluate each depth densely for a fixed
top-k candidate set and expand the survivors. With k large relative to
the number of near-optimal basins this finds the same maximum, and every
step is a static-shape batched gather.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.common.device import FastMatchLayout, fast_match_layout
from hectorgrapher_tpu.mapping.grids import ProbabilityGrid, cell_index
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2, rot2


def precompute_pyramid_2d(values, depth: int):
    """Max-pool stack: level d holds max over [x, x+2^d) x [y, y+2^d).

    (ref: PrecomputationGrid2D — same-resolution grids of running maxima
    with widths 1, 2, 4, ... 2^(depth-1).)
    Returns list of arrays, each the same shape as `values`.
    """
    out = [values]
    current = values
    for d in range(1, depth):
        w = 2 ** (d - 1)
        # max of current and current shifted by w in each axis (doubling trick)
        sx = jnp.concatenate([current[w:], jnp.full((w,) + current.shape[1:], -jnp.inf, current.dtype)], axis=0)
        m = jnp.maximum(current, sx)
        sy = jnp.concatenate([m[:, w:], jnp.full(m.shape[:1] + (w,), -jnp.inf, current.dtype)], axis=1)
        current = jnp.maximum(m, sy)
        out.append(current)
    return out


class FastSearchConfig(NamedTuple):
    num_angles: int  # candidates span [-num_angles, num_angles] * angle_step
    angle_step: float
    linear_cells: int  # offsets in [-linear_cells, linear_cells]
    depth: int
    top_k: int


def make_fast_search_config(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
    branch_and_bound_depth: int = 7,
    top_k: int = 256,
) -> FastSearchConfig:
    angle_step = math.acos(
        max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2)))
    )
    num_angles = int(math.ceil(angular_search_window / angle_step))
    linear_cells = int(math.ceil(linear_search_window / resolution))
    depth = max(1, min(branch_and_bound_depth, int(math.log2(max(2 * linear_cells, 2)))))
    return FastSearchConfig(num_angles, angle_step, linear_cells, depth, top_k)


class PreparedFastMatcher2D(NamedTuple):
    """Per-submap precomputation (the reference's SubmapScanMatcher /
    PrecomputationGridStack2D, constraint_builder_2d.cc
    DispatchScanMatcherConstruction): build ONCE per finished submap and
    reuse across every constraint candidate scored against it.

    Each level stores probability MINUS the 0.1 unknown score (so
    out-of-bounds lookups contribute exactly 0 and the score adds 0.1 back
    analytically), with one extra all-zero x-row at index nx that
    out-of-bounds x indices are routed to, in the layout's level dtype."""

    flat_levels: jax.Array  # (depth, nx + 1, ny): prob - 0.1; row nx = 0
    meta: object  # GridMeta
    dims: jax.Array  # (2,) int32


@functools.partial(jax.jit, static_argnames=("depth", "layout"))
def prepare_fast_matcher_2d(
    grid: ProbabilityGrid, depth: int, layout: FastMatchLayout | None = None
) -> PreparedFastMatcher2D:
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    layout = layout or fast_match_layout()
    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    prob = grid.probability()
    pyramid = precompute_pyramid_2d(prob, depth)
    stack = (jnp.stack(pyramid) - 0.1).astype(layout.level_dtype)  # (depth, nx, ny)
    flat_levels = jnp.concatenate(
        [stack, jnp.zeros((depth, 1, prob.shape[1]), stack.dtype)], axis=1
    )
    return PreparedFastMatcher2D(
        flat_levels=flat_levels,
        meta=grid.meta,
        dims=jnp.asarray(prob.shape, jnp.int32),
    )


def match_fast_2d(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    config: FastSearchConfig,
) -> Tuple[jax.Array, Rigid2]:
    """Search the window around initial_pose; returns (score, pose).

    Score is the mean occupancy probability at hit cells (same scale as
    the reference's CandidateScore; min_score gates apply outside).
    """
    return match_fast_2d_prepared(
        prepare_fast_matcher_2d(grid, config.depth), cloud, initial_pose, config
    )


@functools.partial(jax.jit, static_argnames=("config", "layout"))
def match_fast_2d_prepared(
    prepared: PreparedFastMatcher2D,
    cloud: PointCloud,
    initial_pose: Rigid2,
    config: FastSearchConfig,
    layout: FastMatchLayout | None = None,
) -> Tuple[jax.Array, Rigid2]:
    levels = prepared.flat_levels  # (depth, nx+1, ny)
    nx = levels.shape[1] - 1
    ny = levels.shape[2]
    return _match_fast_2d_core(
        levels.reshape(-1, ny),
        jnp.asarray(0, jnp.int32),
        prepared.meta.resolution,
        prepared.meta.min_corner,
        nx,
        ny,
        cloud,
        initial_pose,
        config,
        layout or fast_match_layout(),
    )


def _match_fast_2d_core(
    flat_table: jax.Array,  # (R, ny): stacked (submap, level, x) rows
    row_base,  # int32 scalar: first row of this candidate's submap block
    resolution,
    min_corner,
    nx: int,
    ny: int,
    cloud: PointCloud,
    initial_pose: Rigid2,
    config: FastSearchConfig,
    layout: FastMatchLayout,
) -> Tuple[jax.Array, Rigid2]:
    """Scalar-gather scoring from one shared flat table.

    Score of candidate (t, ox, oy) at pyramid level L =
    mean over valid points of [inside ? level[clamp(idx)] : 0.1], with
    inside = idx in (-2^L, n) per axis — identical semantics to the
    reference's PrecomputationGrid2D bound (negative block starts clamp to
    0 because level[0] pools a superset; fully-outside blocks score the
    0.1 unknown value; at level 0 the 2^0 span degenerates to idx >= 0).

    Schedule: levels store (prob - 0.1) with a zero OOB x-row, so the
    score is 0.1 + sum(contributions)/n_valid, one scalar gather per
    (candidate, point, cell), chunked over points (`layout.point_chunk`)
    so the gathered transient stays bounded.

    The table is passed FLAT with the candidate's submap selected by
    `row_base` folded into the row index rather than by indexing a
    batched operand: under vmap a per-candidate table operand lowers to a
    batched gather that serializes over the batch, while a shared flat
    operand keeps the whole batch in one gather."""
    depth_rows = nx + 1  # rows per level block
    res = resolution

    n_th = 2 * config.num_angles + 1
    thetas = (jnp.arange(n_th, dtype=jnp.float32) - config.num_angles) * config.angle_step
    angles = initial_pose.angle + thetas

    pts = cloud.positions[:, :2]
    valid = cloud.mask
    n_valid = jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)

    rotated = rot2(angles[:, None], pts[None, :, :]) + initial_pose.translation[None, None, :]
    from hectorgrapher_tpu.mapping.grids import GridMeta

    base_idx = cell_index(
        GridMeta(resolution=resolution, min_corner=min_corner), rotated
    )  # (T, N, 2)

    CH = layout.point_chunk
    n_pts = pts.shape[0]
    pad = (-n_pts) % CH
    nch = (n_pts + pad) // CH

    def pad_pts(a, fill):
        if pad:
            a = jnp.concatenate(
                [a, jnp.full(a.shape[:-1] + (pad,), fill, a.dtype)], axis=-1
            )
        return a

    bx = pad_pts(base_idx[..., 0], nx + 1)  # (T, P); pad lands OOB
    by = pad_pts(base_idx[..., 1], ny + 1)
    validp = pad_pts(valid, False)  # (P,)

    def score_sum(level: int, ix, iy, bvalid):
        """Summed (prob - 0.1) contributions.

        ix: (..., P, X) candidate x-indices; iy: (..., P, Y); bvalid: (P,).
        Returns (..., X, Y). Chunked over P so the gathered tensor stays
        bounded."""
        base_row = row_base + level * depth_rows
        span = 2 ** level

        def body(acc, args):
            ixc, iyc, bvc = args  # (..., CH, X), (..., CH, Y), (CH,)
            x_in = (ixc > -span) & (ixc < nx)
            ixg = jnp.where(x_in, jnp.maximum(ixc, 0), nx)
            y_in = (iyc > -span) & (iyc < ny)
            # Clamp (negative starts read cell 0, same as ix) then mark
            # masked-out picks -1.
            iyg = jnp.where(y_in & bvc[:, None], jnp.clip(iyc, 0, ny - 1), -1)
            pick = iyg >= 0  # (..., CH, Y)
            idx = ((base_row + ixg)[..., :, None] * ny
                   + jnp.maximum(iyg, 0)[..., None, :])  # (..., CH, X, Y)
            v = flat_table.reshape(-1)[idx].astype(jnp.float32)
            v = jnp.where(pick[..., :, None, :], v, 0.0)  # (..., CH, X, Y)
            return acc + jnp.sum(v, axis=-3), None

        chunk = lambda a: jnp.moveaxis(
            a.reshape(a.shape[:-2] + (nch, CH, a.shape[-1])), -3, 0
        )
        init = jnp.zeros(ix.shape[:-2] + (ix.shape[-1], iy.shape[-1]), jnp.float32)
        acc, _ = jax.lax.scan(
            body, init, (chunk(ix), chunk(iy), validp.reshape(nch, CH))
        )
        return acc

    k = config.top_k
    lc = config.linear_cells
    stride = 2 ** (config.depth - 1)

    # Coarse stage: all angles x the dense stride-2^(depth-1) offset grid,
    # one row gather per (angle, point, x-offset) serving every y-offset.
    n_blocks = 2 * ((lc + stride - 1) // stride) + 1
    block_off = (jnp.arange(n_blocks, dtype=jnp.int32) - n_blocks // 2) * stride - stride // 2
    ix0 = bx[:, :, None] + block_off[None, None, :]  # (T, P, J)
    iy0 = by[:, :, None] + block_off[None, None, :]
    s0 = score_sum(config.depth - 1, ix0, iy0, validp)  # (T, J, J)
    scores = 0.1 + s0.reshape(-1) / n_valid
    tt, bxg, byg = jnp.meshgrid(
        jnp.arange(n_th, dtype=jnp.int32), block_off, block_off, indexing="ij"
    )
    cand_t = tt.reshape(-1)
    cand_ox = bxg.reshape(-1)
    cand_oy = byg.reshape(-1)

    def top(cands, scores, k):
        kk = min(k, scores.shape[0])
        s, i = jax.lax.top_k(scores, kk)
        return tuple(c[i] for c in cands), s

    (cand_t, cand_ox, cand_oy), scores = top((cand_t, cand_ox, cand_oy), scores, k)

    # Coarse-to-fine: expand each survivor into its 2x2 children at half
    # stride — 2 x-rows per (parent, point), 2 y-picks per row.
    for level in range(config.depth - 2, -1, -1):
        half = 2 ** level
        dxy = jnp.array([0, half], jnp.int32)
        cxs = jnp.clip(cand_ox[:, None] + dxy, -lc, lc)  # (K, 2)
        cys = jnp.clip(cand_oy[:, None] + dxy, -lc, lc)  # (K, 2)
        bxk = bx[cand_t]  # (K, P)
        byk = by[cand_t]
        ix = bxk[:, :, None] + cxs[:, None, :]  # (K, P, 2)
        iy = byk[:, :, None] + cys[:, None, :]
        s = score_sum(level, ix, iy, validp)  # (K, 2, 2): [x0y0 x0y1; x1y0 x1y1]
        kk = cand_t.shape[0]
        ct = jnp.repeat(cand_t, 4)
        cx = jnp.broadcast_to(cxs[:, :, None], (kk, 2, 2)).reshape(-1)
        cy = jnp.broadcast_to(cys[:, None, :], (kk, 2, 2)).reshape(-1)
        (cand_t, cand_ox, cand_oy), scores = top(
            (ct, cx, cy), 0.1 + s.reshape(-1) / n_valid, k
        )

    best = jnp.argmax(scores)
    dx = cand_ox[best].astype(jnp.float32) * res
    dy = cand_oy[best].astype(jnp.float32) * res
    pose = Rigid2(
        translation=initial_pose.translation + jnp.stack([dx, dy]),
        angle=angles[cand_t[best]],
    )
    return scores[best], pose

"""Gauss-Newton 2D scan-match refinement.

Replacement for CeresScanMatcher2D
(ref: internal/2d/scan_matching/ceres_scan_matcher_2d.cc — occupied-space
cost via bicubic interpolation, occupied_space_cost_function_2d.cc:47-74;
TSDF cost via InterpolatedTSDF2D, tsdf_match_cost_function_2d.cc; plus
translation/rotation delta penalties).

The LM loop here is specialized for grid matching: ONE wide patch row
(the 4x4 bicubic neighborhood widened by SLACK cells per side) is
gathered per point at the initial pose, and every LM iteration — current
AND trial cost, gradient, Jacobian — is evaluated from the carried rows
by scattering the 4-tap cubic weights to the pose's shifted base cell
inside the wide row. Zero gathers inside the iteration loop (one wide
row per point replaces a 16-tap gather per point per iteration). Exact as long as the refinement moves the base cell by
at most SLACK cells per axis — GN refinement starts within half a cell
of the correlative optimum and is pulled to the target by the
translation penalty, so SLACK=3 cells (0.15 m at 5 cm) bounds it with
a wide margin; beyond that the lookup clamps to the patch border. The
Jacobian is written out analytically — identical values to jacfwd of
the residual, since floor() has zero derivative.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.grids import ProbabilityGrid, TSDFGrid
from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
    gather_rows_2d,
    prepare_field_2d_wide,
)

_GN_SLACK = 3  # carried-row slack cells per side (0.15 m at 5 cm)
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2, rot2


def _solve3_sym(a, g):
    """Solve the symmetric 3x3 system a @ x = g via the adjugate (no LU)."""
    a00, a01, a02 = a[0, 0], a[0, 1], a[0, 2]
    a11, a12, a22 = a[1, 1], a[1, 2], a[2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    x0 = (c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv_det
    x1 = (c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv_det
    x2 = (c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv_det
    return jnp.stack([x0, x1, x2])


def _catmull(d):
    """Catmull-Rom convolution kernel K(d) and K'(d), supported on |d|<2.

    Evaluating K directly at every wide-patch lane offset is the
    fusion-friendly form of "scatter the 4 cubic weights at the shifted
    base cell": the weights live only as elementwise math inside the row
    contraction — no (N, W, 4) one-hot (tiny batched matmul) and no
    (N, W, W) outer-product intermediate (whose (8, 128) tile padding
    costs a ~10x HBM blowup if materialized). K at integer-offset lanes
    equals _cubic_weights of the fractional part exactly."""
    t = jnp.abs(d)
    k_near = ((1.5 * t - 2.5) * t) * t + 1.0
    k_far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    k = jnp.where(t < 1.0, k_near, jnp.where(t < 2.0, k_far, 0.0))
    dk_near = (4.5 * t - 5.0) * t
    dk_far = (-1.5 * t + 5.0) * t - 4.0
    dk = jnp.sign(d) * jnp.where(t < 1.0, dk_near, jnp.where(t < 2.0, dk_far, 0.0))
    return k, dk


def _lm_grid_2d(
    value_of_rows,
    gather_fn,
    pts,
    valid,
    scale,
    initial_pose: Rigid2,
    target_translation,
    translation_weight,
    rotation_weight,
    meta,
    num_iterations: int,
    slack: int = _GN_SLACK,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    function_tolerance: float = 1e-6,
):
    """Wide-carried-rows LM over (tx, ty, theta) against a prepared field.

    value_of_rows(rows, w) -> (value, dval_scale) where `value` is the
    per-point match residual before `scale` and dval_scale gates the
    derivative (0 where the residual is hard-gated). gather_fn(world)
    returns the pytree of (N, (4+2*slack)^2) wide rows for world xy
    positions — called exactly ONCE, at the initial pose.

    Termination mirrors Ceres (the reference's solver): at most
    num_iterations (ceres_solver_options.max_num_iterations,
    trajectory_builder_2d.lua:51), stopping early once an accepted step
    decreases the cost by less than function_tolerance * cost (Ceres
    default 1e-6). Under vmap the loop runs until every lane converges;
    converged lanes are frozen.
    """
    theta0 = initial_pose.angle
    res = meta.resolution
    width = 4 + 2 * slack
    # Pin f32: weights arrive as weak f64 under the x64 test config.
    scale = jnp.asarray(scale, jnp.float32)
    translation_weight = jnp.asarray(translation_weight, jnp.float32)
    rotation_weight = jnp.asarray(rotation_weight, jnp.float32)
    target_translation = jnp.asarray(target_translation, jnp.float32)

    def world_of(pose):
        return rot2(pose.angle, pts) + pose.translation

    rows = gather_fn(world_of(initial_pose))
    i0_init = jnp.floor(
        (world_of(initial_pose) - meta.min_corner) / res - 0.5
    ).astype(jnp.int32)
    # Patch-local lane coordinates, flat (dx-major) to match the patch
    # channel order; the patch's (0, 0) lane holds cell i0_init - 1 - slack.
    lane = jnp.arange(width * width, dtype=jnp.int32)
    lane_x = (lane // width).astype(jnp.float32)[None, :]
    lane_y = (lane % width).astype(jnp.float32)[None, :]
    base = (i0_init - (1 + slack)).astype(jnp.float32)  # (N, 2)

    def lane_weights(pose):
        """w, dwx, dwy over the flat wide lanes at the pose's positions —
        pure elementwise math that fuses into the row contractions.
        Unused outputs are dead-code-eliminated per call site."""
        u = (world_of(pose) - meta.min_corner) / res - 0.5
        kx, dkx = _catmull((u[..., 0] - base[..., 0])[:, None] - lane_x)
        ky, dky = _catmull((u[..., 1] - base[..., 1])[:, None] - lane_y)
        return kx * ky, dkx * ky, kx * dky

    def terms(pose):
        w, _, _ = lane_weights(pose)
        value, dgate = value_of_rows(rows, w)
        r_occ = jnp.where(valid, value, 0.0) * scale
        dt = pose.translation - target_translation
        dth = pose.angle - theta0
        cost = 0.5 * (
            jnp.sum(r_occ * r_occ)
            + translation_weight**2 * jnp.sum(dt * dt)
            + rotation_weight**2 * dth * dth
        )
        aux = (dgate, dt, dth)
        return cost, r_occ, aux

    def jacobian(pose, r_occ, aux):
        dgate, dt, dth = aux
        # d value / d frac via the separable kernel derivatives.
        _, dwx16, dwy16 = lane_weights(pose)
        dv_dfx, dv_dfy = value_grad_rows(rows, dwx16, dwy16)
        gate = jnp.where(valid, dgate, 0.0) * scale
        dv_dfx = dv_dfx * gate
        dv_dfy = dv_dfy * gate
        # d frac / d pose: u = (R p + t - min)/res - 0.5.
        dp_dth = rot2(pose.angle + jnp.pi / 2.0, pts)  # dR/dtheta @ p
        j_tx = dv_dfx / res
        j_ty = dv_dfy / res
        j_th = (dv_dfx * dp_dth[..., 0] + dv_dfy * dp_dth[..., 1]) / res
        jocc = jnp.stack([j_tx, j_ty, j_th], axis=-1)  # (N, 3)
        jtj = jocc.T @ jocc
        g = jocc.T @ r_occ
        tw2 = translation_weight**2
        rw2 = rotation_weight**2
        jtj = jtj + jnp.diag(jnp.stack([tw2, tw2, rw2]))
        g = g + jnp.concatenate([tw2 * dt, (rw2 * dth)[None]])
        return jtj, g

    # value_grad_rows is supplied by the caller through a closure on
    # value_of_rows' structure; defined below per cost type.
    value_grad_rows = value_of_rows.grad_rows

    def cond(carry):
        it, done, *_ = carry
        return (it < num_iterations) & ~done

    def step(carry):
        # The current pose's residuals/aux are CARRIED from the iteration
        # that accepted it (terms() per iteration: one for the trial, none
        # for the incumbent — one fewer full row pass).
        it, done, pose, lam, cost, r_occ, aux = carry
        jtj, g = jacobian(pose, r_occ, aux)
        diag = jnp.diagonal(jtj)
        damped = jtj + lam * jnp.diag(jnp.maximum(diag, 1e-12)) + 1e-12 * jnp.eye(3, dtype=jtj.dtype)
        delta = -_solve3_sym(damped, g)
        pose_new = Rigid2(translation=pose.translation + delta[:2], angle=pose.angle + delta[2])
        cost_new, r_occ_new, aux_new = terms(pose_new)
        # ~done freezes converged lanes under vmap (a batched launch runs
        # until every lane converges; a frozen lane must return exactly
        # what the serial solve would have).
        accept = (cost_new < cost) & ~done
        lam_next = jnp.where(accept, jnp.maximum(lam * 0.33, min_lambda), jnp.minimum(lam * 4.0, max_lambda))
        x_norm = jnp.sqrt(jnp.sum(pose.translation**2) + pose.angle**2)
        done_next = (
            done
            | (accept & (cost - cost_new <= function_tolerance * cost))
            | (jnp.linalg.norm(delta) <= 1e-7 * (x_norm + 1e-7))
        )
        sel = lambda a, b: jnp.where(accept, b, a)
        return (
            it + 1,
            done_next,
            jax.tree.map(sel, pose, pose_new),
            lam_next,
            jnp.where(accept, cost_new, cost),
            jax.tree.map(sel, r_occ, r_occ_new),
            jax.tree.map(sel, aux, aux_new),
        )

    cost0, r_occ0, aux0 = terms(initial_pose)
    carry = jax.lax.while_loop(
        cond,
        step,
        (
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            initial_pose,
            jnp.asarray(init_lambda, jnp.float32),
            cost0,
            r_occ0,
            aux0,
        ),
    )
    return carry[2], carry[4]


class _ProbabilityCost:
    """Occupied-space residual: 1 - P(T p) (ref: occupied_space_cost_
    function_2d.cc:47-74)."""

    def __call__(self, rows, w16):
        value = 1.0 - jnp.sum(rows * w16, axis=-1)
        return value, jnp.ones((), jnp.float32)

    @staticmethod
    def grad_rows(rows, dwx16, dwy16):
        # d(1 - sum rows*w)/dfrac = -sum rows*dw.
        return -jnp.sum(rows * dwx16, axis=-1), -jnp.sum(rows * dwy16, axis=-1)


class _TsdfCost:
    """Weight-gated TSD residual (ref: tsdf_match_cost_function_2d.cc:30,74;
    cells never observed carry no signal)."""

    def __call__(self, rows, w16):
        tsd_rows, w_rows = rows
        tsd = jnp.sum(tsd_rows * w16, axis=-1)
        w = jnp.sum(w_rows * w16, axis=-1)
        gate = jnp.where(w > 1e-6, 1.0, 0.0)
        return tsd * gate, gate

    @staticmethod
    def grad_rows(rows, dwx16, dwy16):
        tsd_rows, _ = rows
        return jnp.sum(tsd_rows * dwx16, axis=-1), jnp.sum(tsd_rows * dwy16, axis=-1)


@jax.jit
def prepare_gn_probability_field(grid: ProbabilityGrid):
    """Wide carried-row field for repeated probability-grid refinement.

    Build once per grid VERSION and amortize across matches against it —
    the analog of the reference's per-submap precomputation grids."""
    from hectorgrapher_tpu.mapping import probability_values as pv
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    return prepare_field_2d_wide(
        grid.probability(), grid.meta, pv.MIN_PROBABILITY, _GN_SLACK
    )


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def _match_gn_2d_probability_field(
    prepared,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    num_iterations: int = 20,
) -> Tuple[Rigid2, jax.Array]:
    valid = cloud.mask
    n = jnp.maximum(jnp.sum(valid), 1)
    pts = cloud.positions[:, :2]
    scale = occupied_space_weight / jnp.sqrt(n.astype(jnp.float32))
    pose, cost = _lm_grid_2d(
        _ProbabilityCost(),
        lambda world: gather_rows_2d(prepared, world),
        pts,
        valid,
        scale,
        initial_pose,
        target_translation,
        translation_weight,
        rotation_weight,
        prepared.meta,
        num_iterations,
    )
    return pose, cost


def match_gn_2d_probability(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    num_iterations: int = 20,
) -> Tuple[Rigid2, jax.Array]:
    """Refine pose against an occupancy grid.

    Residuals (ref: ceres_scan_matcher_2d.cc:84-120):
      * occupied space: w_o/sqrt(N) * (1 - P(T p_i)) per point
      * translation: w_t * (t - target_translation)
      * rotation: w_r * (theta - theta0)
    """
    return _match_gn_2d_probability_field(
        prepare_gn_probability_field(grid),
        cloud,
        initial_pose,
        target_translation,
        occupied_space_weight,
        translation_weight,
        rotation_weight,
        num_iterations=num_iterations,
    )


@jax.jit
def prepare_gn_tsdf_fields(grid: TSDFGrid):
    """Wide carried-row (tsd, weight) fields for repeated TSDF refinement
    (build once per grid version; see prepare_gn_probability_field)."""
    from hectorgrapher_tpu.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    return (
        prepare_field_2d_wide(grid.tsd, grid.meta, grid.truncation_distance, _GN_SLACK),
        prepare_field_2d_wide(grid.weight, grid.meta, 0.0, _GN_SLACK),
    )


def match_gn_2d_tsdf(
    grid: TSDFGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    num_iterations: int = 20,
) -> Tuple[Rigid2, jax.Array]:
    """Refine pose against a 2D TSDF (ref: tsdf_match_cost_function_2d.cc —
    residual is the interpolated TSD at each transformed point)."""
    return _match_gn_2d_tsdf_fields(
        prepare_gn_tsdf_fields(grid), cloud, initial_pose, target_translation,
        occupied_space_weight, translation_weight, rotation_weight,
        num_iterations=num_iterations,
    )


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def _match_gn_2d_tsdf_fields(
    fields,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    num_iterations: int = 20,
) -> Tuple[Rigid2, jax.Array]:
    tsd_field, weight_field = fields
    valid = cloud.mask
    n = jnp.maximum(jnp.sum(valid), 1)
    pts = cloud.positions[:, :2]
    scale = occupied_space_weight / jnp.sqrt(n.astype(jnp.float32))
    pose, cost = _lm_grid_2d(
        _TsdfCost(),
        lambda world: (
            gather_rows_2d(tsd_field, world),
            gather_rows_2d(weight_field, world),
        ),
        pts,
        valid,
        scale,
        initial_pose,
        target_translation,
        translation_weight,
        rotation_weight,
        tsd_field.meta,
        num_iterations,
    )
    return pose, cost


# ---------------------------------------------------------------------------
# Batched refinement
# ---------------------------------------------------------------------------


def match_gn_2d_probability_batched(
    grid,
    clouds: PointCloud,
    initial_poses: Rigid2,
    target_translations,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    num_iterations: int = 20,
    prepared_field=None,
):
    """Batched CeresScanMatcher2D refinement over B independent matches.

    vmap over the carried-rows LM; the while-loop termination runs until
    every match in the batch converges (Ceres function_tolerance
    semantics, see _lm_grid_2d). Pass prepared_field (from
    prepare_gn_probability_field) to amortize the wide-row field across
    calls against the same grid version."""
    if prepared_field is None:
        prepared_field = prepare_gn_probability_field(grid)
    return jax.vmap(
        lambda cl, ip, tt: _match_gn_2d_probability_field(
            prepared_field, cl, ip, tt,
            occupied_space_weight, translation_weight, rotation_weight,
            num_iterations=num_iterations,
        ),
        in_axes=(0, 0, 0),
    )(clouds, initial_poses, target_translations)


def match_gn_2d_fields_batched(
    stacked_fields,
    clouds: PointCloud,
    initial_poses: Rigid2,
    target_translations,
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    is_tsdf: bool,
    num_iterations: int = 20,
):
    """Batched refinement where every match targets a DIFFERENT submap.

    stacked_fields: the per-submap prepared fields (from
    prepare_gn_probability_field / prepare_gn_tsdf_fields) stacked leaf-wise
    with a leading batch axis — the loop-closure fan-out shape: one
    (node, submap) refinement per lane (ref: constraint_builder_2d.cc
    ComputeConstraint's ceres_scan_matcher_.Match, one thread-pool task per
    candidate; here one vmap lane each). Converged lanes freeze
    (see _lm_grid_2d), so each lane returns the serial solve's result."""
    fn = _match_gn_2d_tsdf_fields if is_tsdf else _match_gn_2d_probability_field
    return jax.vmap(
        lambda f, cl, ip, tt: fn(
            f, cl, ip, tt,
            occupied_space_weight, translation_weight, rotation_weight,
            num_iterations=num_iterations,
        ),
        in_axes=(0, 0, 0, 0),
    )(stacked_fields, clouds, initial_poses, target_translations)


def _gather_wide_from_values(values, min_corner, resolution, world, pad_value,
                             slack: int = _GN_SLACK):
    """Wide (N, (4+2*slack)^2) rows gathered DIRECTLY from a raw (nx, ny)
    grid — the same rows prepare_field_2d_wide tabulates, without the
    per-submap 100x table blowup. Used by the loop-closure fan-out, where
    every candidate refines against a different submap: packing all
    finished submaps' wide tables device-resident would cost ~26 MB each
    (vs 0.26 MB raw), and re-stacking tables per round dominated the
    production constraint round. Element gathers instead of row gathers
    cost ~w^2 more gather rows, but only for ONE gather per solve (rows
    are carried across LM iterations)."""
    nx, ny = values.shape
    w = 4 + 2 * slack
    u = (world - min_corner) / resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32) - (1 + slack)  # (N, 2) patch corner
    lane = jnp.arange(w * w, dtype=jnp.int32)
    ix = i0[..., 0:1] + (lane // w)[None, :]
    iy = i0[..., 1:2] + (lane % w)[None, :]
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = jnp.where(ok, ix * ny + iy, 0)
    rows = values.reshape(-1)[flat]
    return jnp.where(ok, rows.astype(jnp.float32), pad_value)


def _gather_wide_from_flat(flat_values, base, nx, ny, min_corner, resolution,
                           world, pad_value, slack: int = _GN_SLACK):
    """_gather_wide_from_values with the submap selected by a row OFFSET
    into one shared flat table instead of a per-candidate operand: under
    vmap a per-candidate table lowers to a batch-serialized gather."""
    w = 4 + 2 * slack
    u = (world - min_corner) / resolution - 0.5
    i0 = jnp.floor(u).astype(jnp.int32) - (1 + slack)  # (N, 2) patch corner
    lane = jnp.arange(w * w, dtype=jnp.int32)
    ix = i0[..., 0:1] + (lane // w)[None, :]
    iy = i0[..., 1:2] + (lane % w)[None, :]
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = jnp.where(ok, base + ix * ny + iy, 0)
    rows = flat_values[flat]
    return jnp.where(ok, rows.astype(jnp.float32), pad_value)


@functools.partial(jax.jit, static_argnames=("is_tsdf", "num_iterations"))
def match_gn_2d_packed_grids(
    values_stack,  # (S_pad, nx, ny) probability or tsd values
    weight_stack,  # (S_pad, nx, ny) tsdf weights (any 1-submap slice if not tsdf)
    min_corners,  # (S_pad, 2)
    resolution,  # scalar f32
    pad_value,  # scalar f32: MIN_PROBABILITY or truncation_distance
    slots,  # (C,) int32 — submap slot per candidate
    clouds: PointCloud,  # (C, N, 3)/(C, N)
    initial_poses: Rigid2,  # (C, ...) batched
    target_translations,  # (C, 2)
    occupied_space_weight,
    translation_weight,
    rotation_weight,
    is_tsdf: bool,
    num_iterations: int = 20,
):
    """Batched refinement against a device-resident RAW grid pack.

    The loop-closure round's GN stage (ref: constraint_builder_2d.cc
    ComputeConstraint's ceres_scan_matcher_.Match, one thread-pool task
    per candidate): one vmap lane per surviving candidate, each gathering
    its wide rows from its own submap's slot in the pack. The pack is the
    GN analog of PackedSubmaps2D — built incrementally as submaps finish,
    reused by every round, so a round uploads only poses and slot ids."""
    from hectorgrapher_tpu.mapping.grids import GridMeta

    S, nx, ny = values_stack.shape
    flat_vals = values_stack.reshape(-1)
    flat_wts = weight_stack.reshape(-1)

    def one(slot, clp, clm, it, ia, tt):
        mc = min_corners[slot]
        base = slot * (nx * ny)
        if is_tsdf:
            gather = lambda world: (
                _gather_wide_from_flat(flat_vals, base, nx, ny, mc, resolution, world, pad_value),
                _gather_wide_from_flat(flat_wts, base, nx, ny, mc, resolution, world, 0.0),
            )
            cost = _TsdfCost()
        else:
            gather = lambda world: _gather_wide_from_flat(
                flat_vals, base, nx, ny, mc, resolution, world, pad_value
            )
            cost = _ProbabilityCost()
        n = jnp.maximum(jnp.sum(clm), 1)
        scale = occupied_space_weight / jnp.sqrt(n.astype(jnp.float32))
        return _lm_grid_2d(
            cost,
            gather,
            clp[:, :2],
            clm,
            scale,
            Rigid2(translation=it, angle=ia),
            tt,
            translation_weight,
            rotation_weight,
            GridMeta(resolution=resolution, min_corner=mc),
            num_iterations,
        )

    return jax.vmap(one)(
        slots,
        clouds.positions,
        clouds.mask,
        initial_poses.translation,
        initial_poses.angle,
        target_translations,
    )

"""Gauss-Newton 3D scan-match refinement.

Replacement for CeresScanMatcher3D
(ref: internal/3d/scan_matching/ceres_scan_matcher_3d.{h,cc} — per-grid
weighted occupied-space/TSDF costs over the {high, low} resolution pair,
translation/rotation delta penalties, quaternion parameterization,
optional only_optimize_yaw).

Like gn_2d, the LM loop carries the gathered trilinear patch rows across
iterations (one gather pass per iteration) and computes the grid-residual
Jacobian analytically — identical values to jacfwd, since the gather
index (floor) has zero derivative. The small delta-penalty blocks keep
autodiff.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
    PreparedTsdf3D,
    gather_rows_3d,
    prepare_grid_3d,
    prob_value_and_dfrac,
    tsdf_value_and_dfrac,
)
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import (
    Rigid3,
    quat_conjugate,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_axis_angle,
)


def _gather(prepared, world, base=0):
    """(N, 4, 128) z-segment stencil rows for one grid at world positions.

    `base` offsets the row indices into a shared flat table of stacked
    per-submap blocks (the packed batched path — a per-lane table operand
    under vmap batch-serializes the gather, so the table is shared and the
    submap is folded into the index, like the fast-matcher pyramids)."""
    from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
        _PROB_SEG,
        _TSDF_SEG,
        _stencil_3d,
    )

    seg = _TSDF_SEG if isinstance(prepared, PreparedTsdf3D) else _PROB_SEG
    rows, _, _, _ = _stencil_3d(prepared, world, seg)
    return prepared.table[base + rows]


def _value_and_dfrac(prepared, rows, world):
    """Match-cost value (N,) and its d/dfrac (N, 3) from carried rows.

    Identical to autodiff of value_at_prepared_3d: the weight gate's
    derivative is zero a.e., and the gathered rows are constants."""
    if isinstance(prepared, PreparedTsdf3D):
        return tsdf_value_and_dfrac(prepared, rows, world)
    return prob_value_and_dfrac(prepared, rows, world)


def _meta_of(prepared):
    return prepared.meta


def _skew_apply(p, world_rot):
    """Columns of -R [p]x: dworld/dtheta for right-multiplied boxplus.
    world_rot(v) applies R(q). Returns (N, 3, 3): [..., i, k] = d world_i /
    d theta_k."""
    # d world / d theta_k = R (e_k x p) = -R (p x e_k)
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32), p.shape)
    ey = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), p.shape)
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), p.shape)
    cols = [world_rot(jnp.cross(e, p)) for e in (ex, ey, ez)]
    return jnp.stack(cols, axis=-1)  # (N, 3, 3)


@functools.partial(jax.jit, static_argnames=("num_iterations", "only_optimize_yaw"))
def match_gn_3d(
    high_grid,
    low_grid,
    high_cloud: PointCloud,
    low_cloud: PointCloud,
    initial_pose: Rigid3,
    target_translation,
    occupied_space_weight_0,
    occupied_space_weight_1,
    translation_weight,
    rotation_weight,
    num_iterations: int = 10,
    only_optimize_yaw: bool = False,
) -> Tuple[Rigid3, jax.Array]:
    """Refine pose against the high/low-resolution grid pair."""
    return _match_gn_3d_core(
        prepare_grid_3d(high_grid), prepare_grid_3d(low_grid), 0, 0,
        high_cloud, low_cloud, initial_pose, target_translation,
        occupied_space_weight_0, occupied_space_weight_1,
        translation_weight, rotation_weight,
        num_iterations=num_iterations, only_optimize_yaw=only_optimize_yaw,
    )


def _match_gn_3d_core(
    prepared_hi,
    prepared_lo,
    base_hi,  # int32: row offset of this lane's submap block in the table
    base_lo,
    high_cloud: PointCloud,
    low_cloud: PointCloud,
    initial_pose: Rigid3,
    target_translation,
    occupied_space_weight_0,
    occupied_space_weight_1,
    translation_weight,
    rotation_weight,
    num_iterations: int = 10,
    only_optimize_yaw: bool = False,
) -> Tuple[Rigid3, jax.Array]:
    n_hi = jnp.maximum(jnp.sum(high_cloud.mask), 1).astype(jnp.float32)
    n_lo = jnp.maximum(jnp.sum(low_cloud.mask), 1).astype(jnp.float32)
    q0 = initial_pose.rotation
    translation_weight = jnp.asarray(translation_weight, jnp.float32)
    rotation_weight = jnp.asarray(rotation_weight, jnp.float32)
    target_translation = jnp.asarray(target_translation, jnp.float32)
    s_hi = jnp.asarray(occupied_space_weight_0, jnp.float32) / jnp.sqrt(n_hi)
    s_lo = jnp.asarray(occupied_space_weight_1, jnp.float32) / jnp.sqrt(n_lo)

    if only_optimize_yaw:
        # (ref: ceres_scan_matcher_3d yaw-only parameterization)
        fixed = jnp.asarray([False, False, False, True, True, False])
    else:
        fixed = jnp.zeros(6, bool)

    def world_of(pose, pts):
        return quat_rotate(pose.rotation[None, :], pts) + pose.translation[None, :]

    def gather_all(pose):
        return (
            _gather(prepared_hi, world_of(pose, high_cloud.positions), base_hi),
            _gather(prepared_lo, world_of(pose, low_cloud.positions), base_lo),
        )

    def penalty_residual(pose):
        trans = translation_weight * (pose.translation - target_translation)
        dq = quat_multiply(quat_conjugate(q0), pose.rotation)
        rot = rotation_weight * quat_to_axis_angle(dq)
        return jnp.concatenate([trans, rot])

    def grid_terms(pose, rows, prepared, cloud, scale):
        world = world_of(pose, cloud.positions)
        val, dval_dfrac = _value_and_dfrac(prepared, rows, world)
        r = jnp.where(cloud.mask, val, 0.0) * scale
        return r, dval_dfrac

    def cost_at(pose, rows_hi, rows_lo):
        r_hi, _ = grid_terms(pose, rows_hi, prepared_hi, high_cloud, s_hi)
        r_lo, _ = grid_terms(pose, rows_lo, prepared_lo, low_cloud, s_lo)
        pen = penalty_residual(pose)
        return 0.5 * (jnp.sum(r_hi * r_hi) + jnp.sum(r_lo * r_lo) + jnp.sum(pen * pen))

    def grid_jacobian(pose, rows, prepared, cloud, scale):
        r, dval_dfrac = grid_terms(pose, rows, prepared, cloud, scale)
        res = _meta_of(prepared).resolution
        # d frac / d world = 1/res; d world/dt = I; d world/dtheta = R(e_k x p).
        dv = dval_dfrac * (jnp.where(cloud.mask, 1.0, 0.0) * scale)[..., None] / res  # (N,3)
        rot_cols = _skew_apply(cloud.positions, lambda v: quat_rotate(pose.rotation[None, :], v))
        j_t = dv  # (N, 3)
        j_r = jnp.einsum("ni,nik->nk", dv, rot_cols)  # (N, 3)
        return r, jnp.concatenate([j_t, j_r], axis=-1)  # (N, 6)

    def cond(carry):
        it, done = carry[0], carry[1]
        return (it < num_iterations) & ~done

    def step(carry):
        # Ceres-style function_tolerance termination (see gn_2d).
        it, done, pose, lam, rows_hi, rows_lo, cost = carry
        r_hi, J_hi = grid_jacobian(pose, rows_hi, prepared_hi, high_cloud, s_hi)
        r_lo, J_lo = grid_jacobian(pose, rows_lo, prepared_lo, low_cloud, s_lo)

        def pen_of(delta6):
            p = Rigid3(
                translation=pose.translation + delta6[:3],
                rotation=quat_normalize(quat_multiply(pose.rotation, quat_from_axis_angle(delta6[3:6]))),
            )
            return penalty_residual(p)

        z6 = jnp.zeros(6, jnp.float32)
        r_pen = pen_of(z6)
        J_pen = jax.jacfwd(pen_of)(z6)

        J = jnp.concatenate([J_hi, J_lo, J_pen], axis=0)
        r = jnp.concatenate([r_hi, r_lo, r_pen])
        J = jnp.where(fixed[None, :], 0.0, J)
        jtj = J.T @ J
        g = J.T @ r

        diag = jnp.diagonal(jtj)
        damped = jtj + lam * jnp.diag(jnp.maximum(diag, 1e-12)) + 1e-12 * jnp.eye(6, dtype=jtj.dtype)
        delta = -jnp.linalg.solve(damped, g)
        delta = jnp.where(fixed, 0.0, delta)
        pose_new = Rigid3(
            translation=pose.translation + delta[:3],
            rotation=quat_normalize(quat_multiply(pose.rotation, quat_from_axis_angle(delta[3:6]))),
        )
        rows_hi_new, rows_lo_new = gather_all(pose_new)
        cost_new = cost_at(pose_new, rows_hi_new, rows_lo_new)
        # ~done freezes converged lanes under vmap (see gn_2d).
        accept = (cost_new < cost) & ~done
        lam_next = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-10), jnp.minimum(lam * 4.0, 1e6))
        sel = lambda a, b: jnp.where(accept, b, a)
        pose_next = jax.tree.map(sel, pose, pose_new)
        rows_hi_next = jax.tree.map(sel, rows_hi, rows_hi_new)
        rows_lo_next = jax.tree.map(sel, rows_lo, rows_lo_new)
        cost_next = jnp.where(accept, cost_new, cost)
        x_norm = jnp.sqrt(jnp.sum(pose.translation**2) + 1.0)  # unit quat
        done_next = (
            done
            | (accept & (cost - cost_new <= 1e-6 * cost))
            | (jnp.linalg.norm(delta) <= 1e-7 * (x_norm + 1e-7))
        )
        return (it + 1, done_next, pose_next, lam_next, rows_hi_next, rows_lo_next, cost_next)

    rows_hi0, rows_lo0 = gather_all(initial_pose)
    cost0 = cost_at(initial_pose, rows_hi0, rows_lo0)
    carry = jax.lax.while_loop(
        cond,
        step,
        (
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            initial_pose,
            jnp.asarray(1e-4, jnp.float32),
            rows_hi0,
            rows_lo0,
            cost0,
        ),
    )
    return carry[2], carry[6]


def match_gn_3d_batched(
    high_grids,
    low_grids,
    high_clouds: PointCloud,
    low_clouds: PointCloud,
    initial_poses: Rigid3,
    target_translations,
    occupied_space_weight_0,
    occupied_space_weight_1,
    translation_weight,
    rotation_weight,
    num_iterations: int = 10,
):
    """Batched CeresScanMatcher3D refinement, one (node, submap) candidate
    per lane — grids stacked leaf-wise with a leading batch axis so every
    lane refines against its OWN submap pair (ref: constraint_builder_3d.cc
    ComputeConstraint:258-269, one thread-pool task per candidate).
    Converged lanes freeze, so per-lane results equal the serial solve.

    NOTE: each lane materializes its own prepared interpolation table —
    fine at test extents, prohibitive at the production 256^3 grids where
    one table is ~168 MB. Production callers use the packed path
    (prepare_gn_pack_3d + match_gn_3d_packed), which prepares each
    DISTINCT submap once and row-gathers from a shared flat table."""
    return jax.vmap(
        lambda hg, lg, hc, lc, ip, tt: match_gn_3d(
            hg, lg, hc, lc, ip, tt,
            occupied_space_weight_0, occupied_space_weight_1,
            translation_weight, rotation_weight,
            num_iterations=num_iterations,
        ),
        in_axes=(0, 0, 0, 0, 0, 0),
    )(high_grids, low_grids, high_clouds, low_clouds, initial_poses, target_translations)


@jax.jit
def _prepare_pack_3d_jit(grids_d):
    """vmap-prepare D stacked grids -> batched prepared pytree."""
    return jax.vmap(prepare_grid_3d)(grids_d)


def prepare_gn_pack_3d(grids_d):
    """Prepare D DISTINCT submap grids (stacked leaf-wise, possibly in
    their uint16 finished form) for the packed batched GN refine.

    Returns (flat_table, template, min_corners, rows_per_submap):
    flat_table (D*R, 128) f32 stacked per-submap prepared blocks (each
    block ends in its own pad row, so local OOB indices stay in-block);
    template is a prepared NamedTuple carrying the shared scalar fields
    (resolution, dims, truncation) with a dummy table; min_corners (D, 3).
    The f32 tables are round transients — steady-state HBM keeps only the
    compact raw pack (ref: constraint_builder_3d.cc keeps per-submap
    scan-matcher state; we additionally dedup per distinct submap)."""
    prepared = _prepare_pack_3d_jit(grids_d)
    table = prepared.table  # (D, R, 128)
    r = int(table.shape[1])
    flat = table.reshape(-1, table.shape[-1])
    tmpl = jax.tree.map(lambda x: x[0], prepared)
    tmpl = tmpl._replace(table=jnp.zeros((1, table.shape[-1]), jnp.float32))
    mc = prepared.meta.min_corner  # (D, 3)
    return flat, tmpl, mc, r


@functools.partial(
    jax.jit, static_argnames=("r_hi", "r_lo", "num_iterations")
)
def match_gn_3d_packed(
    flat_hi,  # (D*R_hi, 128) shared prepared hi tables
    flat_lo,  # (D*R_lo, 128)
    tmpl_hi,  # prepared template (shared resolution/dims/truncation)
    tmpl_lo,
    mc_hi,  # (D, 3) per-distinct-submap min corners
    mc_lo,
    lane_d,  # (B,) int32: distinct-submap index of each candidate lane
    high_clouds: PointCloud,  # (B, N, 3)
    low_clouds: PointCloud,
    initial_poses: Rigid3,
    target_translations,
    occupied_space_weight_0,
    occupied_space_weight_1,
    translation_weight,
    rotation_weight,
    r_hi: int = 0,
    r_lo: int = 0,
    num_iterations: int = 10,
):
    """Packed batched refine: every lane row-gathers from ONE shared flat
    table pair (submap folded into the row index), so HBM holds each
    distinct submap's prepared table once regardless of the lane count —
    the production-extent replacement for match_gn_3d_batched."""

    def one(mch, mcl, bh, bl, hc, lc, ip, tt):
        ph = tmpl_hi._replace(
            table=flat_hi, meta=tmpl_hi.meta._replace(min_corner=mch)
        )
        pl = tmpl_lo._replace(
            table=flat_lo, meta=tmpl_lo.meta._replace(min_corner=mcl)
        )
        return _match_gn_3d_core(
            ph, pl, bh, bl, hc, lc, ip, tt,
            occupied_space_weight_0, occupied_space_weight_1,
            translation_weight, rotation_weight,
            num_iterations=num_iterations,
        )

    return jax.vmap(one)(
        mc_hi[lane_d], mc_lo[lane_d], lane_d * r_hi, lane_d * r_lo,
        high_clouds, low_clouds, initial_poses, target_translations,
    )

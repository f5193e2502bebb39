"""Continuous-time sliding-window optimization: the jitted core.

Replacement for the Ceres problem built per window by
OptimizingLocalTrajectoryBuilder (ref: mapping/internal/3d/
optimizing_local_trajectory_builder.cc MaybeOptimize:1114-1290 and the
cost functors under internal/3d/scan_matching/):

  * scan-match residuals per cloud against the matching submap's
    high/low-resolution grids, with the cloud pose slerp/lerp-interpolated
    between its two bracketing control points
    (AddPerScanMatchingResiduals:323-511, interpolated_tsdf_space_cost_
    function_3d.h, interpolated_occupied_space_cost_function_3d.h)
  * IMU residuals in the reference's ACTIVE preintegration form
    (prediction_imu_preintegration_cost_functor.h:27 — NOTE: the full
    preintegration terms are commented out upstream; the live code uses
    constant-velocity translation error, velocity-difference error, and
    the gyro-preintegrated rotation delta. We implement the live form,
    with the full form available via use_full_preintegration.)
  * odometry relative-pose residuals with adaptive weights
    (AddOdometryResiduals:1009-1074, relative_translation_and_yaw_cost_
    function.h)
  * first control point frozen; quaternion manifold via the LM solver's
    retraction (:1268-1281).

All shapes are static: K control points, C clouds, P/Pl points per cloud,
masked. One solve is one XLA program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.mapping.grids import ProbabilityGrid, TSDFGrid
from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
    PreparedTsdf3D,
    gather_rows_3d,
    prepare_grid_3d,
    prob_value_and_dfrac,
    probability_at_3d,
    tsd_at_3d_weighted,
    tsdf_value_and_dfrac,
    value_at_prepared_3d,
)
from hectorgrapher_tpu.solvers.gauss_newton import levenberg_marquardt
from hectorgrapher_tpu.transform.rigid import (
    Rigid3,
    quat_conjugate,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_slerp,
    quat_to_axis_angle,
)


class CtState(NamedTuple):
    """Batched control-point states (ref: internal/3d/state.h State)."""

    translation: jax.Array  # (K, 3)
    rotation: jax.Array  # (K, 4) wxyz
    velocity: jax.Array  # (K, 3)


class CtProblem(NamedTuple):
    """Static-shape window problem; device arrays, masks for validity."""

    # Control points
    cp_mask: jax.Array  # (K,) bool — valid control points
    cp_times: jax.Array  # (K,) f32 — control point times (window-relative)
    # Clouds
    cloud_mask: jax.Array  # (C,) bool
    cloud_prev: jax.Array  # (C,) int32 — bracketing CP indices
    cloud_next: jax.Array  # (C,)
    cloud_factor: jax.Array  # (C,) f32 interpolation factor in [0, 1]
    cloud_time: jax.Array  # (C,) f32 — window-relative scan end times
    hi_points: jax.Array  # (C, P, 3) tracking-frame points
    hi_mask: jax.Array  # (C, P)
    hi_times: jax.Array  # (C, P) per-point relative times (<= 0)
    lo_points: jax.Array  # (C, Pl, 3)
    lo_mask: jax.Array  # (C, Pl)
    lo_times: jax.Array  # (C, Pl)
    # IMU per consecutive CP pair i-1 -> i (index i-1 in (K-1,) arrays)
    pair_mask: jax.Array  # (K-1,) bool — both CPs valid
    pair_dt: jax.Array  # (K-1,)
    imu_delta_rotation: jax.Array  # (K-1, 4) gyro-preintegrated
    imu_delta_velocity: jax.Array  # (K-1, 3) accel-preintegrated (full form)
    imu_delta_translation: jax.Array  # (K-1, 3) (full form)
    # Odometry per pair
    odom_mask: jax.Array  # (K-1,) bool
    odom_delta_translation: jax.Array  # (K-1, 3) — prev^-1 * cur, fwd delta
    odom_delta_rotation: jax.Array  # (K-1, 4)
    odom_translation_weight: jax.Array  # (K-1,)
    odom_rotation_weight: jax.Array  # (K-1,)


class CtWeights(NamedTuple):
    high_resolution_grid_weight: jax.Array
    low_resolution_grid_weight: jax.Array
    translation_weight: jax.Array
    velocity_weight: jax.Array
    rotation_weight: jax.Array


class DirectImuData(NamedTuple):
    """Raw (calibrated) IMU samples per CP pair for the DIRECT cost term
    (ref: prediction_direct_imu_integration_cost_functor.h — the functor
    re-integrates the IMU inside the residual, so the prediction is a
    function of the START control point's state and gets differentiated
    through). Samples are ZOH-resampled onto M uniform sub-steps per pair
    on the host so shapes stay static; masked pairs carry dt == 0."""

    dt: jax.Array  # (K-1, M) sub-step durations, 0 where inactive
    gyro: jax.Array  # (K-1, M, 3) calibrated angular velocity
    accel: jax.Array  # (K-1, M, 3) calibrated linear acceleration
    gravity: jax.Array  # () scalar, m/s^2


def _integrate_direct(t, q, v, dts, gyro, accel, gravity):
    """Euler/ZOH state integration through one pair's sub-steps; runs inside
    the residual so jacfwd differentiates through it (the DIRECT term's
    defining property)."""
    g_vec = gravity * jnp.array([0.0, 0.0, 1.0], jnp.float32)

    def step(carry, x):
        t_, q_, v_ = carry
        dt, w, a = x
        q_ = quat_normalize(quat_multiply(q_, quat_from_axis_angle(w * dt)))
        v_ = v_ + (quat_rotate(q_, a) - g_vec) * dt
        t_ = t_ + v_ * dt
        return (t_, q_, v_), None

    (t, q, v), _ = jax.lax.scan(step, (t, q, v), (dts, gyro, accel))
    return t, q, v


def interpolate_pose(state: CtState, prev_idx, next_idx, factor) -> Rigid3:
    """Pose at interpolation factor between two control points, batched."""
    t0 = state.translation[prev_idx]
    t1 = state.translation[next_idx]
    q0 = state.rotation[prev_idx]
    q1 = state.rotation[next_idx]
    return Rigid3(
        translation=t0 + factor[..., None] * (t1 - t0),
        rotation=quat_slerp(q0, q1, factor),
    )


def _rpy_of_quat(q):
    """Roll/pitch/yaw residual components (ref: transform.h GetRoll/GetPitch/
    GetYaw applied to the error pose). For small errors these approximate
    2*vec(q); we use the exact angle extraction to match the reference."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def per_point_brackets(problem: CtProblem, times):
    """Per-point bracketing control points + interpolation factors.

    times: (C, P) relative point times. Absolute point time = cloud_time +
    relative time; the bracketing pair comes from searchsorted over the
    (masked) control-point times — the dense form of the reference's
    per-point control-point walk (AddPerPointMatchingResiduals,
    optimizing_local_trajectory_builder.cc:513-926, which subdivides
    clouds only to economize on CPU; per-point slerp is free here.)
    """
    k = problem.cp_times.shape[0]
    cp_t = jnp.where(problem.cp_mask, problem.cp_times, jnp.inf)
    abs_t = problem.cloud_time[:, None] + times  # (C, P)
    nxt = jnp.clip(jnp.searchsorted(cp_t, abs_t, side="right"), 1, k - 1).astype(jnp.int32)
    prv = nxt - 1
    t0 = cp_t[prv]
    t1 = cp_t[nxt]
    factor = jnp.clip((abs_t - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)
    factor = jnp.where(jnp.isfinite(factor), factor, 0.0)
    return prv, nxt, factor


def make_ct_residual(
    high_grid, low_grid, problem: CtProblem, weights: CtWeights, is_tsdf: bool,
    per_point: bool = False, direct: Optional[DirectImuData] = None,
):
    """Build the residual function over CtState for this window."""

    n_hi = jnp.maximum(jnp.sum(problem.hi_mask, axis=1), 1).astype(jnp.float32)  # (C,)
    n_lo = jnp.maximum(jnp.sum(problem.lo_mask, axis=1), 1).astype(jnp.float32)

    def scan_residuals(state: CtState):
        if per_point:
            hi_prv, hi_nxt, hi_f = per_point_brackets(problem, problem.hi_times)
            lo_prv, lo_nxt, lo_f = per_point_brackets(problem, problem.lo_times)
            hi_poses = interpolate_pose(state, hi_prv, hi_nxt, hi_f)  # (C, P, ...)
            lo_poses = interpolate_pose(state, lo_prv, lo_nxt, lo_f)
            hi_world = quat_rotate(hi_poses.rotation, problem.hi_points) + hi_poses.translation
            lo_world = quat_rotate(lo_poses.rotation, problem.lo_points) + lo_poses.translation
        else:
            poses = interpolate_pose(state, problem.cloud_prev, problem.cloud_next, problem.cloud_factor)

            def world(points):
                # points: (C, P, 3); poses batched over C
                return quat_rotate(poses.rotation[:, None, :], points) + poses.translation[:, None, :]

            hi_world = world(problem.hi_points)
            lo_world = world(problem.lo_points)
        if is_tsdf:
            hi_val, hi_w = tsd_at_3d_weighted(high_grid, hi_world)
            lo_val, lo_w = tsd_at_3d_weighted(low_grid, lo_world)
            # Unobserved cells carry no signal (weight gate).
            hi_val = jnp.where(hi_w > 1e-6, hi_val, 0.0)
            lo_val = jnp.where(lo_w > 1e-6, lo_val, 0.0)
        else:
            hi_val = 1.0 - probability_at_3d(high_grid, hi_world)
            lo_val = 1.0 - probability_at_3d(low_grid, lo_world)

        hi_scale = (
            weights.high_resolution_grid_weight / jnp.sqrt(n_hi) * problem.cloud_mask
        )[:, None]
        lo_scale = (
            weights.low_resolution_grid_weight / jnp.sqrt(n_lo) * problem.cloud_mask
        )[:, None]
        hi_r = jnp.where(problem.hi_mask, hi_val, 0.0) * hi_scale
        lo_r = jnp.where(problem.lo_mask, lo_val, 0.0) * lo_scale
        return hi_r.reshape(-1), lo_r.reshape(-1)

    def imu_residuals(state: CtState):
        """(ref: prediction_imu_preintegration_cost_functor.h live code, or
        prediction_direct_imu_integration_cost_functor.h when `direct`.)"""
        t0 = state.translation[:-1]
        t1 = state.translation[1:]
        v0 = state.velocity[:-1]
        v1 = state.velocity[1:]
        q0 = state.rotation[:-1]
        q1 = state.rotation[1:]
        dt = problem.pair_dt[:, None]

        if direct is not None:
            pt, pq, pv = jax.vmap(_integrate_direct, in_axes=(0, 0, 0, 0, 0, 0, None))(
                t0, q0, v0, direct.dt, direct.gyro, direct.accel, direct.gravity
            )
            translation_error = t1 - pt
            velocity_error = v1 - pv
            rotation_error = quat_multiply(quat_conjugate(q1), pq)[..., 1:]
        else:
            translation_error = t1 - t0 - dt * v0
            velocity_error = v1 - v0
            # rotation_error = q1^-1 * q0 * delta_rotation, vector part
            err_q = quat_multiply(quat_multiply(quat_conjugate(q1), q0), problem.imu_delta_rotation)
            rotation_error = err_q[..., 1:]

        m = problem.pair_mask[:, None]
        r = jnp.concatenate(
            [
                weights.translation_weight * translation_error * m,
                weights.velocity_weight * velocity_error * m,
                weights.rotation_weight * rotation_error * m,
            ],
            axis=-1,
        )
        return r.reshape(-1)

    def odom_residuals(state: CtState):
        """(ref: relative_translation_and_yaw_cost_function.h — error =
        (start^-1 end)^-1 * odom_delta, translation + roll/pitch/yaw)."""
        t0 = state.translation[:-1]
        t1 = state.translation[1:]
        q0 = state.rotation[:-1]
        q1 = state.rotation[1:]
        # start^-1 * end (forward delta of the estimate)
        rel_q = quat_multiply(quat_conjugate(q0), q1)
        rel_t = quat_rotate(quat_conjugate(q0), t1 - t0)
        # error = rel^-1 * odom_delta
        err_q = quat_multiply(quat_conjugate(rel_q), problem.odom_delta_rotation)
        err_t = quat_rotate(quat_conjugate(rel_q), problem.odom_delta_translation - rel_t)
        m = problem.odom_mask[:, None]
        r = jnp.concatenate(
            [
                problem.odom_translation_weight[:, None] * err_t * m,
                problem.odom_rotation_weight[:, None] * _rpy_of_quat(err_q) * m,
            ],
            axis=-1,
        )
        return r.reshape(-1)

    def residual(state: CtState):
        hi_r, lo_r = scan_residuals(state)
        return jnp.concatenate([hi_r, lo_r, imu_residuals(state), odom_residuals(state)])

    return residual


def ct_retract(state: CtState, delta) -> CtState:
    """Tangent (K*9,) -> state: [dt(3), dtheta(3), dv(3)] per control point."""
    k = state.translation.shape[0]
    d = delta.reshape(k, 9)
    return CtState(
        translation=state.translation + d[:, 0:3],
        rotation=quat_normalize(
            quat_multiply(state.rotation, quat_from_axis_angle(d[:, 3:6]))
        ),
        velocity=state.velocity + d[:, 6:9],
    )


def _cp_state(state: CtState, idx):
    return state.translation[idx], state.rotation[idx], state.velocity[idx]


def _retract_one(t, q, v, d9):
    return (
        t + d9[:3],
        quat_normalize(quat_multiply(q, quat_from_axis_angle(d9[3:6]))),
        v + d9[6:9],
    )


def _dquat_rotate_dq(q, p):
    """d(R(q) p)/dq as a free 4-vector (..., 3, 4), wxyz convention;
    q (..., 4) broadcasts against p (..., 3).

    R(q)p = (w^2 - v.v) p + 2 (v.p) v + 2 w (v x p); exact for tangents
    orthogonal to q (guaranteed: the pose chain ends in quat_normalize,
    whose jacobian projects onto the unit-sphere tangent space)."""
    w = q[..., 0:1]
    v = q[..., 1:4]
    vxp = jnp.cross(jnp.broadcast_to(v, p.shape), p)
    dw = 2.0 * (w * p + vxp)  # (..., 3)
    vdotp = jnp.sum(jnp.broadcast_to(v, p.shape) * p, axis=-1, keepdims=True)
    cols = [dw]
    eye = jnp.eye(3, dtype=p.dtype)
    for i in range(3):
        e = eye[i]
        cols.append(
            -2.0 * q[..., 1 + i : 2 + i] * p
            + 2.0 * p[..., i : i + 1] * v
            + 2.0 * vdotp * e
            + 2.0 * w * jnp.cross(jnp.broadcast_to(e, p.shape), p)
        )
    return jnp.stack(cols, axis=-1)  # (..., 3, 4)


def make_ct_block_families(prepared_hi, prepared_lo, problem: CtProblem, weights: CtWeights, is_tsdf: bool,
                           direct: Optional[DirectImuData] = None, per_point: bool = False):
    """Block-structured residual/Jacobian families for the window solve.

    Every residual block touches exactly TWO control points, so Jacobians
    live on an 18-dim local tangent and scatter-assemble into the K*9-dim
    normal equations. The scan blocks (the heavy path: grid row gathers +
    lane mixing over C*P points) use ANALYTIC Jacobians — value gradient
    from the carried-rows helpers chained through d(world)/d(pose) and a
    tiny jacfwd d(pose)/d(tangent18) — so the row math runs once per
    evaluation instead of once per tangent direction. The small pair
    blocks (IMU + odometry) keep jacfwd.
    """
    n_hi = jnp.maximum(jnp.sum(problem.hi_mask, axis=1), 1).astype(jnp.float32)
    n_lo = jnp.maximum(jnp.sum(problem.lo_mask, axis=1), 1).astype(jnp.float32)

    value_and_dfrac = tsdf_value_and_dfrac if is_tsdf else prob_value_and_dfrac

    if per_point:
        # Per-point unwarping (ref: AddPerPointMatchingResiduals,
        # optimizing_local_trajectory_builder.cc:513-926): every point is
        # its own scalar residual block bracketed by ITS control-point
        # pair at its own timestamp. Same analytic-Jacobian scheme as the
        # per-scan blocks; the tiny pose jacfwd runs per point (the grid
        # row math still runs once per evaluation).
        hi_prv, hi_nxt, hi_f = per_point_brackets(problem, problem.hi_times)
        lo_prv, lo_nxt, lo_f = per_point_brackets(problem, problem.lo_times)

        def _quat_of(qp, qn, f, d6):
            q0 = quat_multiply(qp, quat_from_axis_angle(d6[:3]))
            q1 = quat_multiply(qn, quat_from_axis_angle(d6[3:6]))
            return quat_normalize(quat_slerp(q0, q1, f))

        def point_scan_block(state: CtState):
            def part(points, mask, prv, nxt, f, prepared, scale_per_cloud):
                P = points.shape[1]
                pts = points.reshape(-1, 3)
                m = mask.reshape(-1)
                prv_, nxt_, f_ = prv.reshape(-1), nxt.reshape(-1), f.reshape(-1)
                sm = jnp.where(m, jnp.repeat(scale_per_cloud, P), 0.0)
                tp_, qp_ = state.translation[prv_], state.rotation[prv_]
                tn_, qn_ = state.translation[nxt_], state.rotation[nxt_]
                # Pose jacobian wrt the 18-dim pair tangent, with AD only
                # where it earns its keep: the interpolated translation is
                # linear in the translation tangents ((1-f) I / f I), the
                # velocity columns are zero, and only the 6 rotation dims
                # go through jacfwd (retract -> slerp -> normalize). The
                # former full-18-dual jacfwd tripled the per-point dual
                # chain for columns with closed forms.
                z6 = jnp.zeros(6, jnp.float32)
                pose_q = jax.vmap(_quat_of, in_axes=(0, 0, 0, None))(qp_, qn_, f_, z6)
                dq6 = jax.vmap(jax.jacfwd(_quat_of, argnums=3), in_axes=(0, 0, 0, None))(
                    qp_, qn_, f_, z6
                )  # (N, 4, 6)
                pose_t = tp_ + f_[:, None] * (tn_ - tp_)
                world = quat_rotate(pose_q, pts) + pose_t
                rows = gather_rows_3d(prepared, world)
                val, dval_dfrac = value_and_dfrac(prepared, rows, world)
                dval_dworld = dval_dfrac / prepared.meta.resolution  # (N, 3)
                dval_dq = jnp.einsum("ni,nij->nj", dval_dworld, _dquat_rotate_dq(pose_q, pts))
                Jrot = jnp.einsum("nq,nqk->nk", dval_dq, dq6)  # (N, 6)
                zeros3 = jnp.zeros_like(dval_dworld)
                J = jnp.concatenate(
                    [
                        (1.0 - f_)[:, None] * dval_dworld, Jrot[:, :3], zeros3,
                        f_[:, None] * dval_dworld, Jrot[:, 3:6], zeros3,
                    ],
                    axis=1,
                ) * sm[:, None]
                return J, val * sm, prv_

            hi_scale = weights.high_resolution_grid_weight / jnp.sqrt(n_hi) * problem.cloud_mask
            lo_scale = weights.low_resolution_grid_weight / jnp.sqrt(n_lo) * problem.cloud_mask
            outs = [
                part(problem.hi_points, problem.hi_mask, hi_prv, hi_nxt, hi_f,
                     prepared_hi, hi_scale),
                part(problem.lo_points, problem.lo_mask, lo_prv, lo_nxt, lo_f,
                     prepared_lo, lo_scale),
            ]
            # Pre-reduce by bracket pair (nxt == prv + 1 by construction):
            # segment-summing the 18x18 outer products collapses N scalar
            # blocks to K-1 pair blocks BEFORE the one-hot projection — at
            # production per-point cardinality a per-block (N, 18, D)
            # one-hot would be an O(points x tangent) HBM blowup.
            k1 = problem.cp_times.shape[0] - 1
            S = jnp.zeros((k1, 18, 18), jnp.float32)
            gb = jnp.zeros((k1, 18), jnp.float32)
            cost = 0.0
            for J, r, seg in outs:
                # One-hot batched matmul instead of segment_sum: k1 is
                # tiny (#CP pairs), so masking J into (k1, N, 18) and
                # batch-matmuling against (N, 18) is one dense reduction
                # with no scatter.
                onehot = (seg[:, None] == jnp.arange(k1)[None, :]).astype(J.dtype)
                Jk = onehot.T[:, :, None] * J[None, :, :]  # (k1, N, 18)
                S = S + jnp.einsum("kni,nj->kij", Jk, J)
                gb = gb + jnp.einsum("kni,n->ki", Jk, r)
                cost = cost + 0.5 * jnp.sum(r * r)
            pairs = jnp.arange(k1)
            idx = jnp.concatenate(
                [
                    (pairs * 9)[:, None] + jnp.arange(9)[None, :],
                    ((pairs + 1) * 9)[:, None] + jnp.arange(9)[None, :],
                ],
                axis=1,
            )
            return S, gb, cost, idx

    else:
        point_scan_block = None

    def scan_block(state: CtState):
        """Per-cloud residuals + Jacobians wrt (prev, next) CP tangents."""

        def one(ci):
            p_idx = problem.cloud_prev[ci]
            n_idx = problem.cloud_next[ci]
            tp, qp, vp = _cp_state(state, p_idx)
            tn, qn, vn = _cp_state(state, n_idx)
            f = problem.cloud_factor[ci]
            hi_scale = weights.high_resolution_grid_weight / jnp.sqrt(n_hi[ci]) * problem.cloud_mask[ci]
            lo_scale = weights.low_resolution_grid_weight / jnp.sqrt(n_lo[ci]) * problem.cloud_mask[ci]

            def pose_of(d18):
                t0, q0, _ = _retract_one(tp, qp, vp, d18[:9])
                t1, q1, _ = _retract_one(tn, qn, vn, d18[9:])
                pose_t = t0 + f * (t1 - t0)
                pose_q = quat_normalize(quat_slerp(q0, q1, f))
                return jnp.concatenate([pose_t, pose_q])

            z = jnp.zeros(18, jnp.float32)
            pose7 = pose_of(z)
            dpose7 = jax.jacfwd(pose_of)(z)  # (7, 18) — tiny
            pose_t, pose_q = pose7[:3], pose7[3:]

            def grid_part(prepared, pts, mask, scale):
                world = quat_rotate(pose_q[None, :], pts) + pose_t[None, :]
                rows = gather_rows_3d(prepared, world)
                val, dval_dfrac = value_and_dfrac(prepared, rows, world)
                sm = jnp.where(mask, scale, 0.0)
                dval_dworld = dval_dfrac / prepared.meta.resolution  # (P, 3)
                dval_dq = jnp.einsum("ni,nij->nj", dval_dworld, _dquat_rotate_dq(pose_q, pts))
                dval_dpose7 = jnp.concatenate([dval_dworld, dval_dq], axis=-1)
                return val * sm, (dval_dpose7 @ dpose7) * sm[:, None]

            hi_r, hi_J = grid_part(prepared_hi, problem.hi_points[ci], problem.hi_mask[ci], hi_scale)
            lo_r, lo_J = grid_part(prepared_lo, problem.lo_points[ci], problem.lo_mask[ci], lo_scale)
            return jnp.concatenate([hi_J, lo_J], axis=0), jnp.concatenate([hi_r, lo_r])

        J, r = jax.vmap(one)(jnp.arange(problem.cloud_prev.shape[0]))
        idx = jnp.concatenate(
            [
                (problem.cloud_prev * 9)[:, None] + jnp.arange(9)[None, :],
                (problem.cloud_next * 9)[:, None] + jnp.arange(9)[None, :],
            ],
            axis=1,
        )
        return J, r, idx

    def pair_block(state: CtState):
        """Per-CP-pair IMU + odometry residuals (15 per pair) wrt the two
        CP tangents."""

        def one(pi):
            ta, qa, va = _cp_state(state, pi)
            tb, qb, vb = _cp_state(state, pi + 1)
            dt = problem.pair_dt[pi]
            m_imu = problem.pair_mask[pi]
            m_odom = problem.odom_mask[pi]

            def local(d18):
                t0, q0, v0 = _retract_one(ta, qa, va, d18[:9])
                t1, q1, v1 = _retract_one(tb, qb, vb, d18[9:])
                if direct is not None:
                    # DIRECT: integrate raw IMU from the START state inside
                    # the residual (differentiated through).
                    pt, pq, pv = _integrate_direct(
                        t0, q0, v0, direct.dt[pi], direct.gyro[pi], direct.accel[pi], direct.gravity
                    )
                    translation_error = t1 - pt
                    velocity_error = v1 - pv
                    rot_vec = quat_multiply(quat_conjugate(q1), pq)[1:]
                else:
                    # IMU (live preintegration form)
                    translation_error = t1 - t0 - dt * v0
                    velocity_error = v1 - v0
                    rot_vec = quat_multiply(
                        quat_multiply(quat_conjugate(q1), q0), problem.imu_delta_rotation[pi]
                    )[1:]
                imu_r = jnp.concatenate(
                    [
                        weights.translation_weight * translation_error,
                        weights.velocity_weight * velocity_error,
                        weights.rotation_weight * rot_vec,
                    ]
                ) * m_imu
                # Odometry relative pose
                rel_q = quat_multiply(quat_conjugate(q0), q1)
                rel_t = quat_rotate(quat_conjugate(q0), t1 - t0)
                oerr_q = quat_multiply(quat_conjugate(rel_q), problem.odom_delta_rotation[pi])
                oerr_t = quat_rotate(quat_conjugate(rel_q), problem.odom_delta_translation[pi] - rel_t)
                odom_r = jnp.concatenate(
                    [
                        problem.odom_translation_weight[pi] * oerr_t,
                        problem.odom_rotation_weight[pi] * _rpy_of_quat(oerr_q),
                    ]
                ) * m_odom
                return jnp.concatenate([imu_r, odom_r])

            z = jnp.zeros(18, jnp.float32)
            return jax.jacfwd(local)(z), local(z)

        pairs = jnp.arange(problem.pair_mask.shape[0])
        J, r = jax.vmap(one)(pairs)
        idx = jnp.concatenate(
            [
                (pairs * 9)[:, None] + jnp.arange(9)[None, :],
                ((pairs + 1) * 9)[:, None] + jnp.arange(9)[None, :],
            ],
            axis=1,
        )
        return J, r, idx

    return (point_scan_block if per_point else scan_block), pair_block


def _make_ct_assemble(prepared_hi, prepared_lo, problem: CtProblem,
                      weights: CtWeights, is_tsdf: bool, D: int,
                      direct: Optional[DirectImuData] = None,
                      per_point: bool = False):
    """Closure assembling the window's dense normal equations (JtJ, g, cost)
    at a state — shared by the LM solver and exposed through
    ct_normal_equations for Jacobian-parity testing."""
    scan_block, pair_block = make_ct_block_families(
        prepared_hi, prepared_lo, problem, weights, is_tsdf, direct=direct,
        per_point=per_point,
    )

    def assemble(state):
        JtJ = jnp.zeros((D, D), jnp.float32)
        g = jnp.zeros((D,), jnp.float32)
        cost = 0.0
        for fam in (scan_block(state), pair_block(state)):
            # Dense one-hot projection instead of scatter-add: E maps each
            # block's 18-dim tangent into the D-dim layout; JtJ += E^T S E
            # runs as a dense matmul and vmaps cleanly (batched scatters serialize,
            # which wrecked solve_ct_window_batched at larger batches).
            # Families come either raw (J, r, idx) or pre-reduced
            # (S, g_blk, cost_blk, idx) — the per-point family segment-sums
            # its scalar blocks into K-1 pair blocks first.
            if len(fam) == 4:
                S, gb, cb, idx = fam
            else:
                J, r, idx = fam
                S = jnp.einsum("cri,crj->cij", J, J)
                gb = jnp.einsum("cri,cr->ci", J, r)
                cb = 0.5 * jnp.sum(r * r)
            E = (idx[:, :, None] == jnp.arange(D)[None, None, :]).astype(jnp.float32)
            JtJ = JtJ + jnp.einsum("cid,cij,cje->de", E, S, E)
            g = g + jnp.einsum("cid,ci->d", E, gb)
            cost = cost + cb
        return JtJ, g, cost

    return assemble


@functools.partial(jax.jit, static_argnames=("is_tsdf", "per_point"))
def ct_normal_equations(
    high_grid,
    low_grid,
    problem: CtProblem,
    state: CtState,
    weights: CtWeights,
    is_tsdf: bool,
    per_point: bool = False,
    direct: Optional[DirectImuData] = None,
):
    """(JtJ, g, cost) of the window at `state` on the K*9 tangent —
    the analytic-Jacobian block assembly's output, for parity checks
    against jacfwd of the dense residual (tests/test_ct_window.py)."""
    D = 9 * state.translation.shape[0]
    assemble = _make_ct_assemble(
        prepare_grid_3d(high_grid), prepare_grid_3d(low_grid),
        problem, weights, is_tsdf, D, direct=direct, per_point=per_point,
    )
    return assemble(state)


@functools.partial(jax.jit, static_argnames=("is_tsdf", "num_iterations", "per_point"))
def solve_ct_window_block(
    high_grid,
    low_grid,
    problem: CtProblem,
    state0: CtState,
    weights: CtWeights,
    is_tsdf: bool,
    num_iterations: int = 12,
    direct: Optional[DirectImuData] = None,
    per_point: bool = False,
):
    """Block-assembled LM solve of the window.

    Per-scan mode: one 18-dim block per cloud. Per-point mode: one scalar
    block per point, bracketed by its own control-point pair (the
    reference's AddPerPointMatchingResiduals). Both use analytic scan
    Jacobians and dense matmul normal-equation assembly.
    """
    k = state0.translation.shape[0]
    D = 9 * k
    # Materialize the interpolation tables ONCE per solve.
    prepared_hi = prepare_grid_3d(high_grid)
    prepared_lo = prepare_grid_3d(low_grid)
    assemble = _make_ct_assemble(
        prepared_hi, prepared_lo, problem, weights, is_tsdf, D,
        direct=direct, per_point=per_point,
    )

    per_cp_fixed = ~problem.cp_mask
    per_cp_fixed = per_cp_fixed.at[0].set(True)
    fixed = jnp.repeat(per_cp_fixed, 9)

    def cost_of(state):
        return assemble(state)[2]

    # Shared carried-evaluation LM driver (one assembly per iteration,
    # Ceres-style termination — the reference drives this solve through
    # Ceres, optimizing_local_trajectory_builder.cc).
    from hectorgrapher_tpu.mapping.pose_graph.optimization import _lm_drive

    def eval_fn(state):
        JtJ, g, cost = assemble(state)
        JtJ = jnp.where(fixed[:, None] | fixed[None, :], 0.0, JtJ)
        g = jnp.where(fixed, 0.0, g)
        return (JtJ, g), cost

    def delta_of(quant, lam):
        JtJ, g = quant
        diag = jnp.diag(JtJ)
        damped = JtJ + jnp.diag(lam * jnp.maximum(diag, 1e-12) + 1e-12) + jnp.diag(fixed.astype(jnp.float32))
        return jnp.where(fixed, 0.0, -jnp.linalg.solve(damped, g))

    initial_cost = cost_of(state0)
    state, final_cost = _lm_drive(
        eval_fn, delta_of, ct_retract, state0, num_iterations,
        init_lambda=1e-4, max_lambda=1e6,
    )
    return state, final_cost, initial_cost


@functools.partial(jax.jit, static_argnames=("is_tsdf", "num_iterations", "per_point"))
def solve_ct_window(
    high_grid,
    low_grid,
    problem: CtProblem,
    state0: CtState,
    weights: CtWeights,
    is_tsdf: bool,
    num_iterations: int = 12,
    per_point: bool = False,
    direct: Optional[DirectImuData] = None,
):
    """Solve the window; returns (CtState, final_cost, initial_cost).

    Both modes dispatch to the block-assembled solver; per-point mode uses
    one scalar residual block per point with its own bracketing pair."""
    return solve_ct_window_block(
        high_grid, low_grid, problem, state0, weights,
        is_tsdf=is_tsdf, num_iterations=num_iterations, direct=direct,
        per_point=per_point,
    )


@functools.partial(
    jax.jit, static_argnames=("is_tsdf", "num_iterations", "per_point")
)
def solve_ct_window_batched(
    high_grids,
    low_grids,
    problems: CtProblem,
    states0: CtState,
    weights: CtWeights,
    is_tsdf: bool,
    num_iterations: int = 12,
    per_point: bool = False,
    directs: Optional[DirectImuData] = None,
):
    """vmapped window solve over a leading batch axis — the multi-robot
    server operating point (many trajectories, one chip). Amortizes the
    per-solve fixed costs (table build bandwidth, dispatch, the 72x72
    damped solves become one batched LU) exactly like the batched 2D
    matcher; grids must share shapes (bucket by submap configuration).
    All pytree leaves of every argument except `weights` carry a leading
    batch dim; weights are shared. per_point=True and DIRECT-IMU payloads
    (`directs`, batched DirectImuData) batch the accuracy-flagship modes
    (ref: optimizing_local_trajectory_builder.cc:513-926)."""
    if directs is None:
        return jax.vmap(
            lambda h, l, p, s: solve_ct_window_block(
                h, l, p, s, weights, is_tsdf=is_tsdf,
                num_iterations=num_iterations, per_point=per_point,
            )
        )(high_grids, low_grids, problems, states0)
    return jax.vmap(
        lambda h, l, p, s, d: solve_ct_window_block(
            h, l, p, s, weights, is_tsdf=is_tsdf,
            num_iterations=num_iterations, per_point=per_point, direct=d,
        )
    )(high_grids, low_grids, problems, states0, directs)


@jax.jit
def unwarp_and_accumulate(
    state: CtState,
    optimized_pose_t,
    optimized_pose_q,
    points,  # (C, P, 3) tracking-frame raw points of marginalized clouds
    mask,  # (C, P)
    prev_idx,  # (C,)
    next_idx,  # (C,)
    factor,  # (C,)
):
    """Transform marginalized clouds into the frame of the optimized pose.

    (ref: MaybeOptimize :1383-1407 — cloud pose interpolated between its
    bracketing control points, then optimized_pose^-1 * transform applied.)
    Returns (C, P, 3) points in the tracking frame of optimized_pose.
    """
    poses = interpolate_pose(state, prev_idx, next_idx, factor)
    inv_q = quat_conjugate(optimized_pose_q)
    world = quat_rotate(poses.rotation[:, None, :], points) + poses.translation[:, None, :]
    out = quat_rotate(inv_q[None, None, :], world - optimized_pose_t[None, None, :])
    return jnp.where(mask[..., None], out, 0.0)

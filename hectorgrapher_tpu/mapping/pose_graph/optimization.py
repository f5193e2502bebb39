"""Sparse pose adjustment (SPA) as batched block Gauss-Newton.

Replacement for OptimizationProblem2D/3D
(ref: internal/optimization/optimization_problem_{2d,3d}.cc — Ceres
problems with SPA residuals per constraint (cost_functions/spa_cost_
function_2d/3d.h), Huber loss on INTER constraints, first submap held
constant, frozen trajectories constant, quaternion parameterization).

Design ("batch, don't queue"): instead of a Ceres sparse solver, the
block structure is exploited directly — per-constraint 12-dim (3D) or
6-dim (2D) Jacobians are computed with a vmapped jacfwd and reduced with
batched einsums. The plain SPA system is solved by Schur elimination of
the node block (`_spa_schur_delta`): both diagonal blocks of the normal
matrix are block-diagonal, so the factorization shrinks from
(P*(S+N))^2 to (P*S)^2 — the dense analog of Ceres' SPARSE_SCHUR. The
`_full` variants (odometry/fixed-frame/landmark/IMU families introduce
node-node and global couplings) assemble the dense damped normal matrix
and solve it with one Cholesky as a dense matmul — dense is right at this
scale, D = 6*(S+N) stays in the thousands. Huber is applied as IRLS
sqrt-weights recomputed each LM iteration.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hectorgrapher_tpu.transform.rigid import (
    quat_conjugate,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_axis_angle,
)
from hectorgrapher_tpu.common.math import normalize_angle_difference


# ---------------------------------------------------------------------------
# Block-Schur solver for the plain SPA system
# ---------------------------------------------------------------------------


def _chol_solve(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve SPD a @ x = b via Cholesky (the damped normal matrix is SPD;
    cheaper than the generic LU path)."""
    lo = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(lo, b, lower=True)
    return jax.scipy.linalg.solve_triangular(lo.T, y, lower=False)


def _spa_schur_delta(j_s, j_n, r, c_submap, c_node, s_count, n_count,
                     fixed_s, fixed_n, lam):
    """LM step of the plain SPA system by Schur elimination of the nodes.

    The plain SPA normal matrix has NO submap-submap or node-node edges
    (every residual couples exactly one submap and one node), so both
    diagonal blocks are block-diagonal. Eliminating the node block reduces
    the factorization from (P*(S+N))^2 dense to (P*S)^2 — the dense analog
    of Ceres' SPARSE_SCHUR (ref: pose_graph.lua ceres solver options).
    The damped system (per-coordinate diagonal damping, zeroed fixed
    rows/columns with unit diagonal) is identical to the dense path's, so
    the returned step matches the dense solve exactly.

    j_s, j_n: (C, R, P) masked jacobian halves; r: (C, R) masked weighted
    residuals. Returns delta (S*P + N*P,).
    """
    blocks = _spa_partial_blocks(j_s, j_n, r, c_submap, c_node, s_count, n_count)
    return _spa_schur_solve(blocks, fixed_s, fixed_n, lam)


def _lm_drive(
    eval_fn,
    delta_of,
    retract,
    params0,
    num_iterations: int,
    init_lambda: float,
    max_lambda: float = 1e8,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-7,
):
    """Carried-evaluation LM driver shared by every SPA solver.

    eval_fn(params) -> (quantities, cost): ONE normal-equation assembly
    per iteration — the trial evaluation is reused as the incumbent's on
    accept (the scan-based loops paid 2-3 evaluations per iteration).
    delta_of(quantities, lam) -> tangent step.

    Termination mirrors Ceres (ref: pose_graph.lua ceres solver options):
    at most num_iterations, stopping once an accepted step improves the
    cost by less than function_tolerance * cost (Ceres default 1e-6) or
    the attempted step shrinks below parameter_tolerance (Ceres's second
    criterion — fires when damping has collapsed the step at a plateau).
    Zero tolerances force the full iteration count.
    """

    def cond(carry):
        it, done = carry[0], carry[1]
        return (it < num_iterations) & ~done

    def body(carry):
        it, done, params, lam, quant, cost = carry
        delta = delta_of(quant, lam)
        new_params = retract(params, delta)
        new_quant, new_cost = eval_fn(new_params)
        accept = new_cost < cost
        sel = lambda a, b: jnp.where(accept, b, a)
        lam_next = jnp.where(
            accept, jnp.maximum(lam * 0.33, 1e-10), jnp.minimum(lam * 4.0, max_lambda)
        )
        done_next = done | (accept & (cost - new_cost <= function_tolerance * cost))
        if parameter_tolerance > 0.0:
            step_norm = jnp.sqrt(sum(jnp.sum(d * d) for d in jax.tree.leaves(delta)))
            x_norm = jnp.sqrt(sum(jnp.sum(q * q) for q in jax.tree.leaves(params)))
            done_next = done_next | (
                step_norm <= parameter_tolerance * (x_norm + parameter_tolerance)
            )
        return (
            it + 1,
            done_next,
            jax.tree.map(sel, params, new_params),
            lam_next,
            jax.tree.map(sel, quant, new_quant),
            jnp.where(accept, new_cost, cost),
        )

    quant0, cost0 = eval_fn(params0)
    carry = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            params0,
            jnp.asarray(init_lambda, jnp.float32),
            quant0,
            cost0,
        ),
    )
    return carry[2], carry[5]


def _spa_diag_blocks(j_s, j_n, r, c_submap, c_node, s_count, n_count):
    """Block-diagonal normal-equation operands (no submap-node coupling),
    summed over the given constraints: (a_blocks, c_blocks, g_s, g_n).
    O(S + N) memory — the CG path's whole quadratic-form footprint."""
    p = j_s.shape[-1]
    a_blocks = jnp.zeros((s_count, p, p), jnp.float32).at[c_submap].add(
        jnp.einsum("cri,crj->cij", j_s, j_s)
    )
    c_blocks = jnp.zeros((n_count, p, p), jnp.float32).at[c_node].add(
        jnp.einsum("cri,crj->cij", j_n, j_n)
    )
    g_s = jnp.zeros((s_count, p), jnp.float32).at[c_submap].add(
        jnp.einsum("cri,cr->ci", j_s, r)
    )
    g_n = jnp.zeros((n_count, p), jnp.float32).at[c_node].add(
        jnp.einsum("cri,cr->ci", j_n, r)
    )
    return a_blocks, c_blocks, g_s, g_n


def _spa_partial_blocks(j_s, j_n, r, c_submap, c_node, s_count, n_count):
    """Block normal-equation operands, summed over the given constraints.

    Linear in the constraint set, so shards' partial blocks psum to the
    global ones — the distributed solver reduces THESE across devices instead of
    a dense (D, D) matrix (10x less collective payload).

    NOTE the (S, N, P, P) coupling tensor is O(S*N) memory — fine at the
    per-round operating point (<= ~1M submap-node products) but fatal at
    production graph sizes (500 x 5000 pads to 9.5 GB). Large
    graphs take the matrix-free CG path (`_spa_cg_solve`) instead.
    """
    a_blocks, c_blocks, g_s, g_n = _spa_diag_blocks(
        j_s, j_n, r, c_submap, c_node, s_count, n_count
    )
    p = j_s.shape[-1]
    b_blocks = jnp.zeros((s_count, n_count, p, p), jnp.float32).at[c_submap, c_node].add(
        jnp.einsum("cri,crj->cij", j_s, j_n)
    )
    return a_blocks, c_blocks, b_blocks, g_s, g_n


def _spa_cg_solve(
    j_s, j_n, blocks, c_submap, c_node, fixed_s, fixed_n, lam,
    max_iters: int = 200, tol: float = 1e-6,
):
    """LM step of the SPA system by block-Jacobi preconditioned CG.

    Matrix-free: the damped normal matrix is only ever applied as
    v -> J^T (J v) + damping*v with per-constraint gathers/scatters, so
    memory stays O(C*R*P + (S+N)*P^2) — no (S, N) coupling tensor and no
    dense factorization. This is the production-scale path (the dense analog
    of Ceres' ITERATIVE_SCHUR + JACOBI): the Schur path's exact solve wins
    below ~1M submap-node products, CG wins above.

    The damped, fixed-masked system is identical to `_spa_schur_solve`'s,
    so for converged CG the step matches the exact solve to tolerance.
    j_s, j_n: (C, R, P) masked weighted Jacobian halves; blocks: output of
    `_spa_diag_blocks` on the same Jacobians.
    """
    a_blocks, c_blocks, g_s, g_n = blocks
    p = a_blocks.shape[-1]
    f32 = jnp.float32
    # Fixed coordinates: zero Jacobian columns / gradient, unit diagonal —
    # same masked system as the Schur path.
    j_s = jnp.where(fixed_s[c_submap][:, None, None], 0.0, j_s)
    j_n = jnp.where(fixed_n[c_node][:, None, None], 0.0, j_n)
    a_blocks = jnp.where(fixed_s[:, None, None], 0.0, a_blocks)
    c_blocks = jnp.where(fixed_n[:, None, None], 0.0, c_blocks)
    g_s = jnp.where(fixed_s[:, None], 0.0, g_s)
    g_n = jnp.where(fixed_n[:, None], 0.0, g_n)

    eye = jnp.eye(p, dtype=f32)

    def damp(blocks, fixed):
        diag = jnp.diagonal(blocks, axis1=-2, axis2=-1)
        add = lam * jnp.maximum(diag, 1e-8) + 1e-8 + fixed[:, None].astype(f32)
        return blocks + add[:, :, None] * eye, add

    a_d, add_s = damp(a_blocks, fixed_s)
    c_d, add_n = damp(c_blocks, fixed_n)
    # Block-Jacobi preconditioner: the damped per-submap / per-node (P, P)
    # diagonal blocks, inverted batched (tiny dense solves).
    a_inv = jnp.linalg.inv(a_d)
    c_inv = jnp.linalg.inv(c_d)

    def matvec(v):
        v_s, v_n = v
        t = jnp.einsum("crp,cp->cr", j_s, v_s[c_submap]) + jnp.einsum(
            "crp,cp->cr", j_n, v_n[c_node]
        )
        y_s = jnp.zeros_like(v_s).at[c_submap].add(jnp.einsum("crp,cr->cp", j_s, t))
        y_n = jnp.zeros_like(v_n).at[c_node].add(jnp.einsum("crp,cr->cp", j_n, t))
        return (y_s + add_s * v_s, y_n + add_n * v_n)

    def precond(r):
        return (
            jnp.einsum("sij,sj->si", a_inv, r[0]),
            jnp.einsum("nij,nj->ni", c_inv, r[1]),
        )

    def vdot(a, b):
        return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

    b = (g_s, g_n)
    bnorm2 = vdot(b, b)
    z0 = precond(b)

    def cond(carry):
        it, x, r, z, pdir, rz = carry
        return (it < max_iters) & (vdot(r, r) > tol * tol * bnorm2)

    def body(carry):
        it, x, r, z, pdir, rz = carry
        ap = matvec(pdir)
        alpha = rz / jnp.maximum(vdot(pdir, ap), 1e-30)
        x = jax.tree.map(lambda a, q: a + alpha * q, x, pdir)
        r = jax.tree.map(lambda a, q: a - alpha * q, r, ap)
        z = precond(r)
        rz_new = vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        pdir = jax.tree.map(lambda zq, pq: zq + beta * pq, z, pdir)
        return (it + 1, x, r, z, pdir, rz_new)

    x0 = (jnp.zeros_like(g_s), jnp.zeros_like(g_n))
    carry = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), x0, b, z0, z0, vdot(b, z0))
    )
    x_s, x_n = carry[1]
    delta = -jnp.concatenate([x_s.reshape(-1), x_n.reshape(-1)])
    fixed_coord = jnp.concatenate([jnp.repeat(fixed_s, p), jnp.repeat(fixed_n, p)])
    return jnp.where(fixed_coord, 0.0, delta)


# b_blocks coupling tensors above this element count take the CG path.
_SCHUR_COUPLING_BUDGET = 1_000_000


def _spa_schur_solve(blocks, fixed_s, fixed_n, lam):
    """Solve the damped block system by Schur elimination of the nodes."""
    a_blocks, c_blocks, b_blocks, g_s, g_n = blocks
    s_count = a_blocks.shape[0]
    n_count = c_blocks.shape[0]
    p = a_blocks.shape[-1]
    fs = fixed_s[:, None, None]
    fn = fixed_n[:, None, None]

    # Fixed coordinates: zero couplings and gradient, unit diagonal.
    a_blocks = jnp.where(fs, 0.0, a_blocks)
    c_blocks = jnp.where(fn, 0.0, c_blocks)
    b_blocks = jnp.where(fs[:, None] | fn[None], 0.0, b_blocks)
    g_s = jnp.where(fixed_s[:, None], 0.0, g_s)
    g_n = jnp.where(fixed_n[:, None], 0.0, g_n)

    eye = jnp.eye(p, dtype=jnp.float32)

    def damp(blocks, fixed):
        diag = jnp.diagonal(blocks, axis1=-2, axis2=-1)
        add = lam * jnp.maximum(diag, 1e-8) + 1e-8 + fixed[:, None].astype(jnp.float32)
        return blocks + add[:, :, None] * eye

    a_d = damp(a_blocks, fixed_s)
    c_d = damp(c_blocks, fixed_n)

    c_inv = jnp.linalg.inv(c_d)  # (N, P, P) tiny batched inverses
    # B C^-1 and the Schur complement A - B C^-1 B^T.
    bc = jnp.einsum("snik,nkj->snij", b_blocks, c_inv)  # (S, N, P, P)
    b_flat = b_blocks.transpose(0, 2, 1, 3).reshape(s_count * p, n_count * p)
    bc_flat = bc.transpose(0, 2, 1, 3).reshape(s_count * p, n_count * p)
    a_dense = jnp.zeros((s_count, p, s_count, p), jnp.float32)
    a_dense = a_dense.at[jnp.arange(s_count), :, jnp.arange(s_count), :].set(a_d)
    schur = a_dense.reshape(s_count * p, s_count * p) - bc_flat @ b_flat.T
    rhs = g_s.reshape(-1) - bc_flat @ g_n.reshape(-1)

    x_s = _chol_solve(schur, rhs)
    x_n = jnp.einsum(
        "nij,nj->ni", c_inv, g_n - (b_flat.T @ x_s).reshape(n_count, p)
    ).reshape(-1)
    delta = -jnp.concatenate([x_s, x_n])
    fixed_coord = jnp.concatenate([jnp.repeat(fixed_s, p), jnp.repeat(fixed_n, p)])
    return jnp.where(fixed_coord, 0.0, delta)


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------


class SpaProblem3D(NamedTuple):
    """Static-capacity pose graph arrays (S submaps, N nodes, C constraints)."""

    submap_translation: jax.Array  # (S, 3)
    submap_rotation: jax.Array  # (S, 4)
    node_translation: jax.Array  # (N, 3)
    node_rotation: jax.Array  # (N, 4)
    submap_fixed: jax.Array  # (S,) bool — fixed or invalid
    node_fixed: jax.Array  # (N,) bool
    c_submap: jax.Array  # (C,) int32
    c_node: jax.Array  # (C,) int32
    c_mask: jax.Array  # (C,) bool
    c_rel_translation: jax.Array  # (C, 3) zbar_ij
    c_rel_rotation: jax.Array  # (C, 4)
    c_translation_weight: jax.Array  # (C,)
    c_rotation_weight: jax.Array  # (C,)
    c_huber_scale: jax.Array  # (C,) — large value disables the loss


def _constraint_residual_3d(sub_t, sub_q, node_t, node_q, rel_t, rel_q, wt, wr):
    """(ref: cost_functions/spa_cost_function_3d.h ComputeUnscaledError)"""
    inv_q = quat_conjugate(sub_q)
    h_t = quat_rotate(inv_q, node_t - sub_t)
    h_q = quat_multiply(inv_q, node_q)
    err_q = quat_multiply(quat_conjugate(rel_q), h_q)
    err_t = quat_rotate(quat_conjugate(rel_q), h_t - rel_t)
    return jnp.concatenate([wt * err_t, wr * quat_to_axis_angle(err_q)])


@functools.partial(jax.jit, static_argnames=("num_iterations", "linear_solver"))
def solve_spa_3d(
    problem: SpaProblem3D,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    linear_solver: str = "auto",
):
    """Returns (submap_translation, submap_rotation, node_translation,
    node_rotation, final_cost).

    linear_solver: "schur" (exact block-Schur elimination, O(S*N) memory),
    "cg" (matrix-free block-Jacobi PCG, O(C + S + N) memory), or "auto"
    (schur below _SCHUR_COUPLING_BUDGET submap-node products)."""
    S = problem.submap_translation.shape[0]
    N = problem.node_translation.shape[0]
    if linear_solver == "auto":
        linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"

    def retract(params, delta):
        st, sq, nt, nq = params
        ds = delta[: 6 * S].reshape(S, 6)
        dn = delta[6 * S :].reshape(N, 6)
        return (
            st + ds[:, :3],
            quat_normalize(quat_multiply(sq, quat_from_axis_angle(ds[:, 3:]))),
            nt + dn[:, :3],
            quat_normalize(quat_multiply(nq, quat_from_axis_angle(dn[:, 3:]))),
        )

    def residuals_and_weights(params):
        st, sq, nt, nq = params
        r = jax.vmap(_constraint_residual_3d)(
            st[problem.c_submap],
            sq[problem.c_submap],
            nt[problem.c_node],
            nq[problem.c_node],
            problem.c_rel_translation,
            problem.c_rel_rotation,
            problem.c_translation_weight,
            problem.c_rotation_weight,
        )  # (C, 6)
        r = jnp.where(problem.c_mask[:, None], r, 0.0)
        # Huber IRLS sqrt-weight per constraint block norm.
        norm = jnp.linalg.norm(r, axis=-1)
        scale = problem.c_huber_scale
        w = jnp.where(norm <= scale, 1.0, jnp.sqrt(scale / jnp.maximum(norm, 1e-12)))
        return r, w

    def per_constraint_jac(params, w):
        st, sq, nt, nq = params

        def one(ci):
            si = problem.c_submap[ci]
            ni = problem.c_node[ci]

            def local(d12):
                dsub = d12[:6]
                dnode = d12[6:]
                s_t = st[si] + dsub[:3]
                s_q = quat_normalize(quat_multiply(sq[si], quat_from_axis_angle(dsub[3:])))
                n_t = nt[ni] + dnode[:3]
                n_q = quat_normalize(quat_multiply(nq[ni], quat_from_axis_angle(dnode[3:])))
                return _constraint_residual_3d(
                    s_t, s_q, n_t, n_q,
                    problem.c_rel_translation[ci],
                    problem.c_rel_rotation[ci],
                    problem.c_translation_weight[ci],
                    problem.c_rotation_weight[ci],
                ) * w[ci]

            J = jax.jacfwd(local)(jnp.zeros(12, jnp.float32))  # (6, 12)
            r = local(jnp.zeros(12, jnp.float32))
            return J, r

        return jax.vmap(one)(jnp.arange(problem.c_submap.shape[0]))

    def eval_fn(params):
        _, w = residuals_and_weights(params)
        J, r = per_constraint_jac(params, w)  # (C, 6, 12), (C, 6)
        m = problem.c_mask[:, None, None]
        J = jnp.where(m, J, 0.0)
        r = jnp.where(problem.c_mask[:, None], r, 0.0)
        j_s, j_n = J[:, :, :6], J[:, :, 6:]
        cost = 0.5 * jnp.sum(r * r)
        if linear_solver == "cg":
            diag = _spa_diag_blocks(j_s, j_n, r, problem.c_submap, problem.c_node, S, N)
            return (j_s, j_n, diag), cost
        blocks = _spa_partial_blocks(j_s, j_n, r, problem.c_submap, problem.c_node, S, N)
        return blocks, cost

    def delta_of(quant, lam):
        if linear_solver == "cg":
            j_s, j_n, diag = quant
            return _spa_cg_solve(
                j_s, j_n, diag, problem.c_submap, problem.c_node,
                problem.submap_fixed, problem.node_fixed, lam,
            )
        return _spa_schur_solve(quant, problem.submap_fixed, problem.node_fixed, lam)

    params0 = (
        problem.submap_translation,
        problem.submap_rotation,
        problem.node_translation,
        problem.node_rotation,
    )
    params, final_cost = _lm_drive(
        eval_fn, delta_of, retract, params0, num_iterations, init_lambda
    )
    return params + (final_cost,)


# ---------------------------------------------------------------------------
# 3D extras: odometry / consecutive-node, fixed-frame, landmarks
# ---------------------------------------------------------------------------


class SpaExtras3D(NamedTuple):
    """Additional residual families of OptimizationProblem3D
    (ref: optimization_problem_3d.cc Solve:353-530 — odometry and
    consecutive-local-pose relative residuals between node pairs,
    fixed-frame (GPS) pose residuals, landmark cost functions with
    landmark poses as free variables; landmark_cost_function_3d.h).

    All arrays are static-capacity with masks. Landmarks add L extra
    6-dof parameters to the solve.
    """

    # node-node relative constraints (odometry / local SLAM consecutive)
    nn_a: jax.Array  # (P,) int32 — earlier node
    nn_b: jax.Array  # (P,) int32 — later node
    nn_mask: jax.Array  # (P,)
    nn_rel_translation: jax.Array  # (P, 3) — pose of b in a's frame
    nn_rel_rotation: jax.Array  # (P, 4)
    nn_translation_weight: jax.Array  # (P,)
    nn_rotation_weight: jax.Array  # (P,)
    # fixed-frame (GPS-like) priors on node translation
    ff_mask: jax.Array  # (N,)
    ff_translation: jax.Array  # (N, 3)
    ff_translation_weight: jax.Array  # (N,)
    # landmarks
    landmark_translation: jax.Array  # (L, 3) initial landmark poses
    landmark_rotation: jax.Array  # (L, 4)
    landmark_mask: jax.Array  # (L,)
    lm_node: jax.Array  # (O,) int32 observing node
    lm_index: jax.Array  # (O,) int32 landmark index
    lm_mask: jax.Array  # (O,)
    lm_rel_translation: jax.Array  # (O, 3) landmark in tracking frame
    lm_rel_rotation: jax.Array  # (O, 4)
    lm_translation_weight: jax.Array  # (O,)
    lm_rotation_weight: jax.Array  # (O,)
    # IMU rotation residuals between consecutive nodes
    # (ref: cost_functions/rotation_cost_function_3d.h — error =
    # end^-1 start C dR C^-1 with the extrinsic calibration C free)
    ir_a: jax.Array  # (R,) int32
    ir_b: jax.Array  # (R,)
    ir_traj: jax.Array  # (R,) int32 — trajectory slot for calibration
    ir_mask: jax.Array  # (R,)
    ir_delta_rotation: jax.Array  # (R, 4) gyro-preintegrated (IMU frame)
    ir_weight: jax.Array  # (R,)
    # IMU acceleration residuals over node triples
    # (ref: cost_functions/acceleration_cost_function_3d.h — finite-diff
    # velocity change vs IMU delta velocity, gravity constant free)
    ia_a: jax.Array  # (A,) int32
    ia_b: jax.Array  # (A,)
    ia_c: jax.Array  # (A,)
    ia_traj: jax.Array  # (A,)
    ia_mask: jax.Array  # (A,)
    ia_delta_velocity: jax.Array  # (A, 3) IMU frame at middle node
    ia_dt1: jax.Array  # (A,)
    ia_dt2: jax.Array  # (A,)
    ia_weight: jax.Array  # (A,)
    # Per-trajectory IMU globals
    traj_calibration: jax.Array  # (Tj, 4) extrinsic quaternion, initial
    traj_gravity: jax.Array  # (Tj,) gravity constant, initial
    traj_mask: jax.Array  # (Tj,)
    calibration_fixed: jax.Array  # () bool — freeze extrinsics when not
    # use_online_imu_extrinsics_in_3d


def empty_extras_3d(num_nodes: int, p: int = 1, l: int = 1, o: int = 1,
                    r: int = 1, a: int = 1, tj: int = 1) -> SpaExtras3D:
    qI = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (p, 1))
    qL = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (l, 1))
    qO = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (o, 1))
    return SpaExtras3D(
        nn_a=jnp.zeros(p, jnp.int32),
        nn_b=jnp.zeros(p, jnp.int32),
        nn_mask=jnp.zeros(p, bool),
        nn_rel_translation=jnp.zeros((p, 3), jnp.float32),
        nn_rel_rotation=qI,
        nn_translation_weight=jnp.zeros(p, jnp.float32),
        nn_rotation_weight=jnp.zeros(p, jnp.float32),
        ff_mask=jnp.zeros(num_nodes, bool),
        ff_translation=jnp.zeros((num_nodes, 3), jnp.float32),
        ff_translation_weight=jnp.zeros(num_nodes, jnp.float32),
        landmark_translation=jnp.zeros((l, 3), jnp.float32),
        landmark_rotation=qL,
        landmark_mask=jnp.zeros(l, bool),
        lm_node=jnp.zeros(o, jnp.int32),
        lm_index=jnp.zeros(o, jnp.int32),
        lm_mask=jnp.zeros(o, bool),
        lm_rel_translation=jnp.zeros((o, 3), jnp.float32),
        lm_rel_rotation=qO,
        lm_translation_weight=jnp.zeros(o, jnp.float32),
        lm_rotation_weight=jnp.zeros(o, jnp.float32),
        ir_a=jnp.zeros(r, jnp.int32),
        ir_b=jnp.zeros(r, jnp.int32),
        ir_traj=jnp.zeros(r, jnp.int32),
        ir_mask=jnp.zeros(r, bool),
        ir_delta_rotation=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (r, 1)),
        ir_weight=jnp.zeros(r, jnp.float32),
        ia_a=jnp.zeros(a, jnp.int32),
        ia_b=jnp.zeros(a, jnp.int32),
        ia_c=jnp.zeros(a, jnp.int32),
        ia_traj=jnp.zeros(a, jnp.int32),
        ia_mask=jnp.zeros(a, bool),
        ia_delta_velocity=jnp.zeros((a, 3), jnp.float32),
        ia_dt1=jnp.ones(a, jnp.float32),
        ia_dt2=jnp.ones(a, jnp.float32),
        ia_weight=jnp.zeros(a, jnp.float32),
        traj_calibration=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (tj, 1)),
        traj_gravity=jnp.full(tj, 9.80665, jnp.float32),
        traj_mask=jnp.zeros(tj, bool),
        calibration_fixed=jnp.asarray(True),
    )


def _relative_residual_3d(a_t, a_q, b_t, b_q, rel_t, rel_q, wt, wr):
    """Error of (a^-1 b) vs rel, 6-vector."""
    inv_q = quat_conjugate(a_q)
    h_t = quat_rotate(inv_q, b_t - a_t)
    h_q = quat_multiply(inv_q, b_q)
    err_q = quat_multiply(quat_conjugate(rel_q), h_q)
    err_t = quat_rotate(quat_conjugate(rel_q), h_t - rel_t)
    return jnp.concatenate([wt * err_t, wr * quat_to_axis_angle(err_q)])


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def solve_spa_3d_full(
    problem: SpaProblem3D,
    extras: SpaExtras3D,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
):
    """3D SPA with all residual families; returns (submap_t, submap_q,
    node_t, node_q, landmark_t, landmark_q, calibration, gravity,
    final_cost)."""
    S = problem.submap_translation.shape[0]
    N = problem.node_translation.shape[0]
    L = extras.landmark_translation.shape[0]
    Tj = extras.traj_calibration.shape[0]
    base_g = 6 * (S + N + L)  # start of per-trajectory IMU globals
    D = base_g + 4 * Tj  # 3 calib-rot + 1 gravity per trajectory

    calib_fixed = extras.calibration_fixed | ~extras.traj_mask
    fixed = jnp.concatenate(
        [
            jnp.repeat(problem.submap_fixed, 6),
            jnp.repeat(problem.node_fixed, 6),
            jnp.repeat(~extras.landmark_mask, 6),
            jnp.stack(
                [calib_fixed, calib_fixed, calib_fixed, ~extras.traj_mask], axis=1
            ).reshape(-1),
        ]
    )

    def unpack(params):
        return params

    def retract(params, delta):
        st, sq, nt, nq, lt, lq, cq, grav = params
        ds = delta[: 6 * S].reshape(S, 6)
        dn = delta[6 * S : 6 * (S + N)].reshape(N, 6)
        dl = delta[6 * (S + N) : base_g].reshape(L, 6)
        dg = delta[base_g:].reshape(Tj, 4)
        return (
            st + ds[:, :3],
            quat_normalize(quat_multiply(sq, quat_from_axis_angle(ds[:, 3:]))),
            nt + dn[:, :3],
            quat_normalize(quat_multiply(nq, quat_from_axis_angle(dn[:, 3:]))),
            lt + dl[:, :3],
            quat_normalize(quat_multiply(lq, quat_from_axis_angle(dl[:, 3:]))),
            quat_normalize(quat_multiply(cq, quat_from_axis_angle(dg[:, :3]))),
            grav + dg[:, 3],
        )

    def family_blocks(params):
        """Per-family (J blocks, residuals, tangent indices)."""
        st, sq, nt, nq, lt, lq, cq, grav = unpack(params)

        # -- submap-node constraints (with Huber IRLS)
        def c_one(ci):
            si = problem.c_submap[ci]
            ni = problem.c_node[ci]

            def local(d12):
                s_t = st[si] + d12[:3]
                s_q = quat_normalize(quat_multiply(sq[si], quat_from_axis_angle(d12[3:6])))
                n_t = nt[ni] + d12[6:9]
                n_q = quat_normalize(quat_multiply(nq[ni], quat_from_axis_angle(d12[9:12])))
                return _relative_residual_3d(
                    s_t, s_q, n_t, n_q,
                    problem.c_rel_translation[ci], problem.c_rel_rotation[ci],
                    problem.c_translation_weight[ci], problem.c_rotation_weight[ci],
                )

            r0 = local(jnp.zeros(12, jnp.float32))
            norm = jnp.linalg.norm(r0)
            scale = problem.c_huber_scale[ci]
            w = jnp.where(norm <= scale, 1.0, jnp.sqrt(scale / jnp.maximum(norm, 1e-12)))
            J = jax.jacfwd(local)(jnp.zeros(12, jnp.float32)) * w
            m = problem.c_mask[ci]
            return jnp.where(m, J, 0.0), jnp.where(m, r0 * w, 0.0)

        cJ, cr = jax.vmap(c_one)(jnp.arange(problem.c_submap.shape[0]))
        c_idx = jnp.concatenate(
            [
                (problem.c_submap * 6)[:, None] + jnp.arange(6)[None, :],
                (6 * S + problem.c_node * 6)[:, None] + jnp.arange(6)[None, :],
            ],
            axis=1,
        )

        # -- node-node relative constraints
        def nn_one(pi):
            a = extras.nn_a[pi]
            b = extras.nn_b[pi]

            def local(d12):
                a_t = nt[a] + d12[:3]
                a_q = quat_normalize(quat_multiply(nq[a], quat_from_axis_angle(d12[3:6])))
                b_t = nt[b] + d12[6:9]
                b_q = quat_normalize(quat_multiply(nq[b], quat_from_axis_angle(d12[9:12])))
                return _relative_residual_3d(
                    a_t, a_q, b_t, b_q,
                    extras.nn_rel_translation[pi], extras.nn_rel_rotation[pi],
                    extras.nn_translation_weight[pi], extras.nn_rotation_weight[pi],
                )

            r0 = local(jnp.zeros(12, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(12, jnp.float32))
            m = extras.nn_mask[pi]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        nnJ, nnr = jax.vmap(nn_one)(jnp.arange(extras.nn_a.shape[0]))
        nn_idx = jnp.concatenate(
            [
                (6 * S + extras.nn_a * 6)[:, None] + jnp.arange(6)[None, :],
                (6 * S + extras.nn_b * 6)[:, None] + jnp.arange(6)[None, :],
            ],
            axis=1,
        )

        # -- fixed-frame priors (translation only; ref fix-frame residuals)
        def ff_one(ni):
            def local(d6):
                n_t = nt[ni] + d6[:3]
                return extras.ff_translation_weight[ni] * (n_t - extras.ff_translation[ni])

            r0 = local(jnp.zeros(6, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(6, jnp.float32))
            m = extras.ff_mask[ni]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        ffJ, ffr = jax.vmap(ff_one)(jnp.arange(N))
        ff_idx = (6 * S + jnp.arange(N) * 6)[:, None] + jnp.arange(6)[None, :]

        # -- landmark observations: landmark pose vs node * rel
        def lm_one(oi):
            ni = extras.lm_node[oi]
            li = extras.lm_index[oi]

            def local(d12):
                n_t = nt[ni] + d12[:3]
                n_q = quat_normalize(quat_multiply(nq[ni], quat_from_axis_angle(d12[3:6])))
                l_t = lt[li] + d12[6:9]
                l_q = quat_normalize(quat_multiply(lq[li], quat_from_axis_angle(d12[9:12])))
                return _relative_residual_3d(
                    n_t, n_q, l_t, l_q,
                    extras.lm_rel_translation[oi], extras.lm_rel_rotation[oi],
                    extras.lm_translation_weight[oi], extras.lm_rotation_weight[oi],
                )

            r0 = local(jnp.zeros(12, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(12, jnp.float32))
            m = extras.lm_mask[oi]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        lmJ, lmr = jax.vmap(lm_one)(jnp.arange(extras.lm_node.shape[0]))
        lm_idx = jnp.concatenate(
            [
                (6 * S + extras.lm_node * 6)[:, None] + jnp.arange(6)[None, :],
                (6 * (S + N) + extras.lm_index * 6)[:, None] + jnp.arange(6)[None, :],
            ],
            axis=1,
        )

        # -- IMU rotation residuals (ref: rotation_cost_function_3d.h —
        #    error = end^-1 start C dR C^-1; calibration C per trajectory)
        def ir_one(ri):
            a = extras.ir_a[ri]
            b = extras.ir_b[ri]
            tj = extras.ir_traj[ri]

            def local(d9):
                qa = quat_normalize(quat_multiply(nq[a], quat_from_axis_angle(d9[:3])))
                qb = quat_normalize(quat_multiply(nq[b], quat_from_axis_angle(d9[3:6])))
                c = quat_normalize(quat_multiply(cq[tj], quat_from_axis_angle(d9[6:9])))
                err = quat_multiply(
                    quat_multiply(quat_conjugate(qb), qa),
                    quat_multiply(
                        quat_multiply(c, extras.ir_delta_rotation[ri]), quat_conjugate(c)
                    ),
                )
                return extras.ir_weight[ri] * err[1:]

            r0 = local(jnp.zeros(9, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(9, jnp.float32))
            m = extras.ir_mask[ri]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        irJ, irr = jax.vmap(ir_one)(jnp.arange(extras.ir_a.shape[0]))
        ir_idx = jnp.concatenate(
            [
                (6 * S + extras.ir_a * 6 + 3)[:, None] + jnp.arange(3)[None, :],
                (6 * S + extras.ir_b * 6 + 3)[:, None] + jnp.arange(3)[None, :],
                (base_g + extras.ir_traj * 4)[:, None] + jnp.arange(3)[None, :],
            ],
            axis=1,
        )

        # -- IMU acceleration residuals (ref: acceleration_cost_function_3d.h)
        def ia_one(ai):
            a = extras.ia_a[ai]
            b = extras.ia_b[ai]
            c_ = extras.ia_c[ai]
            tj = extras.ia_traj[ai]
            dt1 = extras.ia_dt1[ai]
            dt2 = extras.ia_dt2[ai]

            def local(d16):
                qb = quat_normalize(quat_multiply(nq[b], quat_from_axis_angle(d16[:3])))
                ta = nt[a] + d16[3:6]
                tb = nt[b] + d16[6:9]
                tc = nt[c_] + d16[9:12]
                g = grav[tj] + d16[12]
                cal = quat_normalize(quat_multiply(cq[tj], quat_from_axis_angle(d16[13:16])))
                imu_dv = quat_rotate(
                    qb, quat_rotate(cal, extras.ia_delta_velocity[ai])
                ) - g * (0.5 * (dt1 + dt2)) * jnp.asarray([0.0, 0.0, 1.0])
                fd_dv = (tc - tb) / dt2 - (tb - ta) / dt1
                return extras.ia_weight[ai] * (imu_dv - fd_dv)

            r0 = local(jnp.zeros(16, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(16, jnp.float32))
            m = extras.ia_mask[ai]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        iaJ, iar = jax.vmap(ia_one)(jnp.arange(extras.ia_a.shape[0]))
        ia_idx = jnp.concatenate(
            [
                (6 * S + extras.ia_b * 6 + 3)[:, None] + jnp.arange(3)[None, :],
                (6 * S + extras.ia_a * 6)[:, None] + jnp.arange(3)[None, :],
                (6 * S + extras.ia_b * 6)[:, None] + jnp.arange(3)[None, :],
                (6 * S + extras.ia_c * 6)[:, None] + jnp.arange(3)[None, :],
                (base_g + extras.ia_traj * 4 + 3)[:, None],
                (base_g + extras.ia_traj * 4)[:, None] + jnp.arange(3)[None, :],
            ],
            axis=1,
        )

        return [
            (cJ, cr, c_idx),
            (nnJ, nnr, nn_idx),
            (ffJ, ffr, ff_idx),
            (lmJ, lmr, lm_idx),
            (irJ, irr, ir_idx),
            (iaJ, iar, ia_idx),
        ]

    def assemble(params):
        JtJ = jnp.zeros((D, D), jnp.float32)
        g = jnp.zeros((D,), jnp.float32)
        cost = 0.0
        for J, r, idx in family_blocks(params):
            # f32 throughout: under x64 test configs, host-provided extras can
            # leak f64 into jacfwd outputs; scatter-add requires matching dtypes.
            J = J.astype(jnp.float32)
            r = r.astype(jnp.float32)
            JtJ = JtJ.at[idx[:, :, None], idx[:, None, :]].add(jnp.einsum("cri,crj->cij", J, J))
            g = g.at[idx].add(jnp.einsum("cri,cr->ci", J, r))
            cost = cost + 0.5 * jnp.sum(r * r)
        return JtJ, g, cost

    def eval_fn(params):
        JtJ, g, cost = assemble(params)
        JtJ = jnp.where(fixed[:, None] | fixed[None, :], 0.0, JtJ)
        g = jnp.where(fixed, 0.0, g)
        return (JtJ, g), cost

    def delta_of(quant, lam):
        JtJ, g = quant
        diag = jnp.diag(JtJ)
        damped = JtJ + jnp.diag(lam * jnp.maximum(diag, 1e-8) + 1e-8) + jnp.diag(fixed.astype(jnp.float32))
        return jnp.where(fixed, 0.0, -_chol_solve(damped, g))

    params0 = (
        problem.submap_translation,
        problem.submap_rotation,
        problem.node_translation,
        problem.node_rotation,
        extras.landmark_translation,
        extras.landmark_rotation,
        extras.traj_calibration,
        extras.traj_gravity,
    )
    params, final_cost = _lm_drive(
        eval_fn, delta_of, retract, params0, num_iterations, init_lambda
    )
    return params + (final_cost,)


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


class SpaProblem2D(NamedTuple):
    submap_pose: jax.Array  # (S, 3) x, y, theta
    node_pose: jax.Array  # (N, 3)
    submap_fixed: jax.Array  # (S,)
    node_fixed: jax.Array  # (N,)
    c_submap: jax.Array  # (C,)
    c_node: jax.Array  # (C,)
    c_mask: jax.Array  # (C,)
    c_rel_pose: jax.Array  # (C, 3) zbar_ij
    c_translation_weight: jax.Array  # (C,)
    c_rotation_weight: jax.Array  # (C,)
    c_huber_scale: jax.Array  # (C,)


def _constraint_residual_2d(sub, node, rel, wt, wr):
    """(ref: cost_functions/spa_cost_function_2d.h ComputeUnscaledError)"""
    c, s = jnp.cos(sub[2]), jnp.sin(sub[2])
    d = node[:2] - sub[:2]
    h = jnp.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    err_t = rel[:2] - h
    err_a = normalize_angle_difference(rel[2] - (node[2] - sub[2]))
    return jnp.concatenate([wt * err_t, (wr * err_a)[None]])


@functools.partial(jax.jit, static_argnames=("num_iterations", "linear_solver"))
def solve_spa_2d(
    problem: SpaProblem2D,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    linear_solver: str = "auto",
):
    S = problem.submap_pose.shape[0]
    N = problem.node_pose.shape[0]
    if linear_solver == "auto":
        linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"

    def residuals_and_weights(params):
        sp, np_ = params
        r = jax.vmap(_constraint_residual_2d)(
            sp[problem.c_submap],
            np_[problem.c_node],
            problem.c_rel_pose,
            problem.c_translation_weight,
            problem.c_rotation_weight,
        )
        r = jnp.where(problem.c_mask[:, None], r, 0.0)
        norm = jnp.linalg.norm(r, axis=-1)
        scale = problem.c_huber_scale
        w = jnp.where(norm <= scale, 1.0, jnp.sqrt(scale / jnp.maximum(norm, 1e-12)))
        return r, w

    def per_constraint_jac(params, w):
        sp, np_ = params

        def one(ci):
            si = problem.c_submap[ci]
            ni = problem.c_node[ci]

            def local(d6):
                return _constraint_residual_2d(
                    sp[si] + d6[:3],
                    np_[ni] + d6[3:],
                    problem.c_rel_pose[ci],
                    problem.c_translation_weight[ci],
                    problem.c_rotation_weight[ci],
                ) * w[ci]

            return jax.jacfwd(local)(jnp.zeros(6, jnp.float32)), local(jnp.zeros(6, jnp.float32))

        return jax.vmap(one)(jnp.arange(problem.c_submap.shape[0]))

    def eval_fn(params):
        _, w = residuals_and_weights(params)
        J, r = per_constraint_jac(params, w)  # (C, 3, 6), (C, 3)
        m = problem.c_mask[:, None, None]
        J = jnp.where(m, J, 0.0)
        r = jnp.where(problem.c_mask[:, None], r, 0.0)
        j_s, j_n = J[:, :, :3], J[:, :, 3:]
        cost = 0.5 * jnp.sum(r * r)
        if linear_solver == "cg":
            diag = _spa_diag_blocks(j_s, j_n, r, problem.c_submap, problem.c_node, S, N)
            return (j_s, j_n, diag), cost
        blocks = _spa_partial_blocks(j_s, j_n, r, problem.c_submap, problem.c_node, S, N)
        return blocks, cost

    def delta_of(quant, lam):
        if linear_solver == "cg":
            j_s, j_n, diag = quant
            return _spa_cg_solve(
                j_s, j_n, diag, problem.c_submap, problem.c_node,
                problem.submap_fixed, problem.node_fixed, lam,
            )
        return _spa_schur_solve(quant, problem.submap_fixed, problem.node_fixed, lam)

    def retract(params, delta):
        sp, np_ = params
        return (sp + delta[: 3 * S].reshape(S, 3), np_ + delta[3 * S :].reshape(N, 3))

    params0 = (problem.submap_pose, problem.node_pose)
    params, final_cost = _lm_drive(
        eval_fn, delta_of, retract, params0, num_iterations, init_lambda
    )
    return params + (final_cost,)


# ---------------------------------------------------------------------------
# 2D extras: odometry / consecutive-node, fixed-frame, landmarks
# ---------------------------------------------------------------------------


class SpaExtras2D(NamedTuple):
    """Additional residual families of OptimizationProblem2D
    (ref: optimization_problem_2d.cc — odometry and consecutive-node
    relative residuals, fixed-frame residuals, landmark cost functions
    with 2D landmark poses as free variables)."""

    nn_a: jax.Array  # (P,)
    nn_b: jax.Array  # (P,)
    nn_mask: jax.Array  # (P,)
    nn_rel_pose: jax.Array  # (P, 3) — pose of b in a's frame (x, y, theta)
    nn_translation_weight: jax.Array  # (P,)
    nn_rotation_weight: jax.Array  # (P,)
    ff_mask: jax.Array  # (N,)
    ff_pose: jax.Array  # (N, 3)
    ff_translation_weight: jax.Array  # (N,)
    landmark_pose: jax.Array  # (L, 3)
    landmark_mask: jax.Array  # (L,)
    lm_node: jax.Array  # (O,)
    lm_index: jax.Array  # (O,)
    lm_mask: jax.Array  # (O,)
    lm_rel_pose: jax.Array  # (O, 3)
    lm_translation_weight: jax.Array  # (O,)
    lm_rotation_weight: jax.Array  # (O,)


def empty_extras_2d(num_nodes: int, p: int = 1, l: int = 1, o: int = 1) -> SpaExtras2D:
    return SpaExtras2D(
        nn_a=jnp.zeros(p, jnp.int32),
        nn_b=jnp.zeros(p, jnp.int32),
        nn_mask=jnp.zeros(p, bool),
        nn_rel_pose=jnp.zeros((p, 3), jnp.float32),
        nn_translation_weight=jnp.zeros(p, jnp.float32),
        nn_rotation_weight=jnp.zeros(p, jnp.float32),
        ff_mask=jnp.zeros(num_nodes, bool),
        ff_pose=jnp.zeros((num_nodes, 3), jnp.float32),
        ff_translation_weight=jnp.zeros(num_nodes, jnp.float32),
        landmark_pose=jnp.zeros((l, 3), jnp.float32),
        landmark_mask=jnp.zeros(l, bool),
        lm_node=jnp.zeros(o, jnp.int32),
        lm_index=jnp.zeros(o, jnp.int32),
        lm_mask=jnp.zeros(o, bool),
        lm_rel_pose=jnp.zeros((o, 3), jnp.float32),
        lm_translation_weight=jnp.zeros(o, jnp.float32),
        lm_rotation_weight=jnp.zeros(o, jnp.float32),
    )


def _relative_residual_2d(a, b, rel, wt, wr):
    """Error of (a^-1 b) vs rel in SE(2)."""
    c, s = jnp.cos(a[2]), jnp.sin(a[2])
    d = b[:2] - a[:2]
    h = jnp.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    err_t = rel[:2] - h
    err_a = normalize_angle_difference(rel[2] - (b[2] - a[2]))
    return jnp.concatenate([wt * err_t, (wr * err_a)[None]])


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def solve_spa_2d_full(
    problem: SpaProblem2D,
    extras: SpaExtras2D,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
):
    """2D SPA with all residual families; returns (submap, node, landmark
    poses, final_cost)."""
    S = problem.submap_pose.shape[0]
    N = problem.node_pose.shape[0]
    L = extras.landmark_pose.shape[0]
    D = 3 * (S + N + L)
    fixed = jnp.concatenate(
        [
            jnp.repeat(problem.submap_fixed, 3),
            jnp.repeat(problem.node_fixed, 3),
            jnp.repeat(~extras.landmark_mask, 3),
        ]
    )

    def family_blocks(params):
        sp, np_, lp = params

        def c_one(ci):
            si = problem.c_submap[ci]
            ni = problem.c_node[ci]

            def local(d6):
                return _relative_residual_2d(
                    sp[si] + d6[:3], np_[ni] + d6[3:],
                    problem.c_rel_pose[ci],
                    problem.c_translation_weight[ci], problem.c_rotation_weight[ci],
                )

            r0 = local(jnp.zeros(6, jnp.float32))
            norm = jnp.linalg.norm(r0)
            scale = problem.c_huber_scale[ci]
            w = jnp.where(norm <= scale, 1.0, jnp.sqrt(scale / jnp.maximum(norm, 1e-12)))
            J = jax.jacfwd(local)(jnp.zeros(6, jnp.float32)) * w
            m = problem.c_mask[ci]
            return jnp.where(m, J, 0.0), jnp.where(m, r0 * w, 0.0)

        cJ, cr = jax.vmap(c_one)(jnp.arange(problem.c_submap.shape[0]))
        c_idx = jnp.concatenate(
            [
                (problem.c_submap * 3)[:, None] + jnp.arange(3)[None, :],
                (3 * S + problem.c_node * 3)[:, None] + jnp.arange(3)[None, :],
            ],
            axis=1,
        )

        def nn_one(pi):
            a = extras.nn_a[pi]
            b = extras.nn_b[pi]

            def local(d6):
                return _relative_residual_2d(
                    np_[a] + d6[:3], np_[b] + d6[3:],
                    extras.nn_rel_pose[pi],
                    extras.nn_translation_weight[pi], extras.nn_rotation_weight[pi],
                )

            r0 = local(jnp.zeros(6, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(6, jnp.float32))
            m = extras.nn_mask[pi]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        nnJ, nnr = jax.vmap(nn_one)(jnp.arange(extras.nn_a.shape[0]))
        nn_idx = jnp.concatenate(
            [
                (3 * S + extras.nn_a * 3)[:, None] + jnp.arange(3)[None, :],
                (3 * S + extras.nn_b * 3)[:, None] + jnp.arange(3)[None, :],
            ],
            axis=1,
        )

        def ff_one(ni):
            def local(d3):
                p = np_[ni] + d3
                return extras.ff_translation_weight[ni] * (p[:2] - extras.ff_pose[ni, :2])

            r0 = local(jnp.zeros(3, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(3, jnp.float32))
            m = extras.ff_mask[ni]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        ffJ, ffr = jax.vmap(ff_one)(jnp.arange(N))
        ff_idx = (3 * S + jnp.arange(N) * 3)[:, None] + jnp.arange(3)[None, :]

        def lm_one(oi):
            ni = extras.lm_node[oi]
            li = extras.lm_index[oi]

            def local(d6):
                return _relative_residual_2d(
                    np_[ni] + d6[:3], lp[li] + d6[3:],
                    extras.lm_rel_pose[oi],
                    extras.lm_translation_weight[oi], extras.lm_rotation_weight[oi],
                )

            r0 = local(jnp.zeros(6, jnp.float32))
            J = jax.jacfwd(local)(jnp.zeros(6, jnp.float32))
            m = extras.lm_mask[oi]
            return jnp.where(m, J, 0.0), jnp.where(m, r0, 0.0)

        lmJ, lmr = jax.vmap(lm_one)(jnp.arange(extras.lm_node.shape[0]))
        lm_idx = jnp.concatenate(
            [
                (3 * S + extras.lm_node * 3)[:, None] + jnp.arange(3)[None, :],
                (3 * (S + N) + extras.lm_index * 3)[:, None] + jnp.arange(3)[None, :],
            ],
            axis=1,
        )
        return [(cJ, cr, c_idx), (nnJ, nnr, nn_idx), (ffJ, ffr, ff_idx), (lmJ, lmr, lm_idx)]

    def assemble(params):
        JtJ = jnp.zeros((D, D), jnp.float32)
        g = jnp.zeros((D,), jnp.float32)
        cost = 0.0
        for J, r, idx in family_blocks(params):
            # f32 throughout: under x64 test configs, host-provided extras can
            # leak f64 into jacfwd outputs; scatter-add requires matching dtypes.
            J = J.astype(jnp.float32)
            r = r.astype(jnp.float32)
            JtJ = JtJ.at[idx[:, :, None], idx[:, None, :]].add(jnp.einsum("cri,crj->cij", J, J))
            g = g.at[idx].add(jnp.einsum("cri,cr->ci", J, r))
            cost = cost + 0.5 * jnp.sum(r * r)
        return JtJ, g, cost

    def eval_fn(params):
        JtJ, g, cost = assemble(params)
        JtJ = jnp.where(fixed[:, None] | fixed[None, :], 0.0, JtJ)
        g = jnp.where(fixed, 0.0, g)
        return (JtJ, g), cost

    def delta_of(quant, lam):
        JtJ, g = quant
        diag = jnp.diag(JtJ)
        damped = JtJ + jnp.diag(lam * jnp.maximum(diag, 1e-8) + 1e-8) + jnp.diag(fixed.astype(jnp.float32))
        return jnp.where(fixed, 0.0, -_chol_solve(damped, g))

    def retract(params, delta):
        sp, np_, lp = params
        return (
            sp + delta[: 3 * S].reshape(S, 3),
            np_ + delta[3 * S : 3 * (S + N)].reshape(N, 3),
            lp + delta[3 * (S + N) :].reshape(L, 3),
        )

    params0 = (problem.submap_pose, problem.node_pose, extras.landmark_pose)
    params, final_cost = _lm_drive(
        eval_fn, delta_of, retract, params0, num_iterations, init_lambda
    )
    return params + (final_cost,)

"""Multi-device sharding of the pose-graph workloads.

Replacement for the reference's distributed mapping layer
(ref: cartographer/cloud — gRPC uplink server holding the global pose
graph; SURVEY.md section 2.12 #3): instead of RPC between processes, the
pose-graph state is sharded over a jax.sharding.Mesh and reductions ride
XLA's collectives.

Implemented here:
  * solve_spa_2d_sharded / solve_spa_3d_sharded — distributed block
    Gauss-Newton, COMMUNICATION-AVOIDING form (VERDICT r4 next #3):

    - The per-constraint Jacobian evaluation (the SPA fan-out compute,
      ref: optimization_problem_3d.cc Solve's per-residual work on the
      thread pool) is sharded over the mesh's "graph" axis.
    - ONE all-gather per LM iteration moves the per-constraint halves
      (j_s, j_n, r — ~C*(2*R*P + R) floats) to every device; the linear
      solve (block-Schur or block-Jacobi CG, same budget-based choice as
      the local solver) then runs REPLICATED with zero collectives.
    - The entire LM loop lives inside one shard_map, so no op is left to
      GSPMD auto-partitioning (which inserted per-op collectives into the
      round-4 solve and blew the virtual-mesh scaling curve up 7x at 8
      devices: the old design psum'd the dense (S, N, P, P) coupling
      tensor — 36*S*N floats — every iteration; the gathered
      per-constraint payload is 14x smaller at the 5k-node operating
      point and independent of S*N).

    Static collective count per LM iteration: 1 all-gather (a 3-leaf
    pytree). The old design: 1 psum of (S,6,6)+(N,6,6)+(S,N,6,6)+(S,6)+
    (N,6)+scalar.

Single-chip training still works: with a 1-device mesh these reduce to
the local solvers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hectorgrapher_tpu.mapping.pose_graph.optimization import (
    _SCHUR_COUPLING_BUDGET,
    SpaProblem2D,
    SpaProblem3D,
    _constraint_residual_2d,
    _constraint_residual_3d,
    _lm_drive,
    _spa_cg_solve,
    _spa_diag_blocks,
    _spa_partial_blocks,
    _spa_schur_solve,
)
from hectorgrapher_tpu.transform.rigid import (
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
)


def _pad_constraints(problem, axis_size: int):
    """Pad the constraint axis to a multiple of the mesh axis size."""
    c = problem.c_submap.shape[0]
    target = ((c + axis_size - 1) // axis_size) * axis_size
    if target == c:
        return problem
    pad = target - c

    def pad_leaf(name, x):
        if not name.startswith("c_"):
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    return type(problem)(**{k: pad_leaf(k, v) for k, v in problem._asdict().items()})


@functools.partial(jax.jit, static_argnames=("mesh", "num_iterations"))
def solve_spa_2d_sharded(problem: SpaProblem2D, mesh: Mesh, num_iterations: int = 20):
    """Distributed 2D SPA over mesh axis "graph" (see module docstring)."""
    axis = mesh.axis_names[0]
    problem = _pad_constraints(problem, mesh.shape[axis])
    S = problem.submap_pose.shape[0]
    N = problem.node_pose.shape[0]
    linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"

    c_spec = P(axis)
    rep = P()

    def device_solve(
        sp0, np0, fixed_s, fixed_n,
        l_submap, l_node, l_mask, l_rel, l_wt, l_wr, l_hub,  # local shard
        c_submap, c_node,  # replicated full index arrays (assembly/CG)
    ):
        def local_jac(sp, np_):
            def one(ci):
                si = l_submap[ci]
                ni = l_node[ci]

                def local(d6):
                    return _constraint_residual_2d(
                        sp[si] + d6[:3], np_[ni] + d6[3:], l_rel[ci], l_wt[ci], l_wr[ci]
                    )

                r0 = local(jnp.zeros(6, jnp.float32))
                norm = jnp.linalg.norm(r0)
                w = jnp.where(
                    norm <= l_hub[ci], 1.0,
                    jnp.sqrt(l_hub[ci] / jnp.maximum(norm, 1e-12)),
                )
                J = jax.jacfwd(local)(jnp.zeros(6, jnp.float32)) * w
                r = r0 * w
                m = l_mask[ci]
                return jnp.where(m, J, 0.0), jnp.where(m, r, 0.0)

            return jax.vmap(one)(jnp.arange(l_submap.shape[0]))

        def eval_fn(params):
            sp, np_ = params
            J, r = local_jac(sp, np_)
            # THE collective: per-constraint halves to every device.
            J, r = jax.lax.all_gather((J, r), axis, tiled=True)
            j_s, j_n = J[:, :, :3], J[:, :, 3:]
            cost = 0.5 * jnp.sum(r * r)
            if linear_solver == "cg":
                diag = _spa_diag_blocks(j_s, j_n, r, c_submap, c_node, S, N)
                return (j_s, j_n, diag), cost
            blocks = _spa_partial_blocks(j_s, j_n, r, c_submap, c_node, S, N)
            return blocks, cost

        def delta_of(quant, lam):
            if linear_solver == "cg":
                j_s, j_n, diag = quant
                return _spa_cg_solve(
                    j_s, j_n, diag, c_submap, c_node, fixed_s, fixed_n, lam
                )
            return _spa_schur_solve(quant, fixed_s, fixed_n, lam)

        def retract(params, delta):
            sp, np_ = params
            return (
                sp + delta[: 3 * S].reshape(S, 3),
                np_ + delta[3 * S :].reshape(N, 3),
            )

        params, final_cost = _lm_drive(
            eval_fn, delta_of, retract, (sp0, np0), num_iterations, 1e-4
        )
        return params[0], params[1], final_cost

    return jax.shard_map(
        device_solve,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep) + (c_spec,) * 7 + (rep, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,  # LM early-termination carry is genuinely per-shard
    )(
        problem.submap_pose,
        problem.node_pose,
        problem.submap_fixed,
        problem.node_fixed,
        problem.c_submap,
        problem.c_node,
        problem.c_mask,
        problem.c_rel_pose,
        problem.c_translation_weight,
        problem.c_rotation_weight,
        problem.c_huber_scale,
        problem.c_submap,
        problem.c_node,
    )


@functools.partial(jax.jit, static_argnames=("mesh", "num_iterations"))
def solve_spa_3d_sharded(problem: SpaProblem3D, mesh: Mesh, num_iterations: int = 20):
    """Distributed 3D SPA over mesh axis "graph" (same structure as 2D)."""
    axis = mesh.axis_names[0]
    problem = _pad_constraints(problem, mesh.shape[axis])
    S = problem.submap_translation.shape[0]
    N = problem.node_translation.shape[0]
    linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"

    c_spec = P(axis)
    rep = P()

    def device_solve(
        st0, sq0, nt0, nq0, fixed_s, fixed_n,
        l_submap, l_node, l_mask, l_rt, l_rq, l_wt, l_wr, l_hub,  # local shard
        c_submap, c_node,  # replicated full index arrays
    ):
        def local_jac(st, sq, nt, nq):
            def one(ci):
                si = l_submap[ci]
                ni = l_node[ci]

                def local(d12):
                    s_t = st[si] + d12[:3]
                    s_q = quat_normalize(
                        quat_multiply(sq[si], quat_from_axis_angle(d12[3:6]))
                    )
                    n_t = nt[ni] + d12[6:9]
                    n_q = quat_normalize(
                        quat_multiply(nq[ni], quat_from_axis_angle(d12[9:12]))
                    )
                    return _constraint_residual_3d(
                        s_t, s_q, n_t, n_q, l_rt[ci], l_rq[ci], l_wt[ci], l_wr[ci]
                    )

                r0 = local(jnp.zeros(12, jnp.float32))
                norm = jnp.linalg.norm(r0)
                w = jnp.where(
                    norm <= l_hub[ci], 1.0,
                    jnp.sqrt(l_hub[ci] / jnp.maximum(norm, 1e-12)),
                )
                J = jax.jacfwd(local)(jnp.zeros(12, jnp.float32)) * w
                m = l_mask[ci]
                return jnp.where(m, J, 0.0), jnp.where(m, r0 * w, 0.0)

            return jax.vmap(one)(jnp.arange(l_submap.shape[0]))

        def eval_fn(params):
            st, sq, nt, nq = params
            J, r = local_jac(st, sq, nt, nq)
            J, r = jax.lax.all_gather((J, r), axis, tiled=True)
            j_s, j_n = J[:, :, :6], J[:, :, 6:]
            cost = 0.5 * jnp.sum(r * r)
            if linear_solver == "cg":
                diag = _spa_diag_blocks(j_s, j_n, r, c_submap, c_node, S, N)
                return (j_s, j_n, diag), cost
            blocks = _spa_partial_blocks(j_s, j_n, r, c_submap, c_node, S, N)
            return blocks, cost

        def delta_of(quant, lam):
            if linear_solver == "cg":
                j_s, j_n, diag = quant
                return _spa_cg_solve(
                    j_s, j_n, diag, c_submap, c_node, fixed_s, fixed_n, lam
                )
            return _spa_schur_solve(quant, fixed_s, fixed_n, lam)

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

        params, final_cost = _lm_drive(
            eval_fn, delta_of, retract, (st0, sq0, nt0, nq0), num_iterations, 1e-4
        )
        return params + (final_cost,)

    return jax.shard_map(
        device_solve,
        mesh=mesh,
        in_specs=(rep,) * 6 + (c_spec,) * 8 + (rep, rep),
        out_specs=(rep,) * 5,
        check_vma=False,  # LM early-termination carry is genuinely per-shard
    )(
        problem.submap_translation,
        problem.submap_rotation,
        problem.node_translation,
        problem.node_rotation,
        problem.submap_fixed,
        problem.node_fixed,
        problem.c_submap,
        problem.c_node,
        problem.c_mask,
        problem.c_rel_translation,
        problem.c_rel_rotation,
        problem.c_translation_weight,
        problem.c_rotation_weight,
        problem.c_huber_scale,
        problem.c_submap,
        problem.c_node,
    )


def spa_sharded_collective_ops(problem, mesh: Mesh, num_iterations: int = 10) -> dict:
    """Static collective-op census of the compiled sharded SPA program
    (the scaling curve's psums-per-solve record, VERDICT r4 next #3):
    counts all-reduce / all-gather / collective-permute HLO ops in the
    lowered executable."""
    solver = (
        solve_spa_2d_sharded
        if isinstance(problem, SpaProblem2D)
        else solve_spa_3d_sharded
    )
    txt = solver.lower(problem, mesh, num_iterations=num_iterations).compile().as_text()
    counts = {}
    for name in ("all-reduce", "all-gather", "collective-permute", "all-to-all"):
        counts[name] = sum(
            1 for line in txt.splitlines() if f" {name}" in line or line.lstrip().startswith(f"%{name}")
        )
    counts["total"] = sum(counts.values())
    return counts

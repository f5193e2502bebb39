"""Matrix-free CG linear solver vs the exact block-Schur path.

The CG path (`_spa_cg_solve`) exists so production-scale graphs avoid the
O(S*N) coupling tensor (a 500x5000 graph pads that tensor to 9.5 GB —
ref operating point: configuration_files/pose_graph.lua:16,
SPA every 90 nodes over multi-thousand-node graphs). Both paths solve the
same damped, fixed-masked normal equations, so converged results must
agree.
"""

import jax
import numpy as np

from hectorgrapher_tpu.evaluation.graph_generator import make_scale_spa_problem
from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_3d


def test_cg_matches_schur_on_medium_graph():
    problem, t_gt, s_gt = make_scale_spa_problem(
        num_nodes=200, num_submaps=24, num_constraints=800, noise=0.3, seed=3
    )
    out_schur = jax.block_until_ready(
        solve_spa_3d(problem, num_iterations=15, linear_solver="schur")
    )
    out_cg = jax.block_until_ready(
        solve_spa_3d(problem, num_iterations=15, linear_solver="cg")
    )
    # Both must reach ground truth; the solutions must agree closely.
    for out in (out_schur, out_cg):
        st, sq, nt, nq, cost = out
        assert np.linalg.norm(np.asarray(nt) - t_gt, axis=1).max() < 0.01
        assert np.linalg.norm(np.asarray(st) - s_gt, axis=1).max() < 0.01
    nt_s, nt_c = np.asarray(out_schur[2]), np.asarray(out_cg[2])
    assert np.abs(nt_s - nt_c).max() < 5e-3, np.abs(nt_s - nt_c).max()


def test_auto_picks_cg_above_budget():
    # 5000 * 500 > _SCHUR_COUPLING_BUDGET: auto must take the CG path.
    # (Covered for convergence by test_spa_scale; here a small smoke run
    # just pins the dispatch so the threshold is not silently lost.)
    from hectorgrapher_tpu.mapping.pose_graph import optimization as opt

    assert 500 * 5000 > opt._SCHUR_COUPLING_BUDGET
    assert 64 * 512 <= opt._SCHUR_COUPLING_BUDGET

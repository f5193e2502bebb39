"""The sharded paths on a multi-device mesh against the same work on one device.

Users reach these without asking: the loop-closure mesh spans every local
device (pose_graph.constraint_search_mesh), and the server shards batched
CT windows with --ct_mesh_devices. Each check also verifies that its
sharded inputs span every device of the mesh, not device 0 alone.
`run_all(devices)` prints one line per check and returns the failures
(chip_smoke.py --cards 4).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh


def _spans(shardings, devices) -> bool:
    """Every sharding lays its array out over all of `devices`."""
    want = set(devices)
    return all(set(s.device_set) == want for s in jax.tree.leaves(shardings))


def _run_compiled(fn, *args):
    """(fn(*args), the input shardings XLA compiled fn for): where the
    launch puts its inputs, whatever the caller passed."""
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled(*args), compiled.input_shardings


def _report(name, err, tol, spans) -> List[str]:
    ok = bool(np.isfinite(err)) and err <= tol and spans
    print(f"SHARDED {name}: max_err={err:.3e} tol={tol:.1e} inputs_span_mesh={spans} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return [] if ok else [f"{name}: err {err:.3e} tol {tol:.1e} spans {spans}"]


def check_constraint_round_3d(devices, grid: int = 256, num_submaps: int = 8) -> List[str]:
    """One batched PoseGraph3D loop-closure round (sharded fast-matcher
    launch + packed GN) over `num_submaps` finished submaps, on a mesh of
    `devices` and on a one-device mesh; the INTER constraints must agree.
    Tolerance 1e-4 m / quaternion units: both runs match the same scan
    against the same submaps in float32, so only summation order differs."""
    from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
    from hectorgrapher_tpu.evaluation.device_checks import production_submap_3d
    from hectorgrapher_tpu.mapping.pose_graph import pose_graph as pg_mod
    from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PgNode, PoseGraph3D
    from hectorgrapher_tpu.mapping.submap_3d import Submap3D
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    hi, lo, hist, high_cloud, low_cloud = production_submap_3d(grid)
    fcm = "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d."
    options = replace_deep(
        MapBuilderOptions(),
        {
            "pose_graph.optimize_every_n_nodes": 0,
            "pose_graph.async_work_queue": False,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 1e6,
            "pose_graph.constraint_builder.min_score": 0.3,
            fcm + "min_rotational_score": 0.1,
            fcm + "min_low_resolution_score": 0.1,
        },
    ).pose_graph

    def round_on(mesh):
        prev = pg_mod._GRAPH_MESH
        pg_mod.set_constraint_search_mesh(mesh)
        try:
            pg = PoseGraph3D(options)
            node = lambda t: PgNode(
                time=t, local_pose=NpRigid3(np.zeros(3)), global_pose=NpRigid3.identity(),
                high_cloud=high_cloud, low_cloud=low_cloud, histogram=hist,
            )
            pg._sampler = pg_mod._SamplerState(0.0)
            for i in range(num_submaps):
                sm = Submap3D(
                    local_pose=NpRigid3(np.array([0.05 * i, 0.0, 0.0])),
                    high_resolution_grid=jax.tree.map(jnp.copy, hi),
                    low_resolution_grid=jax.tree.map(jnp.copy, lo),
                    rotational_histogram=hist, insertion_finished=True,
                )
                pg.add_node(node(0.01 * i), [sm])
            pg._sampler = pg_mod._SamplerState(1.0)
            active = Submap3D(
                local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=hi,
                low_resolution_grid=lo, rotational_histogram=hist,
                insertion_finished=False,
            )
            pg.add_node(node(1.0), [active])
            inter = sorted(
                (c.submap_index, c.zbar.t.tolist(), c.zbar.q.tolist())
                for c in pg.constraints if c.tag == "INTER"
            )
            return inter, pg._pack3d["packed"].pyramids
        finally:
            pg_mod.set_constraint_search_mesh(prev)

    many, pack = round_on(Mesh(np.asarray(devices), ("graph",)))
    one, _ = round_on(Mesh(np.asarray(devices[:1]), ("graph",)))
    if not many or [c[0] for c in many] != [c[0] for c in one]:
        print(f"SHARDED constraint_round_3d: INTER submaps {len(many)} on the mesh vs "
              f"{len(one)} on one device", flush=True)
        return ["constraint_round_3d: INTER constraints differ"]
    err = max(
        float(np.max(np.abs(np.subtract(a[k], b[k])))) for a, b in zip(many, one) for k in (1, 2)
    )
    print(f"constraint_round_3d: {len(many)} INTER constraints over {num_submaps} submaps")
    return _report(
        "constraint_round_3d", err, 1e-4, _spans([a.sharding for a in pack], devices)
    )


def check_spa(devices, sizes=(500, 5000, 20000)) -> List[str]:
    """Sharded SPA (parallel/sharded.py) against solve_spa_3d on one device.
    Tolerance 1e-3 m, as device_checks.check_spa: the sharded solve sums
    its normal equations in another order."""
    from hectorgrapher_tpu.evaluation.graph_generator import make_scale_spa_problem
    from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_3d
    from hectorgrapher_tpu.parallel.sharded import solve_spa_3d_sharded

    s, n, c = sizes
    problem, _, _ = make_scale_spa_problem(n, s, c, noise=0.5, seed=0)
    mesh = Mesh(np.asarray(devices), ("graph",))
    (st, _, nt, _, _), shardings = _run_compiled(
        lambda p: solve_spa_3d_sharded(p, mesh, num_iterations=10), problem
    )
    with jax.default_device(devices[0]):
        rt, _, rn, _, _ = solve_spa_3d(jax.device_put(problem, devices[0]), num_iterations=10)
    err = max(
        float(np.max(np.abs(np.asarray(st) - np.asarray(rt)))),
        float(np.max(np.abs(np.asarray(nt) - np.asarray(rn)))),
    )
    return _report(f"spa_{s}_{n}_{c}", err, 1e-3, _spans(shardings, devices))


def check_ct_windows(devices, grid: int = 256, per_device: int = 2) -> List[str]:
    """Sharded CT windows (parallel/ct_windows.py) against the unsharded
    batched solve on one device. Tolerance 1e-4 m, as
    device_checks.check_ct_window: each window is the same program."""
    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window_batched
    from hectorgrapher_tpu.parallel.ct_windows import solve_ct_windows_sharded

    hi, lo, problem, state, weights = _build_ct_example(grid=grid, cube=True)
    b = per_device * len(devices)
    rng = np.random.default_rng(2)
    bcast = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), t)
    states = bcast(state)._replace(
        translation=jnp.asarray(
            np.asarray(state.translation)[None]
            + rng.normal(0, 0.02, (b,) + state.translation.shape).astype(np.float32)
        )
    )
    batch = (bcast(hi), bcast(lo), bcast(problem), states)
    mesh = Mesh(np.asarray(devices), ("graph",))
    sharded = lambda *b: solve_ct_windows_sharded(
        mesh, *b, weights, is_tsdf=True, num_iterations=8
    )
    (solved, cost, _), shardings = _run_compiled(sharded, *batch)
    one = jax.device_put(batch, devices[0])
    ref, ref_cost, _ = solve_ct_window_batched(
        *one, jax.device_put(weights, devices[0]), is_tsdf=True, num_iterations=8
    )
    err = max(
        float(np.max(np.abs(np.asarray(solved.translation) - np.asarray(ref.translation)))),
        float(np.max(np.abs(np.asarray(solved.rotation) - np.asarray(ref.rotation)))),
        float(np.max(np.abs(np.asarray(cost) - np.asarray(ref_cost))
                     / np.maximum(np.abs(np.asarray(ref_cost)), 1e-12))),
    )
    return _report(
        f"ct_windows_{grid}_b{b}", err, 1e-4, _spans(shardings, devices)
    )


def run_all(devices, grid: int = 256, spa_sizes=(500, 5000, 20000)) -> List[str]:
    failures = []
    failures += check_constraint_round_3d(devices, grid)
    failures += check_spa(devices, spa_sizes)
    failures += check_ct_windows(devices, grid)
    return failures

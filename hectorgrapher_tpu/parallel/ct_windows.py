"""Mesh-sharded continuous-time window solves — multi-robot serving.

The reference's multi-robot MapBuilderServer runs one local SLAM stack
per trajectory on CPU threads (ref: cloud/internal/map_builder_server.cc
— one SLAM thread; scaling is adding servers). The device-side serving
shape: each device of the mesh solves the CT windows of its share of
trajectories — the batched window solve (`solve_ct_window_batched`)
sharded over the mesh's `graph` axis with `shard_map`. Zero collectives:
window solves are independent per trajectory, so the mesh scales serving
throughput linearly and the interconnect stays free for the pose-graph collectives
(parallel/sharded.py).

Grids of one shard batch must share shapes (bucket trajectories by
submap configuration, as the batched matcher buckets cloud sizes).
"""

from __future__ import annotations

import functools

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window_batched


def solve_ct_windows_sharded(
    mesh: Mesh,
    high_grids,
    low_grids,
    problems,
    states0,
    weights,
    is_tsdf: bool,
    num_iterations: int = 12,
    axis: str = "graph",
    per_point: bool = False,
    directs=None,
):
    """Solve a batch of CT windows sharded over `mesh`'s `axis`.

    All pytree leaves of high_grids/low_grids/problems/states0 (and
    `directs`, batched DirectImuData, when given) carry a leading batch
    dim divisible by the mesh axis size; weights are replicated. Returns
    the same (CtState, final_cost, initial_cost) pytree as
    solve_ct_window_batched. per_point=True shards the accuracy-flagship
    per-point-unwarping mode the same way (ref:
    optimizing_local_trajectory_builder.cc:513-926)."""
    sharded = P(axis)
    rep = P()

    fn = functools.partial(
        solve_ct_window_batched, is_tsdf=is_tsdf,
        num_iterations=num_iterations, per_point=per_point,
    )

    def shard_fn(h, l, p, s, w, d):
        return fn(h, l, p, s, w, directs=d)

    batched_spec = lambda tree: jax.tree.map(lambda _: sharded, tree)
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            batched_spec(high_grids),
            batched_spec(low_grids),
            batched_spec(problems),
            batched_spec(states0),
            jax.tree.map(lambda _: rep, weights),
            batched_spec(directs),
        ),
        out_specs=(
            jax.tree.map(lambda _: sharded, states0),
            sharded,
            sharded,
        ),
        # The LM while_loop's early-termination carry becomes device-varying
        # mid-loop; vma checking would reject it (it is genuinely per-shard).
        check_vma=False,
    )(high_grids, low_grids, problems, states0, weights, directs)

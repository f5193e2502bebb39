"""Multi-host (multi-process) distribution.

The reference distributes across machines with gRPC only: robots upload
to one MapBuilderServer process that owns the whole pose graph
(ref: cloud/internal/map_builder_server.cc; SURVEY §2.12 #3). The
shape splits the two planes:

  * SENSOR plane (host-side, unchanged): each host runs the gRPC edge
    (`cloud/server.py`) for its robots — ingestion, collation and local
    SLAM stay host-local, exactly the reference's topology.
  * SOLVER plane (device-side, new): pose-graph state is sharded over the
    GLOBAL mesh spanning every host's devices. The sharded SPA and
    constraint search (`parallel/sharded.py`, `parallel/constraint_
    search.py`) run unchanged on that mesh — under `shard_map`, XLA
    lowers the psum/all_gather collectives to NCCL, over NVLink between
    the cards of a host and the network between hosts; no collective is
    written by hand.

This module is the thin bootstrap for the solver plane: every host calls
`initialize_process` (JAX's coordination service: one coordinator
address, a process id per host), then `global_mesh()` returns the mesh
over ALL hosts' devices. Everything downstream takes a `Mesh` and does
not care whether it is single-host.

Hermetic proof (SURVEY §4 "multi-node without a cluster"):
`tests/test_multihost.py` spawns two REAL processes on localhost, each
with 4 virtual CPU devices, forms the 2-process global mesh, and checks
the sharded SPA solve against the single-process result.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_process(
    coordinator_address: str, num_processes: int, process_id: int, **kwargs
) -> None:
    """Join the multi-host coordination service (one call per host,
    before any device use). Wraps jax.distributed.initialize so callers
    don't import jax internals (ref: the reference's equivalent is gRPC
    channel setup in map_builder_server_main.cc)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def global_mesh(axis: str = "graph") -> Mesh:
    """Mesh over every device of every participating host. On one host
    this is exactly the single-host mesh the rest of `parallel/` uses."""
    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def process_count() -> int:
    return jax.process_count()


def local_device_slice(global_batch: int) -> slice:
    """The rows of a leading batch axis this host feeds (hosts supply
    per-host data for globally-sharded arrays via
    jax.make_array_from_process_local_data or equivalent)."""
    if global_batch % jax.process_count() != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{jax.process_count()} — pad the batch (rows would be silently dropped)"
        )
    per = global_batch // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)

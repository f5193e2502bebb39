"""Cross-trajectory batched CT window serving.

The reference's multi-robot MapBuilderServer runs ONE SLAM thread that
processes sensor items FIFO, so each trajectory's continuous-time window
solves run serially (ref: cloud/internal/map_builder_server.cc
ProcessSensorDataQueue:157-176). On a device that schedule wastes it:
a single window solve is latency-bound while the batched
solve amortizes dispatch and the 72x72 damped solves into one program
(solve_ct_window_batched — the benched multi-robot operating point).

This batcher gives the server that operating point on the PRODUCTION
path: the SLAM loop drains the sensor queue, advances each trajectory on
its own worker thread (per-trajectory order preserved — the reference's
TrajectoryCollator makes the same guarantee and no stronger one), and
when every live worker is blocked inside a window solve, stacks the
compatible pending solves into ONE batched launch — including the
accuracy-flagship per-point-unwarping mode and DIRECT-IMU payloads
(grouped by mode + leaf shapes). Results are distributed back and the
workers continue. Solves that cannot share a program (different grid
shapes / iteration counts / weights / payload shapes) fall back to the
serial solver, unchanged.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np


def _batch_key(p) -> tuple:
    """Solves sharing this key run in one solve_ct_window_batched launch
    (weights are shared across the batch by that function's contract)."""
    import jax

    grid_shapes = tuple(
        tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves((p.high_grid, p.low_grid))
    )
    weights = tuple(float(np.asarray(w)) for w in jax.tree_util.tree_leaves(p.weights))
    return (
        grid_shapes,
        tuple(tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(p.problem)),
        p.is_tsdf,
        p.num_iterations,
        weights,
        bool(p.per_point),
        # DIRECT-IMU payloads batch when their leaf shapes agree; None and
        # present payloads never share a program.
        tuple(tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(p.direct))
        if p.direct is not None
        else None,
    )


class CtWindowBatcher:
    """Coordinator + per-builder solve hook (see module docstring).

    Usage: `batcher.install(ct_builder)` per trajectory; `begin(n)`, run
    each trajectory's sensor items on its own thread ending with
    `finish()`; the coordinator thread calls `serve()` until all workers
    finish. The server (cloud/server.py batch_ct_windows mode) wires this
    into its SLAM loop."""

    def __init__(self, mesh=None):
        self._cv = threading.Condition()
        self._requests: List[dict] = []
        self._active_workers = 0
        self._blocked = 0
        self._mesh = mesh
        self._dead = None  # set by fail_pending: subsequent solves fail fast
        # Observability (also the test's proof of batching).
        self.batched_launches = 0
        self.serial_solves = 0
        self.batch_sizes: List[int] = []

    def install(self, builder) -> None:
        builder.window_solve_fn = self._solve

    # -- worker side ---------------------------------------------------------

    def begin(self, n: int) -> None:
        """Register n workers BEFORE starting their threads (serve() would
        otherwise observe zero active workers and return immediately)."""
        with self._cv:
            self._active_workers += n

    def finish(self) -> None:
        """Called by each worker thread when its items are exhausted."""
        with self._cv:
            self._active_workers -= 1
            self._cv.notify_all()

    def _solve(self, pending):
        """Builder hook, called on a worker thread: queue the request and
        block until the coordinator solves it."""
        entry = {"pending": pending, "event": threading.Event(), "solved": None, "error": None}
        with self._cv:
            if self._dead is not None:
                raise self._dead
            self._requests.append(entry)
            self._blocked += 1
            self._cv.notify_all()
        entry["event"].wait()
        with self._cv:
            self._blocked -= 1
        if entry["error"] is not None:
            raise entry["error"]
        return entry["solved"]

    def fail_pending(self, error: Exception) -> None:
        """Abort every queued/blocked solve with `error` (the server's
        recovery path when serve() dies: blocked workers must wake and
        finish their items or every RPC joining the sensor queue hangs)."""
        with self._cv:
            self._dead = error
            pending = self._requests
            self._requests = []
        for entry in pending:
            entry["error"] = error
            entry["event"].set()

    # -- coordinator side ----------------------------------------------------

    def serve(self, timeout: float = 300.0) -> None:
        """Run on the coordinating (SLAM) thread until every worker has
        exited: whenever all live workers are blocked on solves, flush
        the pending batch. `timeout` bounds time WITHOUT PROGRESS (a
        flush, a new request, or a worker exiting all reset it) — a
        fixed overall deadline would fire on long but healthy drains."""
        import time

        last_progress = time.monotonic()
        progress_marker = (0, 0, 0)
        with self._cv:
            while self._active_workers > 0:
                marker = (self._active_workers, self._blocked, len(self._requests))
                if marker != progress_marker:
                    progress_marker = marker
                    last_progress = time.monotonic()
                ready = (
                    self._blocked > 0
                    and len(self._requests) >= self._blocked
                    and self._blocked >= self._active_workers
                )
                if not ready:
                    if (
                        not self._cv.wait(timeout=1.0)
                        and time.monotonic() - last_progress > timeout
                    ):
                        raise RuntimeError("ct batcher stalled")
                    continue
                batch = self._requests
                self._requests = []
                last_progress = time.monotonic()
                self._cv.release()
                try:
                    self._flush(batch)
                finally:
                    self._cv.acquire()

    def _flush(self, batch: List[dict]) -> None:
        groups: Dict[tuple, List[dict]] = {}
        serial: List[dict] = []
        for entry in batch:
            p = entry["pending"]
            groups.setdefault(_batch_key(p), []).append(entry)
        for key, entries in groups.items():
            if len(entries) == 1:
                serial.extend(entries)
                continue
            try:
                self._solve_batched(entries)
            except Exception as e:  # noqa: BLE001 — report to the waiting worker
                for entry in entries:
                    entry["error"] = e
                    entry["event"].set()
        for entry in serial:
            try:
                p = entry["pending"]
                from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window

                solved, _, _ = solve_ct_window(
                    p.high_grid, p.low_grid, p.problem, p.state0, p.weights,
                    is_tsdf=p.is_tsdf, num_iterations=p.num_iterations,
                    per_point=p.per_point, direct=p.direct,
                )
                self.serial_solves += 1
                entry["solved"] = solved
            except Exception as e:  # noqa: BLE001
                entry["error"] = e
            entry["event"].set()

    def _solve_batched(self, entries: List[dict]) -> None:
        import jax
        import jax.numpy as jnp

        from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window_batched

        ps = [e["pending"] for e in entries]
        n = len(ps)
        pad_n = n
        if self._mesh is not None:
            # Sharded serving (parallel/ct_windows.py): pad the batch to a
            # mesh-divisible size (repeating lane 0 — window solves are
            # independent, pad lanes are discarded) so each device solves
            # its share of trajectories.
            d = self._mesh.devices.size
            pad_n = ((n + d - 1) // d) * d
        idx = list(range(n)) + [0] * (pad_n - n)
        stack = lambda trees: jax.tree_util.tree_map(
            lambda *xs: jnp.stack([xs[i] for i in idx]), *trees
        )
        his = stack([p.high_grid for p in ps])
        los = stack([p.low_grid for p in ps])
        problems = stack([p.problem for p in ps])
        states = stack([p.state0 for p in ps])
        per_point = bool(ps[0].per_point)
        directs = (
            stack([p.direct for p in ps]) if ps[0].direct is not None else None
        )
        if self._mesh is not None:
            from hectorgrapher_tpu.parallel.ct_windows import solve_ct_windows_sharded

            solved, _, _ = solve_ct_windows_sharded(
                self._mesh, his, los, problems, states, ps[0].weights,
                is_tsdf=ps[0].is_tsdf, num_iterations=ps[0].num_iterations,
                per_point=per_point, directs=directs,
            )
        else:
            solved, _, _ = solve_ct_window_batched(
                his, los, problems, states, ps[0].weights,
                is_tsdf=ps[0].is_tsdf, num_iterations=ps[0].num_iterations,
                per_point=per_point, directs=directs,
            )
        self.batched_launches += 1
        self.batch_sizes.append(len(entries))
        trans = np.asarray(solved.translation)
        rot = np.asarray(solved.rotation)
        vel = np.asarray(solved.velocity)
        for i, entry in enumerate(entries):
            entry["solved"] = type(solved)(
                translation=trans[i], rotation=rot[i], velocity=vel[i]
            )
            entry["event"].set()

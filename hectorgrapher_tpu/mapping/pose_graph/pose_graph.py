"""Pose graph back-end: constraints, loop closure, global optimization.

Replacement for PoseGraph2D/PoseGraph3D
(ref: mapping/internal/2d/pose_graph_2d.cc, internal/3d/pose_graph_3d.cc +
internal/constraints/constraint_builder_{2d,3d}.cc). The reference runs an
asynchronous work queue on a thread pool; here the same decisions run
synchronously and the *computation* is batched on device ("batch, don't
queue", SURVEY.md section 2.12): loop-closure searches are dense top-k
matcher launches, and the SPA solve is one jitted block-GN program.

Bookkeeping (node/submap tables, constraint lists, sampling and distance
gates, trajectory lifecycle) lives on the host.
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.common.math import normalize_angle_difference
from hectorgrapher_tpu.mapping.pose_graph.optimization import (
    SpaProblem2D,
    SpaProblem3D,
    solve_spa_2d,
    solve_spa_3d,
)
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_2d import (
    make_fast_search_config,
    match_fast_2d_prepared,
    prepare_fast_matcher_2d,
)
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
    FastCorrelativeScanMatcher3D,
)
from hectorgrapher_tpu.mapping.scan_matching.gn_2d import (
    _match_gn_2d_probability_field,
    _match_gn_2d_tsdf_fields,
    prepare_gn_probability_field,
    prepare_gn_tsdf_fields,
)
from hectorgrapher_tpu.mapping.scan_matching.gn_3d import match_gn_3d
from hectorgrapher_tpu.mapping.grids import TSDFGrid
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu.transform.rigid import Rigid2, Rigid3


class TrajectoryState(Enum):
    """(ref: pose_graph_interface.h:85)"""

    ACTIVE = 0
    FINISHED = 1
    FROZEN = 2
    DELETED = 3


@dataclass
class Constraint:
    """(ref: pose_graph_interface.h:33-53 Constraint)"""

    submap_index: int
    node_index: int
    zbar: NpRigid3  # relative pose submap <- node (3D); 2D packs (x,y,theta)
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA" | "INTER"


@dataclass
class PgNode:
    time: float
    local_pose: NpRigid3
    global_pose: NpRigid3
    trajectory_id: int = 0
    # constant data for loop closure:
    cloud: Optional[PointCloud] = None  # 2D: gravity-aligned filtered cloud
    high_cloud: Optional[PointCloud] = None  # 3D
    low_cloud: Optional[PointCloud] = None
    histogram: Optional[np.ndarray] = None
    gravity_alignment: Optional[np.ndarray] = None
    # Stable identity surviving trims — the analog of the reference's
    # NodeId (ref: mapping/id.h:136). Positional indices into
    # pose_graph.nodes are remapped by trimming; async work items and
    # matcher caches must reference nodes by this id instead.
    node_id: int = -1


@dataclass
class PgSubmap:
    submap: object  # Submap2D | Submap3D
    global_pose: NpRigid3
    trajectory_id: int = 0
    finished: bool = False
    matcher: object = None  # lazily built loop-closure matcher
    # Stable identity surviving trims (ref: mapping/id.h SubmapId).
    submap_id: int = -1


_SCORE_HISTOGRAMS: Dict[str, object] = {}


def _observe_constraint_score(kind: str, score: float) -> None:
    """Loop-closure matcher score histograms (ref: constraint_builder_
    {2d,3d}.cc:303-315 — the reference logs score histograms after every
    constraint round; here they land in the metrics registry and the
    Prometheus endpoint)."""
    from hectorgrapher_tpu.common.profiling import global_factory

    h = _SCORE_HISTOGRAMS.get(kind)
    if h is None:
        h = global_factory().new_histogram_family(
            f"pose_graph_constraint_scores_{kind}",
            "loop-closure matcher scores (found + rejected candidates)",
            boundaries=[i / 20.0 for i in range(1, 21)],
        ).add({})
        _SCORE_HISTOGRAMS[kind] = h
    h.observe(score)


_BATCH_METRICS: Dict[str, object] = {}
_RESIDUAL_HISTOGRAMS: Dict[str, object] = {}
_PACK_GAUGES: Dict[str, object] = {}


def _set_pack_bytes_gauge(kind: str, value: int) -> None:
    """HBM bytes of the device-resident constraint-search pack (see
    _get_pack_3d budget/eviction)."""
    from hectorgrapher_tpu.common.profiling import global_factory

    g = _PACK_GAUGES.get(kind)
    if g is None:
        g = global_factory().new_gauge_family(
            f"pose_graph_constraint_pack_bytes_{kind}",
            "device-resident constraint-search pack residency in bytes",
        ).add({})
        _PACK_GAUGES[kind] = g
    g.set(float(value))


def _observe_batched_round(num_candidates: int) -> None:
    """Count batched loop-closure launches + candidates per launch (the
    observable proof that production rounds ride the sharded path)."""
    from hectorgrapher_tpu.common.profiling import global_factory

    if "rounds" not in _BATCH_METRICS:
        _BATCH_METRICS["rounds"] = global_factory().new_counter_family(
            "pose_graph_batched_constraint_rounds_total",
            "loop-closure rounds scored via one sharded matcher launch",
        ).add({})
        _BATCH_METRICS["candidates"] = global_factory().new_histogram_family(
            "pose_graph_batched_constraint_candidates",
            "gate-passing candidates per batched loop-closure launch",
            boundaries=[2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0],
        ).add({})
    _BATCH_METRICS["rounds"].increment()
    _BATCH_METRICS["candidates"].observe(float(num_candidates))


# Per-stage profiling of one production constraint round (bench's
# constraint_round_breakdown, VERDICT r3 #2): set ROUND_PROFILING = True,
# run one add_node, read LAST_ROUND_BREAKDOWN (seconds per stage; device
# stages are closed by forced readbacks so they measure completion, not
# enqueue).
ROUND_PROFILING = False
LAST_ROUND_BREAKDOWN: Dict[str, float] = {}

# Max DISTINCT submaps per packed-GN refinement launch (3D): each distinct
# entry holds ~193 MB of prepared interpolation table at the 256^3
# production extent (plus comparable prepare transients), so rounds whose
# survivors span more distinct submaps split into sequential blocks.
_GN3D_MAX_DISTINCT = 8

_GRAPH_MESH = None


def constraint_search_mesh():
    """Device mesh for batched loop-closure launches: all LOCAL devices on
    a 'graph' axis. One chip locally degenerates to plain batching; the
    multihost server installs a global mesh via set_solver_mesh (with a
    follower broadcast hook) so the same launches shard submaps across
    hosts (SURVEY §2.12 #3). The default is deliberately local-only: on a
    multi-process runtime jax.devices() spans every host, and a collective
    launch over devices no follower drives deadlocks at the first round."""
    global _GRAPH_MESH
    if _GRAPH_MESH is None:
        import jax
        from jax.sharding import Mesh

        _GRAPH_MESH = Mesh(np.asarray(jax.local_devices()), ("graph",))
    return _GRAPH_MESH


def _pack_budget_bytes(options) -> int:
    """The constraint builder's pack budget, derived from the device where
    the options leave it unset."""
    from hectorgrapher_tpu.common.device import pack_budget_bytes

    budget = options.constraint_builder.pack_hbm_budget_bytes
    return pack_budget_bytes() if budget is None else int(budget)


def set_constraint_search_mesh(mesh) -> None:
    global _GRAPH_MESH
    _GRAPH_MESH = mesh


def _stack_trees(trees, pad_to: int = 0):
    """Stack a list of identically-shaped pytrees along a new axis 0,
    repeating the first element up to pad_to lanes (padding bounds the
    number of distinct batch shapes the jitted solvers compile for)."""
    import jax

    if pad_to > len(trees):
        trees = list(trees) + [trees[0]] * (pad_to - len(trees))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _SamplerState:
    """(ref: common/fixed_ratio_sampler.h FixedRatioSampler)"""

    def __init__(self, ratio: float):
        self.ratio = ratio
        self.num_pulses = 0
        self.num_samples = 0

    def pulse(self) -> bool:
        self.num_pulses += 1
        if self.num_samples * 1.0 < self.ratio * self.num_pulses:
            self.num_samples += 1
            return True
        return False


class PoseGraphBase:
    """Shared bookkeeping for 2D/3D pose graphs."""

    def __init__(self, options):
        from hectorgrapher_tpu.mapping.pose_graph.connectivity import TrajectoryConnectivityState

        self._options = options  # PoseGraphOptions
        self.nodes: List[PgNode] = []
        self.submaps: List[PgSubmap] = []
        self.constraints: List[Constraint] = []
        self._submap_ids: Dict[int, int] = {}  # id(submap object) -> index
        # Stable-id bookkeeping (ref: mapping/id.h NodeId/SubmapId): work
        # items and caches key by these ids; trimming rebuilds the maps
        # (trimmers.rebuild_id_maps) so pending items resolve to the right
        # entries — or get dropped — instead of silently hitting remapped
        # positional indices.
        self._next_node_id = 0
        self._next_submap_id = 0
        self._node_index_by_id: Dict[int, int] = {}
        self._submap_index_by_id: Dict[int, int] = {}
        self._num_nodes_since_last_optimization = 0
        self._sampler = _SamplerState(options.constraint_builder.sampling_ratio)
        self._global_sampler = _SamplerState(options.global_sampling_ratio)
        self._trajectory_states: Dict[int, TrajectoryState] = {0: TrajectoryState.ACTIVE}
        self.connectivity = TrajectoryConnectivityState()
        self.trimmers: List[object] = []
        self.num_optimizations = 0
        self._global_optimization_callbacks: List[object] = []
        # Landmark pose overrides (ref: pose_graph SetLandmarkPose — a
        # client-provided pose seeds/fixes the landmark in optimization).
        self._landmark_pose_overrides: Dict[str, object] = {}

        # Async work queue (ref: pose_graph_3d.cc AddWorkItem:162-177,
        # DrainWorkQueue:512-535): AddNode returns after enqueueing; the
        # constraint searches + periodic optimization run on a background
        # thread. _lock guards the host bookkeeping; _opt_lock serializes
        # optimizations (the jitted solve itself runs without _lock so the
        # front-end keeps streaming — the reference's exact structure).
        self._lock = threading.RLock()
        self._opt_lock = threading.Lock()
        # Serializes whole constraint rounds: the batched path mutates
        # per-round caches (_pack2d/_pack3d, _matcher_cache, samplers) and
        # — multi-host — must keep broadcast/launch ordering; embeddings
        # that call add_node from several threads (the batched CT server's
        # per-trajectory workers) would otherwise race them. RLock: the
        # round may re-enter run_final_optimization on the same thread.
        self._constraint_lock = threading.RLock()
        # Multi-host solver plane (SURVEY §2.12 #3): when set, the SPA
        # solve runs sharded over this mesh and `_solver_broadcast` (if
        # any) ships each solve's inputs to follower processes so every
        # participant enters the same collective program.
        self._solver_mesh = None
        self._solver_broadcast = None
        self._shipped_pack2d: set = set()  # {(sid, depth)} shipped
        self._shipped_order2d: Dict[int, list] = {}  # depth -> order
        self._shipped_pack3d: set = set()
        self._shipped_order3d = None
        self._cloud_range_cache: Dict[int, float] = {}
        self._async = bool(getattr(options, "async_work_queue", False))
        self._work_queue: Optional[queue_mod.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if self._async:
            self._work_queue = queue_mod.Queue()
            self._worker = threading.Thread(
                target=self._drain_work_queue, name="pose-graph-work-queue", daemon=True
            )
            self._worker.start()

    # -- submap bookkeeping -------------------------------------------------

    def _get_or_add_submap(self, submap, trajectory_id: int) -> int:
        key = id(submap)
        if key not in self._submap_ids:
            # Initialize the global pose from the local pose corrected by the
            # current local-to-global transform of the trajectory.
            local_to_global = self.local_to_global(trajectory_id)
            self._submap_ids[key] = len(self.submaps)
            self._submap_index_by_id[self._next_submap_id] = len(self.submaps)
            self.submaps.append(
                PgSubmap(
                    submap=submap,
                    global_pose=local_to_global.compose(submap.local_pose),
                    trajectory_id=trajectory_id,
                    submap_id=self._next_submap_id,
                )
            )
            self._next_submap_id += 1
        idx = self._submap_ids[key]
        if getattr(submap, "insertion_finished", False) and not self.submaps[idx].finished:
            self.submaps[idx].finished = True
            if self._async:
                # Matcher/pyramid construction happens off the front-end
                # thread (ref: DispatchScanMatcherConstruction as a
                # dependency task, constraint_builder_3d.cc:162-189).
                self._work_queue.put(("finish_submap", self.submaps[idx].submap_id))
            else:
                self._on_submap_finished(self.submaps[idx])
        return idx

    def local_to_global(self, trajectory_id: int = 0) -> NpRigid3:
        """Correction mapping local SLAM frame -> global frame
        (ref: pose_graph GetLocalToGlobalTransform)."""
        with self._lock:
            for node in reversed(self.nodes):
                if node.trajectory_id == trajectory_id:
                    return node.global_pose.compose(node.local_pose.inverse())
            return NpRigid3.identity()

    def register_trajectory(self, trajectory_id: int) -> None:
        """Mark a trajectory ACTIVE (idempotent) — the public entry for
        MapBuilder/deserialization instead of poking _trajectory_states."""
        self._trajectory_states.setdefault(trajectory_id, TrajectoryState.ACTIVE)

    def freeze_trajectory(self, trajectory_id: int) -> None:
        self._trajectory_states[trajectory_id] = TrajectoryState.FROZEN

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._trajectory_states[trajectory_id] = TrajectoryState.FINISHED

    def is_frozen(self, trajectory_id: int) -> bool:
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FROZEN

    def is_finished(self, trajectory_id: int) -> bool:
        """(ref: pose_graph IsTrajectoryFinished)"""
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FINISHED

    def trajectory_states(self) -> Dict[int, TrajectoryState]:
        """(ref: pose_graph GetTrajectoryStates)"""
        with self._lock:
            return dict(self._trajectory_states)

    def delete_trajectory(self, trajectory_id: int) -> None:
        """Remove a trajectory's submaps/nodes/constraints and per-
        trajectory sensor buffers from the graph (ref: pose_graph_2d/3d.cc
        DeleteTrajectory — the trajectory is marked DELETED and its data
        trimmed on the work queue).

        Holds _opt_lock for the whole operation: a concurrent optimization
        round's trimmer would remap the positional indices between our
        index snapshot and the trim."""
        from hectorgrapher_tpu.mapping.pose_graph.trimmers import trim_submaps

        self.wait_for_all_computations()
        with self._opt_lock, self._lock:
            self._trajectory_states[trajectory_id] = TrajectoryState.DELETED
            own = {
                i for i, s in enumerate(self.submaps) if s.trajectory_id == trajectory_id
            }
            if own:
                trim_submaps(self, own)
            # Nodes of the trajectory that survived (kept alive by
            # constraints to other trajectories' submaps are already gone
            # with those constraints; unconstrained leftovers drop here).
            keep = [i for i, n in enumerate(self.nodes) if n.trajectory_id != trajectory_id]
            if len(keep) != len(self.nodes):
                node_remap = {old: new for new, old in enumerate(keep)}
                self.constraints = [
                    c for c in self.constraints if c.node_index in node_remap
                ]
                for c in self.constraints:
                    c.node_index = node_remap[c.node_index]
                self.nodes = [self.nodes[i] for i in keep]
                self._node_index_by_id = {
                    n.node_id: i for i, n in enumerate(self.nodes)
                }
            # Per-trajectory sensor state must go with the trajectory:
            # stale landmark observations would otherwise re-bind to other
            # trajectories' nodes in later solves.
            for attr in ("_odometry", "_fixed_frame", "_imu"):
                buf = getattr(self, attr, None)
                if isinstance(buf, dict):
                    buf.pop(trajectory_id, None)
            obs = getattr(self, "_landmark_observations", None)
            if obs is not None:
                self._landmark_observations = [
                    o for o in obs if o["trajectory_id"] != trajectory_id
                ]

    def set_landmark_pose(self, landmark_id: str, global_pose) -> None:
        """Set a landmark's global pose (ref: pose_graph SetLandmarkPose —
        the provided pose replaces the current estimate and seeds the next
        solve, which may refine it; _build_extras consumes the override as
        the landmark's initialization and _run_optimization drops it once
        an optimized estimate exists)."""
        with self._lock:
            self._landmark_pose_overrides[landmark_id] = global_pose
            ids = getattr(self, "_landmark_ids", None)
            if ids is not None and landmark_id not in ids:
                ids[landmark_id] = len(ids)

    def landmark_poses(self) -> Dict[str, NpRigid3]:
        """Current landmark estimates: optimized poses, with client
        overrides (set_landmark_pose) shadowing until the next solve
        consumes them as seeds."""
        with self._lock:
            out = dict(self._landmark_poses) if hasattr(self, "_landmark_poses") else {}
            out.update(self._landmark_pose_overrides)
            return out

    def _consume_landmark_overrides(self, optimized_ids) -> None:
        """Drop overrides whose landmark was just optimized (the seed has
        been consumed; the refined estimate takes over). Caller context:
        end of _run_optimization."""
        with self._lock:
            for name in list(self._landmark_pose_overrides):
                ids = getattr(self, "_landmark_ids", {})
                if ids.get(name) in optimized_ids:
                    self._landmark_pose_overrides.pop(name)

    def set_solver_mesh(self, mesh, broadcast=None) -> None:
        """Install a device mesh for the back-end's device programs: the
        batched constraint search runs sharded over it, and extras-free
        SPA solves route through the sharded solvers (parallel/sharded.py).
        `broadcast(op, payload)` — if given — is called before each sharded
        solve and each batched constraint-round launch so follower
        processes of a multi-host mesh enter the same collective programs
        (cloud/solver_plane.py). None reverts to local devices.

        A mesh spanning multiple PROCESSES without a broadcast hook is
        refused: the leader's first collective launch would wait forever
        for devices no local code ever drives (the round-3 deadlock)."""
        if mesh is not None and broadcast is None:
            import jax

            local = set(jax.local_devices())
            if any(d not in local for d in mesh.devices.flat):
                raise ValueError(
                    "set_solver_mesh: mesh spans multiple processes but no "
                    "broadcast hook was given — followers could never enter "
                    "the collective programs (wire cloud/solver_plane.py)"
                )
        self._solver_mesh = mesh
        self._solver_broadcast = broadcast
        # Per-mesh broadcast bookkeeping: which pack entries followers hold.
        self._shipped_pack2d = set()
        self._shipped_order2d = {}
        self._shipped_pack3d = set()
        self._shipped_order3d = None
        set_constraint_search_mesh(mesh)

    def add_global_slam_optimization_callback(self, callback) -> None:
        """callback(num_optimizations) runs after every optimization round
        (ref: pose_graph SetGlobalSlamOptimizationCallback,
        map_builder_server.cc OnGlobalSlamOptimizations fan-out)."""
        self._global_optimization_callbacks.append(callback)

    def _notify_global_optimization(self) -> None:
        for cb in list(self._global_optimization_callbacks):
            try:
                cb(self.num_optimizations)
            except Exception:
                import traceback

                traceback.print_exc()

    # -- hooks implemented by 2D/3D subclasses ------------------------------

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        raise NotImplementedError

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False) -> Optional[Constraint]:
        raise NotImplementedError

    def _run_optimization(self, num_iterations: int) -> None:
        raise NotImplementedError

    # -- main entry ---------------------------------------------------------

    def add_node(self, node: PgNode, insertion_submaps, newly_finished=()) -> int:
        """(ref: pose_graph_3d.cc AddNode:142-160 — bookkeeping under the
        mutex — then ComputeConstraintsForNode:313-395, executed inline in
        sync mode or as a work item on the background thread in async
        mode.)"""
        with self._lock:
            local_to_global = self.local_to_global(node.trajectory_id)
            node.global_pose = local_to_global.compose(node.local_pose)
            node_index = len(self.nodes)
            node.node_id = self._next_node_id
            self._node_index_by_id[node.node_id] = node_index
            self._next_node_id += 1
            self.nodes.append(node)

            # INTRA constraints against the submaps the node was inserted into.
            self.connectivity.add(node.trajectory_id)
            for submap in insertion_submaps:
                si = self._get_or_add_submap(submap, node.trajectory_id)
                zbar = submap.local_pose.inverse().compose(node.local_pose)
                self.constraints.append(
                    Constraint(
                        submap_index=si,
                        node_index=node_index,
                        zbar=zbar,
                        translation_weight=self._options.matcher_translation_weight,
                        rotation_weight=self._options.matcher_rotation_weight,
                        tag="INTRA",
                    )
                )
                self.connectivity.connect(node.trajectory_id, self.submaps[si].trajectory_id, node.time)

            inserted_ids = {
                self.submaps[self._submap_ids[id(s)]].submap_id for s in insertion_submaps
            }
            finished_ids = [
                self.submaps[self._submap_ids[id(s)]].submap_id
                for s in newly_finished
                if id(s) in self._submap_ids
            ]
            node_id = node.node_id

        # Work items reference stable ids, never positional indices:
        # trimming can remap indices while items sit in the queue, and a
        # stale index would attach constraints to the wrong node/submap.
        if self._async:
            self._work_queue.put(("node", node_id, inserted_ids, finished_ids))
            return node_index
        self._compute_constraints_for_node(node_id, inserted_ids, finished_ids)
        return node_index

    def _compute_constraints_for_node(self, node_id, inserted_ids, finished_ids) -> None:
        """INTER searches + optimization cadence — the body of the
        reference's ComputeConstraintsForNode work item. All arguments are
        stable ids; entries trimmed while this item was queued resolve to
        None and are skipped.

        The reference fans one thread-pool task out per candidate pair
        (constraint_builder_3d.cc:162-189) and merges results at the
        WhenDone barrier (:150-160). Here the whole round's candidates are
        gated on the host (same order, so the FixedRatioSamplers pulse
        identically), then scored in ONE mesh-sharded matcher launch and
        ONE batched GN-refinement launch (_compute_constraints_batched);
        results merge afterwards — the same dispatch-gate/merge-at-barrier
        semantics, with device batching instead of a task DAG."""
        from hectorgrapher_tpu.common import profiling

        # Candidate pairs in the reference's dispatch order:
        # (a) this node vs all finished submaps,
        # (b) each newly finished submap vs all old nodes.
        pairs: List[Tuple[int, int]] = []
        with self._lock:
            pairs.extend(
                (node_id, s.submap_id)
                for s in self.submaps
                if s.finished and s.submap_id not in inserted_ids
            )
        for sid in finished_ids:
            # One pass over the constraint list (per-node scans are
            # O(nodes * constraints) and stall the front-end while holding
            # the lock).
            with self._lock:
                intra: Dict[int, set] = {}
                for c in self.constraints:
                    if c.tag == "INTRA":
                        nid = self.nodes[c.node_index].node_id
                        if nid < node_id:
                            intra.setdefault(nid, set()).add(
                                self.submaps[c.submap_index].submap_id
                            )
                old_node_ids = [n.node_id for n in self.nodes if n.node_id < node_id]
            pairs.extend(
                (nid, sid) for nid in old_node_ids if sid not in intra.get(nid, ())
            )

        with profiling.section("constraint_search"), self._constraint_lock:
            gated_local: List[tuple] = []
            gated_global: List[tuple] = []
            for nid, sid in pairs:
                gated = self._gate_candidate(nid, sid)
                if gated is None:
                    continue
                node, pg_submap, global_search = gated
                (gated_global if global_search else gated_local).append(
                    (nid, sid, node, pg_submap)
                )

            # Local-window searches AND full-submap (global localization)
            # searches each go through one sharded launch for the round —
            # global candidates share the full-window compiled config, so
            # a first localization against a large frozen map (when dozens
            # fire at once, ref: MatchFullSubmap + pose_graph_3d.cc:188-192)
            # is one batch, not a serial loop (VERDICT r3 #7).
            for gated, global_search in ((gated_local, False), (gated_global, True)):
                results = None
                if self._options.use_batched_constraint_search and len(gated) >= 2:
                    try:
                        results = self._compute_constraints_batched(
                            gated, global_search=global_search
                        )
                    except NotImplementedError:
                        results = None
                if results is not None:
                    _observe_batched_round(len(gated))
                    for (nid, sid, node, pg_submap), constraint in zip(gated, results):
                        if constraint is not None:
                            self._append_constraint(nid, sid, node, pg_submap, constraint)
                else:
                    for nid, sid, node, pg_submap in gated:
                        constraint = self._compute_constraint(
                            node, pg_submap, global_search=global_search
                        )
                        if constraint is not None:
                            self._append_constraint(nid, sid, node, pg_submap, constraint)

        with self._constraint_lock:
            self._num_nodes_since_last_optimization += 1
            run_opt = (
                self._num_nodes_since_last_optimization
                >= self._options.optimize_every_n_nodes
                > 0
            )
        if run_opt:
            self.run_final_optimization(self._options.optimization_problem.ceres_solver_options.max_num_iterations)

    def _compute_constraints_batched(self, gated: List[tuple], global_search: bool = False):
        """Score + refine every candidate of a round (local-window, or
        full-submap when global_search) in one batched launch. Returns a
        list of Optional[Constraint] aligned with gated, or raises
        NotImplementedError to fall back to the serial per-candidate path
        (e.g. mixed grid shapes)."""
        raise NotImplementedError

    # -- async work queue ----------------------------------------------------

    def _drain_work_queue(self) -> None:
        """(ref: pose_graph_3d.cc DrainWorkQueue:512-535.)"""
        while True:
            item = self._work_queue.get()
            try:
                if item is None:
                    return
                kind = item[0]
                if kind == "node":
                    _, node_id, inserted_ids, finished_ids = item
                    self._compute_constraints_for_node(node_id, inserted_ids, finished_ids)
                elif kind == "finish_submap":
                    with self._lock:
                        idx = self._submap_index_by_id.get(item[1])
                        pg_submap = self.submaps[idx] if idx is not None else None
                    if pg_submap is not None:
                        self._on_submap_finished(pg_submap)
            except Exception:  # noqa: BLE001 — a dead worker deadlocks join()
                import traceback

                traceback.print_exc()
            finally:
                self._work_queue.task_done()

    def wait_for_all_computations(self) -> None:
        """Block until the work queue is drained
        (ref: pose_graph WaitForAllComputations:537+)."""
        if self._async:
            self._work_queue.join()

    def _gate_candidate(self, node_id: int, submap_id: int):
        """Local-vs-global decision + distance/sampling gates
        (ref: pose_graph ComputeConstraint :248-311 — recently-connected
        trajectories search a local window; otherwise the global
        localization sampler gates a full-submap search). Arguments are
        stable ids. Returns (node, pg_submap, global_search) for candidates
        that pass the gates, None otherwise — gate decisions happen at
        dispatch time, exactly like the reference's MaybeAdd*Constraint;
        the matches themselves run (possibly batched) afterwards and merge
        at the barrier (constraint_builder_3d.cc:150-160)."""
        with self._lock:
            ni = self._node_index_by_id.get(node_id)
            si = self._submap_index_by_id.get(submap_id)
            if ni is None or si is None:
                return None  # trimmed while this work item was pending
            node = self.nodes[ni]
            pg_submap = self.submaps[si]
            last = self.connectivity.last_connection_time(node.trajectory_id, pg_submap.trajectory_id)
            recently_connected = (
                node.trajectory_id == pg_submap.trajectory_id
                or (
                    last is not None
                    and node.time - last < self._options.global_constraint_search_after_n_seconds
                )
                or not self._options.use_global_constraint_search
            )
            if recently_connected:
                d = np.linalg.norm(node.global_pose.t - pg_submap.global_pose.t)
                if d > self._options.constraint_builder.max_constraint_distance:
                    return None
                if not self._sampler.pulse():
                    return None
                return node, pg_submap, False
            if not self._global_sampler.pulse():
                return None
            return node, pg_submap, True

    def _scan_range_bucket(self, node) -> float:
        """Angular search step base: the node's ACTUAL max scan range, as
        the reference computes per scan (ref: correlative_scan_matcher_2d.cc
        SearchParameters ctor; fast_correlative_scan_matcher_2d.cc:
        GenerateRotatedScans uses the cloud's own extent) — a fixed
        construction-time bound oversamples the angular window by the
        ratio of bound to reality (6x at the default 30 m bound on ~5 m
        indoor scans, measured round 4: the coarse stage scored 631
        angles where 119 carry information). Bucketed to powers of
        sqrt(2) so the jitted matcher compiles O(log range) configs, not
        one per scan; capped by the construction-time bound."""
        cloud = node.cloud if node.cloud is not None else node.high_cloud
        # Keyed by the STABLE node id: id(cloud) would go stale when
        # CPython recycles a trimmed node's cloud address. Costs one cloud
        # download per node lifetime (~once per added node).
        key = node.node_id
        r = self._cloud_range_cache.get(key)
        if r is None:
            pos = np.asarray(cloud.positions)
            mask = np.asarray(cloud.mask)
            sq = np.sum(pos**2, axis=-1)
            rmax = float(np.sqrt(np.max(np.where(mask, sq, 0.0), initial=0.0)))
            bucket = 1.0
            while bucket < rmax and bucket < self._max_scan_range:
                bucket *= math.sqrt(2.0)
            r = min(bucket, self._max_scan_range)
            self._cloud_range_cache[key] = r
        return r

    def _append_constraint(self, node_id: int, submap_id: int, node, pg_submap, constraint) -> None:
        """Merge a found constraint into the graph (the per-constraint part
        of the reference's WhenDone barrier merge, pose_graph_3d.cc:436-510).
        Positional indices are resolved by stable id at append time — after
        any trim that ran while the matcher executed."""
        with self._lock:
            ni = self._node_index_by_id.get(node_id)
            si = self._submap_index_by_id.get(submap_id)
            if ni is None or si is None:
                return  # trimmed during the matcher launch — drop it
            constraint.node_index = ni
            constraint.submap_index = si
            self.constraints.append(constraint)
            self.connectivity.connect(node.trajectory_id, pg_submap.trajectory_id, node.time)

    def _maybe_add_constraint(self, node_id: int, submap_id: int) -> None:
        """Single-candidate path: gate, match on device, merge."""
        gated = self._gate_candidate(node_id, submap_id)
        if gated is None:
            return
        node, pg_submap, global_search = gated
        # The matcher launch runs without the lock (device work) on the
        # node/submap OBJECTS.
        constraint = self._compute_constraint(node, pg_submap, global_search=global_search)
        if constraint is not None:
            self._append_constraint(node_id, submap_id, node, pg_submap, constraint)

    def run_final_optimization(self, num_iterations: Optional[int] = None) -> None:
        """(ref: RunFinalOptimization — used both periodically and at end)"""
        # Drain in-flight constraint work first (ref: RunFinalOptimization
        # -> WaitForAllComputations): trimming remaps indices, which must
        # not race the lock-free matcher section of _maybe_add_constraint.
        # The periodic cadence calls this FROM the worker thread, where
        # joining the queue would wait on the worker's own current item.
        if threading.current_thread() is not self._worker:
            self.wait_for_all_computations()
        if num_iterations is None:
            num_iterations = self._options.max_num_final_iterations
        if not self.nodes or not self.submaps:
            return
        from hectorgrapher_tpu.common import profiling

        with self._opt_lock, profiling.section("pose_graph_optimization"):
            self._run_optimization(num_iterations)
            self.num_optimizations += 1
            self._num_nodes_since_last_optimization = 0
            if self._options.log_residual_histograms:
                self._log_residual_histograms()
            with self._lock:
                for trimmer in self.trimmers:
                    trimmer.trim(self)
        self._notify_global_optimization()

    def _log_residual_histograms(self) -> None:
        """Post-optimization constraint residual histograms, gated by
        log_residual_histograms (ref: pose_graph.lua:88; the reference's
        OptimizationProblem logs per-residual-family histograms under this
        flag — here they land in the metrics registry / the Prometheus
        endpoint instead of LOG(INFO))."""
        from hectorgrapher_tpu.common.profiling import global_factory

        if "trans" not in _RESIDUAL_HISTOGRAMS:
            f = global_factory()
            _RESIDUAL_HISTOGRAMS["trans"] = f.new_histogram_family(
                "hg_pose_graph_residual_translation_m",
                "post-optimization constraint translation residuals",
                boundaries=[0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0],
            )
            _RESIDUAL_HISTOGRAMS["rot"] = f.new_histogram_family(
                "hg_pose_graph_residual_rotation_deg",
                "post-optimization constraint rotation residuals",
                boundaries=[0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0],
            )
        with self._lock:
            snapshot = [
                (
                    c.tag,
                    self.submaps[c.submap_index].global_pose,
                    self.nodes[c.node_index].global_pose,
                    c.zbar,
                )
                for c in self.constraints
            ]
        for tag, submap_pose, node_pose, zbar in snapshot:
            actual = submap_pose.inverse().compose(node_pose)
            dt = float(np.linalg.norm(actual.t - zbar.t))
            dq = nq.quat_multiply(nq.quat_conjugate(zbar.q), actual.q)
            angle = 2.0 * math.degrees(math.acos(min(1.0, abs(float(dq[0])))))
            _RESIDUAL_HISTOGRAMS["trans"].add({"tag": tag}).observe(dt)
            _RESIDUAL_HISTOGRAMS["rot"].add({"tag": tag}).observe(angle)

    # -- shared SPA writeback helpers ---------------------------------------

    def _snapshot_lists(self):
        """Consistent snapshot of the optimization inputs (ref: the
        reference solves on data captured under the mutex while AddNode
        keeps appending, pose_graph_3d.cc HandleWorkQueue:436-510)."""
        with self._lock:
            return list(self.nodes), list(self.submaps), list(self.constraints)

    def _correct_post_snapshot(self, snap_nodes, snap_submaps) -> None:
        """Re-anchor nodes/submaps appended while the solve ran: their
        global pose was computed with the pre-optimization local-to-global;
        recompute it from the last *optimized* node of their trajectory
        (ref: HandleWorkQueue's extrapolation of new nodes). Caller holds
        _lock."""
        l2g: Dict[int, NpRigid3] = {}
        for node in reversed(snap_nodes):
            if node.trajectory_id not in l2g:
                l2g[node.trajectory_id] = node.global_pose.compose(node.local_pose.inverse())
        for node in self.nodes[len(snap_nodes):]:
            corr = l2g.get(node.trajectory_id)
            if corr is not None:
                node.global_pose = corr.compose(node.local_pose)
        for sub in self.submaps[len(snap_submaps):]:
            corr = l2g.get(sub.trajectory_id)
            if corr is not None:
                sub.global_pose = corr.compose(sub.submap.local_pose)

    @staticmethod
    def _pad_to(n: int) -> int:
        """Pad capacities to limit recompiles of the jitted SPA solve."""
        p = 8
        while p < n:
            p *= 2
        return p


def _pose2_of(p: NpRigid3) -> np.ndarray:
    return np.array([p.t[0], p.t[1], nq.quat_yaw(p.q)], np.float32)


def _rigid_of_pose2(v) -> NpRigid3:
    return NpRigid3(
        np.array([v[0], v[1], 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, float(v[2])]))
    )


class PoseGraph2D(PoseGraphBase):
    """(ref: mapping/internal/2d/pose_graph_2d.cc)"""

    def __init__(self, options, max_scan_range: float = 30.0):
        super().__init__(options)
        self._max_scan_range = max_scan_range
        # submap_id -> {depth: (PreparedFastMatcher2D, GN fields)}
        self._matcher_cache: Dict[int, dict] = {}
        # Device-resident packs of every finished submap's prepared
        # matcher, sharded over the constraint-search mesh, ONE PER
        # SEARCH DEPTH (local-window and full-submap global rounds use
        # different depths; a single slot would thrash on alternation);
        # rebuilt only when new submaps finish, NOT per round.
        self._packs2d: Dict[int, dict] = {}
        # HBM-budgeted membership bookkeeping (see _get_pack_2d/_3d).
        self._pack2d_round: int = 0
        self._pack2d_used: Dict[int, int] = {}
        self._odometry: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._fixed_frame: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._landmark_ids: Dict[str, int] = {}
        self._landmark_observations: List[dict] = []

    # -- auxiliary sensor ingestion (ref: pose_graph_2d.cc AddOdometryData/
    #    AddFixedFramePoseData/AddLandmarkData) ----------------------------

    def add_odometry_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._odometry.setdefault(trajectory_id, []).append((time, pose))

    def add_fixed_frame_pose_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._fixed_frame.setdefault(trajectory_id, []).append((time, pose))

    def add_landmark_data(self, trajectory_id, time, landmark_id, landmark_to_tracking,
                          translation_weight, rotation_weight) -> None:
        if landmark_id not in self._landmark_ids:
            self._landmark_ids[landmark_id] = len(self._landmark_ids)
        self._landmark_observations.append(
            dict(trajectory_id=trajectory_id, time=time,
                 landmark_index=self._landmark_ids[landmark_id],
                 transform=landmark_to_tracking,
                 translation_weight=translation_weight,
                 rotation_weight=rotation_weight)
        )

    def _lookup_buffer(self, buf, time: float) -> Optional[NpRigid3]:
        if not buf or time < buf[0][0] or time > buf[-1][0]:
            return None
        times = [t for t, _ in buf]
        j = int(np.searchsorted(times, time))
        if j == 0:
            return buf[0][1]
        if j >= len(buf):
            return buf[-1][1]
        t0, p0 = buf[j - 1]
        t1, p1 = buf[j]
        f = (time - t0) / max(t1 - t0, 1e-9)
        return NpRigid3(p0.t + f * (p1.t - p0.t), nq.quat_slerp(p0.q, p1.q, f))

    def _build_extras(self, N_cap: int, nodes=None):
        """Build SpaExtras2D from buffered sensors, or None if empty."""
        from hectorgrapher_tpu.mapping.pose_graph.optimization import empty_extras_2d

        nodes = self.nodes if nodes is None else nodes
        opt = self._options.optimization_problem
        nn = []
        by_traj: Dict[int, List[int]] = {}
        for i, n in enumerate(nodes):
            by_traj.setdefault(n.trajectory_id, []).append(i)
        for tid, idxs in by_traj.items():
            if self.is_frozen(tid):
                continue  # ref: frozen trajectories are skipped
            odom = self._odometry.get(tid, [])
            for a, b in zip(idxs[:-1], idxs[1:]):
                na, nb = nodes[a], nodes[b]
                # Odometry residual when available, PLUS the unconditional
                # local-SLAM relative-pose residual — both families, like
                # the reference (ref: optimization_problem_2d.cc:278-298).
                oa = self._lookup_buffer(odom, na.time)
                ob = self._lookup_buffer(odom, nb.time)
                if oa is not None and ob is not None:
                    rel = oa.inverse().compose(ob)
                    nn.append((a, b, _pose2_of(rel),
                               opt.odometry_translation_weight, opt.odometry_rotation_weight))
                rel_local = na.local_pose.inverse().compose(nb.local_pose)
                nn.append((a, b, _pose2_of(rel_local),
                           opt.local_slam_pose_translation_weight,
                           opt.local_slam_pose_rotation_weight))
        has_ff = any(self._fixed_frame.values())
        has_lm = bool(self._landmark_observations)
        if not nn and not has_ff and not has_lm:
            return None

        P = max(self._pad_to(max(len(nn), 1)), 1)
        L = max(len(self._landmark_ids), 1)
        O = max(self._pad_to(max(len(self._landmark_observations), 1)), 1)
        extras = empty_extras_2d(N_cap, p=P, l=L, o=O)
        if nn:
            nn_a = np.zeros(P, np.int32); nn_b = np.zeros(P, np.int32)
            nn_mask = np.zeros(P, bool); nn_rel = np.zeros((P, 3), np.float32)
            nn_wt = np.zeros(P, np.float32); nn_wr = np.zeros(P, np.float32)
            for i, (a, b, rel, wt, wr) in enumerate(nn):
                nn_a[i], nn_b[i], nn_mask[i] = a, b, True
                nn_rel[i] = rel
                nn_wt[i], nn_wr[i] = wt, wr
            extras = extras._replace(
                nn_a=jnp.asarray(nn_a), nn_b=jnp.asarray(nn_b), nn_mask=jnp.asarray(nn_mask),
                nn_rel_pose=jnp.asarray(nn_rel),
                nn_translation_weight=jnp.asarray(nn_wt), nn_rotation_weight=jnp.asarray(nn_wr),
            )
        if has_ff:
            ff_mask = np.zeros(N_cap, bool); ff_p = np.zeros((N_cap, 3), np.float32)
            ff_w = np.zeros(N_cap, np.float32)
            for i, n in enumerate(nodes):
                pose = self._lookup_buffer(self._fixed_frame.get(n.trajectory_id, []), n.time)
                if pose is not None:
                    ff_mask[i] = True
                    ff_p[i] = _pose2_of(pose)
                    ff_w[i] = opt.fixed_frame_pose_translation_weight
            extras = extras._replace(
                ff_mask=jnp.asarray(ff_mask), ff_pose=jnp.asarray(ff_p),
                ff_translation_weight=jnp.asarray(ff_w),
            )
        if has_lm:
            lm_node = np.zeros(O, np.int32); lm_index = np.zeros(O, np.int32)
            lm_mask = np.zeros(O, bool); lm_rel = np.zeros((O, 3), np.float32)
            lm_wt = np.zeros(O, np.float32); lm_wr = np.zeros(O, np.float32)
            # Observations bind to the nearest node OF THEIR TRAJECTORY
            # (ref: optimization_problem_2d.cc landmark node interpolation
            # is per trajectory); a global nearest-in-time would attach
            # another trajectory's motion to the landmark.
            by_traj: Dict[int, Tuple[list, list]] = {}
            for i, n in enumerate(nodes):
                by_traj.setdefault(n.trajectory_id, ([], []))[0].append(n.time)
                by_traj[n.trajectory_id][1].append(i)
            lm_init: Dict[int, np.ndarray] = {}
            for name, pose in self._landmark_pose_overrides.items():
                li = self._landmark_ids.get(name)
                if li is not None:
                    lm_init[li] = _pose2_of(pose)
            count = 0
            for obs in self._landmark_observations:
                if count >= O:
                    break
                times_t, idx_t = by_traj.get(obs["trajectory_id"], (None, None))
                if times_t is None:
                    continue
                j = int(np.searchsorted(times_t, obs["time"]))
                j = idx_t[min(max(j - 1, 0), len(idx_t) - 1)]
                lm_node[count] = j
                lm_index[count] = obs["landmark_index"]
                lm_mask[count] = True
                lm_rel[count] = _pose2_of(obs["transform"])
                lm_wt[count] = obs["translation_weight"]
                lm_wr[count] = obs["rotation_weight"]
                if obs["landmark_index"] not in lm_init:
                    lm_init[obs["landmark_index"]] = _pose2_of(
                        nodes[j].global_pose.compose(obs["transform"])
                    )
                count += 1
            L_p = np.zeros((L, 3), np.float32); L_m = np.zeros(L, bool)
            for li, pose in lm_init.items():
                L_p[li] = pose
                L_m[li] = True
            extras = extras._replace(
                landmark_pose=jnp.asarray(L_p), landmark_mask=jnp.asarray(L_m),
                lm_node=jnp.asarray(lm_node), lm_index=jnp.asarray(lm_index),
                lm_mask=jnp.asarray(lm_mask), lm_rel_pose=jnp.asarray(lm_rel),
                lm_translation_weight=jnp.asarray(lm_wt), lm_rotation_weight=jnp.asarray(lm_wr),
            )
        return extras

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        pass  # matcher built lazily on first constraint candidate

    def _submap_matcher(self, pg_submap: PgSubmap, depth: int):
        """Per-submap precomputation, built once per finished submap and
        reused across every candidate scored against it (ref:
        constraint_builder_2d.cc DispatchScanMatcherConstruction /
        SubmapScanMatcher). Keyed by the stable submap_id — positional
        indices are remapped by trimming. Constraints only target finished
        submaps, so the cached artifacts never go stale."""
        per_sid = self._matcher_cache.setdefault(pg_submap.submap_id, {})
        cached = per_sid.get(depth)
        if cached is not None:
            return cached
        grid = pg_submap.submap.grid
        fast = prepare_fast_matcher_2d(grid, depth)
        if isinstance(grid, TSDFGrid):
            gn = prepare_gn_tsdf_fields(grid)
        else:
            gn = prepare_gn_probability_field(grid)
        per_sid[depth] = (fast, gn)
        return fast, gn

    def _get_pack_2d(self, needed, depth: int, mesh):
        """Device-resident packs for the batched constraint round: the
        sharded fast-matcher pyramids AND the raw-grid GN pack. Rebuilt
        only when a needed submap is not packed yet (a submap finished
        since the last round), when a trim removed packed entries' caches,
        or when the mesh changed — finished grids are immutable, so
        between rebuilds every round reuses the same device arrays.

        `needed` maps sid -> PgSubmap for this round's candidates. Host
        copies of each submap's pyramid/grid are cached per sid, so an
        incremental rebuild downloads only the newly finished submaps —
        np.asarray on device arrays costs a full device round-trip each,
        which dominated production rounds before the cache."""
        from hectorgrapher_tpu.mapping.grids import ensure_f32_grid
        from hectorgrapher_tpu.mapping.probability_values import MIN_PROBABILITY
        from hectorgrapher_tpu.parallel.constraint_search import (
            pack_submaps_2d_from_arrays,
        )

        self._pack2d_round += 1
        for sid in needed:
            self._pack2d_used[sid] = self._pack2d_round
        state = self._packs2d.get(depth)
        if (
            state is not None
            and state["mesh"] is mesh
            and all(sid in state["slots"] for sid in needed)
        ):
            return state["slots"], state["packed"], state["gn"]
        prev_order = state["order"] if state is not None else []
        order = [sid for sid in prev_order if sid in self._matcher_cache]
        order += [sid for sid in needed if sid not in order]
        host = dict(state["host"]) if state is not None else {}
        keep = []
        for sid in order:
            cached = self._matcher_cache.get(sid, {}).get(depth)
            if cached is None:
                continue
            if sid not in host:
                fast = cached[0]
                if sid in needed:  # new sids normally come from this round
                    grid = needed[sid].submap.grid
                else:  # host cache invalidated (depth change): re-download
                    grid = self.submaps[self._submap_index_by_id[sid]].submap.grid
                g32 = ensure_f32_grid(grid)
                if isinstance(grid, TSDFGrid):
                    vals = np.asarray(g32.tsd, np.float32)
                    wts = np.asarray(g32.weight, np.float32)
                    pad_value = float(grid.truncation_distance)
                else:
                    vals = np.asarray(g32.probability(), np.float32)
                    wts = np.zeros_like(vals)
                    pad_value = float(MIN_PROBABILITY)
                host[sid] = {
                    "levels": np.asarray(fast.flat_levels),
                    "mc": np.asarray(fast.meta.min_corner, np.float32),
                    "vals": vals,
                    "wts": wts,
                    "pad": pad_value,
                }
            keep.append(sid)
        host = {sid: host[sid] for sid in keep}
        # HBM budget (per depth pack — see _get_pack_3d for the policy):
        # needed sids unconditional, others most-recently-used first.
        budget = _pack_budget_bytes(self._options)
        bytes_of = lambda h: int(
            h["levels"].nbytes + h["vals"].nbytes + h["wts"].nbytes
        )
        members = {sid for sid in keep if sid in needed}
        total = sum(bytes_of(host[sid]) for sid in members)
        for sid in sorted(
            (s for s in keep if s not in members),
            key=lambda s: -self._pack2d_used.get(s, 0),
        ):
            b = bytes_of(host[sid])
            if total + b > budget:
                break
            members.add(sid)
            total += b
        evicted = [sid for sid in keep if sid not in members]
        if evicted:
            self._shipped_pack2d -= {(sid, depth) for sid in evicted}
        keep = [sid for sid in keep if sid in members]
        host = {sid: host[sid] for sid in keep}
        _set_pack_bytes_gauge("2d", total)
        if len({h["levels"].shape for h in host.values()}) != 1:
            raise NotImplementedError("mixed pyramid shapes")
        res = None
        for sid in keep:
            g = self._matcher_cache[sid][depth][0]
            res = float(np.asarray(g.meta.resolution))
            nx, ny = (int(v) for v in np.asarray(g.dims))
            break
        packed = pack_submaps_2d_from_arrays(
            [(host[sid]["levels"], host[sid]["mc"]) for sid in keep],
            res,
            (nx, ny),
            mesh,
        )
        s_pad = packed.s_per_dev * mesh.devices.size
        import jax

        gshape = host[keep[0]]["vals"].shape
        vals_stack = np.zeros((s_pad,) + gshape, np.float32)
        wts_stack = np.zeros((s_pad,) + gshape, np.float32)
        mcs = np.zeros((s_pad, 2), np.float32)
        for i, sid in enumerate(keep):
            vals_stack[i] = host[sid]["vals"]
            wts_stack[i] = host[sid]["wts"]
            mcs[i] = host[sid]["mc"]
        gn = {
            "values": jax.device_put(vals_stack),
            "weights": jax.device_put(wts_stack),
            "min_corners": jax.device_put(mcs),
            "resolution": res,
            "pad_value": host[keep[0]]["pad"],
        }
        self._packs2d[depth] = {
            "order": keep,
            "slots": {sid: i for i, sid in enumerate(keep)},
            "mesh": mesh,
            "packed": packed,
            "gn": gn,
            "host": host,
            "res": res,
            "dims": (nx, ny),
        }
        return self._packs2d[depth]["slots"], packed, gn

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False) -> Optional[Constraint]:
        """(ref: constraint_builder_2d.cc ComputeConstraint — FCSM match
        gated by min_score (global_localization_min_score for full-submap
        searches), then Ceres refinement.) Indices on the returned
        Constraint are filled in by the caller under the lock."""
        submap = pg_submap.submap
        cb = self._options.constraint_builder

        # Initial pose of the node in the submap's grid frame via global
        # poses: the grid lives in the local SLAM frame the submap was
        # built in, where the submap origin is submap.local_pose.
        init = pg_submap.global_pose.inverse().compose(node.global_pose)
        node_in_grid = pg_submap.submap.local_pose.compose(init)
        initial = Rigid2(
            translation=jnp.asarray(node_in_grid.t[:2], jnp.float32),
            angle=jnp.asarray(nq.quat_yaw(node_in_grid.q), jnp.float32),
        )

        scan_range = self._scan_range_bucket(node)
        if global_search:
            # Full-submap search (ref: MatchFullSubmap): window sized to
            # the grid, full angular range.
            res = float(submap.grid.meta.resolution)
            config = make_fast_search_config(
                submap.grid.shape[0] * res / 2.0,
                math.pi,
                res,
                scan_range,
                cb.fast_correlative_scan_matcher.branch_and_bound_depth,
            )
            min_score = cb.global_localization_min_score
        else:
            config = make_fast_search_config(
                cb.fast_correlative_scan_matcher.linear_search_window,
                cb.fast_correlative_scan_matcher.angular_search_window,
                float(submap.grid.meta.resolution),
                scan_range,
                cb.fast_correlative_scan_matcher.branch_and_bound_depth,
            )
            min_score = cb.min_score
        fast, gn_prepared = self._submap_matcher(pg_submap, config.depth)
        score, pose = match_fast_2d_prepared(fast, node.cloud, initial, config)
        _observe_constraint_score("global" if global_search else "local", float(score))
        if float(score) < min_score:
            return None

        cm = cb.ceres_scan_matcher
        is_tsdf = isinstance(submap.grid, TSDFGrid)
        refine = _match_gn_2d_tsdf_fields if is_tsdf else _match_gn_2d_probability_field
        refined, _ = refine(
            gn_prepared,
            node.cloud,
            pose,
            pose.translation,
            cm.occupied_space_weight,
            cm.translation_weight,
            cm.rotation_weight,
            num_iterations=cm.ceres_solver_options.max_num_iterations,
        )
        # zbar: submap-frame pose of the node = grid-frame pose relative to
        # submap.local_pose.
        refined_np = _rigid_of_pose2(np.asarray(jnp.concatenate([refined.translation, refined.angle[None]])))
        zbar = pg_submap.submap.local_pose.inverse().compose(refined_np)
        return Constraint(
            submap_index=-1,  # resolved by _maybe_add_constraint under the lock
            node_index=-1,
            zbar=zbar,
            translation_weight=cb.loop_closure_translation_weight,
            rotation_weight=cb.loop_closure_rotation_weight,
            tag="INTER",
        )

    def _cs_broadcast_2d(self, config, mesh):
        """Multi-host hook for a batched 2D round: ship the pack delta
        (newly finished submaps' pyramids — once each; finished grids are
        immutable) and return a callable that ships the round's candidate
        arrays, so followers enter the same collective launch
        (cloud/solver_plane.py; fixes the round-3 multi-host deadlock)."""
        bc = self._solver_broadcast
        if bc is None or mesh is not self._solver_mesh:
            return None
        depth = config.depth
        state = self._packs2d[depth]
        new = {
            sid: {"levels": state["host"][sid]["levels"], "mc": state["host"][sid]["mc"]}
            for sid in state["order"]
            if (sid, depth) not in self._shipped_pack2d
        }
        if new or self._shipped_order2d.get(depth) != state["order"]:
            bc(
                "cs2d_pack",
                {
                    "depth": depth,
                    "order": list(state["order"]),
                    "new": new,
                    "res": state["res"],
                    "dims": tuple(state["dims"]),
                },
                wait=True,  # pack state must exist before any round op
            )
            for sid in new:
                self._shipped_pack2d.add((sid, depth))
            self._shipped_order2d[depth] = list(state["order"])
        return lambda arrays: bc(
            "cs2d", {"depth": depth, "arrays": arrays, "config": tuple(config)}
        )

    def _compute_constraints_batched(self, gated, global_search: bool = False):
        """All candidates of a constraint round (local-window, or
        full-submap when global_search) in ONE sharded fast-matcher launch
        + ONE batched GN-refinement launch.

        The replacement for the reference's per-candidate
        thread-pool fan-out (ref: constraint_builder_2d.cc
        MaybeAddConstraint/ComputeConstraint, tasks dispatched at :112-160):
        submaps are partitioned over the mesh's 'graph' axis, candidates
        routed to their submap's owner, every gate/refinement identical to
        the serial _compute_constraint."""
        from hectorgrapher_tpu.mapping.scan_matching.gn_2d import (
            match_gn_2d_packed_grids,
        )
        from hectorgrapher_tpu.parallel.constraint_search import (
            sharded_fast_matches_2d_packed,
        )

        cb = self._options.constraint_builder
        # Stacking requires uniform shapes (production grids are
        # fixed-extent per config; anything else -> serial fallback).
        # Per-sid info cache: meta.resolution is a DEVICE scalar, so the
        # uncached set comprehension cost one device readback per
        # candidate per round.
        info = getattr(self, "_grid_info", None)
        if info is None:
            info = self._grid_info = {}
        for _, sid, _, p in gated:
            if sid not in info:
                g = p.submap.grid
                info[sid] = (
                    float(np.asarray(g.meta.resolution)),
                    isinstance(g, TSDFGrid),
                )
        resolutions = {info[sid][0] for _, sid, _, _ in gated}
        npts = {n.cloud.mask.shape[0] for _, _, n, _ in gated}
        kinds = {info[sid][1] for _, sid, _, _ in gated}
        shapes = {p.submap.grid.shape[0] for _, _, _, p in gated}
        if len(resolutions) != 1 or len(npts) != 1 or len(kinds) != 1 or len(shapes) != 1:
            raise NotImplementedError("mixed candidate shapes")
        is_tsdf = kinds.pop()
        res = resolutions.pop()
        # The round's angular step comes from its nodes' actual scan
        # ranges (max bucket across the round; see _scan_range_bucket).
        scan_range = max(self._scan_range_bucket(n) for _, _, n, _ in gated)
        if global_search:
            # Full-submap search (ref: MatchFullSubmap): window sized to
            # the grid, full angular range — same construction as the
            # serial _compute_constraint's global branch.
            config = make_fast_search_config(
                shapes.pop() * res / 2.0,
                math.pi,
                res,
                scan_range,
                cb.fast_correlative_scan_matcher.branch_and_bound_depth,
            )
            min_score = cb.global_localization_min_score
        else:
            config = make_fast_search_config(
                cb.fast_correlative_scan_matcher.linear_search_window,
                cb.fast_correlative_scan_matcher.angular_search_window,
                res,
                scan_range,
                cb.fast_correlative_scan_matcher.branch_and_bound_depth,
            )
            min_score = cb.min_score
        # Per-submap matcher artifacts come from the persistent cache
        # (built once per finished submap, ref:
        # DispatchScanMatcherConstruction); the device-resident packs of
        # all finished submaps are reused across rounds.
        import time as time_mod

        prof = {} if ROUND_PROFILING else None
        t0 = time_mod.perf_counter()
        needed: Dict[int, PgSubmap] = {}
        for _, sid, _, p in gated:
            if sid not in needed:
                self._submap_matcher(p, config.depth)
                needed[sid] = p
        mesh = constraint_search_mesh()
        slot_by_sid, packed, gn_pack = self._get_pack_2d(needed, config.depth, mesh)
        broadcast = self._cs_broadcast_2d(config, mesh)
        if prof is not None:
            prof["pack"] = time_mod.perf_counter() - t0
            t0 = time_mod.perf_counter()

        # Initials stay HOST-side numpy: a per-candidate jnp.asarray costs
        # a device dispatch each; the packer uploads one stacked batch.
        candidates = []
        for _, sid, node, p in gated:
            init = p.global_pose.inverse().compose(node.global_pose)
            node_in_grid = p.submap.local_pose.compose(init)
            initial = Rigid2(
                translation=node_in_grid.t[:2].astype(np.float32),
                angle=np.float32(nq.quat_yaw(node_in_grid.q)),
            )
            candidates.append((slot_by_sid[sid], node.cloud, initial))
        if prof is not None:
            prof["initials"] = time_mod.perf_counter() - t0
        matches = sharded_fast_matches_2d_packed(
            packed, candidates, config, mesh, broadcast=broadcast, profile=prof
        )

        survivors = []
        for i, (score, pose) in enumerate(matches):
            _observe_constraint_score("global" if global_search else "local", float(score))
            if float(score) >= min_score:
                survivors.append((i, pose))
        results: List[Optional[Constraint]] = [None] * len(gated)
        if not survivors:
            return results

        # ONE batched GN launch against the raw-grid pack: slots + poses
        # upload as single numpy arrays; clouds broadcast device-side when
        # the round is one node against many submaps (the common case).
        pad = _pow2(len(survivors))
        slot_ids = np.zeros(pad, np.int32)
        pose_t = np.zeros((pad, 2), np.float32)
        pose_a = np.zeros(pad, np.float32)
        for k, (i, pose) in enumerate(survivors):
            slot_ids[k] = slot_by_sid[gated[i][1]]
            pose_t[k] = np.asarray(pose.translation)
            pose_a[k] = np.asarray(pose.angle)
        for k in range(len(survivors), pad):  # pad lanes repeat lane 0
            slot_ids[k] = slot_ids[0]
            pose_t[k] = pose_t[0]
            pose_a[k] = pose_a[0]
        surv_clouds = [gated[i][2].cloud for i, _ in survivors]
        if len({id(c) for c in surv_clouds}) == 1:
            import jax

            clouds = jax.tree.map(
                lambda x: jnp.broadcast_to(x[None], (pad,) + x.shape),
                surv_clouds[0],
            )
        else:
            clouds = _stack_trees(surv_clouds, pad)
        poses = Rigid2(translation=pose_t, angle=pose_a)
        t_gn = time_mod.perf_counter() if prof is not None else 0.0
        cm = cb.ceres_scan_matcher
        refined, _ = match_gn_2d_packed_grids(
            gn_pack["values"],
            gn_pack["weights"],
            gn_pack["min_corners"],
            np.float32(gn_pack["resolution"]),
            np.float32(gn_pack["pad_value"]),
            slot_ids,
            clouds,
            poses,
            poses.translation,
            cm.occupied_space_weight,
            cm.translation_weight,
            cm.rotation_weight,
            is_tsdf=is_tsdf,
            num_iterations=cm.ceres_solver_options.max_num_iterations,
        )
        if prof is not None:
            import jax as jax_mod

            jax_mod.device_get(refined.translation.ravel()[:1])
            prof["gn_launch"] = time_mod.perf_counter() - t_gn
            t0 = time_mod.perf_counter()
        rt = np.asarray(refined.translation)
        ra = np.asarray(refined.angle)
        if prof is not None:
            prof["gn_readback"] = time_mod.perf_counter() - t0
            LAST_ROUND_BREAKDOWN.clear()
            LAST_ROUND_BREAKDOWN.update(prof)
        for k, (i, _) in enumerate(survivors):
            _, sid, node, p = gated[i]
            refined_np = _rigid_of_pose2(np.array([rt[k, 0], rt[k, 1], ra[k]]))
            zbar = p.submap.local_pose.inverse().compose(refined_np)
            results[i] = Constraint(
                submap_index=-1,  # resolved by _append_constraint under the lock
                node_index=-1,
                zbar=zbar,
                translation_weight=cb.loop_closure_translation_weight,
                rotation_weight=cb.loop_closure_rotation_weight,
                tag="INTER",
            )
        return results

    def _run_optimization(self, num_iterations: int) -> None:
        """(ref: optimization_problem_2d.cc Solve)"""
        nodes, submaps, constraints = self._snapshot_lists()
        S = self._pad_to(len(submaps))
        N = self._pad_to(len(nodes))
        C = self._pad_to(max(len(constraints), 1))

        submap_pose = np.zeros((S, 3), np.float32)
        node_pose = np.zeros((N, 3), np.float32)
        submap_fixed = np.ones(S, bool)
        node_fixed = np.ones(N, bool)
        for i, s in enumerate(submaps):
            submap_pose[i] = _pose2_of(s.global_pose)
            submap_fixed[i] = i == 0 or self.is_frozen(s.trajectory_id)
        for i, n in enumerate(nodes):
            node_pose[i] = _pose2_of(n.global_pose)
            node_fixed[i] = self.is_frozen(n.trajectory_id)

        cs = np.zeros(C, np.int32)
        cn = np.zeros(C, np.int32)
        cm = np.zeros(C, bool)
        crel = np.zeros((C, 3), np.float32)
        cwt = np.zeros(C, np.float32)
        cwr = np.zeros(C, np.float32)
        chub = np.full(C, 1e6, np.float32)
        huber = self._options.optimization_problem.huber_scale
        for i, c in enumerate(constraints):
            cs[i] = c.submap_index
            cn[i] = c.node_index
            cm[i] = True
            crel[i] = _pose2_of(c.zbar)
            cwt[i] = c.translation_weight
            cwr[i] = c.rotation_weight
            if c.tag == "INTER":
                chub[i] = huber

        problem = SpaProblem2D(
            submap_pose=jnp.asarray(submap_pose),
            node_pose=jnp.asarray(node_pose),
            submap_fixed=jnp.asarray(submap_fixed),
            node_fixed=jnp.asarray(node_fixed),
            c_submap=jnp.asarray(cs),
            c_node=jnp.asarray(cn),
            c_mask=jnp.asarray(cm),
            c_rel_pose=jnp.asarray(crel),
            c_translation_weight=jnp.asarray(cwt),
            c_rotation_weight=jnp.asarray(cwr),
            c_huber_scale=jnp.asarray(chub),
        )
        extras = self._build_extras(N, nodes)
        if extras is not None:
            from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_2d_full

            sub_out, node_out, lm_out, _ = solve_spa_2d_full(
                problem, extras, num_iterations=min(num_iterations, 50)
            )
            self._landmark_poses = {
                name: _rigid_of_pose2(np.asarray(lm_out)[idx])
                for name, idx in self._landmark_ids.items()
            }
            self._consume_landmark_overrides(set(self._landmark_ids.values()))
        elif self._solver_mesh is not None:
            # Multi-host / multi-chip SPA: constraints sharded over the
            # mesh axis, normal equations psum-reduced (SURVEY §2.12 #3).
            # The extras-augmented solve stays single-device for now — the
            # extras families are O(nodes), the constraint assembly this
            # shards is the O(C) term.
            import jax

            from hectorgrapher_tpu.parallel.sharded import solve_spa_2d_sharded

            iters = min(num_iterations, 50)
            # numpy pytrees: identical host-local numpy inputs act as
            # replicated global values on a multi-process mesh (see
            # cloud/solver_plane.py).
            problem_np = jax.tree.map(np.asarray, problem)
            if self._solver_broadcast is not None:
                self._solver_broadcast("spa2d", (problem_np, iters))
            sub_out, node_out, _ = solve_spa_2d_sharded(
                problem_np, self._solver_mesh, num_iterations=iters
            )
        else:
            sub_out, node_out, _ = solve_spa_2d(problem, num_iterations=min(num_iterations, 50))
        sub_out = np.asarray(sub_out)
        node_out = np.asarray(node_out)
        with self._lock:
            for i, s in enumerate(submaps):
                s.global_pose = _rigid_of_pose2(sub_out[i])
            for i, n in enumerate(nodes):
                n.global_pose = _rigid_of_pose2(node_out[i])
            self._correct_post_snapshot(nodes, submaps)


class PoseGraph3D(PoseGraphBase):
    """(ref: mapping/internal/3d/pose_graph_3d.cc)"""

    def __init__(self, options, histogram_size: int = 120, max_scan_range: float = 20.0):
        super().__init__(options)
        self._histogram_size = histogram_size
        self._max_scan_range = max_scan_range
        # Device-resident pack of finished-submap matcher state for the
        # batched constraint search (see PoseGraph2D._pack2d).
        self._pack3d: Optional[dict] = None
        # HBM-budgeted membership bookkeeping (see _get_pack_3d): round
        # counter + per-sid last-candidate round for MRU retention.
        self._pack3d_round: int = 0
        self._pack3d_used: Dict[int, int] = {}
        # Auxiliary sensor buffers for the optimization problem
        # (ref: optimization_problem_3d.h odometry_data_/fixed_frame_pose_
        # data_/landmark_nodes_; MapByTime per trajectory).
        self._odometry: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._fixed_frame: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._landmark_ids: Dict[str, int] = {}
        self._landmark_observations: List[dict] = []
        self._imu: Dict[int, List[Tuple[float, np.ndarray, np.ndarray]]] = {}

    # -- auxiliary sensor ingestion (ref: pose_graph_3d.cc AddOdometryData/
    #    AddImuData/AddFixedFramePoseData/AddLandmarkData) ------------------

    def add_odometry_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._odometry.setdefault(trajectory_id, []).append((time, pose))

    def add_imu_data(self, trajectory_id: int, time: float, linear_acceleration, angular_velocity) -> None:
        self._imu.setdefault(trajectory_id, []).append(
            (time, np.asarray(linear_acceleration, float), np.asarray(angular_velocity, float))
        )

    def add_fixed_frame_pose_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._fixed_frame.setdefault(trajectory_id, []).append((time, pose))

    def add_landmark_data(
        self,
        trajectory_id: int,
        time: float,
        landmark_id: str,
        landmark_to_tracking: NpRigid3,
        translation_weight: float,
        rotation_weight: float,
    ) -> None:
        if landmark_id not in self._landmark_ids:
            self._landmark_ids[landmark_id] = len(self._landmark_ids)
        self._landmark_observations.append(
            dict(
                trajectory_id=trajectory_id,
                time=time,
                landmark_index=self._landmark_ids[landmark_id],
                transform=landmark_to_tracking,
                translation_weight=translation_weight,
                rotation_weight=rotation_weight,
            )
        )

    def _lookup_buffer(self, buf: List[Tuple[float, NpRigid3]], time: float) -> Optional[NpRigid3]:
        if not buf or time < buf[0][0] or time > buf[-1][0]:
            return None
        times = [t for t, _ in buf]
        j = int(np.searchsorted(times, time))
        if j == 0:
            return buf[0][1]
        if j >= len(buf):
            return buf[-1][1]
        t0, p0 = buf[j - 1]
        t1, p1 = buf[j]
        f = (time - t0) / max(t1 - t0, 1e-9)
        return NpRigid3(p0.t + f * (p1.t - p0.t), nq.quat_slerp(p0.q, p1.q, f))

    def _build_extras(self, N_cap: int, nodes=None):
        """Build SpaExtras3D from buffered sensors, or None if empty."""
        from hectorgrapher_tpu.mapping.pose_graph.optimization import empty_extras_3d

        import jax.numpy as jnp2

        nodes = self.nodes if nodes is None else nodes

        opt = self._options.optimization_problem
        nn = []
        # Odometry / consecutive-node residuals between successive nodes of
        # each trajectory (ref: optimization_problem_3d.cc :450-503).
        by_traj: Dict[int, List[int]] = {}
        for i, n in enumerate(nodes):
            by_traj.setdefault(n.trajectory_id, []).append(i)
        # The reference adds odometry + consecutive-local-pose residuals in
        # 3D only under fix_z_in_3d (ref: optimization_problem_3d.cc:450-503
        # "if (options_.fix_z_in_3d())"); without it, inter-node stiffness
        # comes from the IMU residual families below. Both families are
        # ADDED (odometry does not substitute for the local-SLAM residual).
        if opt.fix_z_in_3d:
            for tid, idxs in by_traj.items():
                if self.is_frozen(tid):
                    continue  # ref: frozen trajectories are skipped
                odom = self._odometry.get(tid, [])
                for a, b in zip(idxs[:-1], idxs[1:]):
                    na, nb = nodes[a], nodes[b]
                    oa = self._lookup_buffer(odom, na.time)
                    ob = self._lookup_buffer(odom, nb.time)
                    if oa is not None and ob is not None:
                        rel = oa.inverse().compose(ob)
                        nn.append(
                            (a, b, rel, opt.odometry_translation_weight, opt.odometry_rotation_weight)
                        )
                    rel_local = na.local_pose.inverse().compose(nb.local_pose)
                    nn.append(
                        (
                            a,
                            b,
                            rel_local,
                            opt.local_slam_pose_translation_weight,
                            opt.local_slam_pose_rotation_weight,
                        )
                    )

        # IMU rotation + acceleration residuals between consecutive nodes
        # (ref: optimization_problem_3d.cc :353-447).
        ir = []
        ia = []
        use_imu = (
            not opt.fix_z_in_3d
            and (opt.rotation_weight > 0 or opt.acceleration_weight > 0)
        )
        traj_slots: Dict[int, int] = {}
        if use_imu:
            from hectorgrapher_tpu.mapping.ct import imu_integration

            for tid, idxs in by_traj.items():
                imu = self._imu.get(tid, [])
                if len(imu) < 2:
                    continue
                if tid not in traj_slots:
                    traj_slots[tid] = len(traj_slots)
                slot = traj_slots[tid]
                imu_t = np.asarray([x[0] for x in imu])
                imu_a = np.asarray([x[1] for x in imu])
                imu_g = np.asarray([x[2] for x in imu])
                for j in range(len(idxs) - 1):
                    a, b = idxs[j], idxs[j + 1]
                    ta, tb = nodes[a].time, nodes[b].time
                    if tb <= ta:
                        continue
                    dq, _, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, ta, tb)
                    ir.append((a, b, slot, dq, opt.rotation_weight))
                    if opt.acceleration_weight > 0 and j + 2 < len(idxs):
                        c = idxs[j + 2]
                        tc = nodes[c].time
                        if tc <= tb:
                            continue
                        dt1 = tb - ta
                        dt2 = tc - tb
                        c1 = ta + dt1 / 2
                        c2 = tb + dt2 / 2
                        dq_full, _, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, ta, tb)
                        dq_c1, _, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, ta, c1)
                        _, dv_cc, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, c1, c2)
                        # delta velocity in the IMU frame at the second node
                        # (ref: :420-428)
                        rel = nq.quat_multiply(nq.quat_conjugate(dq_full), dq_c1)
                        dv = nq.quat_rotate(rel, dv_cc)
                        ia.append((a, b, c, slot, dv, dt1, dt2, opt.acceleration_weight))

        has_ff = any(self._fixed_frame.values())
        has_lm = bool(self._landmark_observations)
        if not nn and not has_ff and not has_lm and not ir and not ia:
            return None

        P = max(self._pad_to(max(len(nn), 1)), 1)
        L = max(len(self._landmark_ids), 1)
        O = max(self._pad_to(max(len(self._landmark_observations), 1)), 1)
        R = max(self._pad_to(max(len(ir), 1)), 1)
        A = max(self._pad_to(max(len(ia), 1)), 1)
        Tj = max(len(traj_slots), 1)
        extras = empty_extras_3d(N_cap, p=P, l=L, o=O, r=R, a=A, tj=Tj)
        if ir:
            ir_a = np.zeros(R, np.int32); ir_b = np.zeros(R, np.int32)
            ir_tj = np.zeros(R, np.int32); ir_mask = np.zeros(R, bool)
            ir_dq = np.tile(np.array([1, 0, 0, 0], np.float32), (R, 1))
            ir_w = np.zeros(R, np.float32)
            for i, (a, b, slot, dq, w) in enumerate(ir):
                ir_a[i], ir_b[i], ir_tj[i], ir_mask[i] = a, b, slot, True
                ir_dq[i] = dq
                ir_w[i] = w
            extras = extras._replace(
                ir_a=jnp.asarray(ir_a), ir_b=jnp.asarray(ir_b),
                ir_traj=jnp.asarray(ir_tj), ir_mask=jnp.asarray(ir_mask),
                ir_delta_rotation=jnp.asarray(ir_dq), ir_weight=jnp.asarray(ir_w),
            )
        if ia:
            ia_a = np.zeros(A, np.int32); ia_b = np.zeros(A, np.int32)
            ia_c = np.zeros(A, np.int32); ia_tj = np.zeros(A, np.int32)
            ia_mask = np.zeros(A, bool)
            ia_dv = np.zeros((A, 3), np.float32)
            ia_dt1 = np.ones(A, np.float32); ia_dt2 = np.ones(A, np.float32)
            ia_w = np.zeros(A, np.float32)
            for i, (a, b, c, slot, dv, dt1, dt2, w) in enumerate(ia):
                ia_a[i], ia_b[i], ia_c[i], ia_tj[i], ia_mask[i] = a, b, c, slot, True
                ia_dv[i] = dv
                ia_dt1[i], ia_dt2[i] = dt1, dt2
                ia_w[i] = w
            extras = extras._replace(
                ia_a=jnp.asarray(ia_a), ia_b=jnp.asarray(ia_b), ia_c=jnp.asarray(ia_c),
                ia_traj=jnp.asarray(ia_tj), ia_mask=jnp.asarray(ia_mask),
                ia_delta_velocity=jnp.asarray(ia_dv),
                ia_dt1=jnp.asarray(ia_dt1), ia_dt2=jnp.asarray(ia_dt2),
                ia_weight=jnp.asarray(ia_w),
            )
        if traj_slots:
            extras = extras._replace(
                traj_mask=jnp.asarray(
                    [True] * len(traj_slots) + [False] * (Tj - len(traj_slots))
                ),
                calibration_fixed=jnp.asarray(not opt.use_online_imu_extrinsics_in_3d),
            )

        if nn:
            nn_a = np.zeros(P, np.int32)
            nn_b = np.zeros(P, np.int32)
            nn_mask = np.zeros(P, bool)
            nn_rt = np.zeros((P, 3), np.float32)
            nn_rq = np.tile(np.array([1, 0, 0, 0], np.float32), (P, 1))
            nn_wt = np.zeros(P, np.float32)
            nn_wr = np.zeros(P, np.float32)
            for i, (a, b, rel, wt, wr) in enumerate(nn):
                nn_a[i], nn_b[i], nn_mask[i] = a, b, True
                nn_rt[i], nn_rq[i] = rel.t, rel.q
                nn_wt[i] = wt
                nn_wr[i] = wr
            extras = extras._replace(
                nn_a=jnp2.asarray(nn_a),
                nn_b=jnp2.asarray(nn_b),
                nn_mask=jnp2.asarray(nn_mask),
                nn_rel_translation=jnp2.asarray(nn_rt),
                nn_rel_rotation=jnp2.asarray(nn_rq),
                nn_translation_weight=jnp2.asarray(nn_wt),
                nn_rotation_weight=jnp2.asarray(nn_wr),
            )

        if has_ff:
            ff_mask = np.zeros(N_cap, bool)
            ff_t = np.zeros((N_cap, 3), np.float32)
            ff_w = np.zeros(N_cap, np.float32)
            for i, n in enumerate(nodes):
                pose = self._lookup_buffer(self._fixed_frame.get(n.trajectory_id, []), n.time)
                if pose is not None:
                    ff_mask[i] = True
                    ff_t[i] = pose.t
                    ff_w[i] = opt.fixed_frame_pose_translation_weight
            extras = extras._replace(
                ff_mask=jnp2.asarray(ff_mask),
                ff_translation=jnp2.asarray(ff_t),
                ff_translation_weight=jnp2.asarray(ff_w),
            )

        if has_lm:
            lm_node = np.zeros(O, np.int32)
            lm_index = np.zeros(O, np.int32)
            lm_mask = np.zeros(O, bool)
            lm_rt = np.zeros((O, 3), np.float32)
            lm_rq = np.tile(np.array([1, 0, 0, 0], np.float32), (O, 1))
            lm_wt = np.zeros(O, np.float32)
            lm_wr = np.zeros(O, np.float32)
            # Per-trajectory node binding + override seeding (see the 2D
            # variant; ref: optimization_problem_3d.cc landmark nodes are
            # interpolated within the observation's own trajectory).
            by_traj: Dict[int, Tuple[list, list]] = {}
            for i, n in enumerate(nodes):
                by_traj.setdefault(n.trajectory_id, ([], []))[0].append(n.time)
                by_traj[n.trajectory_id][1].append(i)
            count = 0
            lm_init: Dict[int, NpRigid3] = {}
            for name, pose in self._landmark_pose_overrides.items():
                li = self._landmark_ids.get(name)
                if li is not None:
                    lm_init[li] = pose
            for obs in self._landmark_observations:
                times_t, idx_t = by_traj.get(obs["trajectory_id"], (None, None))
                if times_t is None:
                    continue
                j = int(np.searchsorted(times_t, obs["time"]))
                j = idx_t[min(max(j - 1, 0), len(idx_t) - 1)]
                if count >= O:
                    break
                lm_node[count] = j
                lm_index[count] = obs["landmark_index"]
                lm_mask[count] = True
                lm_rt[count] = obs["transform"].t
                lm_rq[count] = obs["transform"].q
                lm_wt[count] = obs["translation_weight"]
                lm_wr[count] = obs["rotation_weight"]
                if obs["landmark_index"] not in lm_init:
                    lm_init[obs["landmark_index"]] = nodes[j].global_pose.compose(obs["transform"])
                count += 1
            lm_t = np.zeros((L, 3), np.float32)
            lm_q = np.tile(np.array([1, 0, 0, 0], np.float32), (L, 1))
            lm_valid = np.zeros(L, bool)
            for li, pose in lm_init.items():
                lm_t[li] = pose.t
                lm_q[li] = pose.q
                lm_valid[li] = True
            extras = extras._replace(
                landmark_translation=jnp2.asarray(lm_t),
                landmark_rotation=jnp2.asarray(lm_q),
                landmark_mask=jnp2.asarray(lm_valid),
                lm_node=jnp2.asarray(lm_node),
                lm_index=jnp2.asarray(lm_index),
                lm_mask=jnp2.asarray(lm_mask),
                lm_rel_translation=jnp2.asarray(lm_rt),
                lm_rel_rotation=jnp2.asarray(lm_rq),
                lm_translation_weight=jnp2.asarray(lm_wt),
                lm_rotation_weight=jnp2.asarray(lm_wr),
            )
        return extras

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        """Build the per-submap loop-closure matcher lazily (ref:
        constraint_builder_3d.cc DispatchScanMatcherConstruction:162-189)."""
        pg_submap.matcher = FastCorrelativeScanMatcher3D(
            self._options.constraint_builder.fast_correlative_scan_matcher_3d,
            pg_submap.submap.high_resolution_grid,
            pg_submap.submap.low_resolution_grid,
            pg_submap.submap.rotational_histogram,
            self._histogram_size,
        )

    def _get_pack_3d(self, needed_matchers: Dict[int, object], mesh):
        """Device-resident pack of 3D matcher state for the batched
        constraint search, rebuilt only when a needed submap is not
        packed, a trim removed packed submaps, or the mesh changed (see
        _get_pack_2d — the 3D pyramids are far larger, so per-round
        re-upload would dominate the round). Host copies of each matcher's
        pack arrays are cached per sid so an incremental rebuild uploads
        only newly admitted submaps (and so the multi-host broadcast can
        ship each submap's arrays exactly once); once downloaded, the
        matcher's own device copies demote to host (matcher.to_host()) so
        the pack is the SOLE device residence of finished-submap search
        state.

        HBM budget (options.constraint_builder.pack_hbm_budget_bytes):
        this round's candidate submaps are always resident — they are
        already distance-gated by max_constraint_distance upstream — and
        the remaining finished submaps stay packed most-recently-used
        first until the budget is hit; evicted submaps are dropped from
        the device pack (and the follower ship-set) and re-admitted from
        the host cache on demand. A pack-bytes gauge reports residency
        (ref: the reference's HybridGrid submaps live in robot RAM,
        submap_3d.cc:505-507; our analog must fit one device's memory at
        the 256^3/128^3 production extents)."""
        from hectorgrapher_tpu.parallel.constraint_search import (
            host_arrays_3d_nbytes,
            matcher_host_arrays_3d,
            pack_submaps_3d_from_arrays,
        )

        self._pack3d_round += 1
        for sid in needed_matchers:
            self._pack3d_used[sid] = self._pack3d_round

        state = self._pack3d
        if (
            state is not None
            and state["mesh"] is mesh
            and all(sid in state["slots"] for sid in needed_matchers)
        ):
            return state["slots"], state["packed"]
        with self._lock:
            live = {
                s.submap_id: s.matcher for s in self.submaps if s.matcher is not None
            }
        live.update(needed_matchers)
        host = dict(state["host"]) if state is not None else {}
        for sid in live:
            if sid not in host:
                host[sid] = matcher_host_arrays_3d(live[sid])
                demote = getattr(live[sid], "to_host", None)
                if demote is not None:
                    demote()
        host = {sid: h for sid, h in host.items() if sid in live}
        # Membership: needed first (unconditional), then other finished
        # submaps most-recently-used first while under budget.
        budget = _pack_budget_bytes(self._options)
        per_bytes = {sid: host_arrays_3d_nbytes(h) for sid, h in host.items()}
        members = set(needed_matchers)
        total = sum(per_bytes[sid] for sid in members)
        for sid in sorted(
            (s for s in live if s not in members),
            key=lambda s: -self._pack3d_used.get(s, 0),
        ):
            if total + per_bytes[sid] > budget:
                break
            members.add(sid)
            total += per_bytes[sid]
        prev_order = state["order"] if state is not None else []
        order = [sid for sid in prev_order if sid in members]
        order += [sid for sid in members if sid not in order]
        evicted = set(prev_order) - members
        if evicted:
            # Followers drop evicted host arrays with the next pack op's
            # order; re-admission must re-ship them.
            self._shipped_pack3d -= evicted
        if len({(tuple(t.shape for t in host[sid]["pyr"]), host[sid]["low"].shape) for sid in order}) != 1:
            raise NotImplementedError("mixed pyramid shapes")
        packed = pack_submaps_3d_from_arrays([host[sid] for sid in order], mesh)
        _set_pack_bytes_gauge("3d", total)
        self._pack3d = {
            "order": order,
            "slots": {sid: i for i, sid in enumerate(order)},
            "mesh": mesh,
            "packed": packed,
            "host": host,
            "bytes": total,
        }
        return self._pack3d["slots"], packed

    def _cs_broadcast_3d(self, config, mesh, use_rotational: bool):
        """Multi-host hook for a batched 3D round (see _cs_broadcast_2d)."""
        bc = self._solver_broadcast
        if bc is None or mesh is not self._solver_mesh:
            return None
        state = self._pack3d
        new_sids = [sid for sid in state["order"] if sid not in self._shipped_pack3d]
        if new_sids or self._shipped_order3d != state["order"]:
            # One pack op per new submap: bounds each wire payload to one
            # pyramid (the full delta of a large map could exceed the wire
            # caps), with the full order only on the last op.
            for j, sid in enumerate(new_sids or [None]):
                last = j == len(new_sids or [None]) - 1
                bc(
                    "cs3d_pack",
                    {
                        "order": list(state["order"]) if last else
                        [s for s in state["order"] if s in self._shipped_pack3d or s in new_sids[: j + 1]],
                        "new": {sid: state["host"][sid]} if sid is not None else {},
                    },
                    wait=True,  # pack failures must surface before a round op
                )
            self._shipped_pack3d.update(new_sids)
            self._shipped_order3d = list(state["order"])
        return lambda arrays: bc(
            "cs3d",
            {
                "arrays": arrays,
                "config": tuple(config),
                "use_rotational": use_rotational,
            },
        )

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False) -> Optional[Constraint]:
        """(ref: constraint_builder_3d.cc ComputeConstraint:191-296;
        global_search uses MatchFullSubmap with the global localization
        score gate.) Indices on the returned Constraint are filled in by
        the caller under the lock."""
        cb = self._options.constraint_builder
        if pg_submap.matcher is None:
            self._on_submap_finished(pg_submap)

        init = pg_submap.global_pose.inverse().compose(node.global_pose)
        node_in_grid = pg_submap.submap.local_pose.compose(init)
        initial = Rigid3(
            translation=jnp.asarray(node_in_grid.t, jnp.float32),
            rotation=jnp.asarray(node_in_grid.q, jnp.float32),
        )
        initial_yaw = float(nq.quat_yaw(node_in_grid.q))

        match_fn = pg_submap.matcher.match_full_submap if global_search else pg_submap.matcher.match
        score, low_score, rot_score, pose = match_fn(
            initial,
            node.high_cloud,
            node.low_cloud,
            jnp.asarray(node.histogram),
            initial_yaw,
            max_scan_range=self._scan_range_bucket(node),
        )
        fc = cb.fast_correlative_scan_matcher_3d
        min_score = cb.global_localization_min_score if global_search else cb.min_score
        _observe_constraint_score("global" if global_search else "local", float(score))
        if float(score) < min_score:
            return None
        if float(low_score) < fc.min_low_resolution_score:
            return None

        cm = cb.ceres_scan_matcher_3d
        refined, _ = match_gn_3d(
            pg_submap.submap.high_resolution_grid,
            pg_submap.submap.low_resolution_grid,
            node.high_cloud,
            node.low_cloud,
            pose,
            pose.translation,
            cm.occupied_space_weight_0,
            cm.occupied_space_weight_1,
            cm.translation_weight,
            cm.rotation_weight,
            num_iterations=cm.ceres_solver_options.max_num_iterations,
        )
        refined_np = NpRigid3(
            np.asarray(refined.translation, np.float64), np.asarray(refined.rotation, np.float64)
        )
        zbar = pg_submap.submap.local_pose.inverse().compose(refined_np)
        return Constraint(
            submap_index=-1,  # resolved by _maybe_add_constraint under the lock
            node_index=-1,
            zbar=zbar,
            translation_weight=cb.loop_closure_translation_weight,
            rotation_weight=cb.loop_closure_rotation_weight,
            tag="INTER",
        )

    def _compute_constraints_batched(self, gated, global_search: bool = False):
        """All 3D candidates of a constraint round (local-window, or
        full-submap when global_search) in ONE sharded fast-matcher launch
        + ONE batched GN-refinement launch — the reference's defining
        back-end fan-out (ref: constraint_builder_3d.cc:162-189 one task
        per candidate, barrier at :150-160) as mesh-sharded batching.
        Gates and refinement parameters identical to the serial
        _compute_constraint."""
        from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
            make_fast_search_3d_config,
        )
        from hectorgrapher_tpu.parallel.constraint_search import (
            sharded_fast_matches_3d_packed,
        )

        cb = self._options.constraint_builder
        fc = cb.fast_correlative_scan_matcher_3d
        matcher_by_sid: Dict[int, object] = {}
        for _, sid, _, p in gated:
            if sid not in matcher_by_sid:
                if p.matcher is None:
                    self._on_submap_finished(p)
                matcher_by_sid[sid] = p.matcher
        matchers = list(matcher_by_sid.values())
        # .shape is array metadata (no transfer); per-sid resolution cache
        # because meta.resolution is a device scalar (one device readback
        # per uncached float()).
        info = getattr(self, "_grid_info", None)
        if info is None:
            info = self._grid_info = {}
        for sid, m in matcher_by_sid.items():
            if sid not in info:
                info[sid] = float(np.asarray(m._high_grid.meta.resolution))
        pyr_shapes = {tuple(t.shape for t in m._pyramid_levels) for m in matchers}
        low_shapes = {tuple(m._low_scores.shape) for m in matchers}
        res_set = {info[sid] for sid in matcher_by_sid}
        n_hi = {n.high_cloud.positions.shape[0] for _, _, n, _ in gated}
        n_lo = {n.low_cloud.positions.shape[0] for _, _, n, _ in gated}
        n_hist = {np.asarray(n.histogram).shape[0] for _, _, n, _ in gated}
        if (
            len(pyr_shapes) != 1
            or len(low_shapes) != 1
            or len(res_set) != 1
            or len(n_hi) != 1
            or len(n_lo) != 1
            or len(n_hist) != 1
        ):
            raise NotImplementedError("mixed candidate shapes")
        # Same config construction as FastCorrelativeScanMatcher3D.match /
        # match_full_submap (full yaw + grid-sized window for the global
        # localization batch).
        res = res_set.pop()
        # Per-round angular step from the nodes' actual scan ranges (see
        # _scan_range_bucket).
        scan_range = max(self._scan_range_bucket(n) for _, _, n, _ in gated)
        if global_search:
            g0 = matchers[0]._high_grid  # uniform shapes checked above
            grid_cells = int(
                g0.tsd.shape[0] if hasattr(g0, "tsd") else g0.log_odds.shape[0]
            )
            config = make_fast_search_3d_config(
                fc, res, scan_range, True, 256, grid_cells=grid_cells
            )
            min_score = cb.global_localization_min_score
        else:
            config = make_fast_search_3d_config(
                fc, res, scan_range, False, 256
            )
            min_score = cb.min_score
        import time as time_mod

        prof = {} if ROUND_PROFILING else None
        t0 = time_mod.perf_counter()
        mesh = constraint_search_mesh()
        slot_by_sid, packed = self._get_pack_3d(matcher_by_sid, mesh)
        use_rotational = bool(fc.use_rotational_scan_matcher)
        broadcast = self._cs_broadcast_3d(config, mesh, use_rotational)
        if prof is not None:
            prof["pack"] = time_mod.perf_counter() - t0
            t0 = time_mod.perf_counter()

        hist_np: Dict[int, np.ndarray] = {}
        candidates = []
        for _, sid, node, p in gated:
            init = p.global_pose.inverse().compose(node.global_pose)
            node_in_grid = p.submap.local_pose.compose(init)
            # Host-side numpy initials (one stacked upload in the packer).
            initial = Rigid3(
                translation=node_in_grid.t.astype(np.float32),
                rotation=node_in_grid.q.astype(np.float32),
            )
            h = hist_np.get(id(node.histogram))
            if h is None:
                h = hist_np[id(node.histogram)] = np.asarray(node.histogram)
            candidates.append(
                (
                    slot_by_sid[sid],
                    node.high_cloud,
                    node.low_cloud,
                    h,
                    initial,
                    float(nq.quat_yaw(node_in_grid.q)),
                )
            )
        if prof is not None:
            prof["initials"] = time_mod.perf_counter() - t0
        matches = sharded_fast_matches_3d_packed(
            packed,
            candidates,
            config,
            mesh,
            use_rotational=use_rotational,
            broadcast=broadcast,
            profile=prof,
        )

        survivors = []
        for i, (score, low_score, pose) in enumerate(matches):
            _observe_constraint_score("global" if global_search else "local", float(score))
            if float(score) < min_score:
                continue
            if float(low_score) < fc.min_low_resolution_score:
                continue
            survivors.append((i, pose))
        results: List[Optional[Constraint]] = [None] * len(gated)
        if not survivors:
            if prof is not None:
                LAST_ROUND_BREAKDOWN.clear()
                LAST_ROUND_BREAKDOWN.update(prof)
            return results

        # Refine with the PACKED GN path: each DISTINCT surviving submap's
        # grids (in their storage form — dequantization is deterministic,
        # so quantized and f32 submaps give values identical to the serial
        # path) are stacked and prepared ONCE, and every lane row-gathers
        # from the shared flat interpolation tables by submap-folded row
        # index. At the production 256^3 extent a per-lane prepared table
        # is ~168 MB, so per-lane duplication (the old vmap-of-prepare)
        # cannot fit the chip; per-distinct transients can (ref:
        # constraint_builder_3d.cc ComputeConstraint:258-269). Rounds
        # whose survivors span many distinct submaps split into blocks of
        # <= _GN3D_MAX_DISTINCT distinct submaps — at 256^3 each distinct
        # entry costs ~193 MB of prepared table + comparable prepare
        # transients, so an unbounded stack grows without bound with the
        # round's distinct submaps.
        import jax

        from hectorgrapher_tpu.mapping.scan_matching.gn_3d import (
            match_gn_3d_packed,
            prepare_gn_pack_3d,
        )

        with self._lock:
            submap_by_sid = {s.submap_id: s.submap for s in self.submaps}
        cm = cb.ceres_scan_matcher_3d
        if prof is not None:
            prof["gn_prepare"] = 0.0
            prof["gn_launch"] = 0.0
            prof["gn_readback"] = 0.0

        # Group survivors into blocks of <= _GN3D_MAX_DISTINCT distinct
        # submaps (sorted by sid so one submap never straddles blocks).
        by_sid: Dict[int, list] = {}
        for i, pose in survivors:
            by_sid.setdefault(gated[i][1], []).append((i, pose))
        groups: List[list] = []
        cur: list = []
        for sid in sorted(by_sid):
            if len({gated[i][1] for i, _ in cur}) >= _GN3D_MAX_DISTINCT:
                groups.append(cur)
                cur = []
            cur.extend(by_sid[sid])
        if cur:
            groups.append(cur)

        def bcast_or_stack(items, pad):
            if len({id(c) for c in items}) == 1:
                return jax.tree.map(
                    lambda x: jnp.broadcast_to(x[None], (pad,) + x.shape), items[0]
                )
            return _stack_trees(items, pad)

        for group in groups:
            if prof is not None:
                t0 = time_mod.perf_counter()
            pad = _pow2(len(group))
            distinct_sids: List[int] = []
            for i, _ in group:
                sid = gated[i][1]
                if sid not in distinct_sids:
                    distinct_sids.append(sid)
            d_pad = _pow2(len(distinct_sids))
            d_list = (distinct_sids + [distinct_sids[0]] * d_pad)[:d_pad]
            hi_d = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[submap_by_sid[sid].high_resolution_grid for sid in d_list],
            )
            lo_d = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[submap_by_sid[sid].low_resolution_grid for sid in d_list],
            )
            flat_hi, tmpl_hi, mc_hi, r_hi = prepare_gn_pack_3d(hi_d)
            flat_lo, tmpl_lo, mc_lo, r_lo = prepare_gn_pack_3d(lo_d)
            if prof is not None:
                import jax as jax_mod

                jax_mod.device_get(flat_hi.ravel()[:1])
                prof["gn_prepare"] += time_mod.perf_counter() - t0
            lane_d = np.zeros(pad, np.int32)
            pose_t = np.zeros((pad, 3), np.float32)
            pose_q = np.tile(np.array([1, 0, 0, 0], np.float32), (pad, 1))
            for k, (i, pose) in enumerate(group):
                lane_d[k] = distinct_sids.index(gated[i][1])
                pose_t[k] = np.asarray(pose.translation)
                pose_q[k] = np.asarray(pose.rotation)
            for k in range(len(group), pad):  # pad lanes repeat lane 0
                lane_d[k] = lane_d[0]
                pose_t[k] = pose_t[0]
                pose_q[k] = pose_q[0]

            hi_clouds = bcast_or_stack(
                [gated[i][2].high_cloud for i, _ in group], pad
            )
            lo_clouds = bcast_or_stack(
                [gated[i][2].low_cloud for i, _ in group], pad
            )
            poses = Rigid3(translation=pose_t, rotation=pose_q)
            t_gn = time_mod.perf_counter() if prof is not None else 0.0
            refined, _ = match_gn_3d_packed(
                flat_hi,
                flat_lo,
                tmpl_hi,
                tmpl_lo,
                mc_hi,
                mc_lo,
                jnp.asarray(lane_d),
                hi_clouds,
                lo_clouds,
                poses,
                poses.translation,
                cm.occupied_space_weight_0,
                cm.occupied_space_weight_1,
                cm.translation_weight,
                cm.rotation_weight,
                r_hi=r_hi,
                r_lo=r_lo,
                num_iterations=cm.ceres_solver_options.max_num_iterations,
            )
            if prof is not None:
                import jax as jax_mod

                jax_mod.device_get(refined.translation.ravel()[:1])
                prof["gn_launch"] += time_mod.perf_counter() - t_gn
                t0 = time_mod.perf_counter()
            rt = np.asarray(refined.translation)
            rq = np.asarray(refined.rotation)
            if prof is not None:
                prof["gn_readback"] += time_mod.perf_counter() - t0
            for k, (i, _) in enumerate(group):
                _, sid, node, p = gated[i]
                refined_np = NpRigid3(rt[k].astype(np.float64), rq[k].astype(np.float64))
                zbar = p.submap.local_pose.inverse().compose(refined_np)
                results[i] = Constraint(
                    submap_index=-1,  # resolved by _append_constraint under the lock
                    node_index=-1,
                    zbar=zbar,
                    translation_weight=cb.loop_closure_translation_weight,
                    rotation_weight=cb.loop_closure_rotation_weight,
                    tag="INTER",
                )
        if prof is not None:
            LAST_ROUND_BREAKDOWN.clear()
            LAST_ROUND_BREAKDOWN.update(prof)
        return results

    def _run_optimization(self, num_iterations: int) -> None:
        """(ref: optimization_problem_3d.cc Solve:257-530.)"""
        nodes, submaps, constraints = self._snapshot_lists()
        S = self._pad_to(len(submaps))
        N = self._pad_to(len(nodes))
        C = self._pad_to(max(len(constraints), 1))

        st = np.zeros((S, 3), np.float32)
        sq = np.tile(np.array([1, 0, 0, 0], np.float32), (S, 1))
        nt = np.zeros((N, 3), np.float32)
        nqr = np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
        s_fixed = np.ones(S, bool)
        n_fixed = np.ones(N, bool)
        for i, s in enumerate(submaps):
            st[i] = s.global_pose.t
            sq[i] = s.global_pose.q
            s_fixed[i] = i == 0 or self.is_frozen(s.trajectory_id)
        for i, n in enumerate(nodes):
            nt[i] = n.global_pose.t
            nqr[i] = n.global_pose.q
            n_fixed[i] = self.is_frozen(n.trajectory_id)

        cs = np.zeros(C, np.int32)
        cn = np.zeros(C, np.int32)
        cmask = np.zeros(C, bool)
        crt = np.zeros((C, 3), np.float32)
        crq = np.tile(np.array([1, 0, 0, 0], np.float32), (C, 1))
        cwt = np.zeros(C, np.float32)
        cwr = np.zeros(C, np.float32)
        chub = np.full(C, 1e6, np.float32)
        huber = self._options.optimization_problem.huber_scale
        for i, c in enumerate(constraints):
            cs[i] = c.submap_index
            cn[i] = c.node_index
            cmask[i] = True
            crt[i] = c.zbar.t
            crq[i] = c.zbar.q
            cwt[i] = c.translation_weight
            cwr[i] = c.rotation_weight
            if c.tag == "INTER":
                chub[i] = huber

        problem = SpaProblem3D(
            submap_translation=jnp.asarray(st),
            submap_rotation=jnp.asarray(sq),
            node_translation=jnp.asarray(nt),
            node_rotation=jnp.asarray(nqr),
            submap_fixed=jnp.asarray(s_fixed),
            node_fixed=jnp.asarray(n_fixed),
            c_submap=jnp.asarray(cs),
            c_node=jnp.asarray(cn),
            c_mask=jnp.asarray(cmask),
            c_rel_translation=jnp.asarray(crt),
            c_rel_rotation=jnp.asarray(crq),
            c_translation_weight=jnp.asarray(cwt),
            c_rotation_weight=jnp.asarray(cwr),
            c_huber_scale=jnp.asarray(chub),
        )
        extras = self._build_extras(N, nodes)
        if extras is not None:
            from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_3d_full

            st_o, sq_o, nt_o, nq_o, lt_o, lq_o, cq_o, grav_o, _ = solve_spa_3d_full(
                problem, extras, num_iterations=min(num_iterations, 50)
            )
            # Store optimized landmark poses keyed by string id.
            self._landmark_poses = {
                name: NpRigid3(
                    np.asarray(lt_o)[idx].astype(np.float64),
                    np.asarray(lq_o)[idx].astype(np.float64),
                )
                for name, idx in self._landmark_ids.items()
            }
            self._consume_landmark_overrides(set(self._landmark_ids.values()))
        elif self._solver_mesh is not None:
            import jax

            from hectorgrapher_tpu.parallel.sharded import solve_spa_3d_sharded

            iters = min(num_iterations, 50)
            problem_np = jax.tree.map(np.asarray, problem)  # see 2D branch
            if self._solver_broadcast is not None:
                self._solver_broadcast("spa3d", (problem_np, iters))
            st_o, sq_o, nt_o, nq_o, _ = solve_spa_3d_sharded(
                problem_np, self._solver_mesh, num_iterations=iters
            )
        else:
            st_o, sq_o, nt_o, nq_o, _ = solve_spa_3d(problem, num_iterations=min(num_iterations, 50))
        st_o, sq_o = np.asarray(st_o), np.asarray(sq_o)
        nt_o, nq_o = np.asarray(nt_o), np.asarray(nq_o)
        with self._lock:
            for i, s in enumerate(submaps):
                s.global_pose = NpRigid3(st_o[i].astype(np.float64), sq_o[i].astype(np.float64))
            for i, n in enumerate(nodes):
                n.global_pose = NpRigid3(nt_o[i].astype(np.float64), nq_o[i].astype(np.float64))
            self._correct_post_snapshot(nodes, submaps)

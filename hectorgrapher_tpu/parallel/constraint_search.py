"""Mesh-sharded loop-closure constraint search.

The reference fans constraint computation out over a thread pool — one
task per (node, finished submap) candidate
(ref: constraint_builder_2d.cc MaybeAddConstraint/ComputeConstraint,
constraint_builder_3d.cc:162-189). Here: all candidates
of an optimization round are scored in ONE sharded launch — finished
submaps are partitioned across the mesh's `graph` axis (each device holds
only its own submaps' precomputed pyramids), candidates are routed to the
device owning their submap, and every device runs the batched fast
correlative matcher on its block. Results feed the existing sharded SPA
(parallel/sharded.py).

Fixed-extent dense grids make this possible: every submap pyramid has the
same shape, so per-submap state stacks into one array with a leading
submap axis and PartitionSpec('graph') shards it with zero copies once
placed.
"""

from __future__ import annotations

import functools
import time as _time
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hectorgrapher_tpu.common.device import candidate_chunk_cap_bytes, fast_match_layout
from hectorgrapher_tpu.mapping.grids import GridMeta
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_2d import (
    FastSearchConfig,
    PreparedFastMatcher2D,
    _match_fast_2d_core,
)
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2


def _pow2_pad(n: int) -> int:
    """Pad per-device counts to powers of two: the production pose graph
    launches a round of every size, and each new (S_pad, C_pad) shape would
    otherwise recompile the jitted sharded matcher."""
    p = 1
    while p < n:
        p *= 2
    return p



def _put_sharded(arr: np.ndarray, sharding) -> jax.Array:
    """Place a full host array as a global sharded array.

    On a MULTI-PROCESS mesh jax.device_put cannot place non-addressable
    shards; make_array_from_callback lets each process materialize only
    the shards its own devices address, so the leader and every follower
    build the same global array from the same host copy without
    cross-process transfers. Single-process meshes keep the plain
    device_put fast path."""
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

class CandidateBatch2D(NamedTuple):
    """Device-ready candidate arrays (C_pad = n_devices * per_device)."""

    cloud_positions: jax.Array  # (C_pad, N, 3)
    cloud_mask: jax.Array  # (C_pad, N)
    init_translation: jax.Array  # (C_pad, 2)
    init_angle: jax.Array  # (C_pad,)
    submap_slot: jax.Array  # (C_pad,) int32 — LOCAL slot on the owning device
    valid: jax.Array  # (C_pad,) bool


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "nx", "ny", "axis")
)
def _sharded_scores_2d(
    levels: jax.Array,  # (S_pad, depth, F) sharded over submaps
    min_corners: jax.Array,  # (S_pad, 2)
    resolution: jax.Array,  # scalar f32
    batch: CandidateBatch2D,
    config: FastSearchConfig,
    mesh: Mesh,
    nx: int,
    ny: int,
    axis: str = "graph",
):
    layout = fast_match_layout()

    def device_fn(levels_loc, mc_loc, clp, clm, it, ia, cs, cv):
        # ONE shared flat table for the whole device: the candidate's
        # submap is selected by folding a row offset into the gather index
        # (see _match_fast_2d_core — a per-candidate table operand under
        # vmap lowers to a batch-serialized gather).
        s_loc, depth = levels_loc.shape[0], levels_loc.shape[1]
        rows_per_submap = depth * (nx + 1)
        flat_table = levels_loc.reshape(-1, ny)

        def one(clp1, clm1, it1, ia1, s1):
            score, pose = _match_fast_2d_core(
                flat_table,
                s1 * rows_per_submap,
                resolution,
                mc_loc[s1],
                nx,
                ny,
                PointCloud(clp1, clm1),
                Rigid2(it1, ia1),
                config,
                layout,
            )
            return score, pose.translation, pose.angle

        sc, pt, pa = jax.vmap(one)(clp, clm, it, ia, cs)
        sc = jnp.where(cv, sc, -jnp.inf)
        # Replicate the (tiny) outputs: on a multi-HOST mesh a sharded
        # output spans non-addressable devices and no process could fetch
        # it; the tiled all_gather reconstructs global candidate order.
        g = lambda x: jax.lax.all_gather(x, axis, tiled=True)
        return g(sc), g(pt), g(pa)

    spec_s = P(axis)
    # check_vma=False: the tiled all_gather makes every output replicated,
    # which the static varying-mesh-axes check cannot infer.
    return jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec_s,) * 8,
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(
        levels,
        min_corners,
        batch.cloud_positions,
        batch.cloud_mask,
        batch.init_translation,
        batch.init_angle,
        batch.submap_slot,
        batch.valid,
    )


class PackedSubmaps2D(NamedTuple):
    """Device-resident stack of prepared 2D matchers, sharded over the
    mesh's submap axis. Built ONCE per set of finished submaps (the grids
    of finished submaps never change — ref: submap freezing on
    insertion_finished) and reused by every constraint round against them;
    re-uploading the pyramid stack per round would move tens of MB of HBM
    traffic per loop-closure round for nothing."""

    levels: jax.Array  # (S_pad, depth, F) sharded over axis
    min_corners: jax.Array  # (S_pad, 2) sharded
    resolution: jax.Array  # scalar f32
    dims: Tuple[int, int]
    s_per_dev: int
    count: int


def pack_submaps_2d(
    prepared_submaps: Sequence[PreparedFastMatcher2D],
    mesh: Mesh,
    axis: str = "graph",
) -> PackedSubmaps2D:
    """Stack + shard prepared matchers over the mesh (submap i owned by
    device i // s_per_dev, contiguous blocks; s_per_dev pow2-padded so the
    pack grows through O(log S) shapes)."""
    lshape = tuple(np.asarray(prepared_submaps[0].flat_levels).shape)
    res = float(np.asarray(prepared_submaps[0].meta.resolution))
    nx, ny = (int(v) for v in np.asarray(prepared_submaps[0].dims))
    for pm in prepared_submaps:
        assert tuple(np.asarray(pm.flat_levels).shape) == lshape, "mixed pyramid shapes"

    host = [
        (np.asarray(pm.flat_levels), np.asarray(pm.meta.min_corner))
        for pm in prepared_submaps
    ]
    return pack_submaps_2d_from_arrays(host, res, (nx, ny), mesh, axis)


def pack_submaps_2d_from_arrays(
    host_arrays: Sequence[Tuple[np.ndarray, np.ndarray]],
    resolution: float,
    dims: Tuple[int, int],
    mesh: Mesh,
    axis: str = "graph",
) -> PackedSubmaps2D:
    """Pack from HOST copies of (flat_levels, min_corner) per submap.

    The hot caller (PoseGraph2D._get_pack_2d) keeps these host copies in a
    per-submap cache so an incremental repack (one submap finished since
    the last round) downloads nothing: pack_submaps_2d's np.asarray on
    device-resident pyramids costs one device round-trip per submap
    per rebuild, which dominated production constraint rounds."""
    n_dev = mesh.devices.size
    lshape = host_arrays[0][0].shape  # (depth, nx+1, ny)
    s_count = len(host_arrays)
    s_per_dev = _pow2_pad((s_count + n_dev - 1) // n_dev)
    s_pad = s_per_dev * n_dev
    levels = np.zeros((s_pad,) + lshape, host_arrays[0][0].dtype)
    mcs = np.zeros((s_pad, 2), np.float32)
    for i, (lv, mc) in enumerate(host_arrays):
        levels[i] = lv
        mcs[i] = mc
    sharding = NamedSharding(mesh, P(axis))
    return PackedSubmaps2D(
        levels=_put_sharded(levels, sharding),
        min_corners=_put_sharded(mcs, sharding),
        resolution=jnp.asarray(resolution, jnp.float32),
        dims=dims,
        s_per_dev=s_per_dev,
        count=s_count,
    )


def sharded_fast_matches_2d(
    prepared_submaps: Sequence[PreparedFastMatcher2D],
    candidates: Sequence[Tuple[int, PointCloud, Rigid2]],
    config: FastSearchConfig,
    mesh: Mesh,
    axis: str = "graph",
) -> List[Tuple[float, Rigid2]]:
    """Score every (submap_index, cloud, initial_pose) candidate across the
    mesh; returns [(score, pose)] in candidate order. Packs the submaps on
    the fly — hot callers (the production pose graph) pack once via
    pack_submaps_2d and call sharded_fast_matches_2d_packed per round."""
    if not candidates:
        return []
    packed = pack_submaps_2d(prepared_submaps, mesh, axis)
    return sharded_fast_matches_2d_packed(packed, candidates, config, mesh, axis)


def build_candidate_arrays_2d(
    candidates: Sequence[Tuple[int, PointCloud, Rigid2]],
    s_per_dev: int,
    n_dev: int,
) -> Tuple[dict, np.ndarray]:
    """HOST-side candidate arrays for one 2D constraint round, routed to
    each submap's owning device. Split out of the launch so a multi-host
    leader can ship the exact arrays to followers (cloud/solver_plane.py):
    every process device_puts the same global numpy arrays, then enters the
    same collective launch. Returns (arrays dict, slot_of_candidate)."""
    # Distinct-object host caches: a production round is one node against
    # many submaps, so all its candidates share ONE cloud object — without
    # the cache each np.asarray on a device-resident cloud costs a
    # device round-trip PER CANDIDATE.
    _np_cache: dict = {}

    def to_np(x, dtype=None):
        key = id(x)
        got = _np_cache.get(key)
        if got is None:
            got = np.asarray(x, dtype=dtype)
            _np_cache[key] = got
        return got

    npts = to_np(candidates[0][1].positions).shape[0]

    # Route candidates to their submap's owning device.
    per_dev: List[List[int]] = [[] for _ in range(n_dev)]
    for ci, (si, _, _) in enumerate(candidates):
        per_dev[si // s_per_dev].append(ci)
    c_max = _pow2_pad(max(1, max(len(lst) for lst in per_dev)))
    c_pad = n_dev * c_max

    clp = np.zeros((c_pad, npts, 3), np.float32)
    clm = np.zeros((c_pad, npts), bool)
    it = np.zeros((c_pad, 2), np.float32)
    ia = np.zeros(c_pad, np.float32)
    cs = np.zeros(c_pad, np.int32)
    cv = np.zeros(c_pad, bool)
    slot_of_candidate = np.full(len(candidates), -1, np.int32)
    for d, lst in enumerate(per_dev):
        for k, ci in enumerate(lst):
            row = d * c_max + k
            si, cloud, init = candidates[ci]
            clp[row] = to_np(cloud.positions)
            clm[row] = to_np(cloud.mask)
            it[row] = to_np(init.translation)
            ia[row] = to_np(init.angle)
            cs[row] = si - d * s_per_dev  # local slot on the owner
            cv[row] = True
            slot_of_candidate[ci] = row
    arrays = {
        "cloud_positions": clp,
        "cloud_mask": clm,
        "init_translation": it,
        "init_angle": ia,
        "submap_slot": cs,
        "valid": cv,
    }
    return arrays, slot_of_candidate


def fm_launch_fn_args_2d(
    packed: PackedSubmaps2D,
    arrays: dict,
    config: FastSearchConfig,
    mesh: Mesh,
    axis: str = "graph",
):
    """(jitted_fn, args) of one round's collective 2D matcher launch —
    the bench cost-analyzes the exact production program through this
    (VERDICT r4 next #2)."""
    sharding = NamedSharding(mesh, P(axis))
    batch = CandidateBatch2D(
        cloud_positions=_put_sharded(arrays["cloud_positions"], sharding),
        cloud_mask=_put_sharded(arrays["cloud_mask"], sharding),
        init_translation=_put_sharded(arrays["init_translation"], sharding),
        init_angle=_put_sharded(arrays["init_angle"], sharding),
        submap_slot=_put_sharded(arrays["submap_slot"], sharding),
        valid=_put_sharded(arrays["valid"], sharding),
    )
    nx, ny = packed.dims
    args = (
        packed.levels,
        packed.min_corners,
        packed.resolution,
        batch,
        config,
        mesh,
        nx,
        ny,
        axis,
    )
    return _sharded_scores_2d, args


def launch_fast_matches_2d(
    packed: PackedSubmaps2D,
    arrays: dict,
    config: FastSearchConfig,
    mesh: Mesh,
    axis: str = "graph",
):
    """Upload one round's candidate arrays and run the collective matcher
    launch. Called with IDENTICAL `arrays` by the leader and (via the
    solver plane) every follower of a multi-host mesh so all processes
    enter the same collective program. Returns device (scores, pose_t,
    pose_a) in padded-row order."""
    fn, args = fm_launch_fn_args_2d(packed, arrays, config, mesh, axis)
    return fn(*args)


def sharded_fast_matches_2d_packed(
    packed: PackedSubmaps2D,
    candidates: Sequence[Tuple[int, PointCloud, Rigid2]],
    config: FastSearchConfig,
    mesh: Mesh,
    axis: str = "graph",
    broadcast=None,
    profile: dict = None,
) -> List[Tuple[float, Rigid2]]:
    """One launch per round replaces the reference's one-task-per-candidate
    thread-pool dispatch (constraint_builder_2d.cc:112-160). Candidates are
    routed to the device owning their submap's pack slot. `broadcast`, if
    given, is called with the round's host arrays BEFORE the collective
    launch so multi-host followers can join it (the leader's pose graph
    wires cloud/solver_plane.py here). `profile`, if given, receives
    per-stage wall times with forced device syncs between stages (bench's
    constraint_round_breakdown)."""
    if not candidates:
        return []
    t0 = _time.perf_counter()
    arrays, slot_of_candidate = build_candidate_arrays_2d(
        candidates, packed.s_per_dev, mesh.devices.size
    )
    if profile is not None:
        profile["cand_build"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
    if broadcast is not None:
        broadcast(arrays)
        if profile is not None:
            profile["broadcast"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
    scores, pose_t, pose_a = launch_fast_matches_2d(packed, arrays, config, mesh, axis)
    if profile is not None:
        jax.device_get(scores.ravel()[:1])  # real completion, not enqueue
        profile["fm_launch"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
    scores = np.asarray(scores)
    pose_t = np.asarray(pose_t)
    pose_a = np.asarray(pose_a)
    if profile is not None:
        profile["fm_readback"] = _time.perf_counter() - t0
    out: List[Tuple[float, Rigid2]] = []
    for ci in range(len(candidates)):
        row = slot_of_candidate[ci]
        # Numpy-backed poses: per-candidate jnp.asarray would enqueue two
        # device uploads each; callers stack survivors into ONE upload.
        out.append(
            (float(scores[row]), Rigid2(translation=pose_t[row], angle=pose_a[row]))
        )
    return out


# ---------------------------------------------------------------------------
# 3D: the reference's actual fan-out workload
# (ref: constraint_builder_3d.cc:162-189 — one thread-pool task per
# (node, finished submap) candidate with per-submap matcher-construction
# dependency tasks; here every candidate of a round is one sharded launch,
# submaps partitioned across the mesh.)
# ---------------------------------------------------------------------------

from hectorgrapher_tpu.mapping.grids import ProbabilityGrid
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
    FastSearch3DConfig,
    match_fast_3d,
)
from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import match_histograms
from hectorgrapher_tpu.transform.rigid import Rigid3


class CandidateBatch3D(NamedTuple):
    hi_positions: jax.Array  # (C_pad, N, 3)
    hi_mask: jax.Array  # (C_pad, N)
    lo_positions: jax.Array  # (C_pad, Nl, 3)
    lo_mask: jax.Array  # (C_pad, Nl)
    init_translation: jax.Array  # (C_pad, 3)
    init_rotation: jax.Array  # (C_pad, 4)
    scan_histogram: jax.Array  # (C_pad, H)
    initial_yaw: jax.Array  # (C_pad,)
    submap_slot: jax.Array  # (C_pad,) int32 local slot on the owning device
    valid: jax.Array  # (C_pad,) bool


@functools.partial(
    jax.jit,
    static_argnames=("config", "mesh", "grid_shape", "low_shape", "use_rotational", "axis"),
)
def _sharded_scores_3d(
    pyramids,  # tuple per level: (S_pad, nz_l*nx_l+1, ny_l) sharded over submaps
    hi_min_corners: jax.Array,  # (S_pad, 3)
    low_fields: jax.Array,  # (S_pad, lx, ly, lz)
    lo_min_corners: jax.Array,  # (S_pad, 3)
    histograms: jax.Array,  # (S_pad, H)
    hi_resolution: jax.Array,
    lo_resolution: jax.Array,
    batch: CandidateBatch3D,
    config: FastSearch3DConfig,
    mesh: Mesh,
    grid_shape,
    low_shape,
    use_rotational: bool,
    axis: str = "graph",
):
    layout = fast_match_layout()
    chunk_cap = candidate_chunk_cap_bytes()
    n_yaw = 2 * config.num_yaw + 1
    yaws = (jnp.arange(n_yaw, dtype=jnp.float32) - config.num_yaw) * config.yaw_step

    def device_fn(pyr, hmc, low, lmc, hist, hp, hm, lp, lm, it, iq, sh, iy, cs, cv):
        # One shared flat table PER PYRAMID LEVEL per device; the
        # candidate's submap is selected by a row offset folded into the
        # gather index (a per-candidate operand under vmap
        # batch-serializes the gather — see _match_fast_3d_core).
        from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
            _match_fast_3d_core,
        )

        rows_per_submap = tuple(p.shape[1] for p in pyr)  # (nz_l*nx_l + 1,)
        flat_tables = tuple(p.reshape(-1, p.shape[-1]) for p in pyr)

        def one(hp1, hm1, lp1, lm1, it1, iq1, sh1, iy1, s1):
            yaw_scores = match_histograms(hist[s1], sh1, yaws + iy1)
            if not use_rotational:
                yaw_scores = jnp.ones_like(yaw_scores)
            elif n_yaw > 16:
                # Beam-search yaw restriction (see FastCorrelativeScanMatcher3D._run).
                kth = jnp.sort(yaw_scores)[-16]
                yaw_scores = jnp.where(yaw_scores >= kth, yaw_scores, -1.0)
            score, low_score, rot_score, pose = _match_fast_3d_core(
                flat_tables,
                tuple(s1 * r for r in rows_per_submap),
                GridMeta(resolution=hi_resolution, min_corner=hmc[s1]),
                grid_shape,
                low[s1],
                GridMeta(resolution=lo_resolution, min_corner=lmc[s1]),
                PointCloud(hp1, hm1),
                PointCloud(lp1, lm1),
                Rigid3(translation=it1, rotation=iq1),
                yaw_scores,
                config,
                layout,
            )
            return score, low_score, pose.translation, pose.rotation

        # Candidate chunking: each candidate's expansion stage gathers
        # top_k parents x point_chunk points x 8 children per scan step;
        # where a round's candidates together exceed the device's chunk
        # cap, lax.map over pow2 candidate blocks bounds the live set (the
        # per-candidate work already fills the device, so serializing
        # blocks costs only the small cross-candidate overlap).
        c_loc = hp.shape[0]
        # 8 (x, y, z) children per point, each an int32 index and a value.
        per_point = 8 * (4 + jnp.dtype(layout.level_dtype).itemsize)
        per_cand = int(config.top_k) * layout.point_chunk * per_point
        chunk = c_loc
        while chunk > 1 and chunk * per_cand > chunk_cap:
            chunk //= 2
        args = (hp, hm, lp, lm, it, iq, sh, iy, cs)
        if chunk >= c_loc:
            sc, lsc, pt, pq = jax.vmap(one)(*args)
        else:
            n_blocks = c_loc // chunk
            blocked = tuple(
                a.reshape((n_blocks, chunk) + a.shape[1:]) for a in args
            )
            sc, lsc, pt, pq = jax.lax.map(
                lambda ab: jax.vmap(one)(*ab), blocked
            )
            sc, lsc, pt, pq = (
                x.reshape((c_loc,) + x.shape[2:]) for x in (sc, lsc, pt, pq)
            )
        sc = jnp.where(cv, sc, -jnp.inf)
        # Replicated outputs for multi-host fetchability (see the 2D
        # variant).
        g = lambda x: jax.lax.all_gather(x, axis, tiled=True)
        return g(sc), g(lsc), g(pt), g(pq)

    spec = P(axis)
    return jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec,) * 15,
        out_specs=(P(), P(), P(), P()),
        check_vma=False,  # see the 2D variant
    )(
        pyramids, hi_min_corners, low_fields, lo_min_corners, histograms,
        batch.hi_positions, batch.hi_mask, batch.lo_positions, batch.lo_mask,
        batch.init_translation, batch.init_rotation, batch.scan_histogram,
        batch.initial_yaw, batch.submap_slot, batch.valid,
    )


class PackedSubmaps3D(NamedTuple):
    """Device-resident stack of 3D matcher state sharded over the mesh
    (see PackedSubmaps2D — the 3D pyramids are far larger, so per-round
    re-upload would be prohibitive)."""

    pyramids: Tuple[jax.Array, ...]  # per level: (S_pad, nz_l*nx_l+1, ny_l) sharded
    hi_min_corners: jax.Array  # (S_pad, 3)
    low_fields: jax.Array  # (S_pad,) + low_shape
    lo_min_corners: jax.Array  # (S_pad, 3)
    histograms: jax.Array  # (S_pad, H)
    hi_resolution: jax.Array  # scalar f32
    lo_resolution: jax.Array  # scalar f32
    grid_shape: Tuple[int, ...]
    low_shape: Tuple[int, ...]
    s_per_dev: int
    count: int


def matcher_host_arrays_3d(matcher) -> dict:
    """HOST copies of one FastCorrelativeScanMatcher3D's pack state —
    downloaded once per finished submap by the pose graph's pack cache and
    shipped to multi-host followers (finished grids are immutable).
    "pyr" is a LIST of per-level decimated tables (see
    fast_correlative_3d.precompute_pyramid_3d)."""
    hgrid = matcher._high_grid
    return {
        "pyr": [np.asarray(t) for t in matcher._pyramid_levels],
        "hmc": np.asarray(hgrid.meta.min_corner, np.float32),
        "low": np.asarray(matcher._low_scores),
        "lmc": np.asarray(matcher._low_grid.meta.min_corner, np.float32),
        "hist": np.asarray(matcher._histogram),
        "hi_res": float(np.asarray(hgrid.meta.resolution)),
        "lo_res": float(np.asarray(matcher._low_grid.meta.resolution)),
        "grid_shape": tuple(
            hgrid.tsd.shape if hasattr(hgrid, "tsd") else hgrid.log_odds.shape
        ),
    }


def host_arrays_3d_nbytes(a: dict) -> int:
    """HBM bytes one submap's packed matcher state will occupy (pyramid
    levels + low field + corners/histogram are negligible)."""
    return int(
        sum(t.nbytes for t in a["pyr"]) + a["low"].nbytes + a["hist"].nbytes
    )


def pack_submaps_3d_from_arrays(
    host_arrays: Sequence[dict], mesh: Mesh, axis: str = "graph"
) -> PackedSubmaps3D:
    """Pack from matcher_host_arrays_3d dicts: every process of a
    multi-host mesh builds the identical globally-sharded pack from the
    same host arrays (each device_put materializes only that process's
    addressable shards)."""
    n_dev = mesh.devices.size
    a0 = host_arrays[0]
    pshapes = [tuple(t.shape) for t in a0["pyr"]]  # per level (rows+1, ny_l)
    lshape = tuple(a0["low"].shape)
    H = a0["hist"].shape[0]

    s_count = len(host_arrays)
    s_per_dev = _pow2_pad((s_count + n_dev - 1) // n_dev)
    s_pad = s_per_dev * n_dev
    pyr_levels = [
        np.zeros((s_pad,) + ps, a0["pyr"][li].dtype)  # the layout's level dtype
        for li, ps in enumerate(pshapes)
    ]
    hmc = np.zeros((s_pad, 3), np.float32)
    low = np.zeros((s_pad,) + lshape, np.float32)
    lmc = np.zeros((s_pad, 3), np.float32)
    hist = np.zeros((s_pad, H), np.float32)
    for i, a in enumerate(host_arrays):
        assert [tuple(t.shape) for t in a["pyr"]] == pshapes, "mixed pyramid shapes"
        for li, t in enumerate(a["pyr"]):
            pyr_levels[li][i] = t
        hmc[i] = a["hmc"]
        low[i] = a["low"]
        lmc[i] = a["lmc"]
        hist[i] = a["hist"]
    sharding = NamedSharding(mesh, P(axis))
    return PackedSubmaps3D(
        pyramids=tuple(_put_sharded(t, sharding) for t in pyr_levels),
        hi_min_corners=_put_sharded(hmc, sharding),
        low_fields=_put_sharded(low, sharding),
        lo_min_corners=_put_sharded(lmc, sharding),
        histograms=_put_sharded(hist, sharding),
        hi_resolution=jnp.asarray(a0["hi_res"], jnp.float32),
        lo_resolution=jnp.asarray(a0["lo_res"], jnp.float32),
        grid_shape=tuple(a0["grid_shape"]),
        low_shape=lshape,
        s_per_dev=s_per_dev,
        count=s_count,
    )


def pack_submaps_3d(matchers, mesh: Mesh, axis: str = "graph") -> PackedSubmaps3D:
    """Stack + shard FastCorrelativeScanMatcher3D state over the mesh."""
    return pack_submaps_3d_from_arrays(
        [matcher_host_arrays_3d(m) for m in matchers], mesh, axis
    )


def sharded_fast_matches_3d(
    matchers,  # Sequence[FastCorrelativeScanMatcher3D] (same grid shapes)
    candidates,  # [(submap_index, hi_cloud, lo_cloud, scan_histogram, initial_pose(Rigid3), initial_yaw)]
    config: FastSearch3DConfig,
    mesh: Mesh,
    use_rotational: bool = True,
    axis: str = "graph",
):
    """Score every 3D (node, finished submap) candidate of a constraint
    round in ONE launch sharded over the mesh. Packs the submaps on the
    fly — hot callers pack once (pack_submaps_3d) and use
    sharded_fast_matches_3d_packed per round."""
    if not candidates:
        return []
    packed = pack_submaps_3d(matchers, mesh, axis)
    return sharded_fast_matches_3d_packed(
        packed, candidates, config, mesh, use_rotational, axis
    )


def build_candidate_arrays_3d(
    candidates, s_per_dev: int, n_dev: int, H: int
) -> Tuple[dict, np.ndarray]:
    """HOST-side candidate arrays for one 3D constraint round (see
    build_candidate_arrays_2d — same split so a multi-host leader can ship
    the exact arrays to followers)."""
    # Distinct-object host cache — a round's candidates share one node's
    # clouds, and each uncached np.asarray on a device array costs a
    # device round-trip.
    _np_cache: dict = {}

    def to_np(x):
        key = id(x)
        got = _np_cache.get(key)
        if got is None:
            got = np.asarray(x)
            _np_cache[key] = got
        return got

    per_dev: List[List[int]] = [[] for _ in range(n_dev)]
    for ci, cand in enumerate(candidates):
        per_dev[cand[0] // s_per_dev].append(ci)
    c_max = _pow2_pad(max(1, max(len(lst) for lst in per_dev)))
    c_pad = n_dev * c_max
    n_hi = candidates[0][1].positions.shape[0]
    n_lo = candidates[0][2].positions.shape[0]

    hp = np.zeros((c_pad, n_hi, 3), np.float32)
    hm = np.zeros((c_pad, n_hi), bool)
    lp = np.zeros((c_pad, n_lo, 3), np.float32)
    lm = np.zeros((c_pad, n_lo), bool)
    it = np.zeros((c_pad, 3), np.float32)
    iq = np.tile(np.array([1, 0, 0, 0], np.float32), (c_pad, 1))
    sh = np.zeros((c_pad, H), np.float32)
    iy = np.zeros(c_pad, np.float32)
    cs = np.zeros(c_pad, np.int32)
    cv = np.zeros(c_pad, bool)
    slot_of_candidate = np.full(len(candidates), -1, np.int32)
    for d, lst in enumerate(per_dev):
        for k, ci in enumerate(lst):
            row = d * c_max + k
            si, hi_cloud, lo_cloud, scan_hist, init, init_yaw = candidates[ci]
            hp[row] = to_np(hi_cloud.positions)
            hm[row] = to_np(hi_cloud.mask)
            lp[row] = to_np(lo_cloud.positions)
            lm[row] = to_np(lo_cloud.mask)
            it[row] = to_np(init.translation)
            iq[row] = to_np(init.rotation)
            sh[row] = to_np(scan_hist)
            iy[row] = float(init_yaw)
            cs[row] = si - d * s_per_dev
            cv[row] = True
            slot_of_candidate[ci] = row
    arrays = {
        "hi_positions": hp,
        "hi_mask": hm,
        "lo_positions": lp,
        "lo_mask": lm,
        "init_translation": it,
        "init_rotation": iq,
        "scan_histogram": sh,
        "initial_yaw": iy,
        "submap_slot": cs,
        "valid": cv,
    }
    return arrays, slot_of_candidate


def fm_launch_fn_args_3d(
    packed: PackedSubmaps3D,
    arrays: dict,
    config: FastSearch3DConfig,
    mesh: Mesh,
    use_rotational: bool = True,
    axis: str = "graph",
):
    """(jitted_fn, args) of one round's collective 3D matcher launch —
    the bench cost-analyzes the exact production program through this
    (VERDICT r4 next #2: the dominant round stage had no roofline)."""
    sharding = NamedSharding(mesh, P(axis))
    batch = CandidateBatch3D(
        hi_positions=_put_sharded(arrays["hi_positions"], sharding),
        hi_mask=_put_sharded(arrays["hi_mask"], sharding),
        lo_positions=_put_sharded(arrays["lo_positions"], sharding),
        lo_mask=_put_sharded(arrays["lo_mask"], sharding),
        init_translation=_put_sharded(arrays["init_translation"], sharding),
        init_rotation=_put_sharded(arrays["init_rotation"], sharding),
        scan_histogram=_put_sharded(arrays["scan_histogram"], sharding),
        initial_yaw=_put_sharded(arrays["initial_yaw"], sharding),
        submap_slot=_put_sharded(arrays["submap_slot"], sharding),
        valid=_put_sharded(arrays["valid"], sharding),
    )
    args = (
        packed.pyramids,
        packed.hi_min_corners,
        packed.low_fields,
        packed.lo_min_corners,
        packed.histograms,
        packed.hi_resolution,
        packed.lo_resolution,
        batch,
        config,
        mesh,
        packed.grid_shape,
        packed.low_shape,
        use_rotational,
        axis,
    )
    return _sharded_scores_3d, args


def launch_fast_matches_3d(
    packed: PackedSubmaps3D,
    arrays: dict,
    config: FastSearch3DConfig,
    mesh: Mesh,
    use_rotational: bool = True,
    axis: str = "graph",
):
    """Upload one round's candidate arrays and enter the collective 3D
    matcher launch (leader and every follower run this with identical
    arrays). Returns device (scores, low_scores, pose_t, pose_q)."""
    fn, args = fm_launch_fn_args_3d(packed, arrays, config, mesh, use_rotational, axis)
    return fn(*args)


def sharded_fast_matches_3d_packed(
    packed: PackedSubmaps3D,
    candidates,
    config: FastSearch3DConfig,
    mesh: Mesh,
    use_rotational: bool = True,
    axis: str = "graph",
    broadcast=None,
    profile: dict = None,
):
    """One sharded launch for a round's 3D candidates (submaps partitioned
    by pack slot; candidates routed to their submap's owner). Returns
    [(score, low_score, Rigid3 pose)] in candidate order — the caller
    applies the min_score / low-resolution gates and GN refinement exactly
    as the single-device path does. `broadcast`, if given, receives the
    round's host arrays before the collective launch (multi-host).
    `profile`, if given, receives per-stage wall times with forced device
    syncs between stages (bench's constraint_round_3d breakdown)."""
    if not candidates:
        return []
    t0 = _time.perf_counter()
    arrays, slot_of_candidate = build_candidate_arrays_3d(
        candidates, packed.s_per_dev, mesh.devices.size, int(packed.histograms.shape[-1])
    )
    if profile is not None:
        profile["cand_build"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
    if broadcast is not None:
        broadcast(arrays)
        if profile is not None:
            profile["broadcast"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
    scores, low_scores, pose_t, pose_q = launch_fast_matches_3d(
        packed, arrays, config, mesh, use_rotational, axis
    )
    if profile is not None:
        jax.device_get(scores.ravel()[:1])  # real completion, not enqueue
        profile["fm_launch"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
    scores = np.asarray(scores)
    low_scores = np.asarray(low_scores)
    pose_t = np.asarray(pose_t)
    pose_q = np.asarray(pose_q)
    if profile is not None:
        profile["fm_readback"] = _time.perf_counter() - t0
    out = []
    for ci in range(len(candidates)):
        row = slot_of_candidate[ci]
        # Numpy-backed poses (see the 2D packed matcher): callers stack
        # survivors into one upload instead of two dispatches per pose.
        out.append(
            (
                float(scores[row]),
                float(low_scores[row]),
                Rigid3(translation=pose_t[row], rotation=pose_q[row]),
            )
        )
    return out

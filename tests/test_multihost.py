"""Multi-host solver plane, hermetically: two REAL processes on localhost
(SURVEY §4 "multi-node without a cluster"; ref: the reference's
client_server_test.cc starts real servers in-process — here the analog is
two jax.distributed processes forming one global mesh).

Coverage (VERDICT r2 #5):
  1. globally-sharded reduction + sharded SPA-2D (round-2 baseline),
  2. sharded 3D constraint search cross-process, checked against the
     local-mesh result,
  3. a REAL PoseGraph3D optimization through the leader/follower solver
     plane (cloud/solver_plane.py): process 0 owns the pose graph and
     broadcasts each sharded solve; process 1 executes it so the global
     collectives complete.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

proc_id = int(sys.argv[1])
coord = sys.argv[2]
follower_port = int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_ENABLE_X64", "1")

sys.path.insert(0, os.getcwd())

import jax

jax.config.update("jax_platforms", "cpu")
# Join the coordination service BEFORE any backend/device use — the same
# ordering a production main must follow (parallel/multihost.py docs).
jax.distributed.initialize(coordinator_address=coord, num_processes=2, process_id=proc_id)

from hectorgrapher_tpu.parallel.multihost import global_mesh

assert jax.process_count() == 2, jax.process_count()
mesh = global_mesh()
assert len(mesh.devices.ravel()) == 8, mesh

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# ---- 1. globally-sharded reduction + sharded SPA-2D ------------------------
rows = 64
global_shape = (rows, 16)
data = np.arange(rows * 16, dtype=np.float32).reshape(global_shape)
sharding = NamedSharding(mesh, P("graph"))
arr = jax.make_array_from_process_local_data(sharding, data[proc_id * 32 : (proc_id + 1) * 32])

@jax.jit
def total(a):
    return jnp.sum(a * a)

out = float(total(arr))
expected = float(np.sum(data.astype(np.float64) ** 2))
assert abs(out - expected) / expected < 1e-6, (out, expected)

from tests.test_sharded import build_problem
from hectorgrapher_tpu.parallel.sharded import solve_spa_2d_sharded

rng = np.random.default_rng(0)
problem, gt_sub, gt_node = build_problem(rng)
sub_s, node_s, cost = solve_spa_2d_sharded(problem, mesh, num_iterations=20)
err = float(jnp.max(jnp.abs(np.asarray(node_s)[:, :2] - gt_node[:, :2])))
assert err < 0.05, err
print(f"proc {proc_id} SPA2D OK err={err:.2e}")

# ---- 2. sharded 3D constraint search cross-process -------------------------
# Identical submaps/candidates on both processes (SPMD); the global-mesh
# result must match the local-mesh result.
from hectorgrapher_tpu.common.config import (
    FastCorrelativeScanMatcherOptions3D,
    TSDFRangeDataInserterOptions3D,
)
from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
    FastCorrelativeScanMatcher3D,
    make_fast_search_3d_config,
)
from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu.parallel.constraint_search import sharded_fast_matches_3d
from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3

HIST = 64

def build_matcher(seed_shift):
    hi = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.3, max_weight=1000.0)
    lo = make_tsdf_grid(0.45, (24, 24, 12), truncation_distance=1.0, max_weight=1000.0)
    opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    ins_hi = make_tsdf_inserter_3d(opts, 0.1)
    ins_lo = make_tsdf_inserter_3d(opts, 0.45)
    hist = np.zeros(HIST, np.float32)
    for k in range(2):
        origin = np.array([0.3 * k + seed_shift, 0.0, 0.0])
        pts = raycast_box_room_3d(origin, nq.quat_identity(), num_azimuth=128, num_elevation=24)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32) + origin.astype(np.float32)
        rd = RangeData(origin=jnp.asarray(origin, jnp.float32), returns=pad_cloud(pts, 4096),
                       misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
        hi = ins_hi(hi, rd)
        lo = ins_lo(lo, rd)
        pc = pad_cloud(pts, 4096)
        hist += np.asarray(compute_histogram(pc.positions, pc.mask, HIST))
    fc = FastCorrelativeScanMatcherOptions3D(
        linear_xy_search_window=1.0, linear_z_search_window=0.3,
        angular_search_window=np.radians(10.0), branch_and_bound_depth=3,
        min_rotational_score=0.1, min_low_resolution_score=0.1,
    )
    return FastCorrelativeScanMatcher3D(fc, hi, lo, hist, HIST), fc

m0, fc = build_matcher(0.0)
m1, _ = build_matcher(0.15)
scan = raycast_box_room_3d(np.array([0.2, -0.1, 0.0]), nq.quat_identity(), num_azimuth=96, num_elevation=20)
scan = scan[~np.isnan(scan[:, 0])].astype(np.float32)
high = compact_cloud(voxel_filter(pad_cloud(scan, 4096), 0.15), 512)
low = compact_cloud(voxel_filter(pad_cloud(scan, 4096), 0.45), 256)
shist = np.asarray(compute_histogram(high.positions, high.mask, HIST))
init = Rigid3(translation=jnp.asarray([0.25, -0.05, 0.0], jnp.float32),
              rotation=jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32))
config = make_fast_search_3d_config(fc, 0.1, 20.0, False, 256)
candidates = [(0, high, low, shist, init, 0.0), (1, high, low, shist, init, 0.0)]

res_global = sharded_fast_matches_3d([m0, m1], candidates, config, mesh, use_rotational=True)
local_mesh = Mesh(np.array(jax.local_devices()), ("graph",))
res_local = sharded_fast_matches_3d([m0, m1], candidates, config, local_mesh, use_rotational=True)
for (sg, lg, pg_), (sl, ll, pl) in zip(res_global, res_local):
    assert abs(sg - sl) < 1e-4, (sg, sl)
    assert float(jnp.max(jnp.abs(pg_.translation - pl.translation))) < 1e-4
assert res_global[0][0] > 0.3, res_global[0][0]
print(f"proc {proc_id} FM3D OK score={res_global[0][0]:.2f}")

# ---- 3-5. Production pose graph through the solver plane -------------------
# 3: sharded SPA through the leader/follower plane.
# 4: PRODUCTION PoseGraph2D.add_node -> batched loop-closure round on the
#    2-process global mesh (the round-3 deadlock path), constraints
#    asserted identical to a local-mesh run of the same sequence.
# 5: the 3D variant of 4.
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import (
    Constraint, PgNode, PgSubmap, PoseGraph2D, PoseGraph3D,
)
from hectorgrapher_tpu.mapping.submap_2d import Submap2D
from hectorgrapher_tpu.mapping.submap_3d import Submap3D
from hectorgrapher_tpu.transform.np_quat import NpRigid3

if proc_id == 1:
    from hectorgrapher_tpu.cloud.solver_plane import SolverPlaneFollower

    follower = SolverPlaneFollower(f"127.0.0.1:{follower_port}").start()
    assert follower.wait_for_shutdown(timeout=1500), "no shutdown from leader"
    print("proc 1 FOLLOWER OK")
else:
    import time as _time

    from hectorgrapher_tpu.cloud.solver_plane import SolverPlaneLeader

    _time.sleep(2.0)  # let the follower bind its port
    options = replace_deep(
        MapBuilderOptions(),
        {"pose_graph.async_work_queue": False, "pose_graph.optimize_every_n_nodes": 0},
    ).pose_graph
    pg = PoseGraph3D(options, histogram_size=HIST)
    leader = SolverPlaneLeader([f"127.0.0.1:{follower_port}"], collect_stats=True)
    pg.set_solver_mesh(mesh, broadcast=leader)

    submap = Submap3D(
        local_pose=NpRigid3(np.zeros(3)),
        high_resolution_grid=make_tsdf_grid(0.1, (8, 8, 8), 0.3, 100.0),
        low_resolution_grid=make_tsdf_grid(0.45, (4, 4, 4), 1.0, 100.0),
        rotational_histogram=np.zeros(HIST, np.float32),
        num_range_data=1,
    )
    pg.submaps.append(PgSubmap(submap=submap, global_pose=NpRigid3(np.zeros(3)), submap_id=0))
    pg._submap_ids[id(submap)] = 0
    pg._submap_index_by_id[0] = 0
    truth = [np.array([0.2 * k, 0.05 * k, 0.0]) for k in range(4)]
    rng2 = np.random.default_rng(7)
    for k, t_true in enumerate(truth):
        node = PgNode(
            time=0.1 * k,
            local_pose=NpRigid3(t_true),
            global_pose=NpRigid3(t_true + rng2.normal(0, 0.3, 3)),  # perturbed init
            node_id=k,
        )
        pg.nodes.append(node)
        pg._node_index_by_id[k] = k
        pg.constraints.append(
            Constraint(0, k, NpRigid3(t_true), 1e4, 1e4, "INTRA")
        )
    pg.run_final_optimization(25)
    errs = [np.linalg.norm(pg.nodes[k].global_pose.t - truth[k]) for k in range(4)]
    assert max(errs) < 1e-3, errs
    print(f"proc 0 SOLVERPLANE OK err={max(errs):.2e}")

    # ---- 4. production 2D batched rounds on the global mesh ----------------
    import jax.numpy as jnp2
    from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

    opts2 = replace_deep(
        MapBuilderOptions(),
        {
            "pose_graph.async_work_queue": False,
            "pose_graph.optimize_every_n_nodes": 3,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 100.0,
            "pose_graph.constraint_builder.min_score": 0.3,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher.linear_search_window": 0.4,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher.branch_and_bound_depth": 3,
        },
    ).pose_graph
    grid2 = make_probability_grid(0.1, (64, 64))
    ins2 = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=6.0, resolution=0.1
    )
    pts2 = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=2.5, half_height=2.1, num_rays=240)
    pts2 = pts2[~np.isnan(pts2[:, 0])].astype(np.float32)
    cloud2 = pad_cloud(pts2, 256)
    grid2 = ins2(
        grid2,
        RangeData(origin=jnp2.zeros(3, jnp2.float32), returns=cloud2,
                  misses=pad_cloud(np.zeros((0, 3), np.float32), 8)),
    )

    def run_graph_2d(use_global_mesh):
        g = PoseGraph2D(opts2, max_scan_range=6.0)
        if use_global_mesh:
            g.set_solver_mesh(mesh, broadcast=leader)
        for i in range(4):
            sm = Submap2D(local_pose=NpRigid3(np.zeros(3)), grid=grid2,
                          insertion_finished=True)
            node = PgNode(time=0.1 * i, local_pose=NpRigid3(np.zeros(3)),
                          global_pose=NpRigid3.identity(), cloud=cloud2)
            g.add_node(node, [sm])
        return [
            (c.submap_index, c.node_index, tuple(np.round(c.zbar.t, 5)))
            for c in g.constraints if c.tag == "INTER"
        ]

    import hectorgrapher_tpu.mapping.pose_graph.pose_graph as pg_mod

    pg_mod.set_constraint_search_mesh(None)  # local default for the reference run
    ref2 = run_graph_2d(False)
    got2 = run_graph_2d(True)
    assert ref2, "reference 2D run found no INTER constraints"
    assert got2 == ref2, (got2, ref2)
    print(f"proc 0 PROD2D OK inter={len(got2)}")

    # ---- 5. production 3D batched rounds on the global mesh ----------------
    from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions3D as _T3
    from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d as _mk3

    opts3 = replace_deep(
        MapBuilderOptions(),
        {
            "pose_graph.async_work_queue": False,
            "pose_graph.optimize_every_n_nodes": 0,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 100.0,
            "pose_graph.constraint_builder.min_score": 0.2,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.linear_xy_search_window": 0.6,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.linear_z_search_window": 0.3,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.angular_search_window": np.radians(10.0),
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.branch_and_bound_depth": 3,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_rotational_score": 0.1,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_low_resolution_score": 0.1,
        },
    ).pose_graph
    ins_hi3 = _mk3(_T3(normal_computation_method="NONE", min_range=0.4, max_range=30.0), 0.2)
    ins_lo3 = _mk3(_T3(normal_computation_method="NONE", min_range=0.4, max_range=30.0), 0.6)
    hi3 = make_tsdf_grid(0.2, (32, 32, 16), truncation_distance=0.6, max_weight=1000.0)
    lo3 = make_tsdf_grid(0.6, (12, 12, 8), truncation_distance=1.2, max_weight=1000.0)
    pts3 = raycast_box_room_3d(np.zeros(3), nq.quat_identity(),
                               half_extents=(2.0, 1.8, 1.0), num_azimuth=64, num_elevation=12)
    pts3 = pts3[~np.isnan(pts3[:, 0])].astype(np.float32)
    rd3 = RangeData(origin=jnp2.zeros(3, jnp2.float32), returns=pad_cloud(pts3, 1024),
                    misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
    hi3, lo3 = ins_hi3(hi3, rd3), ins_lo3(lo3, rd3)
    full3 = pad_cloud(pts3, 1024)
    hist3 = np.asarray(compute_histogram(full3.positions, full3.mask, HIST))
    hcloud3 = compact_cloud(voxel_filter(full3, 0.3), 128)
    lcloud3 = compact_cloud(voxel_filter(full3, 0.6), 64)

    def run_graph_3d(use_global_mesh):
        g = PoseGraph3D(opts3, histogram_size=HIST, max_scan_range=6.0)
        if use_global_mesh:
            g.set_solver_mesh(mesh, broadcast=leader)
        for i in range(3):
            sm = Submap3D(local_pose=NpRigid3(np.zeros(3)),
                          high_resolution_grid=hi3, low_resolution_grid=lo3,
                          rotational_histogram=hist3, num_range_data=1,
                          insertion_finished=True)
            node = PgNode(time=0.1 * i, local_pose=NpRigid3(np.zeros(3)),
                          global_pose=NpRigid3.identity(),
                          high_cloud=hcloud3, low_cloud=lcloud3, histogram=hist3)
            g.add_node(node, [sm])
        return [
            (c.submap_index, c.node_index, tuple(np.round(c.zbar.t, 5)))
            for c in g.constraints if c.tag == "INTER"
        ]

    pg_mod.set_constraint_search_mesh(None)
    ref3 = run_graph_3d(False)
    got3 = run_graph_3d(True)
    assert ref3, "reference 3D run found no INTER constraints"
    assert got3 == ref3, (got3, ref3)
    # Solver-plane overhead record (VERDICT r4 next #7): per-op payload
    # bytes + follower-ack latencies between hosts (localhost gRPC here; a
    # real network adds its RTT on top of the serialize/deserialize cost
    # shown).
    import json as _json
    summary = {
        op: {
            "count": st["count"],
            "bytes": st["bytes"],
            "ack_ms_p50": round(float(np.median(st["ack_ms"])), 1) if st["ack_ms"] else None,
            "ack_ms_max": round(float(np.max(st["ack_ms"])), 1) if st["ack_ms"] else None,
        }
        for op, st in leader.stats.items()
    }
    print("SOLVERPLANE_STATS " + _json.dumps(summary), flush=True)
    leader.shutdown()
    print(f"proc 0 PROD3D OK inter={len(got3)}")
"""


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("HG_SKIP_MULTIPROCESS") == "1",
    reason="multi-process test disabled",
)
def test_two_process_global_mesh(tmp_path):
    ports = []
    socks = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    coord = f"127.0.0.1:{ports[0]}"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), coord, str(ports[1])],
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=1800)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    assert "SPA2D OK" in outs[0][1] and "SPA2D OK" in outs[1][1]
    assert "FM3D OK" in outs[0][1] and "FM3D OK" in outs[1][1]
    assert "SOLVERPLANE OK" in outs[0][1]
    assert "PROD2D OK" in outs[0][1]
    assert "PROD3D OK" in outs[0][1]
    # Overhead record present.
    stats_line = next(
        (l for l in outs[0][1].splitlines() if l.startswith("SOLVERPLANE_STATS ")),
        None,
    )
    assert stats_line is not None, "leader did not report solver-plane stats"
    stats = json.loads(stats_line[len("SOLVERPLANE_STATS "):])
    assert "cs3d_pack" in stats and "cs3d" in stats, stats
    print(stats_line)
    assert "FOLLOWER OK" in outs[1][1]

"""Full 3D SLAM integration test
(ref: mapping/map_builder_test.cc GlobalSlam3D — CT local SLAM + pose
graph on synthetic scans with IMU + odometry)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu.mapping.map_builder import MapBuilder
from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3

GRAVITY = np.array([0.0, 0.0, 9.80665])


def make_options():
    return replace_deep(
        MapBuilderOptions(),
        {
            "use_trajectory_builder_3d": True,
            "trajectory_builder_3d.min_range": 0.4,
            "trajectory_builder_3d.max_range": 25.0,
            "trajectory_builder_3d.submaps.grid_type": "TSDF",
            "trajectory_builder_3d.submaps.high_grid_size": 96,
            "trajectory_builder_3d.submaps.low_grid_size": 48,
            "trajectory_builder_3d.submaps.num_range_data": 8,
            "trajectory_builder_3d.motion_filter.max_distance_meters": 0.02,
            "trajectory_builder_3d.motion_filter.max_angle_radians": 0.002,
            "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration": 0.45,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points": 12,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window": 12,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud": 256,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.max_num_iterations": 8,
            "pose_graph.optimize_every_n_nodes": 8,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.min_score": 0.5,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.linear_xy_search_window": 2.0,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.linear_z_search_window": 0.4,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.branch_and_bound_depth": 4,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_rotational_score": 0.2,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_low_resolution_score": 0.5,
        },
    )


def gt_pose(t, speed=0.25, rest=0.6):
    # stationary during CT initialization (zero-motion map init), then drive
    x = speed * max(0.0, t - rest)
    return np.array([x, 0.0, 0.0]), nq.quat_identity()


@pytest.mark.slow
def test_full_3d_slam_straight_drive():
    mb = MapBuilder(make_options())
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    rng = np.random.default_rng(0)

    duration, dt_imu, dt_odom, dt_scan = 4.0, 0.01, 0.05, 0.1
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        _, q = gt_pose(t)
        tb.add_imu_data(t, nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.zeros(3))
        if t >= next_odom:
            pt, pq = gt_pose(t)
            tb.add_odometry_data(t, NpRigid3(pt + rng.normal(0, 0.002, 3), pq))
            next_odom += dt_odom
        if t >= next_scan:
            pt, pq = gt_pose(t)
            pts = raycast_box_room_3d(pt, pq, num_azimuth=96, num_elevation=24, noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2560)
            tb.add_range_data(
                TimedPointCloudData(time=jnp.asarray(t), origin=jnp.zeros(3, jnp.float32), ranges=cloud, width=96)
            )
            next_scan += dt_scan
        t = round(t + dt_imu, 6)

    pg = mb.pose_graph
    assert len(pg.nodes) >= 8, f"nodes {len(pg.nodes)}"
    assert len(pg.submaps) >= 1
    intra = [c for c in pg.constraints if c.tag == "INTRA"]
    assert len(intra) >= len(pg.nodes)

    pg.run_final_optimization()
    errs = []
    for node in pg.nodes:
        gt_t, _ = gt_pose(node.time)
        errs.append(np.linalg.norm(node.global_pose.t - gt_t))
    assert max(errs) < 0.2, f"max 3D global pose error {max(errs)}"


# ---------------------------------------------------------------------------
# Closed 3D loop with genuine front-end drift (ref: map_builder_test.cc
# GlobalSlam3D loop cases); the scenario lives in
# evaluation/mapping_runs.py so chip_smoke.py runs it at full extent.
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_full_3d_slam_closed_loop_corrects_drift(tmp_path):
    """Out-and-back 3D drive through CT local SLAM + ASYNC pose graph: the
    returning nodes close the loop against the first finished submap and
    optimization pulls the drifted estimate back. Includes state
    save/load of the result (ref: map_builder_test.cc GlobalSlam3D +
    LocalizationOnFrozenMap save/load)."""
    from hectorgrapher_tpu.evaluation.mapping_runs import (
        check_closed_loop_3d,
        loop_options,
        run_closed_loop_3d,
    )

    r = run_closed_loop_3d(loop_options())
    assert not check_closed_loop_3d(r), check_closed_loop_3d(r)

    # Save/load of the result (full, non-frozen).
    from hectorgrapher_tpu.io.serialization import load_state, save_state
    from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PoseGraph3D

    pg = r.map_builder.pose_graph
    path = str(tmp_path / "loop3d.npz")
    save_state(pg, path)
    pg2 = PoseGraph3D(loop_options().pose_graph, histogram_size=pg._histogram_size)
    load_state(pg2, path, load_frozen_state=False)
    assert len(pg2.nodes) == len(pg.nodes)
    assert len(pg2.constraints) == len(pg.constraints)
    np.testing.assert_allclose(
        pg2.nodes[-1].global_pose.t, pg.nodes[-1].global_pose.t, atol=1e-9
    )

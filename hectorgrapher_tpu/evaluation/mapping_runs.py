"""Synthetic mapping runs through MapBuilder, shared by the CLI, the tests
and chip_smoke.py.

`run_circle_2d`: one circle in a rectangular room at 10 Hz with noisy
odometry (the 2D scenario of the mapping-evaluation CLI), scored by ATE
against ground truth with `ate_rmse_of`.

`run_closed_loop_3d`: a closed 3D loop with injected front-end drift
(ref: mapping/map_builder_test.cc GlobalSlam3D loop cases). An out-and-back
drive in a synthetic box room: 10 Hz lidar, 100 Hz IMU, 20 Hz odometry.
Odometry carries a growing x bias while the x walls are out of range, so
the CT front-end drifts; the returning nodes close the loop against the
first finished submap and optimization pulls the drifted estimate back.
`run_closed_loop_3d` drives the scenario through the async pose graph and
returns the errors its callers bound (the slow integration test at
96^3/48^3 and chip_smoke.py at the reference's 256^3/128^3 extents).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

GRAVITY = np.array([0.0, 0.0, 9.80665])


def run_circle_2d(tb, duration: float, noise: float, rng):
    """Feed one circle (radius 1.4 m, one scan per 0.1 s with noisy
    odometry) into 2D trajectory builder `tb`; returns the ground truth
    (times, poses)."""
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu.transform import np_quat as nq
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    gt_times, gt_poses = [], []
    n = int(duration / 0.1)
    radius, center = 1.4, (0.6, 0.5)
    for i in range(n):
        t = 0.1 * i
        a = 2 * np.pi * i / max(n - 1, 1)
        xy = np.array([center[0] + radius * np.cos(a), center[1] + radius * np.sin(a)])
        yaw = a + np.pi / 2
        pose = NpRigid3(np.array([xy[0], xy[1], 0.0]),
                        nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw])))
        tb.add_odometry_data(t, NpRigid3(pose.t + rng.normal(0, 0.003, 3), pose.q))
        pts = raycast_rect_room_2d(xy, yaw, num_rays=1440, noise_std=noise, rng=rng)
        pts = pts[~np.isnan(pts[:, 0])]
        cloud = pad_timed_cloud(pts.astype(np.float32), np.zeros(len(pts), np.float32), 2048)
        tb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32),
                                              ranges=cloud))
        gt_times.append(t)
        gt_poses.append(pose)
    return gt_times, gt_poses


def ground_truth_in_map_frame(pg, gt_times, gt_poses):
    """Ground truth relative to the pose at the first node's time (the SLAM
    frame anchor)."""
    t0 = pg.nodes[0].time
    anchor = next((p for t, p in zip(gt_times, gt_poses) if abs(t - t0) < 0.26), gt_poses[0])
    return [anchor.inverse().compose(p) for p in gt_poses]


def ate_rmse_of(pg, gt_times, gt_poses, align: bool = True) -> float:
    """ATE RMSE of the pose graph's node poses against ground truth."""
    from hectorgrapher_tpu.evaluation.metrics import ate_rmse

    return ate_rmse(
        [n.time for n in pg.nodes], [n.global_pose for n in pg.nodes],
        gt_times, ground_truth_in_map_frame(pg, gt_times, gt_poses), align=align,
    )
_ORIGIN = np.array([-2.6, -2.0, 0.0])  # rest position of the drive


def loop_options(
    high_grid_size: int = 96,
    low_grid_size: int = 48,
    num_range_data: int = 8,
    optimize_every_n_nodes: int = 16,
):
    """MapBuilderOptions of the scenario. The CT window is weighted toward
    odometry so the injected bias genuinely drifts the front-end
    (dead-reckoning-dominant tuning); the pose graph's loop-closure
    matchers still see the fully informative scans."""
    from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep

    olt = "trajectory_builder_3d.optimizing_local_trajectory_builder."
    fcm = "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d."
    return replace_deep(
        MapBuilderOptions(),
        {
            "use_trajectory_builder_3d": True,
            "trajectory_builder_3d.min_range": 0.4,
            "trajectory_builder_3d.max_range": 25.0,
            "trajectory_builder_3d.submaps.grid_type": "TSDF",
            "trajectory_builder_3d.submaps.high_grid_size": high_grid_size,
            "trajectory_builder_3d.submaps.low_grid_size": low_grid_size,
            "trajectory_builder_3d.submaps.num_range_data": num_range_data,
            "trajectory_builder_3d.motion_filter.max_distance_meters": 0.02,
            "trajectory_builder_3d.motion_filter.max_angle_radians": 0.002,
            "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05,
            olt + "initialization_duration": 0.45,
            olt + "max_control_points": 12,
            olt + "max_clouds_in_window": 12,
            olt + "points_per_cloud": 256,
            olt + "max_num_iterations": 8,
            olt + "odometry_translation_weight": 50.0,
            olt + "odometry_rotation_weight": 50.0,
            olt + "high_resolution_grid_weight": 0.05,
            olt + "low_resolution_grid_weight": 0.05,
            "pose_graph.optimize_every_n_nodes": optimize_every_n_nodes,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 8.0,
            "pose_graph.constraint_builder.min_score": 0.45,
            fcm + "linear_xy_search_window": 2.0,
            fcm + "linear_z_search_window": 0.4,
            fcm + "branch_and_bound_depth": 4,
            fcm + "min_rotational_score": 0.2,
            fcm + "min_low_resolution_score": 0.45,
        },
    )


class ClosedLoopResult(NamedTuple):
    map_builder: object
    num_nodes: int
    num_finished_submaps: int
    num_inter: int
    local_errors_tail: List[float]  # open-loop error of the returning tail
    global_errors_tail: List[float]  # same nodes after the final optimization
    global_errors: List[float]  # every node after the final optimization


def _gt(t, speed=0.8, rest=0.6, out_len=3.0):
    """True pose: rest at the origin, drive +x out_len, drive back."""
    t_out = out_len / speed
    s = max(0.0, t - rest)
    x = speed * s if s <= t_out else out_len - speed * min(s - t_out, t_out)
    return _ORIGIN + np.array([x, 0.0, 0.0])


def _odom_bias(t):
    """Injected odometry drift: +x bias growing 0.1 m/s in t=[2, 5]."""
    return np.array([0.1 * np.clip(t - 2.0, 0.0, 3.0), 0.0, 0.0])


def run_closed_loop_3d(options=None, seed: int = 1) -> ClosedLoopResult:
    """Drive the scenario through MapBuilder and the async pose graph,
    wait for every queued round, run the final optimization, and return
    the errors against ground truth in the map frame."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.map_builder import MapBuilder
    from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu.transform import np_quat as nq
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    mb = MapBuilder(options if options is not None else loop_options())
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    rng = np.random.default_rng(seed)
    q = nq.quat_identity()
    duration = 0.6 + 2 * 3.0 / 0.8

    dt_imu, dt_odom, dt_scan = 0.01, 0.05, 0.1
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        tb.add_imu_data(t, nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.zeros(3))
        if t >= next_odom:
            tb.add_odometry_data(
                t, NpRigid3(_gt(t) + _odom_bias(t) + rng.normal(0, 0.002, 3), q)
            )
            next_odom += dt_odom
        if t >= next_scan:
            pts = raycast_box_room_3d(
                _gt(t), q, num_azimuth=96, num_elevation=24, noise_std=0.004, rng=rng,
            )
            pts = pts[~np.isnan(pts[:, 0])]
            cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2560)
            tb.add_range_data(
                TimedPointCloudData(
                    time=jnp.asarray(t), origin=jnp.zeros(3, jnp.float32),
                    ranges=cloud, width=96,
                )
            )
            next_scan += dt_scan
        t = round(t + dt_imu, 6)

    pg = mb.pose_graph
    pg.wait_for_all_computations()

    # The trajectory starts at rest at the origin with an identity pose,
    # so the map frame is the world frame translated by -origin. The CT
    # window marginalizes with ~1 s delay, so the returning tail is
    # selected by index, not by absolute time.
    def err(pose, time):
        return float(np.linalg.norm(pose.t - (_gt(time) - _ORIGIN)))

    late = pg.nodes[-max(4, len(pg.nodes) // 4):]
    local_tail = [err(n.local_pose, n.time) for n in late]
    num_inter = sum(1 for c in pg.constraints if c.tag == "INTER")
    pg.run_final_optimization()
    return ClosedLoopResult(
        map_builder=mb,
        num_nodes=len(pg.nodes),
        num_finished_submaps=sum(1 for s in pg.submaps if s.finished),
        num_inter=num_inter,
        local_errors_tail=local_tail,
        global_errors_tail=[err(n.global_pose, n.time) for n in late],
        global_errors=[err(n.global_pose, n.time) for n in pg.nodes],
    )


def check_closed_loop_3d(r: ClosedLoopResult) -> List[str]:
    """The scenario's bounds; returns the violated ones. Loop closure must
    correct the returning segment (the part with both accumulated drift
    and loop-closure anchors); the turnaround node, farthest from any
    anchor, legitimately keeps part of its error."""
    failures = []
    if r.num_nodes < 20:
        failures.append(f"only {r.num_nodes} nodes")
    if r.num_finished_submaps < 1:
        failures.append("no finished submap")
    drift = max(r.local_errors_tail)
    if drift <= 0.15:
        failures.append(f"no drift was injected (max tail local error {drift:.3f} m)")
    if r.num_inter < 1:
        failures.append("loop closure found no INTER constraint")
    tail = max(r.global_errors_tail)
    if tail >= drift / 2:
        failures.append(
            f"loop closure failed: tail global {tail:.3f} m vs open-loop {drift:.3f} m"
        )
    if tail >= 0.15:
        failures.append(f"tail global error {tail:.3f} m >= 0.15 m")
    med = float(np.median(r.global_errors))
    if med >= 0.12:
        failures.append(f"median global error {med:.3f} m >= 0.12 m")
    return failures

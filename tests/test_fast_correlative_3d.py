"""3D loop-closure matcher tests
(ref: fast_correlative_scan_matcher_3d_test.cc)."""

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.common.config import (
    FastCorrelativeScanMatcherOptions3D,
    TSDFRangeDataInserterOptions3D,
)
from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
    FastCorrelativeScanMatcher3D,
)
from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3


def build_grids():
    hi = make_tsdf_grid(0.1, (128, 128, 48), truncation_distance=0.3, max_weight=1000.0)
    lo = make_tsdf_grid(0.45, (48, 48, 16), truncation_distance=1.0, max_weight=1000.0)
    opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    ins_hi = make_tsdf_inserter_3d(opts, 0.1)
    ins_lo = make_tsdf_inserter_3d(opts, 0.45)
    hist = np.zeros(120, np.float32)
    for pose_t in [np.zeros(3), np.array([0.4, 0.3, 0.0])]:
        pts = raycast_box_room_3d(pose_t, nq.quat_identity(), num_azimuth=128, num_elevation=24)
        pts = pts[~np.isnan(pts[:, 0])] + pose_t
        rd = RangeData(
            origin=jnp.asarray(pose_t, jnp.float32),
            returns=pad_cloud(pts.astype(np.float32), 4096),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        hi = ins_hi(hi, rd)
        lo = ins_lo(lo, rd)
        hc = pad_cloud(pts.astype(np.float32), 4096)
        hist += np.asarray(compute_histogram(hc.positions, hc.mask, 120))
    return hi, lo, hist


class TestFastCorrelative3D:
    def test_recovers_offset_pose(self):
        hi, lo, submap_hist = build_grids()
        true_t = np.array([0.8, -0.6, 0.1])
        true_yaw = 0.15
        q = nq.quat_from_axis_angle(np.array([0.0, 0.0, true_yaw]))
        pts = raycast_box_room_3d(true_t, q, num_azimuth=96, num_elevation=20)
        pts = pts[~np.isnan(pts[:, 0])]

        scan_cloud = compact_cloud(voxel_filter(pad_cloud(pts.astype(np.float32), 2048), 0.15), 1024)
        low_cloud = compact_cloud(voxel_filter(pad_cloud(pts.astype(np.float32), 2048), 0.45), 512)
        scan_hist = compute_histogram(scan_cloud.positions, scan_cloud.mask, 120)

        options = FastCorrelativeScanMatcherOptions3D(
            branch_and_bound_depth=5,
            linear_xy_search_window=2.0,
            linear_z_search_window=0.5,
            angular_search_window=np.radians(20.0),
            min_rotational_score=0.3,
        )
        matcher = FastCorrelativeScanMatcher3D(options, hi, lo, submap_hist)
        score, low_score, rot_score, pose = matcher.match(
            Rigid3.identity(), scan_cloud, low_cloud, scan_hist, 0.0, max_scan_range=10.0, top_k=2048
        )
        assert float(score) > 0.4, f"score {float(score)}"  # sparse synthetic map caps absolute score
        np.testing.assert_allclose(np.asarray(pose.translation), true_t, atol=0.15)
        from hectorgrapher_tpu.transform.rigid import quat_yaw

        np.testing.assert_allclose(float(quat_yaw(pose.rotation)), true_yaw, atol=0.05)
        assert float(low_score) > 0.4


def test_decimated_pyramid_admissible_bound():
    """The decimated max pyramid (the memory-saving layout) must keep the
    branch-and-bound invariant: the value at cell floor(q / 2^l) of level
    l upper-bounds EVERY exact score in [q, q + 2^l)^3, for any query q —
    including queries not aligned to the level's stride (the reference's
    full-resolution PrecomputationGrid3D stack trivially has this,
    precomputation_grid_3d.h:37; our stride-2^l storage relies on the
    double-width construction window)."""
    from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
        _y_shift,
        precompute_pyramid_3d,
    )

    rng = np.random.default_rng(3)
    # Deliberately non-power-of-two extents; a second case with y large
    # enough to exercise the _Y_MIN_LANES-floored y decimation.
    for shape in ((13, 10, 9), (12, 300, 9)):
        values = jnp.asarray(
            rng.uniform(0.1, 0.9, shape).astype(np.float32)
        )
        depth = 4
        levels = [np.asarray(l) for l in precompute_pyramid_3d(values, depth)]
        v = np.asarray(values)
        np.testing.assert_allclose(levels[0], v)  # level 0 exact
        nx, ny, nz = v.shape
        for level in range(1, depth):
            span = 1 << level
            my = _y_shift(ny, level)
            for _ in range(200):
                q = rng.integers(-span + 1, [nx, ny, nz])  # incl. negative edge
                # Exact max over the query window, clipped to the grid;
                # empty intersections contribute the floor score 0.1.
                sl = tuple(
                    slice(max(int(q[a]), 0), min(int(q[a]) + span, v.shape[a]))
                    for a in range(3)
                )
                block = v[sl]
                exact = float(block.max()) if block.size else 0.1
                cell = (
                    max(int(q[0]), 0) // span,
                    max(int(q[1]), 0) // (1 << my),
                    max(int(q[2]), 0) // span,
                )
                bound = float(levels[level][cell])
                assert bound >= exact - 1e-6, (shape, level, q.tolist(), bound, exact)

"""uint16 quantized grid storage option
(ref: mapping/probability_values.h:64-92 — float probability <-> uint16
codes; mapping/2d/tsd_value_converter.h:33-73 — TSD/weight <-> uint16 with
code 0 = unknown). Divergence (documented in grids.py): active grids
compute in f32; quantization applies when a submap finishes, halving the
footprint of the long-lived finished submaps."""

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.mapping.grids import (
    dequantize_probability_grid,
    dequantize_tsdf_grid,
    ensure_f32_grid,
    grid_nbytes,
    make_probability_grid,
    make_tsdf_grid,
    quantize_probability_grid,
    quantize_tsdf_grid,
)


def _random_tsdf(shape=(32, 32), td=0.3, max_weight=100.0, seed=0):
    rng = np.random.default_rng(seed)
    grid = make_tsdf_grid(0.05, shape, truncation_distance=td, max_weight=max_weight)
    known = rng.random(shape) < 0.6
    tsd = np.where(known, rng.uniform(-td, td, shape), td).astype(np.float32)
    weight = np.where(known, rng.uniform(0.01, max_weight, shape), 0.0).astype(np.float32)
    return grid._replace(tsd=jnp.asarray(tsd), weight=jnp.asarray(weight))


class TestTsdfCodec:
    def test_round_trip_error_within_quant_step(self):
        td, max_weight = 0.3, 100.0
        grid = _random_tsdf(td=td, max_weight=max_weight)
        q = quantize_tsdf_grid(grid)
        assert q.tsd.dtype == jnp.uint16 and q.weight.dtype == jnp.uint16
        back = dequantize_tsdf_grid(q)
        known = np.asarray(grid.weight) > 0
        tsd_step = 2 * td / 65534
        w_step = max_weight / 65534
        assert np.abs(np.asarray(back.tsd) - np.asarray(grid.tsd))[known].max() <= tsd_step
        assert np.abs(np.asarray(back.weight) - np.asarray(grid.weight))[known].max() <= w_step

    def test_unknown_cells_survive(self):
        grid = _random_tsdf()
        back = dequantize_tsdf_grid(quantize_tsdf_grid(grid))
        unknown = np.asarray(grid.weight) == 0
        # weight 0 (unknown) stays exactly 0; tsd reads +truncation there.
        assert (np.asarray(back.weight)[unknown] == 0).all()
        assert np.allclose(np.asarray(back.tsd)[unknown], float(grid.truncation_distance))

    def test_idempotent_and_halves_memory(self):
        grid = _random_tsdf()
        q = quantize_tsdf_grid(grid)
        assert quantize_tsdf_grid(q) is q
        assert dequantize_tsdf_grid(grid) is grid
        assert grid_nbytes(q) == grid_nbytes(grid) // 2
        assert ensure_f32_grid(q).tsd.dtype == jnp.float32


class TestProbabilityCodec:
    def test_round_trip(self):
        rng = np.random.default_rng(1)
        grid = make_probability_grid(0.05, (24, 24))
        known = rng.random((24, 24)) < 0.7
        p = np.where(known, rng.uniform(0.1, 0.9, (24, 24)), 0.5)
        lo = np.log(p / (1 - p)).astype(np.float32)
        grid = grid._replace(log_odds=jnp.asarray(lo), known=jnp.asarray(known))
        q = quantize_probability_grid(grid)
        assert q.log_odds.dtype == jnp.uint16
        back = dequantize_probability_grid(q)
        p_back = np.asarray(back.probability())
        p_orig = np.asarray(grid.probability())
        assert np.abs(p_back - p_orig)[known].max() < 1e-4  # 0.8 / 65534 plus log-odds round trip


class TestQuantizedPipeline:
    def test_finished_submaps_quantize_and_matchers_accept_them(self):
        """End-to-end: 2D SLAM with grid_storage_dtype=uint16; finished
        submaps carry uint16 grids, the pose graph still finds INTER
        constraints against them, and serialization round-trips codes."""
        import tests.test_map_builder_2d as t2d
        from hectorgrapher_tpu.common.config import replace_deep
        from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
        from hectorgrapher_tpu.mapping.map_builder import MapBuilder
        from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
        from hectorgrapher_tpu.transform import np_quat as nq
        from hectorgrapher_tpu.transform.np_quat import NpRigid3

        options = replace_deep(
            t2d.make_options(),
            {"trajectory_builder_2d.submaps.grid_storage_dtype": "uint16"},
        )
        mb = MapBuilder(options)
        tid = mb.add_trajectory_builder()
        tb = mb.get_trajectory_builder(tid)
        rng = np.random.default_rng(0)
        for i, (xy, yaw) in enumerate(t2d.circle_trajectory()):
            t = 0.1 * i
            tb.add_odometry_data(
                t,
                NpRigid3(
                    np.array([xy[0], xy[1], 0.0]) + rng.normal(0, 0.003, 3),
                    nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw + rng.normal(0, 0.002)])),
                ),
            )
            pts = raycast_rect_room_2d(xy, yaw, num_rays=1440, noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            cloud = pad_timed_cloud(pts.astype(np.float32), np.zeros(len(pts), np.float32), 2048)
            tb.add_range_data(
                TimedPointCloudData(time=jnp.asarray(t), origin=jnp.zeros(3, jnp.float32), ranges=cloud)
            )
        pg = mb.pose_graph
        pg.wait_for_all_computations()
        finished = [s for s in pg.submaps if s.finished]
        assert finished, "no finished submaps"
        assert all(s.submap.grid.log_odds.dtype == jnp.uint16 for s in finished)
        inter = [c for c in pg.constraints if c.tag == "INTER"]
        assert inter, "no INTER constraints found against quantized submaps"
        pg.run_final_optimization()
        poses = t2d.circle_trajectory()
        xy0, yaw0 = poses[0]
        c0, s0 = np.cos(yaw0), np.sin(yaw0)
        errs = []
        for node in pg.nodes:
            gt_xy, _ = poses[int(round(node.time / 0.1))]
            d = gt_xy - xy0
            gt_rel = np.array([c0 * d[0] + s0 * d[1], -s0 * d[0] + c0 * d[1]])
            errs.append(np.linalg.norm(node.global_pose.t[:2] - gt_rel))
        assert max(errs) < 0.5, f"max global pose error {max(errs)}"

        # Serialization keeps the uint16 codes (the reference's pbstream
        # stores uint16 cells) and loads them back as uint16.
        import tempfile

        from hectorgrapher_tpu.io.serialization import load_state, save_state

        with tempfile.TemporaryDirectory() as d:
            path = d + "/state.npz"
            save_state(pg, path)
            mb2 = MapBuilder(options)
            load_state(mb2.pose_graph, path, load_frozen_state=False)
            loaded_finished = [s for s in mb2.pose_graph.submaps if s.finished]
            assert any(
                s.submap.grid.log_odds.dtype == jnp.uint16 for s in loaded_finished
            )


class TestMatchersOnQuantizedGrids:
    def test_local_matchers_equal_on_quantized_grid(self):
        """The local 2D matchers (correlative + GN prep) must dequantize
        transparently — a just-finished submap can still be the matching
        submap for one insert (submap_2d.py finish window)."""
        import jax.numpy as jnp
        import numpy as np

        from hectorgrapher_tpu.common.config import (
            ProbabilityGridRangeDataInserterOptions2D,
        )
        from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
        from hectorgrapher_tpu.mapping.grids import (
            dequantize_probability_grid,
            make_probability_grid,
            quantize_probability_grid,
        )
        from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
        from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
            make_search_window,
            match_correlative_2d,
        )
        from hectorgrapher_tpu.mapping.scan_matching.gn_2d import match_gn_2d_probability
        from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
        from hectorgrapher_tpu.transform.rigid import Rigid2

        grid = make_probability_grid(0.05, (128, 128))
        insert = make_probability_inserter_2d(
            ProbabilityGridRangeDataInserterOptions2D(), max_range=6.4, resolution=0.05
        )
        pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=2.5, half_height=2.0, num_rays=360)
        pts = pts[~np.isnan(pts[:, 0])]
        cloud = pad_cloud(pts.astype(np.float32), 512)
        grid = insert(
            grid,
            RangeData(
                origin=jnp.zeros(3, jnp.float32),
                returns=cloud,
                misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
            ),
        )
        q = quantize_probability_grid(grid)
        deq = dequantize_probability_grid(q)
        initial = Rigid2(jnp.asarray([0.04, -0.03], jnp.float32), jnp.asarray(0.01, jnp.float32))
        window = make_search_window(0.15, np.radians(10.0), 0.05, 3.5)
        s_q, p_q = match_correlative_2d(q, cloud, initial, window, 0.1, 0.1)
        s_d, p_d = match_correlative_2d(deq, cloud, initial, window, 0.1, 0.1)
        np.testing.assert_allclose(float(s_q), float(s_d), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(p_q.translation), np.asarray(p_d.translation), atol=1e-7)
        g_q, c_q = match_gn_2d_probability(q, cloud, p_q, initial.translation, 1.0, 10.0, 40.0)
        g_d, c_d = match_gn_2d_probability(deq, cloud, p_d, initial.translation, 1.0, 10.0, 40.0)
        np.testing.assert_allclose(np.asarray(g_q.translation), np.asarray(g_d.translation), atol=1e-6)


class TestQuantized3D:
    def test_finished_3d_submap_quantizes_and_matcher_accepts(self):
        """3D quantize-on-finish: ActiveSubmaps3D with uint16 storage
        quantizes both resolutions at finish; the loop-closure matcher and
        the CT prep dequantize transparently."""
        import jax.numpy as jnp
        import numpy as np

        from hectorgrapher_tpu.common.config import (
            FastCorrelativeScanMatcherOptions3D,
            SubmapsOptions3D,
            replace_deep,
        )
        from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
        from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
            FastCorrelativeScanMatcher3D,
        )
        from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
            interp_tsdf_prepared,
            prepare_grid_3d,
        )
        from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import (
            compute_histogram,
        )
        from hectorgrapher_tpu.mapping.submap_3d import ActiveSubmaps3D
        from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
        from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
        from hectorgrapher_tpu.transform import np_quat as nq
        from hectorgrapher_tpu.transform.rigid import Rigid3

        opts = replace_deep(
            SubmapsOptions3D(),
            {
                "grid_type": "TSDF",
                "num_range_data": 2,
                "high_grid_size": 48,
                "low_grid_size": 24,
                "grid_storage_dtype": "uint16",
            },
        )
        active = ActiveSubmaps3D(opts)
        pts = raycast_box_room_3d(
            np.zeros(3), nq.quat_identity(), half_extents=(2.0, 1.8, 1.0),
            num_azimuth=64, num_elevation=12,
        )
        pts = pts[~np.isnan(pts[:, 0])]
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts.astype(np.float32), 2048),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        hist = np.zeros(120, np.float32)
        for _ in range(4):  # 2*num_range_data inserts -> first submap finishes
            active.insert_data(rd, hist, np.zeros(3))
        finished = [s for s in active.submaps if s.insertion_finished]
        assert finished, "no finished 3D submap"
        sub = finished[0]
        assert sub.high_resolution_grid.tsd.dtype == jnp.uint16
        assert sub.low_resolution_grid.tsd.dtype == jnp.uint16

        # Loop-closure matcher accepts the quantized grids (dequantizes).
        fc_opts = FastCorrelativeScanMatcherOptions3D(
            branch_and_bound_depth=3,
            linear_xy_search_window=0.5,
            linear_z_search_window=0.3,
            angular_search_window=np.radians(10.0),
            min_rotational_score=0.1,
        )
        hc = pad_cloud(pts.astype(np.float32), 2048)
        scan = compact_cloud(voxel_filter(hc, 0.3), 256)
        low_c = compact_cloud(voxel_filter(hc, 0.6), 128)
        scan_hist = compute_histogram(scan.positions, scan.mask, 120)
        matcher = FastCorrelativeScanMatcher3D(
            fc_opts, sub.high_resolution_grid, sub.low_resolution_grid,
            np.asarray(compute_histogram(hc.positions, hc.mask, 120)),
        )
        score, low_score, _, pose = matcher.match(
            Rigid3.identity(), scan, low_c, scan_hist, 0.0, max_scan_range=4.0, top_k=128
        )
        assert float(score) > 0.3
        np.testing.assert_allclose(np.asarray(pose.translation), np.zeros(3), atol=0.2)

        # CT interpolation prep dequantizes too.
        prepared = prepare_grid_3d(sub.high_resolution_grid)
        tsd, w = interp_tsdf_prepared(prepared, jnp.asarray(pts[:64], jnp.float32))
        assert np.isfinite(np.asarray(tsd)).all()
        assert float(jnp.max(w)) > 0.0

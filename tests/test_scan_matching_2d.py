"""2D scan matcher tests: perturb a pose and assert recovery
(ref: real_time_correlative_scan_matcher_2d_test.cc,
ceres_scan_matcher_2d_test.cc)."""

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
from hectorgrapher_tpu.mapping.grids import make_probability_grid
from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
    make_search_window,
    match_correlative_2d,
)
from hectorgrapher_tpu.mapping.scan_matching.gn_2d import match_gn_2d_probability
from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
from hectorgrapher_tpu.transform.rigid import Rigid2, apply2


def build_room_grid_and_scan():
    """Insert one scan from the origin into a grid; return (grid, cloud)."""
    grid = make_probability_grid(0.05, (512, 512))
    opts = ProbabilityGridRangeDataInserterOptions2D()
    insert = make_probability_inserter_2d(opts, max_range=12.0, resolution=0.05)
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=720)
    valid = ~np.isnan(pts[:, 0])
    cloud = pad_cloud(pts[valid].astype(np.float32), 1024)
    rd = RangeData(origin=jnp.zeros(3, jnp.float32), returns=cloud, misses=pad_cloud(np.zeros((0, 3), np.float32), 8))
    for _ in range(5):
        grid = insert(grid, rd)
    return grid, cloud


class TestCorrelative2D:
    def test_recovers_translation_offset(self):
        grid, cloud = build_room_grid_and_scan()
        window = make_search_window(0.3, np.radians(10.0), 0.05, 10.0)
        initial = Rigid2(translation=jnp.array([0.15, -0.1], jnp.float32), angle=jnp.asarray(0.0, jnp.float32))
        score, pose = match_correlative_2d(grid, cloud, initial, window, 0.0, 0.0)
        assert float(score) > 0.3
        np.testing.assert_allclose(np.asarray(pose.translation), [0.0, 0.0], atol=0.06)
        np.testing.assert_allclose(float(pose.angle), 0.0, atol=0.02)

    def test_recovers_rotation_offset(self):
        grid, cloud = build_room_grid_and_scan()
        window = make_search_window(0.2, np.radians(12.0), 0.05, 10.0)
        initial = Rigid2(translation=jnp.zeros(2, jnp.float32), angle=jnp.asarray(0.12, jnp.float32))
        score, pose = match_correlative_2d(grid, cloud, initial, window, 0.0, 0.0)
        np.testing.assert_allclose(float(pose.angle), 0.0, atol=0.02)


class TestGaussNewton2D:
    def test_refines_small_offset(self):
        grid, cloud = build_room_grid_and_scan()
        initial = Rigid2(translation=jnp.array([0.06, -0.04], jnp.float32), angle=jnp.asarray(0.02, jnp.float32))
        pose, cost = match_gn_2d_probability(
            grid, cloud, initial, initial.translation,
            occupied_space_weight=1.0, translation_weight=0.1, rotation_weight=0.1,
            num_iterations=20,
        )
        np.testing.assert_allclose(np.asarray(pose.translation), [0.0, 0.0], atol=0.03)
        np.testing.assert_allclose(float(pose.angle), 0.0, atol=0.01)

    def test_stays_at_optimum(self):
        grid, cloud = build_room_grid_and_scan()
        initial = Rigid2.identity()
        pose, _ = match_gn_2d_probability(
            grid, cloud, initial, initial.translation,
            occupied_space_weight=1.0, translation_weight=10.0, rotation_weight=40.0,
            num_iterations=10,
        )
        np.testing.assert_allclose(np.asarray(pose.translation), [0.0, 0.0], atol=0.02)
        np.testing.assert_allclose(float(pose.angle), 0.0, atol=0.005)


class TestCorrelativeGroupedVsDense:
    """The grouped shared-row matcher must reproduce the straightforward
    per-cell dense scoring exactly (modulo bf16 cell storage)."""

    def _quantized_grid(self, grid):
        # The fast path stores cell values as bf16; quantize the oracle's
        # grid the same way so the comparison isolates the algorithm.
        prob = grid.probability().astype(jnp.bfloat16).astype(jnp.float32)
        log_odds = jnp.log(prob / (1.0 - prob))
        return grid._replace(log_odds=jnp.where(grid.known, log_odds, grid.log_odds))

    def test_score_volume_matches_dense_oracle(self):
        from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
            score_volume_dense,
        )

        grid, cloud = build_room_grid_and_scan()
        qgrid = self._quantized_grid(grid)
        initial = Rigid2(
            translation=jnp.array([0.12, -0.31], jnp.float32),
            angle=jnp.asarray(0.04, jnp.float32),
        )
        pts = np.asarray(cloud.positions)[np.asarray(cloud.mask)]
        max_range = float(np.linalg.norm(pts[:, :2], axis=-1).max())
        window = make_search_window(0.15, np.radians(10.0), 0.05, max_range)

        dense = np.asarray(score_volume_dense(qgrid, cloud, initial, window))
        # Zero delta-cost weights: matcher output = raw max of the volume.
        score, pose = match_correlative_2d(qgrid, cloud, initial, window, 0.0, 0.0)
        np.testing.assert_allclose(float(score), dense.max(), rtol=2e-3, atol=2e-3)
        ti, xi, yi = np.unravel_index(dense.argmax(), dense.shape)
        expect_angle = float(initial.angle) + (ti - window.num_angles) * window.angle_step
        expect_xy = np.asarray(initial.translation) + np.array(
            [(xi - window.num_linear) * 0.05, (yi - window.num_linear) * 0.05]
        )
        np.testing.assert_allclose(float(pose.angle), expect_angle, atol=1e-6)
        np.testing.assert_allclose(np.asarray(pose.translation), expect_xy, atol=1e-6)

    def test_near_boundary_cells_score_unknown_per_cell(self):
        from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
            score_volume_dense,
        )

        # Tiny grid so part of the scan falls off the map: exercises the
        # per-cell out-of-map path of both implementations.
        grid = make_probability_grid(0.05, (64, 64))
        opts = ProbabilityGridRangeDataInserterOptions2D()
        insert = make_probability_inserter_2d(opts, max_range=4.0, resolution=0.05)
        pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=1.3, half_height=1.1, num_rays=180)
        valid = ~np.isnan(pts[:, 0])
        cloud = pad_cloud(pts[valid].astype(np.float32), 256)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=cloud,
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
        )
        grid = insert(grid, rd)
        qgrid = self._quantized_grid(grid)
        # Push the initial pose toward the map edge.
        initial = Rigid2(
            translation=jnp.array([1.05, 0.9], jnp.float32),
            angle=jnp.asarray(-0.1, jnp.float32),
        )
        max_range = float(np.linalg.norm(pts[valid][:, :2], axis=-1).max())
        window = make_search_window(0.2, np.radians(12.0), 0.05, max_range)
        dense = np.asarray(score_volume_dense(qgrid, cloud, initial, window))
        score, pose = match_correlative_2d(qgrid, cloud, initial, window, 0.0, 0.0)
        np.testing.assert_allclose(float(score), dense.max(), rtol=2e-3, atol=2e-3)


class TestWideCarriedRowsExact:
    """The wide-carried-rows LM must read the TRUE grid values at the
    final pose: recomputing the occupied-space cost with direct bicubic
    interpolation at the returned pose must reproduce the returned cost
    (the carried patch covers the whole refinement motion)."""

    def test_final_cost_matches_direct_interpolation(self):
        from hectorgrapher_tpu.mapping import probability_values as pv
        from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
            interp_bicubic_2d,
        )

        grid, cloud = build_room_grid_and_scan()
        # Refinement motion here stays within the carried patch's slack
        # envelope (per-axis base-cell shift <= 3 cells); beyond it the
        # carried evaluation degrades gracefully instead of re-gathering.
        initial = Rigid2(
            translation=jnp.array([0.04, -0.03], jnp.float32),
            angle=jnp.asarray(0.01, jnp.float32),
        )
        tw, rw = 0.3, 1.0
        pose, cost = match_gn_2d_probability(
            grid, cloud, initial, initial.translation,
            occupied_space_weight=1.0, translation_weight=tw, rotation_weight=rw,
            num_iterations=15,
        )
        pts = cloud.positions[:, :2]
        world = apply2(pose, pts)
        p = interp_bicubic_2d(grid.probability(), grid.meta, world, pv.MIN_PROBABILITY)
        n = jnp.maximum(jnp.sum(cloud.mask), 1)
        r = jnp.where(cloud.mask, 1.0 - p, 0.0) / jnp.sqrt(n.astype(jnp.float32))
        dt = pose.translation - initial.translation
        dth = pose.angle - initial.angle
        direct = 0.5 * (
            jnp.sum(r * r) + tw**2 * jnp.sum(dt * dt) + rw**2 * dth * dth
        )
        np.testing.assert_allclose(float(cost), float(direct), rtol=1e-5, atol=1e-7)


class TestBatchedGN:
    """The batched wrapper must reproduce the per-match path."""

    def test_matches_single_path(self):
        from hectorgrapher_tpu.mapping.scan_matching.gn_2d import (
            match_gn_2d_probability_batched,
        )
        from hectorgrapher_tpu.sensor.types import PointCloud

        grid, cloud = build_room_grid_and_scan()
        rng = np.random.default_rng(7)
        B = 3
        offs = rng.uniform(-0.05, 0.05, (B, 2)).astype(np.float32)
        angs = rng.uniform(-0.015, 0.015, B).astype(np.float32)
        clouds = PointCloud(
            positions=jnp.broadcast_to(
                cloud.positions, (B,) + cloud.positions.shape
            ),
            mask=jnp.broadcast_to(cloud.mask, (B,) + cloud.mask.shape),
        )
        initials = Rigid2(translation=jnp.asarray(offs), angle=jnp.asarray(angs))
        poses_b, costs_b = match_gn_2d_probability_batched(
            grid, clouds, initials, initials.translation, 1.0, 10.0, 40.0,
            num_iterations=8,
        )
        for i in range(B):
            one = PointCloud(positions=clouds.positions[i], mask=clouds.mask[i])
            pose_x, cost_x = match_gn_2d_probability(
                grid, one,
                Rigid2(translation=initials.translation[i], angle=initials.angle[i]),
                initials.translation[i], 1.0, 10.0, 40.0, num_iterations=8,
            )
            np.testing.assert_allclose(
                np.asarray(poses_b.translation[i]),
                np.asarray(pose_x.translation), atol=2e-4,
            )
            np.testing.assert_allclose(
                float(poses_b.angle[i]), float(pose_x.angle), atol=2e-4
            )


class TestBatchedCorrelative:
    """The batched matcher (the per-match matcher vmapped over the batch)
    must reproduce the per-match matcher exactly."""

    def test_matches_single_path(self):
        from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
            match_correlative_2d_batched,
        )
        from hectorgrapher_tpu.sensor.types import PointCloud

        grid, cloud = build_room_grid_and_scan()
        window = make_search_window(0.15, np.radians(6.0), 0.05, 10.0)
        rng = np.random.default_rng(3)
        B = 8
        offs = rng.uniform(-0.1, 0.1, (B, 2)).astype(np.float32)
        angs = rng.uniform(-0.05, 0.05, B).astype(np.float32)
        clouds = PointCloud(
            positions=jnp.broadcast_to(cloud.positions, (B,) + cloud.positions.shape),
            mask=jnp.broadcast_to(cloud.mask, (B,) + cloud.mask.shape),
        )
        initials = Rigid2(translation=jnp.asarray(offs), angle=jnp.asarray(angs))
        scores_b, poses_b = match_correlative_2d_batched(
            grid, clouds, initials, window, 0.1, 0.1,
        )
        for i in range(B):
            one = PointCloud(positions=clouds.positions[i], mask=clouds.mask[i])
            score, pose = match_correlative_2d(
                grid, one,
                Rigid2(translation=initials.translation[i], angle=initials.angle[i]),
                window, 0.1, 0.1,
            )
            np.testing.assert_allclose(float(scores_b[i]), float(score), rtol=1e-6)
            np.testing.assert_allclose(
                np.asarray(poses_b.translation[i]), np.asarray(pose.translation),
                atol=1e-6,
            )
            np.testing.assert_allclose(
                float(poses_b.angle[i]), float(pose.angle), atol=1e-6
            )


class TestGaussNewtonTsdf2D:
    """TSDF refinement path (ref: tsdf_match_cost_function_2d.cc)."""

    def test_refines_small_offset_on_tsdf(self):
        from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions2D
        from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
        from hectorgrapher_tpu.mapping.inserters_2d import make_tsdf_inserter_2d
        from hectorgrapher_tpu.mapping.scan_matching.gn_2d import match_gn_2d_tsdf

        grid = make_tsdf_grid(0.05, (512, 512), truncation_distance=0.3, max_weight=10.0)
        insert = make_tsdf_inserter_2d(
            TSDFRangeDataInserterOptions2D(), resolution=0.05
        )
        pts = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=720)
        valid = ~np.isnan(pts[:, 0])
        cloud = pad_cloud(pts[valid].astype(np.float32), 1024)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=cloud,
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
        )
        for _ in range(5):
            grid = insert(grid, rd)
        initial = Rigid2(
            translation=jnp.array([0.05, -0.04], jnp.float32),
            angle=jnp.asarray(0.015, jnp.float32),
        )
        pose, cost = match_gn_2d_tsdf(
            grid, cloud, initial, initial.translation,
            occupied_space_weight=1.0, translation_weight=0.1, rotation_weight=0.1,
            num_iterations=20,
        )
        np.testing.assert_allclose(np.asarray(pose.translation), [0.0, 0.0], atol=0.03)
        np.testing.assert_allclose(float(pose.angle), 0.0, atol=0.01)

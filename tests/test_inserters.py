"""Grid insertion tests
(ref: probability_grid_range_data_inserter_2d_test.cc,
tsdf_range_data_inserter_2d_test.cc, range_data_inserter_3d_test.cc,
tsdf_range_data_inserter_3d (no test in ref; golden checks here))."""

import math

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.common.config import (
    ProbabilityGridRangeDataInserterOptions2D,
    ProbabilityGridRangeDataInserterOptions3D,
    TSDFRangeDataInserterOptions2D,
    TSDFRangeDataInserterOptions3D,
)
from hectorgrapher_tpu.mapping.grids import (
    cell_index,
    make_probability_grid,
    make_tsdf_grid,
)
from hectorgrapher_tpu.mapping.inserters_2d import (
    make_probability_inserter_2d,
    make_tsdf_inserter_2d,
)
from hectorgrapher_tpu.mapping.inserters_3d import (
    insertion_ratio_mask,
    make_probability_inserter_3d,
    make_tsdf_inserter_3d,
    structured_cloud_normals,
)
from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, pad_cloud


def make_range_data_2d(origin_xy, hits_xy, capacity=64):
    origin = jnp.asarray([origin_xy[0], origin_xy[1], 0.0], jnp.float32)
    pts = np.array([[x, y, 0.0] for x, y in hits_xy], dtype=np.float32)
    return RangeData(
        origin=origin,
        returns=pad_cloud(pts, capacity),
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
    )


class TestProbabilityInserter2D:
    def test_hit_and_miss_cells(self):
        grid = make_probability_grid(0.1, (64, 64))
        opts = ProbabilityGridRangeDataInserterOptions2D()
        insert = make_probability_inserter_2d(opts, max_range=5.0, resolution=0.1)
        rd = make_range_data_2d((0.0, 0.0), [(2.03, 0.0)])
        grid = insert(grid, rd)
        prob = np.asarray(grid.probability())
        hit_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[2.03, 0.0]])))[0]
        mid_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[1.03, 0.0]])))[0]
        far_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[3.0, 0.0]])))[0]
        assert prob[hit_idx[0], hit_idx[1]] > 0.5
        assert prob[mid_idx[0], mid_idx[1]] < 0.5
        # beyond the hit: untouched -> unknown -> min probability
        assert prob[far_idx[0], far_idx[1]] == 0.1
        assert not bool(grid.known[far_idx[0], far_idx[1]])

    def test_repeated_hits_saturate(self):
        grid = make_probability_grid(0.1, (32, 32))
        opts = ProbabilityGridRangeDataInserterOptions2D()
        insert = make_probability_inserter_2d(opts, max_range=5.0, resolution=0.1)
        rd = make_range_data_2d((0.0, 0.0), [(1.03, 0.0)])
        for _ in range(40):
            grid = insert(grid, rd)
        prob = np.asarray(grid.probability())
        hit_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[1.03, 0.0]])))[0]
        np.testing.assert_allclose(prob[hit_idx[0], hit_idx[1]], 0.9, atol=1e-3)

    def test_single_update_per_scan(self):
        """Two hits in the same cell must apply the odds update once
        (reference update-marker semantics)."""
        grid = make_probability_grid(0.1, (32, 32))
        opts = ProbabilityGridRangeDataInserterOptions2D(hit_probability=0.7, miss_probability=0.4)
        insert = make_probability_inserter_2d(opts, max_range=5.0, resolution=0.1)
        rd = make_range_data_2d((0.0, 0.0), [(1.03, 0.0), (1.04, 0.01)])
        grid = insert(grid, rd)
        prob = np.asarray(grid.probability())
        hit_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[1.03, 0.0]])))[0]
        np.testing.assert_allclose(prob[hit_idx[0], hit_idx[1]], 0.7, atol=1e-3)


class TestTSDFInserter2D:
    def test_band_signs(self):
        grid = make_tsdf_grid(0.05, (128, 128), truncation_distance=0.3, max_weight=10.0)
        opts = TSDFRangeDataInserterOptions2D(project_sdf_distance_to_scan_normal=False)
        insert = make_tsdf_inserter_2d(opts, resolution=0.05)
        # Vertical wall at x=2: several hits along it so normals are sane.
        hits = [(2.0, y) for y in np.linspace(-0.5, 0.5, 21)]
        rd = make_range_data_2d((0.0, 0.0), hits)
        grid = insert(grid, rd)
        tsd = np.asarray(grid.tsd)
        w = np.asarray(grid.weight)
        hit_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[2.03, 0.0]])))[0]
        before_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[1.85, 0.0]])))[0]
        behind_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[2.15, 0.0]])))[0]
        assert w[hit_idx[0], hit_idx[1]] > 0
        assert abs(tsd[hit_idx[0], hit_idx[1]]) < 0.05
        assert tsd[before_idx[0], before_idx[1]] > 0.05  # free side positive
        assert tsd[behind_idx[0], behind_idx[1]] < -0.05  # occluded side negative

    def test_weight_capped(self):
        grid = make_tsdf_grid(0.05, (64, 64), truncation_distance=0.3, max_weight=10.0)
        opts = TSDFRangeDataInserterOptions2D()
        insert = make_tsdf_inserter_2d(opts, resolution=0.05)
        rd = make_range_data_2d((0.0, 0.0), [(1.03, y) for y in np.linspace(-0.3, 0.3, 13)])
        for _ in range(30):
            grid = insert(grid, rd)
        assert float(jnp.max(grid.weight)) <= 10.0 + 1e-5


class TestProbabilityInserter3D:
    def test_hit_and_free_space(self):
        grid = make_probability_grid(0.1, (64, 64, 32))
        opts = ProbabilityGridRangeDataInserterOptions3D()
        insert = make_probability_inserter_3d(opts)
        pts = np.array([[2.03, 0.0, 0.0]], dtype=np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 16),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        grid = insert(grid, rd)
        prob = np.asarray(grid.probability())
        hit_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[2.03, 0.0, 0.0]])))[0]
        # cell just before the hit (within num_free_space_voxels=2)
        near_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[1.87, 0.0, 0.0]])))[0]
        origin_idx = np.asarray(cell_index(grid.meta, jnp.asarray([[0.2, 0.0, 0.0]])))[0]
        assert prob[tuple(hit_idx)] > 0.5
        assert prob[tuple(near_idx)] < 0.5
        # far from hit: not updated (only last 2 voxels get misses)
        assert not bool(grid.known[tuple(origin_idx)])


class TestTSDFInserter3D:
    def test_ray_based_insert(self):
        grid = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.25, max_weight=1000.0)
        opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=15.0)
        insert = make_tsdf_inserter_3d(opts, resolution=0.1)
        pts = np.array([[2.03, 0.0, 0.0]], dtype=np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 16),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        grid = insert(grid, rd)
        tsd = np.asarray(grid.tsd)
        w = np.asarray(grid.weight)
        hit_idx = tuple(np.asarray(cell_index(grid.meta, jnp.asarray([[2.03, 0.0, 0.0]])))[0])
        free_idx = tuple(np.asarray(cell_index(grid.meta, jnp.asarray([[1.87, 0.0, 0.0]])))[0])
        behind_idx = tuple(np.asarray(cell_index(grid.meta, jnp.asarray([[2.19, 0.0, 0.0]])))[0])
        assert w[hit_idx] > 0
        assert abs(tsd[hit_idx]) < 0.1
        assert tsd[free_idx] > 0.0
        assert tsd[behind_idx] < 0.0

    def test_structured_normals_flat_wall(self):
        # Organized cloud of a wall at x=2, rows scan z, cols scan y.
        width = 8
        ys = np.linspace(-0.7, 0.7, width)
        zs = np.linspace(-0.3, 0.3, 4)
        pts = np.array([[2.03, y, z] for z in zs for y in ys], dtype=np.float32)
        cloud = pad_cloud(pts, 32)
        normals, ok = structured_cloud_normals(
            cloud, jnp.zeros(3, jnp.float32), width=width, vertical_stride=1, horizontal_stride=1
        )
        normals = np.asarray(normals)
        ok = np.asarray(ok)
        assert ok[: len(pts)].sum() > len(pts) // 2
        for i in range(len(pts)):
            if ok[i]:
                assert abs(abs(normals[i, 0]) - 1.0) < 1e-4  # +-x normal

    def test_insertion_ratio_mask(self):
        valid = jnp.ones(100, dtype=bool)
        kept = np.asarray(insertion_ratio_mask(valid, 0.1)).sum()
        assert 8 <= kept <= 12

    def test_normal_based_insert_wall(self):
        grid = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.25, max_weight=1000.0)
        opts = TSDFRangeDataInserterOptions3D(min_range=0.4, max_range=15.0)
        insert = make_tsdf_inserter_3d(opts, resolution=0.1)
        width = 16
        ys = np.linspace(-0.7, 0.7, width)
        zs = np.linspace(-0.3, 0.3, 4)
        pts = np.array([[2.03, y, z] for z in zs for y in ys], dtype=np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 64),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
            width=width,
        )
        grid = insert(grid, rd)
        tsd = np.asarray(grid.tsd)
        w = np.asarray(grid.weight)
        # probe at an interior point of the wall (row 1, col 8)
        probe = pts[width + 8]
        hit_idx = tuple(np.asarray(cell_index(grid.meta, jnp.asarray(probe[None])))[0])
        free = probe - np.array([0.16, 0.0, 0.0], np.float32)
        free_idx = tuple(np.asarray(cell_index(grid.meta, jnp.asarray(free[None])))[0])
        assert w[hit_idx] > 0
        assert abs(tsd[hit_idx]) < 0.1
        assert tsd[free_idx] > 0.0


class TestTriangleFillIn:
    def test_triangle_insert_fills_wall(self):
        """(ref: TRIANGLE_FILL_IN — a sparse organized scan of a wall
        should produce a CONTINUOUS surface via triangle rasterization.)"""
        from hectorgrapher_tpu.mapping.inserters_3d import insert_tsdf_3d_triangles

        grid = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.25, max_weight=1000.0)
        opts = TSDFRangeDataInserterOptions3D(
            normal_computation_method="TRIANGLE_FILL_IN", min_range=0.4, max_range=15.0
        )
        insert = make_tsdf_inserter_3d(opts, resolution=0.1)
        # Sparse organized wall: point spacing 0.35 m >> 0.1 m cells.
        width = 6
        ys = np.linspace(-0.9, 0.9, width)
        zs = np.linspace(-0.5, 0.5, 4)
        pts = np.array([[2.03, y, z] for z in zs for y in ys], dtype=np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 32),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
            width=width,
        )
        grid = insert(grid, rd)
        w = np.asarray(grid.weight)
        tsd = np.asarray(grid.tsd)
        # Cells BETWEEN the sparse points are filled (triangle interior).
        probe = np.array([[2.03, 0.0, 0.0]])  # not a sample point
        pi = tuple(np.asarray(cell_index(grid.meta, jnp.asarray(probe)))[0])
        assert w[pi] > 0, "triangle interior not rasterized"
        assert abs(tsd[pi]) < 0.1
        # The wall surface is continuous over the whole extent.
        xs = np.linspace(-0.8, 0.8, 9)
        filled = 0
        for y in xs:
            pi = tuple(np.asarray(cell_index(grid.meta, jnp.asarray([[2.03, y, 0.05]])))[0])
            filled += w[pi] > 0
        assert filled >= 8, f"only {filled}/9 wall cells observed"


class TestF16Storage:
    def test_f16_tsdf_matches_f32(self):
        """float16 storage with float32 compute stays close to full
        precision (the analog of the reference's uint16 packing)."""
        opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=15.0)
        insert = make_tsdf_inserter_3d(opts, resolution=0.1)
        pts = np.array([[2.03, y, 0.0] for y in np.linspace(-0.5, 0.5, 11)], dtype=np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 16),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        g32 = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.25, max_weight=1000.0)
        g16 = make_tsdf_grid(0.1, (64, 64, 32), truncation_distance=0.25, max_weight=1000.0,
                             dtype=jnp.float16)
        for _ in range(3):
            g32 = insert(g32, rd)
            g16 = insert(g16, rd)
        assert g16.tsd.dtype == jnp.float16
        np.testing.assert_allclose(
            np.asarray(g16.tsd, np.float32), np.asarray(g32.tsd), atol=2e-3
        )
        # interpolation path consumes f16 grids transparently
        from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import tsd_at_3d_weighted

        q = jnp.asarray([[1.95, 0.0, 0.0]], jnp.float32)
        t16, w16 = tsd_at_3d_weighted(g16, q)
        t32, w32 = tsd_at_3d_weighted(g32, q)
        assert t16.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(t16), np.asarray(t32), atol=5e-3)


class TestKnnPcaNormals:
    """Dense k-NN PCA replacement for the PCL/OPEN3D normal backend
    (ref: tsdf_range_data_inserter_3d.cc:405-489)."""

    def test_plane_normals(self):
        from hectorgrapher_tpu.mapping.inserters_3d import knn_pca_normals

        rng = np.random.default_rng(0)
        P = 256
        pts = np.zeros((P, 3), np.float32)
        pts[:, 0] = rng.uniform(-1, 1, P)
        pts[:, 1] = rng.uniform(-1, 1, P)
        pts[:, 2] = 1.0  # z=1 plane; sensor at origin below it
        valid = np.ones(P, bool)
        normals, ok = knn_pca_normals(
            jnp.asarray(pts), jnp.asarray(valid), jnp.zeros(3, jnp.float32), k=16, radius=0.5
        )
        normals = np.asarray(normals)
        assert bool(np.all(np.asarray(ok)))
        # normal is -z (toward the sensor at the origin)
        np.testing.assert_allclose(normals[:, 2], -1.0, atol=1e-3)

    def test_padding_and_degenerate(self):
        from hectorgrapher_tpu.mapping.inserters_3d import knn_pca_normals

        P = 64
        pts = np.zeros((P, 3), np.float32)
        pts[0] = [1, 0, 0]
        pts[1] = [1.01, 0, 0]
        valid = np.zeros(P, bool)
        valid[:2] = True  # only 2 valid points: no defined normal
        normals, ok = knn_pca_normals(
            jnp.asarray(pts), jnp.asarray(valid), jnp.zeros(3, jnp.float32), k=8, radius=0.5
        )
        assert not bool(np.asarray(ok)[0])
        assert not bool(np.asarray(ok)[5])

    def test_inserter_with_knn_backend(self):
        from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions3D
        from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
        from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
        from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

        res = 0.05
        opts = TSDFRangeDataInserterOptions3D(normal_computation_method="KNN_PCA")
        grid = make_tsdf_grid(res, (64, 64, 64), truncation_distance=opts.relative_truncation_distance * res, max_weight=1000.0)
        insert = make_tsdf_inserter_3d(opts, res)
        # wall at x=1, points spread in y/z
        ys, zs = np.meshgrid(np.linspace(-0.4, 0.4, 16), np.linspace(-0.4, 0.4, 16))
        pts = np.stack([np.full(ys.size, 1.0), ys.ravel(), zs.ravel()], axis=-1).astype(np.float32)
        rd = RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=pad_cloud(pts, 512),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
        )
        out = insert(grid, rd)
        assert float(jnp.sum(out.weight)) > 0.0
        # cells just behind the wall carry positive weight with negative tsd;
        # in front, positive tsd (sensor side)
        ci = np.asarray(out.meta.min_corner)
        ix_front = int(round((0.9 - ci[0]) / res))
        ix_back = int(round((1.08 - ci[0]) / res))
        iy = int(round((0.0 - ci[1]) / res))
        iz = int(round((0.0 - ci[2]) / res))
        tsd = np.asarray(out.tsd)
        w = np.asarray(out.weight)
        assert w[ix_front, iy, iz] > 0
        assert tsd[ix_front, iy, iz] > 0
        if w[ix_back, iy, iz] > 0:
            assert tsd[ix_back, iy, iz] < 0

"""3D submaps: paired high/low-resolution dense grids + rotational histogram.

(ref: cartographer/mapping/3d/submap_3d.{h,cc} — each Submap3D holds a
high-resolution (0.10 m) and low-resolution (0.45 m) grid plus an
accumulated rotational-histogram; ActiveSubmaps3D keeps two submaps with
the same spawn/finish cadence as 2D (InsertData :492-515); grid type
switches between PROBABILITY_GRID and TSDF (CreateGrid :516-547).)

Design: fixed-extent dense arrays in the local SLAM frame (grid
min_corner shifted so the array is centered on the submap origin);
insertion and matching are static-shape kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.mapping.grids import (
    make_probability_grid,
    make_tsdf_grid,
)
from hectorgrapher_tpu.mapping.inserters_3d import (
    make_probability_inserter_3d,
    make_tsdf_inserter_3d,
)
from hectorgrapher_tpu.sensor.types import RangeData
from hectorgrapher_tpu.transform.np_quat import NpRigid3


@dataclass
class Submap3D:
    local_pose: NpRigid3  # rotation is identity: grids are axis-aligned in
    # the local frame (the reference asserts the same at
    # optimizing_local_trajectory_builder.cc:1246)
    high_resolution_grid: object  # ProbabilityGrid | TSDFGrid
    low_resolution_grid: object
    rotational_histogram: np.ndarray
    num_range_data: int = 0
    insertion_finished: bool = False
    quantize_on_finish: bool = False

    def finish(self) -> None:
        self.insertion_finished = True
        if self.quantize_on_finish:
            # uint16 storage option (ref: probability_values.h:64-92,
            # tsd_value_converter.h:33-73): finished submaps are long-lived
            # (pose graph + serialization) — halve their footprint; active
            # grids stay f32 for insert/match compute.
            from hectorgrapher_tpu.mapping.grids import (
                ProbabilityGrid,
                quantize_probability_grid,
                quantize_tsdf_grid,
            )

            for attr in ("high_resolution_grid", "low_resolution_grid"):
                g = getattr(self, attr)
                if isinstance(g, ProbabilityGrid):
                    setattr(self, attr, quantize_probability_grid(g))
                else:
                    setattr(self, attr, quantize_tsdf_grid(g))


class ActiveSubmaps3D:
    """(ref: submap_3d.cc ActiveSubmaps3D)"""

    def __init__(self, options, histogram_size: int = 120):
        self._options = options
        self._histogram_size = histogram_size
        self._submaps: List[Submap3D] = []

        self._is_tsdf = options.grid_type == "TSDF"
        hi_res = options.high_resolution
        lo_res = options.low_resolution
        hi_size = options.high_grid_size
        lo_size = options.low_grid_size
        hi_opts = options.high_resolution_range_data_inserter
        lo_opts = options.low_resolution_range_data_inserter

        from hectorgrapher_tpu.mapping.grids import STORAGE_DTYPES

        storage_name = getattr(options, "grid_storage_dtype", "float32")
        # uint16 quantizes on finish; active grids compute in f32.
        self._quantize_on_finish = storage_name == "uint16"
        if not self._is_tsdf and storage_name in ("float16", "bfloat16"):
            raise ValueError(
                f"grid_storage_dtype={storage_name!r} is only supported for TSDF "
                "grids (use 'uint16' for quantize-on-finish of probability grids)"
            )
        storage = STORAGE_DTYPES["float32" if self._quantize_on_finish else storage_name]
        if self._is_tsdf:
            hi_t = hi_opts.tsdf_range_data_inserter
            lo_t = lo_opts.tsdf_range_data_inserter
            self._make_high = lambda: make_tsdf_grid(
                hi_res, (hi_size,) * 3,
                truncation_distance=hi_t.relative_truncation_distance * hi_res,
                max_weight=hi_t.maximum_weight,
                dtype=storage,
            )
            self._make_low = lambda: make_tsdf_grid(
                lo_res, (lo_size,) * 3,
                truncation_distance=lo_t.relative_truncation_distance * lo_res,
                max_weight=lo_t.maximum_weight,
                dtype=storage,
            )
            self._insert_high = make_tsdf_inserter_3d(hi_t, hi_res)
            self._insert_low = make_tsdf_inserter_3d(lo_t, lo_res)
        else:
            hi_p = hi_opts.probability_grid_range_data_inserter
            lo_p = lo_opts.probability_grid_range_data_inserter
            self._make_high = lambda: make_probability_grid(hi_res, (hi_size,) * 3)
            self._make_low = lambda: make_probability_grid(lo_res, (lo_size,) * 3)
            self._insert_high = make_probability_inserter_3d(hi_p)
            self._insert_low = make_probability_inserter_3d(lo_p)

    @property
    def submaps(self) -> List[Submap3D]:
        return list(self._submaps)

    @property
    def matching_submap(self) -> Optional[Submap3D]:
        return self._submaps[0] if self._submaps else None

    def insert_data(
        self,
        range_data_in_local: RangeData,
        rotational_histogram: np.ndarray,
        origin_local: np.ndarray,
    ) -> List[Submap3D]:
        """(ref: submap_3d.cc ActiveSubmaps3D::InsertData :492-515;
        high-res insertion crops to high_resolution_max_range around the
        origin, submap_3d.cc:427-452)."""
        if not self._submaps or self._submaps[-1].num_range_data == self._options.num_range_data:
            self._add_submap(origin_local)
        # High-res grid only takes points within high_resolution_max_range.
        r = jnp.linalg.norm(
            range_data_in_local.returns.positions - range_data_in_local.origin[None, :], axis=-1
        )
        hi_rd = range_data_in_local._replace(
            returns=range_data_in_local.returns._replace(
                mask=range_data_in_local.returns.mask
                & (r <= self._options.high_resolution_max_range)
            )
        )
        for submap in self._submaps:
            submap.high_resolution_grid = self._insert_high(submap.high_resolution_grid, hi_rd)
            submap.low_resolution_grid = self._insert_low(submap.low_resolution_grid, range_data_in_local)
            submap.rotational_histogram = submap.rotational_histogram + np.asarray(rotational_histogram)
            submap.num_range_data += 1
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        # Sampled clip accounting (see submap_2d.count_clipped).
        if self._submaps[0].num_range_data % 8 == 1:
            from hectorgrapher_tpu.mapping.submap_2d import count_clipped

            count_clipped(self._submaps[0].low_resolution_grid, range_data_in_local)
        return list(self._submaps)

    def _add_submap(self, origin_local: np.ndarray) -> None:
        if len(self._submaps) >= 2:
            self._submaps[0].finish()
            self._submaps.pop(0)
        high = self._make_high()
        low = self._make_low()
        origin_t = np.asarray(origin_local[:3], np.float64)

        def place(grid):
            """Center the empty grid on the submap origin, snapped so that
            voxel centers land on the reference's index*resolution lattice
            in the submap frame (ref: hybrid_grid.h GetCenterOfCell) —
            makes pbstream export lossless (io/pbstream_state.py). The
            snap moves the EMPTY grid by at most half a voxel before any
            insertion, so nothing is resampled."""
            res = float(np.asarray(grid.meta.resolution))
            mc = np.asarray(grid.meta.min_corner, np.float64) + origin_t
            k = np.round((mc - origin_t) / res + 0.5)
            mc_snapped = origin_t + (k - 0.5) * res
            return grid._replace(
                meta=grid.meta._replace(min_corner=jnp.asarray(mc_snapped, jnp.float32))
            )

        high = place(high)
        low = place(low)
        self._submaps.append(
            Submap3D(
                local_pose=NpRigid3(np.asarray(origin_local[:3], np.float64)),
                high_resolution_grid=high,
                low_resolution_grid=low,
                rotational_histogram=np.zeros(self._histogram_size, np.float32),
                quantize_on_finish=self._quantize_on_finish,
            )
        )

"""2D submaps: two overlapping fixed-extent dense grids.

(ref: cartographer/mapping/2d/submap_2d.{h,cc} — ActiveSubmaps2D keeps two
submaps; a new one is started every num_range_data inserts and the old one
is finished after 2*num_range_data.)

Design: each submap's grid is a fixed dense array centered on the
submap origin (the tracking position at creation), so insertion and
matching are static-shape kernels; there is no grow-by-doubling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d, make_tsdf_inserter_2d
from hectorgrapher_tpu.sensor.types import RangeData
from hectorgrapher_tpu.transform.np_quat import NpRigid3


def _clipped_points_counter():
    """Counter of scan returns falling outside the fixed submap extent.

    The reference grows grids on demand (grid_2d.h GrowLimits:79-94);
    fixed-extent dense arrays clip instead — this counter makes a
    misconfigured extent visible rather than silent."""
    from hectorgrapher_tpu.common.profiling import global_factory

    global _CLIPPED
    if _CLIPPED is None:
        _CLIPPED = global_factory().new_counter_family(
            "mapping_points_clipped_total",
            "scan returns outside the fixed submap grid extent",
        ).add({})
    return _CLIPPED


_CLIPPED = None


def count_clipped(grid, range_data: RangeData) -> None:
    """Sampled accounting of out-of-extent returns (host fetch of one
    scalar; call at the insertion cadence you can afford)."""
    import jax.numpy as _jnp

    from hectorgrapher_tpu.mapping.grids import cell_index, in_bounds

    pts = range_data.returns.positions[..., : len(grid.meta.min_corner)]
    idx = cell_index(grid.meta, pts)
    shape = grid.log_odds.shape if hasattr(grid, "log_odds") else grid.tsd.shape
    clipped = _jnp.sum(range_data.returns.mask & ~in_bounds(idx, shape))
    n = int(clipped)
    if n:
        _clipped_points_counter().increment(n)


@dataclass
class Submap2D:
    """(ref: submap_2d.h Submap2D; local_pose is the submap frame in the
    local SLAM frame)"""

    local_pose: NpRigid3
    grid: object  # ProbabilityGrid | TSDFGrid
    num_range_data: int = 0
    insertion_finished: bool = False
    quantize_on_finish: bool = False

    def insert(self, range_data_in_submap: RangeData, inserter) -> None:
        assert not self.insertion_finished
        self.grid = inserter(self.grid, range_data_in_submap)
        self.num_range_data += 1

    def finish(self) -> None:
        self.insertion_finished = True
        if self.quantize_on_finish:
            # uint16 storage option (ref: probability_values.h:64-92,
            # tsd_value_converter.h:33-73); see Submap3D.finish.
            from hectorgrapher_tpu.mapping.grids import (
                ProbabilityGrid,
                quantize_probability_grid,
                quantize_tsdf_grid,
            )

            if isinstance(self.grid, ProbabilityGrid):
                self.grid = quantize_probability_grid(self.grid)
            else:
                self.grid = quantize_tsdf_grid(self.grid)


class ActiveSubmaps2D:
    """(ref: submap_2d.cc ActiveSubmaps2D::InsertRangeData/AddSubmap)"""

    def __init__(self, options, max_ray_length: float = 0.0):
        self._options = options
        self._submaps: List[Submap2D] = []
        self._quantize_on_finish = (
            getattr(options, "grid_storage_dtype", "float32") == "uint16"
        )
        resolution = options.grid_options_2d.resolution
        size = options.grid_size
        grid_type = options.grid_options_2d.grid_type
        ins_opts = options.range_data_inserter
        storage_name = getattr(options, "grid_storage_dtype", "float32")
        if grid_type != "TSDF" and storage_name in ("float16", "bfloat16"):
            # Probability grids store f32 log-odds + bool mask; a silent
            # no-op here would fake the documented memory saving.
            raise ValueError(
                f"grid_storage_dtype={storage_name!r} is only supported for TSDF "
                "grids (use 'uint16' for quantize-on-finish of probability grids)"
            )
        if grid_type == "TSDF":
            from hectorgrapher_tpu.mapping.grids import STORAGE_DTYPES

            storage = STORAGE_DTYPES["float32" if self._quantize_on_finish else storage_name]
            tsdf_opts = ins_opts.tsdf_range_data_inserter
            self._make_grid = lambda: make_tsdf_grid(
                resolution,
                (size, size),
                truncation_distance=tsdf_opts.truncation_distance,
                max_weight=tsdf_opts.maximum_weight,
                dtype=storage,
            )
            self._inserter = make_tsdf_inserter_2d(tsdf_opts, resolution)
        else:
            pg_opts = ins_opts.probability_grid_range_data_inserter
            # The free-space sampling budget must cover the LONGEST inserted
            # ray (hits up to the trajectory's max_range, misses shortened
            # to missing_data_ray_length) — samples spread over the whole
            # origin->end segment, so sizing by the grid extent alone makes
            # sub-cell spacing fail for rays longer than the grid and
            # leaves unknown stripes inside carved free space.
            max_range = max(size * resolution, max_ray_length)
            self._make_grid = lambda: make_probability_grid(resolution, (size, size))
            self._inserter = make_probability_inserter_2d(pg_opts, max_range=max_range, resolution=resolution)

    @property
    def submaps(self) -> List[Submap2D]:
        return list(self._submaps)

    def insert_range_data(self, range_data_in_local: RangeData, origin_local: np.ndarray) -> List[Submap2D]:
        """Insert into both active submaps; manage spawn/finish.

        range_data_in_local: scan already transformed into the local SLAM
        frame. origin_local: scan origin (used as new submap center).
        Returns the current submap list (after possible finish/spawn).
        """
        if not self._submaps or self._submaps[-1].num_range_data == self._options.num_range_data:
            self._add_submap(origin_local)
        for submap in self._submaps:
            # Submap grids are stored in the local SLAM frame (the grid's
            # min_corner is shifted to center the array on the submap
            # origin), so no per-insert transform is needed.
            submap.insert(range_data_in_local, self._inserter)
        # Sampled clip accounting (one host scalar every 8 inserts).
        if self._submaps[0].num_range_data % 8 == 1:
            count_clipped(self._submaps[0].grid, range_data_in_local)
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin_local: np.ndarray) -> None:
        if len(self._submaps) >= 2:
            self._submaps[0].finish()
            self._submaps.pop(0)
        grid = self._make_grid()
        # Center the fixed grid on the new submap origin.
        center = np.array([origin_local[0], origin_local[1]], dtype=np.float32)
        meta = grid.meta._replace(min_corner=grid.meta.min_corner + jnp.asarray(center))
        grid = grid._replace(meta=meta)
        self._submaps.append(
            Submap2D(
                local_pose=NpRigid3(np.array([origin_local[0], origin_local[1], 0.0])),
                grid=grid,
                quantize_on_finish=self._quantize_on_finish,
            )
        )

    @property
    def matching_submap(self) -> Optional[Submap2D]:
        return self._submaps[0] if self._submaps else None

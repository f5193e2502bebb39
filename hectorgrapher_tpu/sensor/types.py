"""Typed sensor data as JAX pytrees with static shapes.

Replacement for the reference's value types
(ref: cartographer/sensor/{rangefinder_point.h, point_cloud.h,
timed_point_cloud_data.h, imu_data.h, odometry_data.h, range_data.h,
fixed_frame_pose_data.h, landmark_data.h}).

Design: clouds are fixed-capacity arrays with validity masks, so every
downstream kernel sees static shapes. `width` carries HectorGrapher's
structured-cloud layout (range_data.h adds `width` for organized clouds
used by CLOUD_STRUCTURE normal estimation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hectorgrapher_tpu.transform.rigid import Rigid3


class PointCloud(NamedTuple):
    """Padded point cloud.

    positions: (N, 3) float32; entries with mask==False are arbitrary.
    mask: (N,) bool validity.
    """

    positions: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    def num_valid(self):
        return jnp.sum(self.mask)


class TimedPointCloud(NamedTuple):
    """Cloud with per-point relative times (<= 0, last point == 0)
    (ref: sensor/timed_point_cloud_data.h)."""

    positions: jax.Array  # (N, 3)
    times: jax.Array  # (N,) relative seconds, <= 0
    mask: jax.Array  # (N,)


class TimedPointCloudData(NamedTuple):
    """One rangefinder measurement (ref: sensor/timed_point_cloud_data.h).

    time: float64 scalar — time of the LAST point.
    origin: (3,) sensor origin in tracking frame.
    width: static int, 0 for unstructured; else row width of organized cloud.
    """

    time: jax.Array
    origin: jax.Array
    ranges: TimedPointCloud
    width: int = 0


class RangeData(NamedTuple):
    """Returns + misses from one (accumulated) scan
    (ref: sensor/range_data.h; HectorGrapher adds width)."""

    origin: jax.Array  # (3,)
    returns: PointCloud
    misses: PointCloud
    width: int = 0


class ImuData(NamedTuple):
    """(ref: sensor/imu_data.h)"""

    time: jax.Array
    linear_acceleration: jax.Array  # (3,)
    angular_velocity: jax.Array  # (3,)


class ImuSeries(NamedTuple):
    """Batched IMU samples for lax.scan integration."""

    times: jax.Array  # (M,)
    linear_accelerations: jax.Array  # (M, 3)
    angular_velocities: jax.Array  # (M, 3)
    mask: jax.Array  # (M,)


class OdometryData(NamedTuple):
    """(ref: sensor/odometry_data.h)"""

    time: jax.Array
    pose: Rigid3


class FixedFramePoseData(NamedTuple):
    """GPS-like global pose observation (ref: sensor/fixed_frame_pose_data.h)."""

    time: jax.Array
    pose: Rigid3
    valid: jax.Array  # bool; reference uses optional<Rigid3>


class LandmarkObservation(NamedTuple):
    """(ref: sensor/landmark_data.h LandmarkObservation)"""

    landmark_index: jax.Array  # int32 id (interned host-side from string ids)
    landmark_to_tracking_transform: Rigid3
    translation_weight: jax.Array
    rotation_weight: jax.Array


class LandmarkData(NamedTuple):
    time: jax.Array
    observations: LandmarkObservation  # batched (K, ...)
    mask: jax.Array  # (K,)


# ---------------------------------------------------------------------------
# Construction / padding helpers
# ---------------------------------------------------------------------------


def pad_cloud(points: np.ndarray, capacity: int) -> PointCloud:
    """Pad an (n, 3) numpy array to a fixed-capacity PointCloud."""
    n = min(len(points), capacity)
    positions = np.zeros((capacity, 3), dtype=np.float32)
    positions[:n] = points[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(positions=jnp.asarray(positions), mask=jnp.asarray(mask))


def pad_timed_cloud(points: np.ndarray, times: np.ndarray, capacity: int) -> TimedPointCloud:
    """HOST-side padded container: leaves stay numpy — the front-end's
    range gating / bookkeeping reads them on host, and the device upload
    happens implicitly at the first jit dispatch that consumes them.
    (Uploading here cost a device round-trip per ingest field when the
    CT builder read them back: ~5 of the 131 readbacks/scan the round-5
    pipeline audit found.)"""
    n = min(len(points), capacity)
    positions = np.zeros((capacity, 3), dtype=np.float32)
    positions[:n] = points[:n]
    t = np.zeros((capacity,), dtype=np.float32)
    t[:n] = times[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return TimedPointCloud(positions=positions, times=t, mask=mask)


def transform_point_cloud(cloud: PointCloud, pose: Rigid3) -> PointCloud:
    from hectorgrapher_tpu.transform.rigid import apply_single

    return cloud._replace(positions=apply_single(pose, cloud.positions))


def transform_range_data(rd: RangeData, pose: Rigid3) -> RangeData:
    from hectorgrapher_tpu.transform.rigid import apply_single

    return RangeData(
        origin=apply_single(pose, rd.origin[None])[0],
        returns=transform_point_cloud(rd.returns, pose),
        misses=transform_point_cloud(rd.misses, pose),
        width=rd.width,
    )


def crop_range_data_z(rd: RangeData, min_z: float, max_z: float) -> RangeData:
    """Mask out points outside [min_z, max_z] (ref: sensor/range_data.h
    CropRangeData used by local_trajectory_builder_2d.cc:51-63)."""

    def crop(c: PointCloud) -> PointCloud:
        z = c.positions[..., 2]
        return c._replace(mask=c.mask & (z >= min_z) & (z <= max_z))

    return rd._replace(returns=crop(rd.returns), misses=crop(rd.misses))

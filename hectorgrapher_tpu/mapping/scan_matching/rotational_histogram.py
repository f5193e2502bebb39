"""Rotational scan matcher histograms.

(ref: cartographer/mapping/internal/3d/scan_matching/rotational_scan_matcher.cc
— the scan is sliced by z (0.2 m slices); within each slice points are
sorted by angle around the slice centroid; each consecutive point pair
contributes the angle of its 2D delta (folded to [0, pi)) with weight
max(0, 1 - |delta_hat . direction_hat|) unless the pair is too close
(< 0.2 m), the point is too close to the centroid (< 0.2 m), or the gap
too large (> 0.9 m). Histograms are matched by cosine similarity over
rotated copies.)

Design: one pass of sort + segment ops over a padded cloud; rotation
of histograms by fractional bins via linear interpolation, batched over
many candidate angles at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

MIN_DISTANCE = 0.2
MAX_DISTANCE = 0.9
SLICE_HEIGHT = 0.2


@functools.partial(jax.jit, static_argnames=("histogram_size",))
def compute_histogram(positions, mask, histogram_size: int = 120):
    """Histogram of a (padded) cloud in gravity-aligned frame.

    positions: (N, 3); mask: (N,). Returns (histogram_size,) float32.
    """
    n = positions.shape[0]
    z_slice = jnp.floor(positions[:, 2] / SLICE_HEIGHT).astype(jnp.int32)
    z_slice = jnp.where(mask, z_slice, jnp.int32(1 << 24))

    # Per-slice centroid via segment mean keyed by slice id. Slices ids are
    # arbitrary ints; remap via sort.
    order0 = jnp.argsort(z_slice)
    # For centroids, use scatter-add over a bounded slice index: clamp slice
    # ids into [0, n) after ranking.
    sorted_slices = z_slice[order0]
    new_slice_start = jnp.concatenate([jnp.array([True]), sorted_slices[1:] != sorted_slices[:-1]])
    compact_id_sorted = jnp.cumsum(new_slice_start) - 1  # (N,) compact slice id in sorted order
    compact_id = jnp.zeros((n,), jnp.int32).at[order0].set(compact_id_sorted.astype(jnp.int32))

    valid = mask
    w = valid.astype(jnp.float32)
    sums = jnp.zeros((n, 3), jnp.float32).at[compact_id].add(positions * w[:, None])
    counts = jnp.zeros((n,), jnp.float32).at[compact_id].add(w)
    centroids = sums / jnp.maximum(counts, 1.0)[:, None]  # (n_slices<=N, 3)
    centroid_per_point = centroids[compact_id]

    # Sort points within slice by angle around slice centroid.
    delta_c = positions[:, :2] - centroid_per_point[:, :2]
    angle_around = jnp.arctan2(delta_c[:, 1], delta_c[:, 0])
    # Points too close to the centroid are dropped (ref SortSlice).
    near_centroid = jnp.linalg.norm(delta_c, axis=-1) < MIN_DISTANCE
    valid = valid & ~near_centroid

    sort_key_angle = jnp.where(valid, angle_around, 1e9)
    order = jnp.lexsort((sort_key_angle, jnp.where(valid, compact_id, 1 << 24)))
    p_sorted = positions[order]
    v_sorted = valid[order]
    s_sorted = jnp.where(valid, compact_id, -1)[order]
    c_sorted = centroid_per_point[order]

    # The reference walks each sorted slice accumulating distance until the
    # gap to the LAST ACCEPTED point reaches kMinDistance (AddPointCloud-
    # SliceToHistogram keeps last_point_position on skip). Vectorized
    # approximation: bucket points by cumulative arc length within the
    # slice and keep the first point of each ~MIN_DISTANCE bucket, then
    # pair consecutive kept points.
    first = jnp.arange(s_sorted.shape[0]) > 0  # roll wraps row 0 onto row N-1
    step = jnp.linalg.norm(p_sorted[:, :2] - jnp.roll(p_sorted[:, :2], 1, axis=0), axis=-1)
    same_slice_step = (s_sorted == jnp.roll(s_sorted, 1)) & v_sorted & jnp.roll(v_sorted, 1) & first
    step = jnp.where(same_slice_step, step, 0.0)
    cum = jnp.cumsum(step)
    slice_start_cum = jnp.where(same_slice_step, 0.0, cum)
    # cumulative arc within slice = cum - (cum at slice start), via cummax
    # of per-slice reset marker
    start_marker = jax.lax.associative_scan(jnp.maximum, slice_start_cum)
    arc = cum - start_marker
    bucket = jnp.floor(arc / MIN_DISTANCE).astype(jnp.int32)
    key_change = jnp.concatenate(
        [jnp.array([True]), (bucket[1:] != bucket[:-1]) | (s_sorted[1:] != s_sorted[:-1])]
    )
    kept = key_change & v_sorted

    # Bring kept points of each slice together, preserving angle order.
    order2 = jnp.lexsort((sort_key_angle[order], jnp.where(kept, s_sorted, 1 << 24)))
    p2 = p_sorted[order2]
    s2 = jnp.where(kept, s_sorted, -1)[order2]
    c2 = c_sorted[order2]
    k2 = kept[order2]

    same_slice = (
        (s2 == jnp.roll(s2, 1)) & k2 & jnp.roll(k2, 1)
        & (jnp.arange(s2.shape[0]) > 0)  # roll wraps row 0 onto row N-1
    )
    delta = (p2 - jnp.roll(p2, 1, axis=0))[:, :2]
    direction = (p2 - c2)[:, :2]
    dist = jnp.linalg.norm(delta, axis=-1)
    dnorm = jnp.linalg.norm(direction, axis=-1)
    ok = same_slice & (dist >= MIN_DISTANCE) & (dist <= MAX_DISTANCE) & (dnorm >= MIN_DISTANCE)

    angle = jnp.arctan2(delta[:, 1], delta[:, 0])
    angle = jnp.mod(angle, jnp.pi)  # fold to [0, pi)
    value = jnp.maximum(
        0.0,
        1.0
        - jnp.abs(
            jnp.sum(delta * direction, axis=-1) / jnp.maximum(dist * dnorm, 1e-9)
        ),
    )
    bucket = jnp.clip(
        jnp.round(histogram_size * angle / jnp.pi - 0.5).astype(jnp.int32), 0, histogram_size - 1
    )
    hist = jnp.zeros((histogram_size,), jnp.float32).at[
        jnp.where(ok, bucket, histogram_size)
    ].add(jnp.where(ok, value, 0.0), mode="drop")
    return hist


def rotate_histogram(histogram, angle):
    """Rotate by angle with linear interpolation between buckets
    (ref: rotational_scan_matcher.cc RotateHistogram). Batched over angle."""
    size = histogram.shape[-1]
    angle = jnp.asarray(angle)
    rotate_by_buckets = -angle * size / jnp.pi
    full = jnp.floor(rotate_by_buckets).astype(jnp.int32)
    frac = rotate_by_buckets - full
    idx = (jnp.arange(size) + full[..., None]) % size
    idx2 = (idx + 1) % size
    return (1.0 - frac[..., None]) * histogram[idx] + frac[..., None] * histogram[idx2]


def match_histograms(submap_histogram, scan_histogram, angles):
    """Cosine similarity of the scan histogram rotated by each angle
    against the submap histogram. Returns (len(angles),) scores."""
    rotated = rotate_histogram(scan_histogram, jnp.asarray(angles))  # (A, size)
    norm = jnp.linalg.norm(rotated, axis=-1) * jnp.linalg.norm(submap_histogram)
    scores = jnp.einsum("as,s->a", rotated, submap_histogram) / jnp.maximum(norm, 1e-3)
    return jnp.where(norm < 1e-3, 1.0, scores)

"""SO(3)/SE(3) and SE(2) transforms as batched JAX array operations.

Replacement for the reference's Eigen-based Rigid2<T>/Rigid3<T>
(ref: cartographer/transform/rigid_transform.h, transform/transform.h).
Instead of transform *objects*, everything here is a pure function over
arrays with arbitrary leading batch dimensions, so poses vmap/scan/jit
cleanly and live on device.

Conventions:
  * Quaternions are (..., 4) arrays in (w, x, y, z) order, normalized.
  * A rigid transform is a pytree `Rigid3(translation=(...,3),
    rotation=(...,4))` acting as x -> R(q) @ x + t.
  * Rigid2 is `Rigid2(translation=(...,2), angle=(...,))`.
  * Tangent/rotation vectors are angle-axis (..., 3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Quaternion ops (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(batch_shape=(), dtype=jnp.float32):
    q = jnp.zeros(batch_shape + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_multiply(a, b):
    """Hamilton product a*b, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4).

    Uses the 15-mul formula: v' = v + 2*w*(u x v) + 2*(u x (u x v)).
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_from_axis_angle(aa):
    """Exponential map: angle-axis vector (..., 3) -> quaternion.

    Taylor-safe near zero (ref: transform/transform.h
    AngleAxisVectorToRotationQuaternion).
    """
    angle_sq = jnp.sum(aa * aa, axis=-1, keepdims=True)
    angle = jnp.sqrt(jnp.maximum(angle_sq, 1e-24))
    half = 0.5 * angle
    small = angle_sq < 1e-12
    # sin(x/2)/x -> 1/2 - x^2/48 as x -> 0
    k = jnp.where(small, 0.5 - angle_sq / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - angle_sq / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * aa], axis=-1)


def quat_to_axis_angle(q):
    """Log map: quaternion -> angle-axis vector (..., 3). Angle in [0, pi]."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # take the short way around
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    sin_half = jnp.linalg.norm(vec, axis=-1)
    angle = 2.0 * jnp.arctan2(sin_half, w)
    small = sin_half < 1e-8
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), angle / jnp.maximum(sin_half, 1e-24))
    return scale[..., None] * vec


def quat_angle(q):
    """Rotation angle in [0, pi] (ref: transform/transform.h GetAngle)."""
    w = jnp.abs(q[..., 0])
    sin_half = jnp.linalg.norm(q[..., 1:], axis=-1)
    return 2.0 * jnp.arctan2(sin_half, jnp.clip(w, 0.0, 1.0))


def quat_yaw(q):
    """Yaw of the rotated x-axis (ref: transform/transform.h GetYaw)."""
    # direction = R @ [1,0,0]; yaw = atan2(dir_y, dir_x)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    dir_x = 1.0 - 2.0 * (y * y + z * z)
    dir_y = 2.0 * (x * y + w * z)
    return jnp.arctan2(dir_y, dir_x)


def quat_from_yaw(yaw):
    half = 0.5 * jnp.asarray(yaw)
    zeros = jnp.zeros_like(half)
    return jnp.stack([jnp.cos(half), zeros, zeros, jnp.sin(half)], axis=-1)


def quat_slerp(a, b, t):
    """Spherical linear interpolation, batched; t broadcastable to batch."""
    t = jnp.asarray(t)[..., None]
    dot = jnp.sum(a * b, axis=-1, keepdims=True)
    b = jnp.where(dot < 0, -b, b)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(jnp.clip(dot, 0.0, 1.0))
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-6
    wa = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(use_lerp, 1.0, sin_theta))
    wb = jnp.where(use_lerp, t, jnp.sin(t * theta) / jnp.where(use_lerp, 1.0, sin_theta))
    return quat_normalize(wa * a + wb * b)


def quat_to_matrix(q):
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free.

    Uses the numerically-stable 4-candidate construction and picks the
    candidate with the largest pivot via where-selects (jit friendly).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate (unnormalized) quaternions.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)[..., None]
    q = jnp.where(best == 0, qw, jnp.where(best == 1, qx, jnp.where(best == 2, qy, qz)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Rigid3
# ---------------------------------------------------------------------------


class Rigid3(NamedTuple):
    """SE(3) pose pytree: x -> R(rotation) @ x + translation.

    (ref: transform/rigid_transform.h Rigid3<T>)
    """

    translation: jax.Array  # (..., 3)
    rotation: jax.Array  # (..., 4) wxyz

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Rigid3":
        return Rigid3(
            translation=jnp.zeros(batch_shape + (3,), dtype=dtype),
            rotation=quat_identity(batch_shape, dtype=dtype),
        )

    @staticmethod
    def from_translation(t) -> "Rigid3":
        t = jnp.asarray(t)
        return Rigid3(translation=t, rotation=quat_identity(t.shape[:-1], dtype=t.dtype))

    @staticmethod
    def from_rotation(q) -> "Rigid3":
        q = jnp.asarray(q)
        return Rigid3(translation=jnp.zeros(q.shape[:-1] + (3,), dtype=q.dtype), rotation=q)


def compose(a: Rigid3, b: Rigid3) -> Rigid3:
    """a * b (apply b first, then a)."""
    return Rigid3(
        translation=quat_rotate(a.rotation, b.translation) + a.translation,
        rotation=quat_normalize(quat_multiply(a.rotation, b.rotation)),
    )


def inverse(p: Rigid3) -> Rigid3:
    inv_rot = quat_conjugate(p.rotation)
    return Rigid3(translation=-quat_rotate(inv_rot, p.translation), rotation=inv_rot)


def apply(p: Rigid3, points):
    """Apply pose to points (..., 3); pose batch dims broadcast against points."""
    return quat_rotate(p.rotation[..., None, :] if points.ndim > p.rotation.ndim else p.rotation, points) + (
        p.translation[..., None, :] if points.ndim > p.translation.ndim else p.translation
    )


def apply_single(p: Rigid3, points):
    """Apply one pose to a (N, 3) cloud."""
    return quat_rotate(p.rotation[None, :], points) + p.translation[None, :]


def interpolate(a: Rigid3, b: Rigid3, t) -> Rigid3:
    """lerp translation + slerp rotation (ref: transform/timestamped_transform.cc)."""
    t = jnp.asarray(t)
    return Rigid3(
        translation=a.translation + t[..., None] * (b.translation - a.translation),
        rotation=quat_slerp(a.rotation, b.rotation, t),
    )


def log(p: Rigid3):
    """SE(3)-as-product log: (translation, angle-axis) (..., 6)."""
    return jnp.concatenate([p.translation, quat_to_axis_angle(p.rotation)], axis=-1)


def exp(xi) -> Rigid3:
    """Inverse of `log` (product manifold, not the true SE(3) exp)."""
    return Rigid3(translation=xi[..., :3], rotation=quat_from_axis_angle(xi[..., 3:]))


# ---------------------------------------------------------------------------
# Rigid2
# ---------------------------------------------------------------------------


class Rigid2(NamedTuple):
    """SE(2) pose pytree (ref: transform/rigid_transform.h Rigid2<T>)."""

    translation: jax.Array  # (..., 2)
    angle: jax.Array  # (...,)

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Rigid2":
        return Rigid2(
            translation=jnp.zeros(batch_shape + (2,), dtype=dtype),
            angle=jnp.zeros(batch_shape, dtype=dtype),
        )


def rot2(angle, v):
    """Rotate 2D vectors (..., 2) by angles, broadcasting."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y = v[..., 0], v[..., 1]
    return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)


def compose2(a: Rigid2, b: Rigid2) -> Rigid2:
    from hectorgrapher_tpu.common.math import normalize_angle_difference

    return Rigid2(
        translation=rot2(a.angle, b.translation) + a.translation,
        angle=normalize_angle_difference(a.angle + b.angle),
    )


def inverse2(p: Rigid2) -> Rigid2:
    return Rigid2(translation=-rot2(-p.angle, p.translation), angle=-p.angle)


def apply2(p: Rigid2, points):
    t = p.translation[..., None, :] if points.ndim > p.translation.ndim else p.translation
    a = p.angle[..., None] if points.ndim - 1 > p.angle.ndim else p.angle
    return rot2(a, points) + t


def embed_2d_in_3d(p: Rigid2) -> Rigid3:
    """(ref: transform/transform.h Embed3D)"""
    t = jnp.concatenate([p.translation, jnp.zeros(p.translation.shape[:-1] + (1,), p.translation.dtype)], axis=-1)
    return Rigid3(translation=t, rotation=quat_from_yaw(p.angle))


def project_3d_to_2d(p: Rigid3) -> Rigid2:
    """(ref: transform/transform.h Project2D)"""
    return Rigid2(translation=p.translation[..., :2], angle=quat_yaw(p.rotation))

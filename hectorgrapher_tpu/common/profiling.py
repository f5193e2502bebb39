"""Tracing and profiling helpers.

(ref: the reference instruments hot paths with metrics counters/histograms
registered through metrics::FamilyFactory (metrics/register.cc wires
local_trajectory_builder_{2,3}d, pose_graph_{2,3}d, constraint builders);
profiling is done externally. Here the same section-timing idea is exposed
as a context manager feeding a histogram family, plus a bridge to the JAX
device profiler for XLA-level traces.)
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

from hectorgrapher_tpu.metrics.metrics import GLOBAL_FACTORY, FamilyFactory

# ONE process-wide registry: everything registered here (section
# histograms, clip counters, constraint-score histograms, ...) is what
# the Prometheus endpoint serves (metrics/http_exporter.py defaults to
# GLOBAL_FACTORY — a second registry here would leave /metrics empty).
_factory = GLOBAL_FACTORY
_sections = _factory.new_histogram_family(
    "hg_section_seconds",
    "Wall time per instrumented section",
    boundaries=[1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0],
)
_lock = threading.Lock()
_metrics_cache: Dict[str, object] = {}


def global_factory() -> FamilyFactory:
    """The process-wide registry (ref: metrics/register.cc RegisterAllMetrics)."""
    return _factory


@contextlib.contextmanager
def section(name: str):
    """Time a code section into the hg_section_seconds histogram family.

    Usage: `with profiling.section("scan_match"): ...`
    """
    with _lock:
        metric = _metrics_cache.get(name)
        if metric is None:
            metric = _sections.add({"section": name})
            _metrics_cache[name] = metric
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metric.observe(time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """XLA-level device trace via the JAX profiler into `log_dir`; view
    with TensorBoard or xprof. A profiler that fails to start or stop
    raises."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a device trace (jax.profiler.TraceAnnotation),
    usable as a context manager."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def report() -> str:
    """Text dump of all instrumented sections (ref: FamilyFactory text
    exposition used by the cloud server's /metrics-style debugging)."""
    return _factory.text_format()

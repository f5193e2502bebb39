"""Every choice the program makes from the device it runs on, in one place.

- the fast loop-closure matchers' layout (`fast_match_layout`), chosen by
  platform from on-card A/B timings at the production round shapes;
- device-memory budgets, derived from the device's reported limit on an
  accelerator and fixed constants on the CPU (`pack_budget_bytes`,
  `candidate_chunk_cap_bytes`);
- the float32 matmul precision policy (`MATMUL_PRECISION`, applied by the
  package's `__init__`);
- the persistent compile cache location (`configure_compile_cache`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import jax

# Solvers and matchers compute in full float32. On a GPU the default lets
# a float32 dot run in TF32 (10 mantissa bits), which moves matmul results
# and single SPA or GN steps by 3e-4 to 2e-3 relative (PERF.md).
MATMUL_PRECISION = "highest"

# Fixed CPU budgets (tests and CPU runs). On an accelerator the budgets
# are the shares of its reported memory limit that these constants are of
# 16 GiB: 3/8 for the packs, 3/32 for one candidate block's transient.
_CPU_PACK_BUDGET = 6 << 30
_CPU_CHUNK_CAP = 1_500_000_000
_PACK_SHARE = 3 / 8
_CHUNK_SHARE = 3 / 32

_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


class FastMatchLayout(NamedTuple):
    """How the 2D/3D fast matchers store and gather their pyramid levels.

    point_chunk: points scored per `lax.scan` step (bounds the gathered
        transient).
    level_dtype: storage dtype of the pyramid level tables; scores
        accumulate in float32 either way.
    """

    point_chunk: int
    level_dtype: str


# Chosen by on-card A/B at the production round shapes (PERF.md):
# on the GPU bf16 levels and 512-point chunks beat float32 and 32-point
# chunks; the CPU keeps float32 (emulated bf16 is slow there) and small
# cache-sized chunks.
_FAST_MATCH_LAYOUTS = {
    "cpu": FastMatchLayout(point_chunk=32, level_dtype="float32"),
    "gpu": FastMatchLayout(point_chunk=512, level_dtype="bfloat16"),
}


def fast_match_layout(platform: str | None = None) -> FastMatchLayout:
    """The fast matchers' layout on `platform` (default: JAX's backend)."""
    platform = platform or jax.default_backend()
    try:
        return _FAST_MATCH_LAYOUTS[platform]
    except KeyError:
        raise ValueError(f"no fast-matcher layout for platform {platform!r}") from None


def device_memory_limit(device=None) -> int | None:
    """Bytes the program may allocate on `device` (default: the first local
    device); None on the CPU. An accelerator that reports no limit is an
    error."""
    device = device or jax.local_devices()[0]
    if device.platform == "cpu":
        return None
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"{device} reports no memory limit (memory_stats: {stats})")
    return int(stats["bytes_limit"])


def pack_budget_bytes(device=None) -> int:
    """Default device budget of the loop-closure constraint-search packs."""
    limit = device_memory_limit(device)
    return _CPU_PACK_BUDGET if limit is None else int(limit * _PACK_SHARE)


def candidate_chunk_cap_bytes(device=None) -> int:
    """Gather-transient cap of one block of fast-matcher candidates."""
    limit = device_memory_limit(device)
    return _CPU_CHUNK_CAP if limit is None else int(limit * _CHUNK_SHARE)


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache lives in `.jax_cache/` at the root of
    the checkout (listed in .gitignore). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_CACHE_DIR))
    return str(_CACHE_DIR)

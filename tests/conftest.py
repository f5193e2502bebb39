"""Test configuration: run on CPU with 8 virtual devices.

Multi-chip hardware is not available in CI; sharding tests use a virtual
8-device CPU mesh as SURVEY.md section 4 prescribes. HG_TEST_PLATFORM
selects another platform (`HG_TEST_PLATFORM=gpu pytest -m chip` runs the
chip-marked tests on the card). Some installed pytest plugins import jax
before this conftest runs, so the platform also goes through jax.config,
which works as long as no backend has been initialized yet.
"""

import os

os.environ["JAX_PLATFORMS"] = os.environ.get("HG_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

from hectorgrapher_tpu.common.device import configure_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (tests marked `chip`)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with HG_TEST_PLATFORM=gpu on the card")
    return jax.devices()[0]

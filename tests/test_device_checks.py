"""Solvers and matchers on the GPU against the float32 CPU reference
(hectorgrapher_tpu/evaluation/device_checks.py, the checks chip_smoke.py
runs). Marked `chip`: they skip unless JAX's first device is a GPU."""

import pytest

from hectorgrapher_tpu.evaluation.device_checks import CHECKS


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_device_matches_cpu_reference(gpu, name):
    r = CHECKS[name]()
    assert r.ok, r.line()

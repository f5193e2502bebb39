"""Device-dependent choices (common/device.py) and the chip checks' CPU side."""

import json
import os

import jax
import pytest

from hectorgrapher_tpu.common import device
from hectorgrapher_tpu.common.device import FastMatchLayout, fast_match_layout


class TestPlatformDecision:
    def test_cpu_layout_is_float32_in_small_chunks(self):
        assert fast_match_layout("cpu") == FastMatchLayout(32, "float32")

    def test_gpu_layout_is_bf16_in_large_chunks(self):
        assert fast_match_layout("gpu") == FastMatchLayout(512, "bfloat16")

    def test_default_follows_the_backend(self):
        assert fast_match_layout() == fast_match_layout(jax.default_backend())

    def test_unknown_platform_is_an_error(self):
        with pytest.raises(ValueError, match="rocm"):
            fast_match_layout("rocm")

    def test_matmul_precision_policy_is_full_float32(self):
        import hectorgrapher_tpu  # noqa: F401  (applies the policy)

        assert jax.config.jax_default_matmul_precision == "highest"


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestBudgets:
    def test_cpu_keeps_fixed_constants(self):
        cpu = jax.devices("cpu")[0]
        assert device.pack_budget_bytes(cpu) == 6 << 30
        assert device.candidate_chunk_cap_bytes(cpu) == 1_500_000_000

    @pytest.mark.parametrize("limit", [16 << 30, 60 << 30])
    def test_accelerator_budgets_scale_with_reported_limit(self, limit):
        gpu = _FakeDevice("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
        assert device.pack_budget_bytes(gpu) == int(limit * 3 / 8)
        assert device.candidate_chunk_cap_bytes(gpu) == int(limit * 3 / 32)

    def test_a_16_gib_device_gets_the_cpu_pack_budget(self):
        gpu = _FakeDevice("gpu", {"bytes_limit": 16 << 30})
        assert device.pack_budget_bytes(gpu) == 6 << 30

    @pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
    def test_accelerator_without_a_limit_is_an_error(self, stats):
        with pytest.raises(RuntimeError, match="no memory limit"):
            device.pack_budget_bytes(_FakeDevice("gpu", stats))

    def test_pose_graph_uses_the_configured_budget_or_the_device(self):
        from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
        from hectorgrapher_tpu.mapping.pose_graph.pose_graph import _pack_budget_bytes

        opts = MapBuilderOptions().pose_graph
        assert opts.constraint_builder.pack_hbm_budget_bytes is None
        assert _pack_budget_bytes(opts) == device.pack_budget_bytes()
        set_opts = replace_deep(
            MapBuilderOptions(), {"pose_graph.constraint_builder.pack_hbm_budget_bytes": 1234}
        ).pose_graph
        assert _pack_budget_bytes(set_opts) == 1234


class TestCompileCache:
    def _updates(self, monkeypatch):
        calls = []
        monkeypatch.setattr(device.jax.config, "update", lambda k, v: calls.append((k, v)))
        return calls

    def test_environment_variable_wins_and_nothing_is_set(self, monkeypatch):
        calls = self._updates(monkeypatch)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
        assert device.configure_compile_cache() == "/some/cache"
        assert calls == []

    def test_unset_uses_one_fixed_directory_in_the_checkout(self, monkeypatch):
        calls = self._updates(monkeypatch)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = device.configure_compile_cache()
        assert first == device.configure_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert first == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", first)] * 2
        with open(os.path.join(root, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


# The GPU's layout, and each of its fields flipped alone from the CPU's:
# every branch the GPU takes against the CPU's float32 scalar picks.
_BRANCHES = {
    "gpu": fast_match_layout("gpu"),
    "chunk": fast_match_layout("cpu")._replace(point_chunk=fast_match_layout("gpu").point_chunk),
    "bf16": fast_match_layout("cpu")._replace(level_dtype="bfloat16"),
}


class TestFastMatcherBranches:
    @pytest.mark.parametrize("branch", sorted(_BRANCHES))
    def test_2d_branch_matches_cpu_layout(self, branch):
        from hectorgrapher_tpu.evaluation.device_checks import check_fast_2d

        r = check_fast_2d(64, layout=_BRANCHES[branch])
        assert r.ok, r.line()

    @pytest.mark.parametrize("branch", sorted(_BRANCHES))
    def test_3d_branch_matches_cpu_layout(self, branch):
        from hectorgrapher_tpu.evaluation.device_checks import check_fast_3d

        r = check_fast_3d(40, layout=_BRANCHES[branch])
        assert r.ok, r.line()


class TestChipSmoke:
    def test_refuses_the_cpu_and_prints_no_result(self, capsys):
        import chip_smoke

        assert chip_smoke.main([]) != 0
        out = capsys.readouterr()
        assert "needs a GPU" in out.err
        for line in out.out.splitlines():
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)

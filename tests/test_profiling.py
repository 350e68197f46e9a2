"""Profiling utilities: stage timers, RTF accounting, trace contexts."""

import json
import time

from drnmf_tpu.utils import StageTimer, trace


def test_stage_timer_rtf():
    t = StageTimer()
    with t.stage("a", audio_seconds=10.0):
        time.sleep(0.01)
    with t.stage("b"):  # non-RTF stage, excluded from the factor
        time.sleep(0.01)
    assert t.total_seconds() >= 0.02
    rtf = t.realtime_factor()
    assert 0 < rtf < 10.0 / 0.01
    rep = t.report()
    assert "real-time factor" in rep and "a:" in rep and "b:" in rep
    data = json.loads(t.to_json())
    assert len(data["stages"]) == 2
    assert data["stages"][0]["audio_seconds"] == 10.0


def test_trace_noop():
    with trace(None):
        pass  # must not start a profiler


def test_trace_writes(tmp_path):
    import jax.numpy as jnp

    with trace(str(tmp_path)):
        (jnp.ones(8) * 2).block_until_ready()
    # jax profiler writes a plugins/profile tree
    assert any(tmp_path.rglob("*.xplane.pb")) or any(tmp_path.iterdir())


def _record_config_updates(monkeypatch):
    """Record jax.config.update calls made by enable_compile_cache without
    changing the test process's cache settings."""
    from drnmf_tpu.utils import profiling

    calls = {}
    monkeypatch.setattr(profiling.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_env_set_sets_no_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program leaves the cache
    directory to JAX."""
    from drnmf_tpu.utils import default_compile_cache_dir, enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert default_compile_cache_dir() is None
    calls = _record_config_updates(monkeypatch)
    assert enable_compile_cache()
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_env_unset_uses_checkout_dir(monkeypatch):
    """Without it, the cache goes to one fixed path inside the checkout."""
    import os

    from drnmf_tpu.utils import default_compile_cache_dir, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert default_compile_cache_dir() == os.path.join(repo, ".jax_cache")
    calls = _record_config_updates(monkeypatch)
    assert enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == os.path.join(repo,
                                                              ".jax_cache")

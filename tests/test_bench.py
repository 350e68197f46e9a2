"""bench.py harness plumbing.

Pins the parts that must not regress without a card in the loop: the
default stage suite's failure handling, the final summary headline line
being the LAST JSON line with every secondary metric folded in, and the
peak table the utilization figures divide by.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402


def _json_lines(out):
    return [json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")]


def test_run_default_fault_isolation_and_summary(monkeypatch, capsys):
    """A failing mid-suite stage records an error field and the later
    stages still run; the LAST stdout JSON line is the headline with all
    secondary metrics, and the run then exits non-zero."""
    monkeypatch.setattr(bench, "main", lambda: {
        "metric": "drnmf_enhance_rtf_per_chip", "value": 38000.0,
        "mfu": 0.28})
    def boom():
        raise RuntimeError("step failed\nRESOURCE_EXHAUSTED: out of memory")
    monkeypatch.setattr(bench, "bench_train", boom)
    monkeypatch.setattr(bench, "bench_loop", lambda: {
        "metric": "train_loop_steps_per_second", "value": 27.5})
    monkeypatch.setattr(bench, "bench_score", lambda: {
        "metric": "scoring_rtf_per_chip", "value": 196.5,
        "engine_rtf": 196.5})

    with pytest.raises(SystemExit) as ei:
        bench._run_default()
    assert ei.value.code == 1
    out = capsys.readouterr().out
    last = _json_lines(out)[-1]
    assert last["metric"] == "drnmf_enhance_rtf_per_chip"
    assert last["value"] == 38000.0
    assert last["loop_steps_per_s"] == 27.5
    assert last["scoring_engine_rtf"] == 196.5
    assert last["train_steps_per_s"] is None
    assert "RESOURCE_EXHAUSTED" in last["failed_stages"]["train"]
    assert last["device"]["platform"] == "cpu"  # conftest pins cpu


def test_run_default_exits_nonzero_when_enhance_fails(monkeypatch, capsys):
    """The headline stage failing makes the capture rc!=0 (the driver must
    see the run as failed), but the other stages still report."""
    def boom():
        raise RuntimeError("UNAVAILABLE")
    monkeypatch.setattr(bench, "main", boom)
    ok = {"value": 1.0}
    monkeypatch.setattr(bench, "bench_train", lambda: dict(ok, mfu=0.07))
    monkeypatch.setattr(bench, "bench_loop", lambda: dict(ok))
    monkeypatch.setattr(bench, "bench_score", lambda: dict(ok, engine_rtf=2.0))
    with pytest.raises(SystemExit) as ei:
        bench._run_default()
    assert ei.value.code == 1
    last = _json_lines(capsys.readouterr().out)[-1]
    assert last["value"] is None
    assert last["train_steps_per_s"] == 1.0


def test_device_peaks_h100():
    """The H100 row carries NVIDIA's published dense peaks, and the
    utilization figures divide by the peak of the arithmetic the model's
    matmuls run in (TF32 at 'default', FP32 at 'highest')."""
    row = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert row == {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                   "hbm_bytes": 3.35e12}
    assert bench._MATMUL_CLASS == {"default": "tf32", "highest": "fp32"}


def test_device_peaks_unknown_kind_raises(monkeypatch):
    """A device missing from the table is an error, not a silent None --
    including the CPU the tests run on, through _mfu."""
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no published peaks"):
        bench._mfu(1e12, 1.0)


def test_bench_loop_modes_execute(monkeypatch, capsys):
    """bench --loop's three dispatch arms (epoch fusion, device loss
    accumulator, per-step fetch) all execute and report on CPU with a
    tiny model (the numbers only mean something on the chip)."""
    import numpy as np

    def tiny():
        import jax
        from drnmf_tpu.models import DRNMFConfig, init_drnmf_params

        config = DRNMFConfig(input_dim=9, r=4, output_dim=9, K_layers=2,
                             alph=10.0, lam1=0.5)
        rng = np.random.default_rng(0)
        w = rng.uniform(0.01, 1.0, (9, 8)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        return config, jax.device_put(init_drnmf_params(config, w))

    monkeypatch.setattr(bench, "_flagship", tiny)
    res = bench.bench_loop(bsz=2, maxlen=12, n_steps=4)
    assert res["metric"] == "train_loop_steps_per_second"
    for k in ("value", "accumulate_steps_per_s",
              "per_step_fetch_steps_per_s", "speedup_vs_per_step_fetch",
              "speedup_vs_accumulate"):
        assert res[k] > 0, k
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == res["value"]


def test_profile_train_stage_attribution(monkeypatch, capsys):
    """bench --profile-train produces a complete attribution table whose
    component programs all execute (tiny model on CPU; the numbers only
    mean something on the chip, the plumbing must not break)."""
    import numpy as np

    def tiny():
        import jax
        from drnmf_tpu.models import DRNMFConfig, init_drnmf_params

        config = DRNMFConfig(input_dim=9, r=4, output_dim=9, K_layers=2,
                             alph=10.0, lam1=0.5)
        rng = np.random.default_rng(0)
        w = rng.uniform(0.01, 1.0, (9, 8)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        return config, jax.device_put(init_drnmf_params(config, w))

    monkeypatch.setattr(bench, "_flagship", tiny)
    prof = bench.bench_profile_train(bsz=2, maxlen=16, n_iter=2)
    for k in ("dispatch_floor_ms", "scan_ms", "forward_ms", "loss_ms",
              "grad_ms", "adam_ms", "train_step_ms",
              "scan_per_timestep_us"):
        assert k in prof, k
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "train_step_profile"
    assert line["backward_ms"] == round(line["grad_ms"] - line["loss_ms"], 3)

"""Tests of ``bench.py``'s flow: per-metric subprocesses, run one after
another; a crashed metric records ``null`` without discarding the others;
the JSON line names the device; a metric that finds no GPU fails."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).parent.parent / "bench.py"
spec = importlib.util.spec_from_file_location("bench", BENCH)
bench = importlib.util.module_from_spec(spec)
sys.modules["bench"] = bench
spec.loader.exec_module(bench)

GPU = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "count": 1}


class Proc:
    def __init__(self, returncode=0, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_metric_subprocess_timeout_is_isolated(monkeypatch):
    """A metric that hangs (subprocess timeout) must null ONLY that metric."""

    def timeout_run(*args, **kwargs):
        raise subprocess.TimeoutExpired(cmd="measure", timeout=1)

    monkeypatch.setattr(bench.subprocess, "run", timeout_run)
    record, status = bench._measure_metric_in_subprocess("serial")
    assert record is None and status == "timeout"


def test_metric_subprocess_parses_last_json_line(monkeypatch):
    line = json.dumps(dict(GPU, value=42.0))
    monkeypatch.setattr(
        bench.subprocess, "run",
        lambda *a, **k: Proc(stdout=f"warning noise\n{line}\n"),
    )
    record, status = bench._measure_metric_in_subprocess("serial")
    assert status == "ok" and record == dict(GPU, value=42.0)


@pytest.mark.parametrize(
    "proc, expected",
    [
        (Proc(returncode=1, stderr="XlaRuntimeError: out of memory"), "rc=1"),
        (Proc(stdout="no json here\n"), "no JSON output"),
    ],
)
def test_metric_subprocess_failure_records_error(monkeypatch, proc, expected):
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: proc)
    record, status = bench._measure_metric_in_subprocess("batched")
    assert record is None and status.startswith(expected)


def test_assemble_survives_partial_failure():
    """One dead path must not discard the measured ones."""
    values = {"serial": 100.0, "batched": None, "sweep": 5e6,
              "particle_env": None}
    paths = {"serial": "ok", "batched": "rc=1: boom", "sweep": "ok",
             "particle_env": "timeout"}
    result = bench._assemble(values, paths, dict(GPU, card="H100, 700 W"))
    assert result["value"] == 100.0
    assert result["headline_mode"] == "serial"
    assert result["batched_tracks_per_s"] is None
    assert result["sweep_env_steps_per_s"] == 5e6
    assert result["paths"]["batched"].startswith("rc=1")
    assert {k: result[k] for k in GPU} == GPU
    assert result["card"] == "H100, 700 W"


def test_assemble_picks_the_better_dispatch_mode():
    result = bench._assemble({"serial": 100.0, "batched": 250.0}, {}, GPU)
    assert result["headline_mode"] == "batched"
    assert result["value"] == 250.0
    assert result["vs_baseline"] == 25.0


def test_main_runs_metrics_one_after_another(monkeypatch, capsys):
    """Every metric gets its own subprocess, in order, never two at once,
    and the JSON line carries the device the metrics ran on."""
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd[-1])
        return Proc(stdout=json.dumps(dict(GPU, value=float(len(calls)))))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    import lynx_tpu.profiling

    monkeypatch.setattr(
        lynx_tpu.profiling, "card", lambda: "NVIDIA H100 80GB HBM3, 700 W"
    )
    monkeypatch.setattr(bench.sys, "argv", ["bench.py"])
    bench.main()
    assert calls == list(bench.METRICS)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: result[k] for k in GPU} == GPU
    assert result["card"] == "NVIDIA H100 80GB HBM3, 700 W"
    assert all(status == "ok" for status in result["paths"].values())


def test_measure_only_refuses_the_cpu():
    """A metric that finds no GPU fails instead of timing the CPU."""
    proc = subprocess.run(
        [sys.executable, str(BENCH), "--measure-only", "sweep"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert proc.stdout.strip() == ""

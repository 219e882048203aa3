"""A tiny run of each kind of cell on the CPU prints the benchmark's result line; without a
card the command itself exits non-zero and prints no result.

    python -m pytest bench_port/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_port import run
from bench_port.tests import tiny

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_run(workload: str, seconds: float = 6.0, trace: bool = False, seed: int = 2**31 + 12345) -> dict:
    cfg, tr = workload.split(".")
    return run.run_cell(tiny.bench(), workload, seed, seconds, trace, "cpu", conf=tiny.config(cfg),
                        traffic=tiny.traffic(tr), limits=tiny.limits(workload))


def check_line(res: dict, trace: bool) -> None:
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    for name, (value, limit) in res["checks"].items():
        assert isinstance(value, float) and isinstance(limit, float), name
    json.dumps(res)


@pytest.mark.parametrize("workload", ["tum1_mono.online", "kitti00_stereo.batch8"])
def test_tiny_run_prints_the_result_line(workload):
    res = tiny_run(workload)
    check_line(res, trace=False)
    assert res["correct"], res["checks"]


def test_tiny_traced_run_reports_per_layer_metrics():
    res = tiny_run("tum1_mono.online", seconds=8.0, trace=True)
    check_line(res, trace=True)
    names = {m["name"] for m in tiny.bench()["per_layer"]}
    assert set(res["metrics"]) <= names
    assert "track_host_ms.step" in res["metrics"] and "track_host_ms.multi" not in res["metrics"]


def test_without_a_card_the_command_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "tum1_mono.batch8", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in p.stderr


def test_a_checkout_without_the_port_fails(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "tum1_mono.batch8", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in tiny.bench()["workloads"] if w not in tiny.QUEUED_CELLS])
def test_each_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", workload, "--seed", str(2**31 + 7),
                        "--seconds", "10", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.splitlines()[-1])
    check_line(res, trace=False)
    assert res["correct"], res["checks"]

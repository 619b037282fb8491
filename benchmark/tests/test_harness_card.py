"""A short run of each cell through the one command on the card. Skips
without a CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_one_short_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483900", "--seconds", "1", "--trace", "0"],
        cwd=str(harness.ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert "setup_s" in res["metrics"]

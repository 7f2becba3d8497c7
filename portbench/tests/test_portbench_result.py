"""The result line's keys, and a run that must print no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, SHRINK

REPO = Path(__file__).resolve().parent.parent.parent


@pytest.mark.parametrize("name", CELLS)
def test_result_keys_and_check_last(name):
    r = harness.run(name, 2**31 + 99, 0.2, False, device="cpu",
                    shrink=SHRINK)
    json.dumps(r)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "check"
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["metrics"]) == {"slices_per_s", "batch_p95_ms", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert r["attempted"] >= 1 and r["compared_batches"] >= 1
    for c in r["check"].values():
        assert set(c) == {"value", "limit"}


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_no_result_and_a_failing_code():
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    else:
        env = None
    out = _cli(REPO, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

"""A cell, a traffic mix and a metric added as new files run through the
harness, with no file of the benchmark edited but BENCHMARK.json's list."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench import harness
from portbench.tests.conftest import SHRINK

REPO = Path(__file__).resolve().parent.parent.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_cell(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "xray_clahe.json").read_text())
    config["name"] = "xray_sharpen"
    config["batch"] = 2
    config["program"]["pipeline"] = [
        {"op": "unsharp_mask", "radius": 2.0, "amount": 0.5}]
    (pb / "configs" / "xray_sharpen.json").write_text(json.dumps(config))
    (pb / "traffic" / "single.json").write_text(json.dumps(
        {"name": "single", "in_flight": 1, "pool_bytes": 1}))
    (pb / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.window.calls / run.window.seconds\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "xray_sharpen", "source": "test",
                             "file": "portbench/configs/xray_sharpen.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "xray_sharpen.single",
                               "config": "xray_sharpen", "traffic": "single",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["xray_sharpen.single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = harness.run("xray_sharpen.single", 5, 0.2, False, root=tmp_path,
                    device="cpu", shrink={"slice": SHRINK["slice"]})
    assert r["correct"] is True
    assert r["metrics"]["calls_per_s"]["value"] > 0
    assert "slices_per_s" in r["metrics"]
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())

"""On the card: each cell runs through the command, traced and not, and
the bfloat16 control fails the check at the cell's own size.

    python3 -m pytest portbench/tests -m cuda -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import torch

from portbench import harness
from portbench.reference import chain as ref_chain
from portbench.tests.conftest import CELLS

REPO = Path(__file__).resolve().parent.parent.parent
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name, traced):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", str(traced)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    cell = harness.load_cell(name)
    want = cell.per_layer if traced else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["metrics"]["kernel_roofline_pct"]["value"] <= 100
        assert r["metrics"]["chain_roofline_pct"]["value"] <= 100


def bfloat16_reference(cell):
    """The control: the plain reference in bfloat16, the precision below
    the configuration's float32, put in the program's place."""
    ops_dir = cell.bench_dir / "reference" / "ops"
    return lambda chain: lambda x: ref_chain.run(cell.stages, x,
                                                 torch.bfloat16, ops_dir)[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    """A whole run, a short window at the cell's own batch, slice and pool
    (long enough to compare about as many batches as a run does), with the
    control in the program's place: every batch compared fails.
    Each seed's numbers are printed (``-s``) for the limits' upper
    readings."""
    cell = harness.load_cell(name)
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        r = harness.run(name, seed, 6.0, False, wrap=bfloat16_reference(cell))
        print(json.dumps({"workload": name, "seed": seed, "side": "control",
                          "check": r["check"], "failed": r["failed"],
                          "compared": r["compared_batches"]}))
        assert r["correct"] is False
        assert r["failed"] == r["compared_batches"] > 0

"""A run whose timed path is broken underneath comes out not correct.

The harness runs as on the card, but on the CPU at a tiny size (its look
for a card skipped): each fault a chain of these cells can have is put
around the program's chain, and the check must call the run wrong."""

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, SHRINK


def half_batch_left_out(chain):
    """Only the first half of each batch is computed; the rest repeats it."""
    def run(x):
        half = chain(x[: (x.shape[0] + 1) // 2])
        return torch.cat([half, half])[: x.shape[0]]
    return run


def answer_altered(chain):
    """One slice of each batch comes out one level brighter."""
    def run(x):
        out = chain(x).clone()
        out[-1] = torch.clamp(out[-1].to(torch.int16) + 1, 0, 255).to(
            torch.uint8)
        return out
    return run


def stage_skipped(cell):
    """The chain's middle stage returns its input unchanged."""
    from mies_tpu_torch.pipeline.compiler import compile_pipeline
    from mies_tpu_torch.pipeline.config import from_dict
    prog = dict(cell.config["program"])
    pipe = list(prog["pipeline"])
    del pipe[len(pipe) // 2]
    prog["pipeline"] = pipe
    broken = compile_pipeline(from_dict(prog), batched=True, quantize=True,
                              device="cpu")
    return lambda chain: broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "altered", "stage_skipped"])
def test_fault_comes_out_not_correct(name, fault):
    cell = harness.load_cell(name, shrink=SHRINK)
    wrap = {"half_batch": half_batch_left_out, "altered": answer_altered,
            "stage_skipped": stage_skipped(cell)}[fault]
    r = harness.run(name, 2**32 + 9, 0.2, False, device="cpu",
                    shrink=SHRINK, wrap=wrap)
    assert r["correct"] is False
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_comes_out_correct(name):
    r = harness.run(name, 2**32 + 9, 0.2, False, device="cpu", shrink=SHRINK)
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["check"].values())

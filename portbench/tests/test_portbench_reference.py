"""The plain reference against the port's own plain chain on the CPU, and
the bfloat16 control against the limits."""

import pytest
import torch

from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import from_dict
from portbench import harness
from portbench.reference import chain as ref_chain
from portbench.tests.conftest import CELLS

SMALL = {"slice": [40, 56], "batch": 4, "pool_bytes": 1}


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_ports_cpu_chain(name):
    cell = harness.load_cell(name, shrink=SMALL)
    pool = harness.make_pool(cell, 11, torch.device("cpu"))
    chain = compile_pipeline(from_dict(cell.config["program"]), batched=True,
                             quantize=True, device="cpu")
    for x in pool:
        ref, _ = ref_chain.run(cell.stages, x, block=3)
        assert torch.equal(chain(x), ref)


def test_reference_records_tv_steps_per_slice():
    cell = harness.load_cell(CELLS[1], shrink=SMALL)
    x = harness.make_pool(cell, 3, torch.device("cpu"))[0]
    _, info = ref_chain.run(cell.stages, x, block=3)
    steps = info["denoise_tv.steps"]
    assert steps.shape == (4,) and bool(((steps >= 1) & (steps <= 60)).all())


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_limits(name):
    cell = harness.load_cell(name, shrink=SMALL)
    pool = harness.make_pool(cell, 13, torch.device("cpu"))
    answers = [(i, ref_chain.run(cell.stages, x, torch.bfloat16)[0])
               for i, x in enumerate(pool)]
    numbers, failed, _, _ = harness.check(cell, pool, answers)
    assert failed == len(answers)
    limits = cell.config["check"]
    assert numbers["worst_slice_off"] > 3 * limits["worst_slice_off"]

"""The phantoms are made from the seed alone."""

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, SHRINK


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_pool_other_seed_other_pool(name):
    cell = harness.load_cell(name, shrink=SHRINK)
    cpu = torch.device("cpu")
    a = harness.make_pool(cell, 2**33 + 7, cpu)
    b = harness.make_pool(cell, 2**33 + 7, cpu)
    c = harness.make_pool(cell, 2**33 + 8, cpu)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])   # the pool's batches differ
    assert a[0].dtype == cell.io_dtype
    assert a[0].shape == (cell.batch, *cell.shape)


def test_ct_phantom_is_hounsfield_units_with_noise():
    cell = harness.load_cell(CELLS[1], shrink={"slice": [128, 128],
                                               "batch": 2, "pool_bytes": 1})
    x = harness.make_pool(cell, 5, torch.device("cpu"))[0].float()
    assert x.min() >= -1024 and x.max() <= 3071
    assert (x < -900).any() and ((x > -60) & (x < 140)).any()
    # white noise of 25 HU: neighbours in soft tissue differ by 25 sqrt 2
    a, b = x[:, :, 1:], x[:, :, :-1]
    soft = (a > -60) & (a < 140) & (b > -60) & (b < 140)
    assert 30 < float((a - b)[soft].std()) < 42

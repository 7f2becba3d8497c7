"""BENCHMARK.json keeps to its contract, and every cell resolves to its
files."""

import json
import re

import pytest

from portbench import harness
from portbench.reference import chain as ref_chain
from portbench.tests.conftest import CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_is_listed():
    assert sorted(w["name"] for w in BENCH["workloads"]) == sorted(CELLS)


def test_names_units_and_entry_keys():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell.pool >= 2 and cell.batch >= 1
    assert cell.pool * cell.batch * cell.shape[0] * cell.shape[1] \
        * cell.io_dtype.itemsize > 50e6  # the pool outgrows the L2
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(cell, m["name"]).read)
    assert callable(harness.phantom(cell).make)
    for op, _ in cell.stages:
        assert callable(ref_chain.load_op(op).apply)
    for op, _ in cell.stages:
        assert op in {"window_hu", "denoise_nl_means", "denoise_tv", "clahe",
                      "bilateral_blur", "unsharp_mask", "median_blur"}
    assert set(cell.config["check"]) == {"worst_slice_off", "max_level_off"}


def test_kernel_files_have_their_fields():
    cell = harness.load_cell(CELLS[0])
    kernels = harness.kernel_specs(cell)
    assert {k.NAME for k in kernels} == {"K1L", "K2", "K3", "K4", "K11",
                                         "K12"}
    for k in kernels:
        re.compile(k.PATTERN)
        assert isinstance(k.LAUNCHES, str) and callable(k.work)

"""The trace's reduction on a hand-made chrome trace, and the launch check."""

import json
import types

import pytest

from portbench import harness, trace


def _trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "issue", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "bilateral_strip<5>(float const*, float*)", "ts": 5, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 3, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventRecord",
         "ts": 4, "dur": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 20, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "wait", "ts": 10,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void at::native::add(int)",
         "ts": 40, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(path, harness.SPANS)


def test_busy_is_the_union_and_gaps_carry_the_host_span(tmp_path):
    t = _trace(tmp_path)
    assert len(t.ops) == 3 and len(t.spans) == 2
    assert trace.busy_us(t.ops, 0, 60) == 35     # [5, 30] and [40, 50]
    assert trace.gaps(t.ops, 0, 60) == [(0, 5), (30, 40), (50, 60)]
    assert trace.span_at(t.spans, 35) == "wait"
    assert trace.span_at(t.spans, 2) == "issue"
    assert trace.span_at(t.spans, 99) == "none"
    assert trace.short_name(t.ops[0][0]) == "bilateral_strip<5>"


def test_a_launch_without_its_device_record_is_lost(tmp_path):
    t = _trace(tmp_path)
    assert trace.lost_launches(t, 0) == 1     # correlation 8
    assert trace.lost_launches(t, 2.5) == 1
    assert trace.lost_launches(t, 3.5) == 0


def test_window_takes_operations_by_their_launch_call(tmp_path):
    t = _trace(tmp_path)
    # the kernel starts at 5 on the device's clock, but was launched at 2
    assert [o[1] for o in trace.ops_from(t, 2.5)] == [20, 40]
    assert [o[1] for o in trace.ops_from(t, 1.0)] == [5, 20, 40]


def test_launch_check_refuses_a_trace_with_missing_launches(tmp_path):
    t = _trace(tmp_path)
    k3 = types.SimpleNamespace(NAME="K3", PATTERN=r"\bbilateral_strip\b",
                               LAUNCHES="bilateral")
    kernel_of = harness._kernel_of(t.ops, [k3])
    assert [k is k3 for k in kernel_of] == [True, False, False]
    harness.launch_check(kernel_of, {"bilateral": 4},
                         {"bilateral": 5})
    with pytest.raises(harness.TraceMismatch):
        harness.launch_check(kernel_of, {"bilateral": 4},
                             {"bilateral": 6})
    with pytest.raises(harness.TraceMismatch):  # a counter no file claims
        harness.launch_check(kernel_of, {"bilateral": 4, "tv": 0},
                             {"bilateral": 5, "tv": 3})

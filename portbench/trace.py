"""Reduce a torch.profiler chrome trace to device intervals and host spans.

Device operations are the trace's kernels, copies and fills, on the
device's own timeline; host spans are the harness's ``record_function``
ranges (``issue``, ``wait``, ``check``), on the same clock. Busy time is
the union of the device intervals, never a sum over another loop.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CAT = "user_annotation"
RUNTIME_CATS = frozenset({"cuda_runtime", "cuda_driver"})
# host API calls that put an operation on the device
LAUNCH = re.compile(r"Launch|Memset|Memcpy")


@dataclass
class Trace:
    ops: list[tuple[str, float, float]]    # device: name, start us, us
    spans: list[tuple[str, float, float]]  # host: name, start us, us
    launches: list[tuple[float, int]]      # host launch calls: us, correlation
    op_correlations: list                  # of each device operation


def _correlation(ev):
    return (ev.get("args") or {}).get("correlation")


def read(path: Path, span_names) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t = Trace([], [], [], [])
    ops = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            ops.append(((ev["name"], float(ev["ts"]), float(ev["dur"])),
                        _correlation(ev)))
        elif cat == HOST_CAT and ev.get("name") in span_names:
            t.spans.append((ev["name"], float(ev["ts"]), float(ev["dur"])))
        elif cat in RUNTIME_CATS and LAUNCH.search(str(ev.get("name"))) \
                and _correlation(ev) is not None:
            t.launches.append((float(ev["ts"]), _correlation(ev)))
    ops.sort(key=lambda o: o[0][1])
    t.ops = [o for o, _ in ops]
    t.op_correlations = [c for _, c in ops]
    t.spans.sort(key=lambda s: s[1])
    return t


def lost_launches(t: Trace, start: float) -> int:
    """Host launch calls from ``start`` on whose device operation the
    trace lacks: the profiler dropped its record."""
    seen = set(t.op_correlations)
    return sum(1 for ts, c in t.launches if ts >= start and c not in seen)


def ops_from(t: Trace, start: float) -> list:
    """The device operations launched from ``start`` on (host clock): by
    their launch call where the trace holds it, since the device's clock
    may sit a little off the host's; by their own start otherwise."""
    before = {c for ts, c in t.launches if ts < start}
    after = {c for ts, c in t.launches if ts >= start}
    return [o for o, c in zip(t.ops, t.op_correlations)
            if c in after or (c not in before and o[1] >= start)]


def merged(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the device intervals, clipped to [lo, hi]."""
    out = []
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        s, e = max(start, lo), min(start + dur, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(ops, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(ops, lo, hi))


def gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi]: no device operation runs."""
    out, t = [], lo
    for s, e in merged(ops, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def span_at(spans, t: float) -> str:
    """The host span running at time ``t``, or "none" (the harness's
    spans follow one another and do not nest)."""
    i = bisect.bisect_right([s for _, s, _ in spans], t) - 1
    if i >= 0 and t <= spans[i][1] + spans[i][2]:
        return spans[i][0]
    return "none"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace noise and
    argument list, at most 100 characters."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:100]

"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, and the result line.

The system under test is ``mies_tpu_torch``: its ``compile_pipeline(cfg,
batched=True, quantize=True)``, called on batches already on the card,
and its launch counter ``kernels._build.LAUNCHES``. Everything else (the
inputs, the clock, the trace's reduction, the reference, the work counts
and the comparison) is the harness's own.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import importlib.util
import json
import math
import random
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import imports, roofline, trace
from portbench.reference import chain as ref_chain

ROOT = Path(__file__).resolve().parent.parent
SPANS = ("issue", "wait", "check")
PROFILE_S = 0.25     # device seconds the traced sub-window aims at
WARMUP_CYCLES = 2    # passes over the pool before the window
IO_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
             "int16": torch.int16, "float32": torch.float32}


class NoCard(RuntimeError):
    """No card, or fewer than the cell asks for: no result is printed."""


class TraceMismatch(RuntimeError):
    """The trace's hand-kernel launches disagree with the program's own
    counter: events are missing, and nothing is read from the trace."""


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in this process."""


# --------------------------------------------------------------------------
# the cell's files, found by name
# --------------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    batch: int = 0
    shape: tuple = ()
    pool: int = 0

    @property
    def stages(self) -> list:
        return ref_chain.stages_of(self.config)

    @property
    def io_dtype(self) -> torch.dtype:
        return IO_DTYPES[self.config["program"]["io"]["dtype"]]

    @property
    def bench_dir(self) -> Path:
        return self.root / "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT, shrink: dict | None = None
              ) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration and traffic files. ``shrink`` (tests only) overrides the
    slice, the batch and the pool's bytes."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    cell = Cell(name, root, int(w["chips"]), config, traffic,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))
    shrink = shrink or {}
    h, w_ = shrink.get("slice", config["slice"])
    cell.shape = (int(h), int(w_))
    cell.batch = int(shrink.get("batch", config["batch"]))
    pool_bytes = int(shrink.get("pool_bytes", traffic["pool_bytes"]))
    per_batch = cell.batch * h * w_ * cell.io_dtype.itemsize
    cell.pool = max(2, -(-pool_bytes // per_batch))
    return cell


@functools.lru_cache(maxsize=None)
def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", str(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, metric: str):
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise ValueError(f"metric {metric!r} has no reader at {path}")
    return _module(path)


def kernel_specs(cell: Cell) -> list:
    return [_module(p) for p in sorted((cell.bench_dir / "kernels")
                                       .glob("*.py"))
            if p.name != "__init__.py"]


def phantom(cell: Cell):
    return _module(cell.bench_dir / "phantoms"
                   / f"{cell.config['phantom']}.py")


# --------------------------------------------------------------------------
# the work a batch needs, for the roofline shares
# --------------------------------------------------------------------------


@dataclass
class Work:
    """The chain's stages at one batch: what kernel files and the chain's
    roofline count. ``info`` holds the reference's per-slice records for
    this batch (TV's steps)."""
    stages: list
    shape: tuple
    io_dtype: torch.dtype
    info: dict
    ops_dir: Path

    @property
    def px(self) -> int:
        b, h, w = self.shape
        return b * h * w

    def params(self, op: str) -> list[dict]:
        return [p for o, p in self.stages if o == op]

    def stage_ops(self, op: str) -> int:
        mod = ref_chain.load_op(op, self.ops_dir)
        return sum(mod.operations(self.shape, self.info, **p)
                   for p in self.params(op))

    def last_op(self) -> str:
        return self.stages[-1][0] if self.stages else ""

    def quantize_ops(self) -> int:
        return ref_chain.quantize_operations(self.shape)

    def chain_least_s(self) -> float:
        nbytes = self.px * (self.io_dtype.itemsize + 1)  # raw in, uint8 out
        ops = ref_chain.operations(self.stages, self.shape, self.io_dtype,
                                   self.info, self.ops_dir)
        return roofline.least_s(nbytes, ops)


# --------------------------------------------------------------------------
# the closed loop
# --------------------------------------------------------------------------


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    latency_s: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)
    pool_index: list = field(default_factory=list)


class _HostEvent:
    """A CPU chain has finished when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _no_span(name):
    return contextlib.nullcontext()


def drive(chain, pool: list, in_flight: int, dev: torch.device, *,
          seconds: float | None = None, calls: int | None = None,
          keep=None, span=_no_span) -> Window:
    """Closed loop, one client: call ``i`` runs ``chain`` on
    ``pool[i % len(pool)]`` and is issued while up to ``in_flight - 1``
    earlier calls are still on the card; a call's latency runs from its
    issue to the host seeing its completion event. Issues until
    ``seconds`` have passed (or ``calls`` were issued), then drains.
    ``keep(i, out)`` sees each output once it has completed."""
    cuda = dev.type == "cuda"
    ring = [torch.cuda.Event() if cuda else _HostEvent()
            for _ in range(in_flight + 1)]
    win = Window()
    flight = collections.deque()
    clock = time.perf_counter
    t0 = clock()
    t_done = t0
    while True:
        more = (win.calls < calls) if calls is not None else \
            (clock() - t0 < seconds)
        if more:
            i = win.calls
            p = i % len(pool)
            with span("issue"):
                ts = clock()
                out = chain(pool[p])
                ev = ring[i % len(ring)]
                ev.record()
                te = clock()
            win.dispatch_s.append(te - ts)
            win.pool_index.append(p)
            flight.append((ts, ev, i, out))
            win.calls += 1
            if len(flight) < in_flight:
                continue
        elif not flight:
            break
        ts, ev, i, out = flight.popleft()
        with span("wait"):
            ev.synchronize()
            t_done = clock()
        win.latency_s.append(t_done - ts)
        if keep is not None:
            with span("check"):
                keep(i, out)
    win.seconds = t_done - t0
    return win


class Kept:
    """The outputs the check compares: the last answer to every input of
    the pool and a reservoir sample, drawn from the seed, of every call
    made (the window's, then the traced sub-window's)."""

    def __init__(self, pool: int, seed: int):
        self.pool = pool
        self.rng = random.Random(seed)
        self.calls = 0
        self.last = {}
        self.sample = []

    def __call__(self, i: int, out: torch.Tensor) -> None:
        entry = (self.calls, i % self.pool, out)
        self.calls += 1
        self.last[entry[1]] = entry
        if len(self.sample) < self.pool:
            self.sample.append(entry)
        else:
            j = self.rng.randrange(self.calls)
            if j < self.pool:
                self.sample[j] = entry

    def answers(self) -> list[tuple[int, torch.Tensor]]:
        """(pool index, output) of each call kept, once."""
        seen = {n: (p, out) for n, p, out in [*self.last.values(),
                                               *self.sample]}
        return [seen[n] for n in sorted(seen)]


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """``worst_slice_off``: the largest share of a slice's pixels whose
    uint8 level differs from the reference's; ``max_level_off``: the
    largest difference in levels."""
    if out.shape != ref.shape or out.dtype != torch.uint8:
        return {"worst_slice_off": math.inf, "max_level_off": math.inf}
    diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
    off = (diff > 0).to(torch.float64).mean(dim=(-2, -1))
    return {"worst_slice_off": float(off.max()),
            "max_level_off": float(diff.max())}


def check(cell: Cell, pool: list, answers, dtype=torch.float32):
    """Compare each answer with the reference of its pool batch, computed
    anew from the raw inputs. Returns (numbers, batches over a limit,
    batches compared, the reference's records per pool batch)."""
    limits = cell.config["check"]
    ops_dir = cell.bench_dir / "reference" / "ops"
    refs, infos = {}, {}
    for p in sorted({i % cell.pool for i, _ in answers}):
        refs[p], infos[p] = ref_chain.run(cell.stages, pool[p], dtype,
                                          ops_dir)
    numbers = {k: 0.0 for k in limits}
    failed = 0
    for i, out in answers:
        got = compare(out, refs[i % cell.pool])
        failed += any(got[k] > limits[k] for k in limits)
        numbers = {k: max(numbers[k], got[k]) for k in limits}
    return numbers, failed, len(answers), infos


# --------------------------------------------------------------------------
# the traced sub-window
# --------------------------------------------------------------------------


@dataclass
class Traced:
    calls: int
    pool_index: list
    lo: float
    hi: float
    ops: list
    spans: list
    kernel_of: list          # per device op: its kernel file, or None
    busy_s: float = 0.0
    window_s: float = 0.0


def _kernel_of(ops, kernels) -> list:
    pats = [(k, re.compile(k.PATTERN)) for k in kernels]
    out = []
    for name, _, _ in ops:
        hit = [k for k, pat in pats if pat.search(name)]
        if len(hit) > 1:
            raise TraceMismatch(f"{name!r} matches several kernel files: "
                                f"{[k.NAME for k in hit]}")
        out.append(hit[0] if hit else None)
    return out


def launch_check(kernel_of, before: dict, after: dict) -> None:
    """Hand-kernel launches in the trace, per counter key, must equal the
    rise of the program's ``LAUNCHES`` over the same calls."""
    seen = collections.Counter(k.LAUNCHES for k in kernel_of if k)
    rose = {key: after[key] - before.get(key, 0) for key in after
            if after[key] != before.get(key, 0)}
    keys = set(seen) | set(rose)
    bad = {key: (seen.get(key, 0), rose.get(key, 0)) for key in sorted(keys)
           if seen.get(key, 0) != rose.get(key, 0)}
    if bad:
        raise TraceMismatch(
            "hand-kernel launches in the trace != the rise of "
            "kernels._build.LAUNCHES (trace, counter): "
            + ", ".join(f"{k}: {v}" for k, v in bad.items())
            + "; the profiler dropped events, or a kernel has no file "
            "under portbench/kernels/")


def profile(cell: Cell, chain, pool, dev, calls: int, launches: dict,
            keep: Kept, attempts: int = 3) -> Traced:
    """The traced sub-window, its answers kept by the window's ``keep`` (so
    it allocates no more than the window did); a trace that lost events
    is taken again, up to ``attempts`` times, and never read."""
    for attempt in range(attempts):
        try:
            return _profile_once(cell, chain, pool, dev, calls, launches,
                                 keep)
        except TraceMismatch as e:
            print(f"portbench: trace {attempt + 1} refused: {e}",
                  file=sys.stderr)
            if attempt + 1 == attempts:
                raise


def _profile_once(cell: Cell, chain, pool, dev, calls: int, launches: dict,
                  keep: Kept) -> Traced:
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function, schedule

    kernels = kernel_specs(cell)
    in_flight = cell.traffic["in_flight"]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        # a warm-up step over the pool whose events the tracer drops, then
        # in the traced step a lead-in cycle, drained: the tracer's start-up
        # and any event it loses while starting stay out of the window,
        # which begins after the drain
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1,
                                        repeat=1),
                      on_trace_ready=lambda p: p.export_chrome_trace(
                          str(path))) as prof:
            drive(chain, pool, in_flight, dev, calls=cell.pool)
            torch.cuda.synchronize()
            prof.step()
            drive(chain, pool, in_flight, dev, calls=cell.pool)
            with record_function("drain"):
                torch.cuda.synchronize()
            before = dict(launches)
            win = drive(chain, pool, in_flight, dev, calls=calls,
                        keep=keep, span=record_function)
            torch.cuda.synchronize()
            after = dict(launches)
            prof.step()
        tr = trace.read(path, (*SPANS, "drain"))
    drains = [s for s in tr.spans if s[0] == "drain"]
    issues = [s for s in tr.spans if s[0] == "issue"]
    waits = [s for s in tr.spans if s[0] == "wait"]
    if len(drains) != 1 or len(issues) != win.calls \
            or len(waits) != win.calls:
        raise TraceMismatch(f"the trace holds {len(drains)} drain, "
                            f"{len(issues)} issue and {len(waits)} wait "
                            f"spans for 1 drain and {win.calls} calls")
    start = drains[0][1] + drains[0][2]
    lost = trace.lost_launches(tr, start)
    if lost:
        raise TraceMismatch(f"{lost} launches on the host have no device "
                            f"operation in the trace")
    ops = trace.ops_from(tr, start)
    if not ops:
        raise TraceMismatch("no device operation in the traced window")
    # the window runs from the first issue to the last wait's end; the
    # device's clock may sit a little off the host's, so it also spans
    # every device operation of the loop
    lo = min(issues[0][1], ops[0][1])
    hi = max(waits[-1][1] + waits[-1][2], max(o[1] + o[2] for o in ops))
    kernel_of = _kernel_of(ops, kernels)
    launch_check(kernel_of, before, after)
    t = Traced(win.calls, win.pool_index, lo, hi, ops, tr.spans, kernel_of)
    t.busy_s = trace.busy_us(ops, lo, hi) * 1e-6
    t.window_s = (hi - lo) * 1e-6
    return t


def breakdown(t: Traced) -> dict:
    by_name = collections.Counter()
    for name, _, dur in t.ops:
        by_name[trace.short_name(name)] += dur * 1e-6
    gaps = sorted(trace.gaps(t.ops, t.lo, t.hi), key=lambda g: g[0] - g[1])
    return {
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[trace.span_at(t.spans, (a + b) / 2), (b - a) * 1e-6]
                      for a, b in gaps[:10]],
    }


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window: Window
    slices: int
    traced: Traced | None = None
    infos: dict = field(default_factory=dict)

    def work(self, pool_index: int) -> Work:
        return Work(self.cell.stages, (self.cell.batch, *self.cell.shape),
                    self.cell.io_dtype, self.infos.get(pool_index, {}),
                    self.cell.bench_dir / "reference" / "ops")


def _device(dev: torch.device, chips: int) -> None:
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} card(s), the cell asks "
                     f"for {chips}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def make_pool(cell: Cell, seed: int, dev: torch.device) -> list:
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    make = phantom(cell).make
    h, w = cell.shape
    return [make(cell.batch, h, w, gen, dev).contiguous()
            for _ in range(cell.pool)]


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        root: Path = ROOT, device: str = "cuda", t0: float | None = None,
        shrink: dict | None = None, wrap=None) -> dict:
    """One run of ``workload``; returns the result line as a dict. ``t0``
    is the process's clock at its start (set-up counts from it);
    ``device="cpu"``, ``shrink`` and ``wrap`` (a fault put around the
    program's chain) serve the CPU tests."""
    t0 = time.perf_counter() if t0 is None else t0
    parts = {"import": time.perf_counter() - t0}
    cell = load_cell(workload, root, shrink)
    dev = torch.device(device)
    _device(dev, cell.chips)
    mark = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
    parts["cuda_context"] = time.perf_counter() - mark

    mark = time.perf_counter()
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.pipeline.compiler import compile_pipeline
    from mies_tpu_torch.pipeline.config import from_dict
    if dev.type == "cuda":
        _build.library()
    chain = compile_pipeline(from_dict(cell.config["program"]), batched=True,
                             quantize=True, device=dev)
    if wrap is not None:
        chain = wrap(chain)
    parts["library"] = time.perf_counter() - mark

    mark = time.perf_counter()
    pool = make_pool(cell, seed, dev)
    _sync(dev)
    parts["inputs"] = time.perf_counter() - mark

    mark = time.perf_counter()
    in_flight = int(cell.traffic["in_flight"])
    drive(chain, pool, in_flight, dev, calls=WARMUP_CYCLES * cell.pool)
    _sync(dev)
    parts["warm_up"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - t0

    gc.collect()
    gc.disable()
    try:
        kept = Kept(cell.pool, seed)
        win = drive(chain, pool, in_flight, dev, seconds=seconds, keep=kept)
        tr = None
        if traced:
            if dev.type != "cuda":
                raise NoCard("a traced run needs the card")
            per_call = win.seconds / max(win.calls, 1)
            n = max(2 * cell.pool, math.ceil(PROFILE_S / per_call))
            n = -(-n // cell.pool) * cell.pool
            tr = profile(cell, chain, pool, dev, n, _build.LAUNCHES, kept)
    finally:
        gc.enable()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del chain
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, failed, compared, infos = check(cell, pool, kept.answers())
    limits = cell.config["check"]
    correct = compared > 0 and failed == 0

    r = Run(cell, setup_s, win, win.calls * cell.batch, tr, infos)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(cell, m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    bad = imports.loaded_forbidden()
    if bad:
        raise ForbiddenImport(f"loaded after the window: {bad}")

    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win.calls,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    result["setup_parts_s"] = parts
    result["compared_batches"] = compared
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return result

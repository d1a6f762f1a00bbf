"""The benchmark's machinery: finding a cell's files by name, the measured
window, the trace, the stage timer, the comparison's verdict and the result
line.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and an entry (``entries/<entry>.py``); the
metrics a run reports are the cell's in ``BENCHMARK.json``, each per-layer
one read by ``metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and edits none.

An entry module gives:

* ``setup(ctx) -> state``: the program built from the seed, the inputs,
  the warm-up of every shape the window uses;
* ``call(state)``: one unit of the closed-loop window (a call, a step, a
  tick);
* ``finish(state)``: wait for what ``call`` left in flight;
* ``end_to_end(state, window) -> {metric: value}``;
* ``counts(state) -> {"call": {"flops", "bytes"}, "kernels": {...}}``;
* ``stages(state) -> {stage: fn}``: the layers timed alone in a traced run;
* ``release(state)``: drop the program's state;
* ``check(state, control) -> [(name, value, limit)]``: the comparison with
  the plain reference (with ``control``, the reference in the next lower
  precision in the program's place).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
KINDS = {"configs": ".json", "workloads": ".json", "entries": ".py", "metrics": ".py"}
FORBIDDEN = ("jax", "jaxlib", "flax", "voiceactivityprojection_tpu")


class UnknownName(LookupError):
    """A cell, configuration, entry or metric with no file of that name."""


def find(kind: str, name: str) -> Path:
    if kind not in KINDS:
        raise UnknownName(f"no kind {kind!r}")
    path = BENCH_DIR / kind / f"{name}{KINDS[kind]}"
    if "/" in name or name.startswith(".") or not path.is_file():
        raise UnknownName(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)} is missing)")
    return path


def load_json(kind: str, name: str) -> Dict:
    return json.loads(find(kind, name).read_text())


def load_module(kind: str, name: str) -> ModuleType:
    path = find(kind, name)
    spec = importlib.util.spec_from_file_location(f"vapbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def benchmark(path: Optional[Path] = None) -> Dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """The cell's end-to-end metrics and its per-layer ones: those listing
    the cell, and those without a list that move a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def seed_word(seed: int, *path: int) -> int:
    """A 63-bit word hashed from the run's seed and a path of integers."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, *[int(p) for p in path]]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuBLAS and cuDNN float32 work, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@dataclass
class Context:
    """What an entry and a metric reader see of a run."""

    cell: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    window: Dict = field(default_factory=dict)
    counts: Dict = field(default_factory=dict)
    profile: Optional[Dict] = None
    stage_ms: Dict[str, float] = field(default_factory=dict)
    started: float = field(default_factory=time.perf_counter)

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]

    @property
    def dtype(self) -> str:
        return self.config["dtype"]

    def word(self, *path: int) -> int:
        return seed_word(self.seed, *path)

    def note(self, what: str) -> None:
        """A set-up stage's time on standard error."""
        print(f"vapbench: {what} at {time.perf_counter() - self.started:.2f} s of set-up", file=sys.stderr,
              flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_context(cell: str, seed: int, seconds: float, trace: bool, device,
                 overrides: Optional[Dict] = None) -> Context:
    """The cell's files by name; ``overrides`` ({"traffic": {...}, "model":
    {...}}) shrink a cell for tests."""
    workload = load_json("workloads", cell)
    config = load_json("configs", workload["config"])
    if overrides:
        workload = {**workload, "traffic": {**workload["traffic"], **overrides.get("traffic", {})}}
        config = {**config, "model": {**config["model"], **overrides.get("model", {})}}
    return Context(cell, workload, config, int(seed), float(seconds), bool(trace), torch.device(device))


def apply_precision(config: Dict) -> None:
    """The configuration's precision flags."""
    flags = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["cuda_matmul_allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
    torch.set_float32_matmul_precision(flags["float32_matmul_precision"])


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def seconds_since_process_start() -> float:
    """Seconds since this process was created (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


# ------------------------------------------------------------------ window --
def run_window(entry: ModuleType, state, ctx: Context) -> Dict:
    """Calls back to back for ``ctx.seconds``, then ``finish``: the window
    ends when the last call's work is done. Each call's host time is kept."""
    lat: List[float] = []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    now = start
    while now < deadline:
        entry.call(state)
        t = time.perf_counter()
        lat.append(t - now)
        now = t
    entry.finish(state)
    ctx.sync()
    elapsed = time.perf_counter() - start
    return {"elapsed_s": elapsed, "calls": len(lat), "call_s": lat}


# ------------------------------------------------------------------- trace --
def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize_trace(device_ops: Sequence[Tuple[str, float, float]], window_s: float, calls: int) -> Dict:
    """Device busy time (the union of the operations' intervals), kernel
    seconds by name, launches and the costliest device operations. Times in
    microseconds in, seconds out."""
    by_name: Dict[str, float] = {}
    launches = 0
    for name, a, b in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    busy = _union([(a, b) for _, a, b in device_ops])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": window_s,
        "calls": calls,
        "kernel_s": by_name,
        "launches": launches,
        "breakdown": {"device_ops": [[k[:160], v] for k, v in top]},
    }


def idle_gaps(device_ops: Sequence[Tuple[str, float, float]], host_ops: Sequence[Tuple[str, float, float]]) -> List:
    """The longest gaps between device operations, summed by the innermost
    host operation running when each began: [[name, seconds], ...], ten at
    most."""
    busy = _union([(a, b) for _, a, b in device_ops])
    host = sorted(host_ops, key=lambda e: e[1])
    starts = [e[1] for e in host]
    edges = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps: Dict[str, float] = {}
    for a, b in sorted((e for e in edges if e[1] > e[0]), key=lambda e: e[0] - e[1])[:200]:
        label = _host_label(host, starts, a)
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return [[k[:160], v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]


def _host_label(host, starts, t: float, depth: int = 5000) -> str:
    """The innermost host operation running at ``t``: the latest-starting
    of the ``depth`` operations begun before it that has not ended."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - depth):i]):
        if e[2] > t:
            return e[0]
    return "no host operation"


def _profiled(entry: ModuleType, state, ctx: Context, calls: int, host: bool):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = ctx.device.type == "cuda"
    activities = ([ProfilerActivity.CUDA] if cuda else []) + ([ProfilerActivity.CPU] if host or not cuda else [])
    ctx.sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            entry.call(state)
        entry.finish(state)
        ctx.sync()
        window_s = time.perf_counter() - t0
    dev, host_ops = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else host_ops).append(rec)
    return dev, host_ops, window_s


def trace_calls(entry: ModuleType, state, ctx: Context, calls: int) -> Dict:
    """``calls`` more calls with the profiler recording the device only
    (busy time, kernels, launches: the host keeps its pace), then a third as
    many recording the host too, whose operations name the idle gaps."""
    dev, _, window_s = _profiled(entry, state, ctx, calls, host=False)
    summary = summarize_trace(dev, window_s, calls)
    dev, host_ops, _ = _profiled(entry, state, ctx, max(1, calls // 3), host=True)
    summary["breakdown"]["idle_gaps"] = idle_gaps(dev, host_ops)
    return summary


def time_stage(fn: Callable[[], object], ctx: Context, iters: int, warmup: int = 2) -> float:
    """ms a call of ``fn``: chained calls between two CUDA events after a
    warm-up (the host clock off the card)."""
    for _ in range(warmup):
        fn()
    ctx.sync()
    if ctx.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ctx.sync()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


# ------------------------------------------------------------------ verdict --
def verdict(checks: Sequence[Tuple[str, float, float]]) -> bool:
    """Correct when every number compared is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------- run --
def run_cell(ctx: Context, control: bool = False, setup_clock: Optional[Callable[[], float]] = None) -> Dict:
    """Set-up, window, trace (``ctx.trace``), comparison: the result line's
    fields, and the numbers compared under ``checks``."""
    bench = benchmark()
    e2e, layer = cell_metrics(bench, ctx.cell)
    if not e2e:
        raise UnknownName(f"cell {ctx.cell!r} is not in BENCHMARK.json")
    entry = load_module("entries", ctx.workload["entry"])
    readers = {m["name"]: load_module("metrics", m["name"]) for m in layer} if ctx.trace else {}
    ctx.started = time.perf_counter()
    state = entry.setup(ctx)
    ctx.sync()
    setup_s = setup_clock() if setup_clock else None
    print(f"vapbench: set-up done at {setup_s} s", file=sys.stderr, flush=True)
    ctx.window = run_window(entry, state, ctx)
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    ctx.counts = entry.counts(state)
    metrics: Dict[str, Dict] = {}
    if not ctx.trace:
        values = entry.end_to_end(state, ctx.window)
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx.profile = trace_calls(entry, state, ctx, int(ctx.workload["trace_calls"]))
        iters = int(ctx.workload.get("stage_iters", 5))
        ctx.stage_ms = {name: time_stage(fn, ctx, iters) for name, fn in entry.stages(state).items()}
        for m in layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    pct = np.percentile(ctx.window["call_s"], [50, 90, 95, 99, 100]) * 1e3
    print(f"vapbench: window of {ctx.window['calls']} calls in {ctx.window['elapsed_s']:.3f} s; call ms p50 p90 p95 "
          f"p99 max {' '.join(f'{v:.3f}' for v in pct)}", file=sys.stderr, flush=True)
    failed = int(getattr(state, "failed", 0))
    entry.release(state)
    checks = entry.check(state, control)
    out = {
        "correct": verdict(checks),
        "attempted": ctx.window["calls"],
        "failed": failed,
        "metrics": metrics,
        "device": device_info(ctx, memory_peak),
    }
    if ctx.trace:
        out["breakdown"] = ctx.profile["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def device_info(ctx: Context, memory_peak: int) -> Dict:
    if ctx.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                "count": int(ctx.workload["chips"]), "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if ctx.trace and ctx.profile:
        info["busy_s"] = ctx.profile["busy_s"]
        info["window_s"] = ctx.profile["window_s"]
    return info

"""Timing of one stage of a forward or a train step, for the profile tools.

``time_stage`` calls a stage ``warmup`` times, then ``iters`` times between
two CUDA events on the card (the device's time for the chained calls, the
host's enqueue hidden where the card is the slower side), or on the host
clock on the CPU, and reads the launch ledger (``ops/_build.py``) around
the timed calls: each op's launches a call, without its auxiliary kernels.
It prints one line, ``name  ms`` with the roofline where the stage's FLOPs
are given and the launches a call, and returns them as a dict.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from voiceactivityprojection_tpu_torch.ops import _build


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_stage(name: str, fn: Callable[[], object], device: torch.device, iters: int = 10, warmup: int = 3,
               gflops: Optional[float] = None, peak: Optional[float] = None, width: int = 38) -> Dict:
    """ms a call of ``fn`` (the mean of ``iters`` chained calls after
    ``warmup``), its launches a call, and where ``gflops`` (a call) is given
    the TFLOP/s and, with the card's ``peak`` TFLOP/s, the share of it;
    ``value`` is the last call's output where it is a scalar tensor."""
    out = None
    for _ in range(warmup):
        out = fn()
    sync(device)
    before = _build.launch_counts()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        sync(device)
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
    ran = _build.launch_totals(_build.launches_since(before))
    launches = {k: n / iters for k, n in ran.items() if n}
    rec: Dict = {"ms": ms, "launches": launches}
    line = f"{name:{width}s} {ms:8.2f} ms"
    if gflops is not None:
        tfps = gflops / ms  # G / ms == T / s
        rec.update(gflop=gflops, tflops=tfps)
        line += f"  {gflops:9.1f} G  {tfps:7.1f} TFLOP/s"
        if peak:
            rec["peak_pct"] = 100 * tfps / peak
            line += f"  {rec['peak_pct']:5.1f}% peak"
    if launches:
        line += "  launches " + " ".join(f"{k}={v:g}" for k, v in launches.items())
    if isinstance(out, torch.Tensor) and out.dim() == 0:
        rec["value"] = float(out)
    print(line, flush=True)
    return rec

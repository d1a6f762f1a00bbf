"""What the per-layer metric files read: each returns None where its run
has nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from vapbench.counts.peaks import share_pct

# device kernels of each roofline, by the names their launches carry
KERNEL_NAMES = {
    "conv_stack": ("conv_cn_relu_", "split_tf32_kmajor_"),
    "gru_backward": ("gru_bwd_",),
    "flash_train": ("flash_train_fwd_", "flash_train_dkv_", "flash_train_dq_"),
}


def mfu_pct(ctx) -> Optional[float]:
    """The whole call's least time (operations at the dtype's peak, or its
    bytes at the bandwidth) over the window's time a call."""
    call = ctx.counts.get("call")
    if not call or not ctx.window.get("calls"):
        return None
    return share_pct(call["flops"], call["bytes"], ctx.dtype, ctx.window["elapsed_s"] / ctx.window["calls"])


def idle_pct(ctx) -> Optional[float]:
    """The share of the window's time a call in which no device operation
    runs: 1 - the device's busy time a call in the traced stretch over the
    window's time a call. The stretch's own length is not the base: the
    profiler's work on every launch slows the host there, and so widens
    its gaps, where the host sets the pace."""
    prof = ctx.profile
    if not prof or prof["busy_s"] <= 0 or not ctx.window.get("calls"):
        return None
    return 100.0 * (1.0 - (prof["busy_s"] / prof["calls"]) / (ctx.window["elapsed_s"] / ctx.window["calls"]))


def launches_per_call(ctx) -> Optional[float]:
    prof = ctx.profile
    if not prof or prof["launches"] == 0:
        return None
    return prof["launches"] / prof["calls"]


def kernel_seconds(ctx, patterns: Sequence[str]) -> float:
    prof = ctx.profile or {}
    return sum(s for name, s in prof.get("kernel_s", {}).items() if any(p in name for p in patterns))


def roofline_pct(ctx, kernel: str) -> Optional[float]:
    """A kernel's least time from its shapes over its device time a call."""
    bound = ctx.counts.get("kernels", {}).get(kernel)
    seconds = kernel_seconds(ctx, KERNEL_NAMES[kernel])
    if not bound or seconds <= 0:
        return None
    return share_pct(bound["flops"], bound["bytes"], ctx.dtype, seconds / ctx.profile["calls"])


def stage_ms(ctx, stage: str) -> Optional[float]:
    return ctx.stage_ms.get(stage)


def call_p50_ms(ctx) -> Optional[float]:
    times = ctx.window.get("call_s")
    return 1e3 * statistics.median(times) if times else None

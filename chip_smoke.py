#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit;
2. build: compiles every CUDA kernel of ``voiceactivityprojection_tpu_torch/csrc``;
3. kernels vs their plain PyTorch versions on the card at main-path shapes,
   in float32 with TF32 off and in bfloat16: the conv stack (R=8 x 320000
   samples and a ragged length) and, in float32, its backward against
   autograd of the plain stack; GRU+downsample (2B=8 x 2000 steps and an
   odd length), inference attention (B=8, H=4, T=1000 and T=3000) and its
   backward, the GRU recurrence (R=32 x 2000 steps, R=3 x 1999), the GRU
   backward (R=32 x 2000, R=3 x 1999, R=32 x 128; in float32 also against
   autograd of the plain forward), the training attention forward (out and
   lse) and backward (dq, dk, dv) at B=16, H=4, T=1000 and B=2, T=3000 with
   dropout 0, 0.1 and 0.5; the offset attention (B=1, H=4, Tq=1500 at
   offsets 0, 1500, 4500 of Tk=6000, and Tq=1000 at 2337 of 3337); conv0 +
   conv1 (R=8 x 320000 and a ragged length) and, in float32, its backward
   against autograd of the plain layers (R=2); and the kernels without a
   backward (K2, K10) refusing a grad-requiring input;
4. the inference slice: ``VapModel(VapConfig())`` on the card with weights
   drawn from a seed in the JAX params layout, serving requests of
   (B, 2, 320000) through ``probs`` in float32 and bfloat16, with every
   kernel's launch counter read around the bfloat16 run, and one request
   checked against the same port on the CPU (plain path, float32);
5. the training slice: the frozen-encoder train step at ``VapConfig()``
   widths (dropout 0.1, AdamW) on B=16 x 20 s batches, three steps in
   bfloat16 and three in float32 with the launch counters read around each
   step, the frozen weights checked unchanged and the trained ones moved;
   one eval step; one float32 step on the card against the same step on
   the CPU at dropout 0 and at 0.1 (the elementwise masks drawn on the CPU
   for both), each running the training attention kernels;
6. the encoder-training slice: the unfrozen train step
   (``VapConfig(freeze_encoder=False)``) on B=16 x 20 s batches, three
   steps in bfloat16 with the launch counters read around each (the GRU
   backward once a step) and every weight moved, then timed steps and a
   profile of one; one float32 unfrozen step on the card against the CPU
   at dropout 0 (B=1 x 2 s); CPC pretraining (``train/cpc_pretrain.py``)
   at B=32 x 20480 samples, dim 256, 12 predicted steps, 128 negatives,
   float32: three checked steps (launch counters, a finite loss, the
   encoder moved and its unused downsample not), timed steps and a
   profile of one, and one step on the card against the CPU at B=4;
7. the long-audio slice: ``probs_context_parallel`` (and
   ``forward_context_parallel``) on 600 s of stereo over a 4-shard mesh
   that repeats the one card, float32 and bfloat16, with the default conv
   stage and with ``VAP_CONV_IMPL=fused``, the launch counters read around
   each call (the offset attention at 14 sites x 4 shards, the GRU
   recurrence once per shard, conv0 + conv1 once per shard under
   ``fused``) and the logits held against the single-device forward on the
   card; the bfloat16 single shot timed (audio-seconds/s, peak memory) and
   profiled;
8. the conv0 + conv1 kernel in stereo inference: ``probs`` at B=64 x 20 s
   bfloat16 under ``VAP_CONV_IMPL=fused`` (its launch per request, no conv
   stack kernel), against the default path and timed beside it, in turns;
9. the mono model (``VapMonoModel``, with the history conditioning) at B=8
   x 20 s float32 on the card, its launches, against the CPU;
10. times: audio-seconds/s of ``probs`` at B=64, 20 s chunks, bfloat16 and
   of the train step at B=16, 20 s chunks, bfloat16 (ms per step, peak
   memory, a profile of one step); each kernel's time with CUDA events
   beside its bound, its plain version's time and one PyTorch library call
   that computes the same function (timed as a yardstick only; the port
   never calls it); the GRU backward at the unfrozen step's and the CPC
   step's shapes; the offset attention at one site of the 600 s call; conv0
   + conv1 at the B=64 request's shape.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
A full report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
CHUNK_S = 20.0
SR = 16_000
REPORT: dict = {}


def emit(phase: str, **fields) -> None:
    REPORT.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean device time of fn() over reps, after warm-up (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    check(bool(torch.isfinite(a).all()), "kernel output is finite")
    return float((a.float() - b.float()).abs().max())


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile(fn, what: str, **fields) -> None:
    """One call of fn under torch.profiler: device busy time per kernel
    name and the device's idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:80], [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    emit("profile", what=what, **fields, wall_ms=wall_ms,
         device_busy_ms=busy_ms if busy_ms else "not measured",
         idle_share=1 - busy_ms / wall_ms if busy_ms else "not measured",
         top_kernels=[{"name": k, "ms": ms, "count": c} for k, (ms, c) in top])


# ------------------------------------------------------------------ kernels --
# Tolerances, kernel vs plain version on the same inputs (max abs error).
# float32: the same arithmetic summed in another order (measured on an
# H100: conv 5.5e-6, GRU+downsample 5.6e-6, attention 4.8e-7, GRU
# recurrence 2.2e-7, training attention forward 7.2e-7 and lse 9.5e-7;
# the training backward against its plain version 0 at T >= 77, where
# cuBLAS sums in the kernel's order, and 6.3e-7 at T=1).
F32_TOL = {"conv_stack": 1e-4, "gru_downsample": 5e-5, "flash_alibi": 5e-6,
           "gru_recurrence": 5e-6, "flash_train_forward": 5e-6, "lse": 5e-6,
           "flash_train_backward": 5e-5, "flash_alibi_offset": 5e-6, "conv01": 1e-4}
# float32, held relative to the output's largest magnitude (at least 1):
# the GRU backward's dW_hh / db_hh sum R*T terms in another order, and its
# carry runs through T steps; the conv stack's backward is the plain
# stack's autograd on either side, apart from the kernel's forward sums
F32_REL = {"gru_backward": 1e-5, "conv_stack_backward": 1e-4, "conv01_backward": 1e-4}
# bfloat16: a sum that lands on the other side of a rounding boundary moves
# an output by one bf16 step (2^-7 of its magnitude's power of two). The
# tolerance is that many steps at the largest output magnitude: attention
# rounds p and the output (2); GRU+downsample the LayerNorm output before
# GELU and the output (2); the conv stack rounds every layer's output and,
# in the plain version, each conv sum before its ChannelNorm, and a step
# moves the next layer's statistics (4); the GRU recurrence rounds only
# its output, from an f32 carry (2); the training forward rounds p and the
# output (2); the backward rounds Y, dS and its outputs (3); the offset
# attention as attention (2); conv0 + conv1 as the conv stack (4). lse is f32
# in either mode and keeps the float32 bar.
BF16_STEPS = {"conv_stack": 4, "gru_downsample": 2, "flash_alibi": 2, "gru_recurrence": 2,
              "flash_train_forward": 2, "flash_train_backward": 3, "gru_backward": 2,
              "flash_alibi_offset": 2, "conv01": 4}
# the backward against autograd through the masked dense forward, float32:
# another algorithm (dP = dO V^T and the softmax gradient from lse and
# delta), held relative to the largest gradient; the GRU backward against
# autograd of the plain forward loop likewise
VS_AUTOGRAD_REL = 2e-5


def compare(name, got, want, shape, dtype, **fields) -> float:
    sync()
    err = max_err(got, want)
    top = max(float(want.float().abs().max()), 1.0)
    if name in F32_REL and dtype == torch.float32:
        tol = F32_REL[name] * top
    elif dtype == torch.float32 or name == "lse":
        tol = F32_TOL[name]
    else:
        tol = BF16_STEPS[name] * 2.0 ** (math.floor(math.log2(top)) - 7)
    emit("kernel_check", kernel=name, shape=shape, dtype=str(dtype), **fields, max_abs_err=err, tol=tol)
    check(err <= tol, f"{name} {dtype} {shape} {fields}: {err} > {tol}")
    return err


def conv_stack_case(port, layers, R, n, dtype, gen):
    k1 = port["k1"]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dtype)
    lw = [tuple(t.to(dtype) for t in l) for l in layers]
    compare("conv_stack", k1.fused_conv_stack(lw, x), k1.reference_stack(lw, x), [R, n], dtype)


def gru_ds_case(port, enc, R, T, dtype, gen):
    k2 = port["k2"]
    H = enc.gAR.w_hh.shape[0]
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to("cuda", dtype)
    g, d = enc.gAR, enc.downsample
    args = [x_proj, g.w_hh, g.b_hh, torch.zeros(R, H, device="cuda"), d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    args = [a.to(dtype).contiguous() for a in args]
    compare("gru_downsample", k2.gru_downsample_fused(*args), k2.gru_downsample_reference(*args),
            [R, T, 3 * H], dtype)


def attention_case(port, B, H, T, Dh, dtype, gen):
    k4 = port["k4"]
    q, k, v = ((torch.randn(B, H, T, Dh, generator=gen)).to("cuda", dtype) for _ in range(3))
    slopes = port["alibi_slopes"](H).to("cuda")
    scale = 1.0 / math.sqrt(H * Dh)
    compare("flash_alibi", k4.flash_alibi_attention(q, k, v, slopes, scale),
            k4.dense_reference(q, k, v, slopes, scale), [B, H, T, Dh], dtype)


def offset_attention_case(port, Tq, Tk, off, dtype, gen):
    """K10 for the Tq query rows at global offset ``off`` of Tk keys (B=1,
    H=4, Dh=64, the context-parallel shard shape) against its plain version."""
    k4 = port["k4"]
    q = torch.randn(1, 4, Tq, 64, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(1, 4, Tk, 64, generator=gen).to("cuda", dtype) for _ in range(2))
    slopes = port["alibi_slopes"](4).to("cuda")
    compare("flash_alibi_offset", k4.flash_alibi_attention_offset(q, k, v, slopes, 1 / 16, off),
            k4.dense_offset_reference(q, k, v, slopes, 1 / 16, off), [1, 4, Tq, 64], dtype, Tk=Tk, offset=off)


def conv01_case(port, layers, R, n, dtype, gen):
    k11 = port["k11"]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dtype)
    lw = [tuple(t.to(dtype) for t in l) for l in layers[:2]]
    compare("conv01", k11.fused_conv01(lw, x), k11.reference_unfused(lw, x), [R, n], dtype)


def conv01_backward_case(port, layers, R, n, gen):
    """K11's backward (autograd through the plain layers on the saved inputs,
    as JAX ``_vjp_bwd``) against autograd through ``reference_unfused``,
    float32. Returns the largest error."""
    k11 = port["k11"]
    lw = [tuple(t.detach().clone().requires_grad_() for t in l) for l in layers[:2]]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda").requires_grad_()
    leaves = [x, *(t for l in lw for t in l)]
    cot = torch.randn(R, k11.out_len(n), 256, generator=gen).to("cuda")
    got = torch.autograd.grad(k11.fused_conv01(lw, x), leaves, cot)
    want = torch.autograd.grad(k11.reference_unfused(lw, x), leaves, cot)
    names = ["x"] + [f"layer{i}.{p}" for i in range(2) for p in ("conv.w", "conv.b", "norm.w", "norm.b")]
    return max(compare("conv01_backward", g, w, [R, n], torch.float32, grad=nm)
               for nm, g, w in zip(names, got, want))


def attention_backward_case(port, B, H, T, Dh, gen):
    """The inference kernel's backward (a dense recompute under autograd)
    against autograd through ``dense_reference``, float32."""
    k4 = port["k4"]
    leaves = [torch.randn(B, H, T, Dh, generator=gen).to("cuda").requires_grad_() for _ in range(3)]
    cot = torch.randn(B, H, T, Dh, generator=gen).to("cuda")
    slopes = port["alibi_slopes"](H).to("cuda")
    scale = 1.0 / math.sqrt(H * Dh)
    got = torch.autograd.grad(k4.flash_alibi_attention(*leaves, slopes, scale), leaves, cot)
    want = torch.autograd.grad(k4.dense_reference(*leaves, slopes, scale), leaves, cot)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        compare("flash_alibi", g, w, [B, H, T, Dh], torch.float32, grad=name)


def gru_recurrence_case(port, enc, R, T, dtype, gen):
    k3 = port["k3"]
    H = enc.gAR.w_hh.shape[0]
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to("cuda", dtype)
    h0 = (0.1 * torch.randn(R, H, generator=gen)).to("cuda", dtype)
    args = [x_proj, enc.gAR.w_hh.to(dtype).contiguous(), enc.gAR.b_hh.to(dtype), h0]
    ys, h_last = k3.gru_recurrence(*args)
    want, _ = k3.gru_recurrence_reference(*args)
    check(torch.equal(h_last, ys[:, -1]), "gru_recurrence h_last is ys[:, -1]")
    return compare("gru_recurrence", ys, want, [R, T, 3 * H], dtype)


def train_attention_case(port, B, H, T, Dh, rate, dtype, gen):
    """The training forward (out, lse) and backward (dq, dk, dv) against the
    plain versions; in float32 the backward also against autograd through
    the masked dense forward. Returns the largest bf16/f32 errors."""
    ft = port["ft"]
    q, k, v, do = ((torch.randn(B, H, T, Dh, generator=gen)).to("cuda", dtype) for _ in range(4))
    slopes = port["alibi_slopes"](H).to(dtype).to("cuda")
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    scale = 1.0 / math.sqrt(H * Dh)
    shape = [B, H, T, Dh]
    out, lse = ft.flash_train_forward(q, k, v, slopes, seed, scale, rate)
    want, want_lse = ft.train_forward_reference(q, k, v, slopes, seed, scale, rate)
    e_fwd = compare("flash_train_forward", out, want, shape, dtype, rate=rate, output="out")
    compare("lse", lse, want_lse, shape, dtype, rate=rate)
    got = ft.flash_train_backward(q, k, v, slopes, seed, out, lse, do, scale, rate)
    delta = (do.float() * out.float()).sum(-1).reshape(B * H, T)
    plain = ft.train_backward_reference(q, k, v, do, lse, delta, slopes, seed, scale, rate)
    e_bwd = max(compare("flash_train_backward", g, w, shape, dtype, rate=rate, grad=n)
                for n, g, w in zip(("dq", "dk", "dv"), got, plain))
    del plain
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref, _ = ft.train_forward_reference(*leaves, slopes, seed, scale, rate)
        for n, g, w in zip(("dq", "dk", "dv"), got, torch.autograd.grad(ref, leaves, do)):
            err = max_err(g, w)
            tol = VS_AUTOGRAD_REL * max(float(w.abs().max()), 1.0)
            emit("kernel_check", kernel="flash_train_backward", vs="autograd of the masked dense forward",
                 shape=shape, dtype=str(dtype), rate=rate, grad=n, max_abs_err=err, tol=tol)
            check(err <= tol, f"flash_train_backward vs autograd {n} {shape} rate {rate}: {err} > {tol}")
    return e_fwd, e_bwd


def refuses_grad_case(port, enc, layers):
    """K2 and K10, which have no backward (nor have JAX's), raise on a
    grad-requiring CUDA input instead of returning a result cut from the
    autograd graph; K1, K3 and K11 record their backward."""
    k1, k2, k3, k4, k11 = port["k1"], port["k2"], port["k3"], port["k4"], port["k11"]
    lw = [tuple(t.detach().requires_grad_() for t in l) for l in layers]
    x = torch.zeros(2, 3200, device="cuda")
    g, d = enc.gAR, enc.downsample
    H = g.w_hh.shape[0]
    xp = torch.zeros(2, 8, 3 * H, device="cuda")
    w_hh = g.w_hh.detach().clone().requires_grad_()
    args = [xp, w_hh, g.b_hh, torch.zeros(2, H, device="cuda"), d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    q = torch.zeros(1, 4, 64, 64, device="cuda", requires_grad=True)
    slopes = port["alibi_slopes"](4).to("cuda")
    raised = {}
    for name, call in (("gru_downsample", lambda: k2.gru_downsample_fused(*args)),
                       ("flash_alibi_offset", lambda: k4.flash_alibi_attention_offset(q, q, q, slopes, 0.1, 0))):
        try:
            call()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e)[:100]
    graphs = {"conv_stack": k1.fused_conv_stack(lw, x).grad_fn is not None,
              "gru_recurrence": k3.gru_recurrence(*args[:4])[0].grad_fn is not None,
              "conv01": k11.fused_conv01(lw, x).grad_fn is not None}
    emit("refuses_grad", raised=raised, records_backward=graphs)
    check(all(r is not None for r in raised.values()), f"a kernel without a backward ran: {raised}")
    check(all(graphs.values()), f"a kernel with a backward left the graph: {graphs}")


def conv_stack_backward_case(port, layers, R, n, gen):
    """K1's backward (autograd through the plain stack on the saved inputs,
    as JAX ``_vjp_bwd``) against autograd through ``reference_stack``,
    float32. Returns the largest error and both routes' forward+backward
    times."""
    k1 = port["k1"]
    lw = [tuple(t.detach().clone().requires_grad_() for t in l) for l in layers]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda").requires_grad_()
    leaves = [x, *(t for l in lw for t in l)]
    cot = torch.randn(R, n // 160, 256, generator=gen).to("cuda")
    got = torch.autograd.grad(k1.fused_conv_stack(lw, x), leaves, cot)
    want = torch.autograd.grad(k1.reference_stack(lw, x), leaves, cot)
    names = ["x"] + [f"layer{i}.{p}" for i in range(len(lw)) for p in ("conv.w", "conv.b", "norm.w", "norm.b")]
    err = max(compare("conv_stack_backward", g, w, [R, n], torch.float32, grad=nm)
              for nm, g, w in zip(names, got, want))
    del got, want
    ms = cuda_ms(lambda: torch.autograd.grad(k1.fused_conv_stack(lw, x), leaves, cot), reps=2, warmup=1)
    plain = cuda_ms(lambda: torch.autograd.grad(k1.reference_stack(lw, x), leaves, cot), reps=2, warmup=1)
    return err, ms, plain


def gru_backward_case(port, enc, R, T, dtype, gen):
    """K9 against its plain version on the same inputs (ys from K3); in
    float32 also K3 + K9 through ``gru_recurrence`` against autograd of the
    plain forward loop. Returns the largest error against the plain version."""
    k3 = port["k3"]
    H = enc.gAR.w_hh.shape[0]
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to("cuda", dtype)
    h0 = (0.1 * torch.randn(R, H, generator=gen)).to("cuda", dtype)
    dys = torch.randn(R, T, H, generator=gen).to("cuda", dtype)
    args = [x_proj, enc.gAR.w_hh.to(dtype).contiguous(), enc.gAR.b_hh.to(dtype), h0]
    ys, _ = k3.gru_recurrence(*args)
    got = k3.gru_backward(*args, ys, dys)
    want = k3.gru_backward_reference(*args, ys, dys)
    names = ("dx_proj", "dw_hh", "db_hh", "dh0")
    err = max(compare("gru_backward", g, w, [R, T, 3 * H], dtype, grad=nm)
              for nm, g, w in zip(names, got, want))
    if dtype == torch.float32:
        leaves = [a.clone().requires_grad_() for a in args]
        dh = torch.randn(R, H, generator=gen).to("cuda")
        ys_k, h_k = k3.gru_recurrence(*leaves)
        got = torch.autograd.grad((ys_k * dys).sum() + (h_k * dh).sum(), leaves)
        ys_p, h_p = k3.gru_recurrence_reference(*leaves)
        want = torch.autograd.grad((ys_p * dys).sum() + (h_p * dh).sum(), leaves)
        for nm, g, w in zip(names, got, want):
            e = max_err(g, w)
            tol = VS_AUTOGRAD_REL * max(float(w.abs().max()), 1.0)
            emit("kernel_check", kernel="gru_backward", vs="autograd of the plain forward",
                 shape=[R, T, 3 * H], dtype=str(dtype), grad=nm, max_abs_err=e, tol=tol)
            check(e <= tol, f"gru_backward vs autograd {nm} {[R, T]}: {e} > {tol}")
    return err


# the port on the card vs the same port on the CPU (float32, plain path):
# the JAX package's bars against the reference; bf16 on the card vs f32 on
# the CPU is held to the bf16 slice test's bound (tests/test_torch_model.py)
VS_CPU_TOL = {"logits": 1e-3, "p_now": 2e-4, "p_future": 2e-4, "H": 1e-3}
VS_CPU_BF16_TOL = 2e-3
# context parallelism on the card vs the single-device forward on the card,
# float32 (the JAX package's bar against its single-device forward)
CP_F32_TOL = 2e-4
LONG_S = 600.0  # seconds of stereo audio in one context-parallel call
CP_SHARDS = 4  # time shards of that call, all on the one card
# the mono model on the card vs the CPU, float32 (the JAX package's bar)
MONO_VS_CPU_TOL = 2e-4
# one dropout-free float32 train step on the card vs the CPU: losses, each
# gradient relative to its leaf's largest, updated weights where the
# gradient is clear of that bound and of 1e-6 (Adam's first step is about
# lr * sign(g), so an update flips with a gradient near 0); measured on an
# H100: 4.8e-7, 6.4e-6, and 6.0e-8 / 3.1e-7 in two runs before the 1e-6 floor
TRAIN_VS_CPU_TOL = {"loss": 1e-5, "grad_rel": 1e-4, "update": 5e-7}
FROZEN = ("encoder.gEncoder.", "encoder.gAR.")


@contextlib.contextmanager
def masks_drawn_on_cpu():
    """For the card-vs-CPU train step only: the elementwise dropout masks
    drawn on the CPU from the seed of the step's masks generator and moved
    to the activations' device. On the CPU these are the port's own masks;
    on the card they replace the device generator's, whose stream differs,
    so both steps drop the same elements. The attention masks are the
    kernels' coordinate hash on either device and stay as they are."""
    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    on_device = DropoutRng.dropout

    def dropout(self, x, rate):
        if rate <= 0.0:
            return x
        if not hasattr(self, "cpu_masks"):
            self.cpu_masks = torch.Generator().manual_seed(self.masks.initial_seed())
        keep = (torch.rand(x.shape, generator=self.cpu_masks) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    DropoutRng.dropout = dropout
    try:
        yield
    finally:
        DropoutRng.dropout = on_device


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from voiceactivityprojection_tpu_torch import VapConfig, VapModel
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapNet
    from voiceactivityprojection_tpu_torch.config import VapMonoConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapMonoModel, forward
    from voiceactivityprojection_tpu_torch.ops import _build
    from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
    from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
    from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
    from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
    from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
    from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
    from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
    from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, layer_norm
    from voiceactivityprojection_tpu_torch.parallel.context import (
        MARGIN_FRAMES as cp_margin,
        forward_context_parallel,
        probs_context_parallel,
    )
    from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain as cpc
    from voiceactivityprojection_tpu_torch.train import step as tstep

    port = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k11": k11, "ft": ft, "alibi_slopes": alibi_slopes}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {n: [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
             for n, log in logs.items()}
    emit("build", seconds=build_s, built=sorted(logs), ptxas=ptxas)
    check(all(_build.library_path(s).exists() for s in _build.SOURCES), "every source built")

    conf = VapConfig()
    state = ckpt.params_from_jax(ckpt.random_params_tree(conf, seed=0), conf)
    net = VapNet(conf)
    net.load_state_dict(state)
    net.requires_grad_(False)  # the inference phases: the weights carry no grad
    enc = net.encoder.to("cuda")
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    gen = torch.Generator().manual_seed(0)

    # 3. kernels vs plain ------------------------------------------------------
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (320_000, 12_345):
            conv_stack_case(port, layers, 8, n, dtype, gen)
        for T in (2000, 1999):
            gru_ds_case(port, enc, 8, T, dtype, gen)
        for T in (1000, 3000):
            attention_case(port, 8, 4, T, 64, dtype, gen)
        for R, T in ((32, 2000), (3, 1999)):
            e = gru_recurrence_case(port, enc, R, T, dtype, gen)
            errs.setdefault(("gru_recurrence", dtype), e)
        for R, T in ((32, 2000), (3, 1999), (32, 128)):
            e = gru_backward_case(port, enc, R, T, dtype, gen)
            errs.setdefault(("gru_backward", dtype), e)
            torch.cuda.empty_cache()
        for B, T in ((16, 1000), (2, 3000)):
            for rate in (0.1, 0.5, 0.0):
                e_fwd, e_bwd = train_attention_case(port, B, 4, T, 64, rate, dtype, gen)
                if (B, rate) == (16, 0.1):
                    errs[("flash_train_forward", dtype)] = e_fwd
                    errs[("flash_train_backward", dtype)] = e_bwd
                torch.cuda.empty_cache()
        for Tq, Tk, off in ((1500, 6000, 0), (1500, 6000, 1500), (1500, 6000, 4500), (1000, 3337, 2337)):
            offset_attention_case(port, Tq, Tk, off, dtype, gen)
        for n in (320_000, 12_345):
            conv01_case(port, layers, 8, n, dtype, gen)
        # the shape one shard of the long-audio call gives it: both channels
        # of its 100 Hz frames plus the margin frames on each side
        t100_shard = 2 * int(LONG_S * SR) // 320 // CP_SHARDS
        conv01_case(port, layers, 2, (t100_shard + 2 * cp_margin) * 160, dtype, gen)
        torch.cuda.empty_cache()
    attention_backward_case(port, 16, 4, 1000, 64, gen)
    conv_bwd = conv_stack_backward_case(port, layers, 8, 320_000, gen)
    conv01_bwd = conv01_backward_case(port, layers, 2, 320_000, gen)
    refuses_grad_case(port, enc, layers)
    torch.cuda.empty_cache()

    # 4. the inference slice ---------------------------------------------------
    counters = {"conv_stack": k1.fused_conv_stack, "gru_downsample": k2.gru_downsample_fused,
                "flash_alibi": k4.flash_alibi_attention, "gru_recurrence": k3.gru_recurrence,
                "flash_train_forward": ft.flash_train_forward,
                "flash_train_backward": ft.flash_train_backward, "gru_backward": k3.gru_backward,
                "flash_alibi_offset": k4.flash_alibi_attention_offset, "conv01": k11.fused_conv01}
    no_launch = dict.fromkeys(counters, 0)
    sites = 2 * conf.channel_layers + 4 * conf.cross_layers
    per_forward = dict(no_launch, conv_stack=5, gru_downsample=1, flash_alibi=sites)
    # the frozen-encoder train step: the conv stack kernel, the recurrence
    # kernel, the plain downsample, the training attention at every site
    per_train_step = dict(no_launch, conv_stack=5, gru_recurrence=1, flash_train_forward=sites,
                          flash_train_backward=sites)
    # the unfrozen step: the plain conv stack, K3 forward and K9 backward
    per_unfrozen_step = dict(per_train_step, conv_stack=0, gru_backward=1)
    # the CPC step: the plain conv stack and the GRU, no attention
    per_cpc_step = dict(per_unfrozen_step, flash_train_forward=0, flash_train_backward=0)
    n = int(CHUNK_S * SR)
    T50 = n // 320
    rng = np.random.default_rng(1)

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts():
        return {k: c.launches for k, c in counters.items()}

    def requests(B, count):
        return [(0.1 * rng.standard_normal((B, 2, n))).astype(np.float32) for _ in range(count)]

    def check_probs(out, B, what, T=T50):
        check(out["p_now"].shape == (B, T, 2) and out["H"].shape == (B, T), f"{what} shapes")
        for key in ("probs", "vad", "p_now", "p_future", "H"):
            check(bool(torch.isfinite(out[key]).all()), f"{what} {key} finite")
        s = out["probs"].sum(-1)
        check(float((s - 1).abs().max()) < 1e-3, f"{what} probs sum to 1")
        check(float(out["p_now"].min()) >= 0 and float(out["p_now"].max()) <= 1, f"{what} p_now in [0, 1]")

    def serve(model, reqs, B, what):
        reset_counts()
        t0 = time.perf_counter()
        outs = [model.probs(w) for w in reqs]
        sync()
        dt = time.perf_counter() - t0
        launches = read_counts()
        for out in outs:
            check_probs(out, B, what)
        for k, per in per_forward.items():
            check(launches[k] == per * len(reqs), f"{what}: {k} launched {launches[k]} times, "
                  f"expected {per} per forward")
        emit("serve", model=what, requests=len(reqs), batch=B, seconds=dt, launches=launches)
        return outs, launches

    # float32: 3 requests at B=8, then one request checked against the CPU
    m32 = VapModel(conf, state, device="cuda")
    serve(m32, requests(8, 3), 8, "float32")
    one = requests(1, 1)[0]
    g32 = m32.forward(one)
    p32 = m32.probs(one)
    cpu = VapModel(conf, state, device="cpu")
    c_out = cpu.forward(one)
    c_probs = cpu.probs(one)
    vs_cpu = {
        "logits": max_err(g32["logits"].cpu(), c_out["logits"]),
        **{k: max_err(p32[k].cpu(), c_probs[k]) for k in ("p_now", "p_future", "H")},
    }
    emit("vs_cpu", dtype="float32", max_abs_err=vs_cpu, tol=VS_CPU_TOL)
    for k, bar in VS_CPU_TOL.items():
        check(vs_cpu[k] <= bar, f"float32 card vs CPU {k}: {vs_cpu[k]} > {bar}")
    del m32, cpu
    torch.cuda.empty_cache()

    # bfloat16: the main path (counts read around it) and the throughput
    conf16 = VapConfig(dtype="bfloat16")
    m16 = VapModel(conf16, state, device="cuda")
    B = 64
    reqs = requests(B, 3)
    m16.probs(reqs[0])  # warm-up (allocator, library heuristics)
    sync()
    _, launches = serve(m16, reqs, B, "bfloat16")
    p16 = m16.probs(one)
    vs_cpu16 = {k: max_err(p16[k].cpu(), c_probs[k]) for k in ("p_now", "p_future")}
    emit("vs_cpu", dtype="bfloat16", max_abs_err=vs_cpu16, tol=VS_CPU_BF16_TOL)
    for k, e in vs_cpu16.items():
        check(e <= VS_CPU_BF16_TOL, f"bfloat16 card vs CPU float32 {k}: {e}")

    iters = 2 * len(reqs)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        m16.probs(reqs[i % len(reqs)])
    sync()
    dt = time.perf_counter() - t0
    emit("throughput", metric="audio_seconds_per_second", value=B * CHUNK_S * iters / dt, batch=B,
         chunk_s=CHUNK_S, dtype="bfloat16", iters=iters, seconds=dt, card=smi)
    x = torch.as_tensor(reqs[0], device="cuda")  # the waveform's copy stays out of the window
    profile(lambda: m16.probs(x), "probs", batch=B)
    del m16, reqs, x
    torch.cuda.empty_cache()

    # 5. the training slice ----------------------------------------------------
    TB = 16
    n_vad = int((CHUNK_S + 2) * 50)

    def train_batch(b, chunk_samples=n, vad_frames=n_vad):
        return {"waveform": (0.1 * rng.standard_normal((b, 2, chunk_samples))).astype(np.float32),
                "vad": (rng.random((b, vad_frames, 2)) < 0.4).astype(np.float32)}

    def train_net(c):
        tnet = VapNet(c)
        tnet.load_state_dict(state)
        tnet.to("cuda")
        opt = tstep.make_optimizer(OptConfig(), tnet, c.freeze_encoder)
        return tnet, tstep.make_train_step(c, opt)

    def train_steps(c, b, steps, what, expected):
        tnet, step = train_net(c)
        before = {k: p.detach().clone() for k, p in tnet.named_parameters()}
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in train_batch(b).items()}
                   for _ in range(2)]
        metrics, counts = [], []
        for i in range(steps):
            reset_counts()
            m = step(tnet, batches[i % 2], torch.Generator().manual_seed(i))
            sync()
            counts.append(read_counts())
            metrics.append({k: float(v) for k, v in m.items()})
        emit("train", dtype=c.dtype, batch=b, chunk_s=CHUNK_S, steps=steps, metrics=metrics,
             launches_per_step=counts, note=what)
        for i, (m, cnt) in enumerate(zip(metrics, counts)):
            check(all(math.isfinite(v) for v in m.values()), f"{c.dtype} step {i} loss finite: {m}")
            check(cnt == expected, f"{c.dtype} {what} step {i} launches {cnt}, expected {expected}")
        moved = {}
        for name, p in tnet.named_parameters():
            same = torch.equal(p.detach(), before[name])
            if c.freeze_encoder and name.startswith(FROZEN):
                check(same, f"{c.dtype}: frozen {name} changed")
            elif not c.freeze_encoder or name.startswith(("encoder.downsample.", "vap_head.")):
                moved[name] = not same
        check(all(moved.values()), f"{c.dtype} {what}: weights that did not move: "
              f"{[k for k, v in moved.items() if not v]}")
        return tnet, step, batches, counts

    def timed_steps(tnet, step, batches, what, iters=6):
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        for i in range(iters):
            m = step(tnet, batches[i % 2], torch.Generator().manual_seed(100 + i))
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        check(math.isfinite(loss), f"timed {what} train steps: loss finite")
        emit("train_throughput", metric="train_audio_seconds_per_second", value=TB * CHUNK_S * iters / dt,
             ms_per_step=dt / iters * 1e3, batch=TB, chunk_s=CHUNK_S, dtype="bfloat16", iters=iters,
             seconds=dt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi, encoder=what,
             note="batches already on the card; no augmentation (bench.py --train adds flip + noise)")
        profile(lambda: step(tnet, batches[0], torch.Generator().manual_seed(7)), "train_step",
                batch=TB, dtype="bfloat16", encoder=what)

    def grads_vs_cpu(pairs, metrics_cpu, metrics_card, keys):
        """Largest loss error, gradient error relative to each leaf's largest
        and updated-weight error where the gradient is clear of that bound
        and of 1e-6, over (name, cpu param, card param) ``pairs``."""
        loss_err = max(abs(metrics_cpu[k] - metrics_card[k]) for k in keys)
        grad_rel, upd = 0.0, 0.0
        for name, cp, gp in pairs:
            scale = max(float(cp.grad.abs().max()), 1e-30)
            grad_rel = max(grad_rel, float((gp.grad.cpu() - cp.grad).abs().max()) / scale)
            clear = cp.grad.abs() > max(1e-6, 2 * TRAIN_VS_CPU_TOL["grad_rel"] * scale)
            if bool(clear.any()):
                upd = max(upd, float((gp.detach().cpu() - cp.detach())[clear].abs().max()))
        return {"loss": loss_err, "grad_rel": grad_rel, "update": upd}

    def step_vs_cpu(conf_c, batch, expected, what):
        """One float32 step on the CPU and on the card from the same weights
        and batch (elementwise dropout masks drawn alike)."""
        nets = {}
        with masks_drawn_on_cpu():
            for device in ("cpu", "cuda"):
                tnet = VapNet(conf_c)
                tnet.load_state_dict(state)
                tnet.to(device)
                reset_counts()
                opt = tstep.make_optimizer(OptConfig(), tnet, conf_c.freeze_encoder)
                m = tstep.make_train_step(conf_c, opt)(tnet, batch, torch.Generator().manual_seed(0))
                nets[device] = (tnet, {k: float(v) for k, v in m.items()})
        card_counts = read_counts()
        (cnet, cm), (gnet, gm) = nets["cpu"], nets["cuda"]
        pairs = []
        for (name, cp), gp in zip(cnet.named_parameters(), gnet.parameters()):
            if conf_c.freeze_encoder and name.startswith(FROZEN):
                check(cp.grad is None and gp.grad is None, f"no gradient on frozen {name}")
                continue
            check(cp.grad is not None and gp.grad is not None, f"{what}: a gradient reaches {name}")
            pairs.append((name, cp, gp))
        err = grads_vs_cpu(pairs, cm, gm, cm)
        emit("train_vs_cpu", dtype="float32", batch=1, chunk_s=2.0, dropout=conf_c.dropout, encoder=what,
             metrics_cpu=cm, metrics_card=gm, launches_card=card_counts, max_err=err, tol=TRAIN_VS_CPU_TOL)
        check(card_counts == expected, f"{what} dropout {conf_c.dropout} card step launches "
              f"{card_counts}, expected {expected}")
        for k, bar in TRAIN_VS_CPU_TOL.items():
            check(err[k] <= bar, f"{what} dropout {conf_c.dropout} train step card vs CPU {k}: "
                  f"{err[k]} > {bar}")

    # bfloat16 (the main path): three checked steps, then the timed steps
    conf_t16 = VapConfig(dtype="bfloat16")
    tnet16, step16, batches16, train_counts = train_steps(conf_t16, TB, 3, "frozen", per_train_step)
    timed_steps(tnet16, step16, batches16, "frozen")

    # one eval step: the inference kernels
    reset_counts()
    ev = tstep.make_eval_step(conf_t16)(tnet16, batches16[0])
    sync()
    eval_counts = read_counts()
    emit("eval", dtype="bfloat16", batch=TB, vap_loss=float(ev["vap_loss"]),
         vad_loss=float(ev["vad_loss"]), launches=eval_counts)
    check(math.isfinite(float(ev["vap_loss"])) and math.isfinite(float(ev["vad_loss"])), "eval losses")
    check(eval_counts == per_forward, f"eval step launches {eval_counts}, expected {per_forward}")
    del tnet16, step16, batches16, ev
    torch.cuda.empty_cache()

    # float32: three checked steps at the same batch
    train_steps(VapConfig(), TB, 3, "frozen", per_train_step)
    torch.cuda.empty_cache()

    # one float32 step on the card against the CPU, without dropout and with
    # it (elementwise masks drawn alike, see masks_drawn_on_cpu); with or
    # without dropout, the step's attention runs the training kernels
    small = train_batch(1, chunk_samples=2 * SR, vad_frames=2 * 50 + 100)
    for drop in (0.0, conf.dropout):
        step_vs_cpu(VapConfig(dropout=drop), small, per_train_step, "frozen")
        torch.cuda.empty_cache()

    # 6. the encoder-training slice ------------------------------------------
    # the unfrozen step in bfloat16 (this slice's main path, with the CPC
    # step below): three checked steps, then the timed steps
    conf_u16 = VapConfig(dtype="bfloat16", freeze_encoder=False)
    unet16, ustep16, ubatches16, unfrozen_counts = train_steps(
        conf_u16, TB, 3, "unfrozen", per_unfrozen_step)
    timed_steps(unet16, ustep16, ubatches16, "unfrozen")
    del unet16, ustep16, ubatches16
    torch.cuda.empty_cache()
    step_vs_cpu(VapConfig(dropout=0.0, freeze_encoder=False), small, per_unfrozen_step, "unfrozen")
    torch.cuda.empty_cache()

    # CPC pretraining at the pretrain_cpc.py defaults, float32
    CB, CN, K_PRED, N_NEG = 32, 20_480, 12, 128
    cpc_tree = ckpt.random_params_tree(conf, seed=0)["encoder"]

    def cpc_state(device):
        heads = cpc.init_cpc_heads(torch.Generator().manual_seed(0), K_PRED, conf.encoder_dim,
                                   conf.encoder_dim)
        return cpc.init_cpc_train_state(ckpt.encoder_from_jax(cpc_tree), heads, device=device)

    cstate = cpc_state("cuda")
    cstep = cpc.make_cpc_train_step(K_PRED, N_NEG)
    cwaves = [torch.as_tensor((0.1 * rng.standard_normal((CB, CN))).astype(np.float32), device="cuda")
              for _ in range(2)]
    before = {k: p.detach().clone() for k, p in cstate.encoder.named_parameters()}
    cpc_metrics, cpc_counts = [], []
    for i in range(3):
        reset_counts()
        m = cstep(cstate, cwaves[i % 2], torch.Generator().manual_seed(i))
        sync()
        cpc_counts.append(read_counts())
        cpc_metrics.append({k: float(v) for k, v in m.items()})
    emit("cpc", dtype="float32", batch=CB, samples=CN, n_predicts=K_PRED, n_negatives=N_NEG, steps=3,
         metrics=cpc_metrics, launches_per_step=cpc_counts)
    for i, (m, cnt) in enumerate(zip(cpc_metrics, cpc_counts)):
        check(all(math.isfinite(v) for v in m.values()), f"CPC step {i} finite: {m}")
        check(cnt == per_cpc_step, f"CPC step {i} launches {cnt}, expected {per_cpc_step}")
    for name, p in cstate.encoder.named_parameters():
        same = torch.equal(p.detach(), before[name])
        check(same if name.startswith("downsample.") else not same,
              f"CPC: {name} {'changed' if not same else 'did not move'}")
    check(cstate.step == 3, "CPC step count")
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        m = cstep(cstate, cwaves[i % 2], torch.Generator().manual_seed(100 + i))
    loss = float(m["cpc_loss"])
    dt = time.perf_counter() - t0
    check(math.isfinite(loss), "timed CPC steps: loss finite")
    emit("cpc_throughput", metric="cpc_audio_seconds_per_second", value=CB * CN / SR * iters / dt,
         steps_per_second=iters / dt, ms_per_step=dt / iters * 1e3, batch=CB, samples=CN,
         dtype="float32", iters=iters, seconds=dt,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi,
         note="waveforms already on the card; negatives drawn on the CPU each step")
    profile(lambda: cstep(cstate, cwaves[0], torch.Generator().manual_seed(7)), "cpc_step",
            batch=CB, dtype="float32")
    del cstate, cwaves
    torch.cuda.empty_cache()

    # one CPC step on the card against the CPU: the same weights, waveform
    # and negatives (drawn from the step's CPU generator on both devices)
    small_w = (0.1 * rng.standard_normal((4, CN))).astype(np.float32)
    res = {}
    for device in ("cpu", "cuda"):
        st = cpc_state(device)
        reset_counts()
        m = cstep(st, small_w, torch.Generator().manual_seed(5))
        res[device] = (st, {k: float(v) for k, v in m.items()})
    card_counts = read_counts()
    (cst, cm), (gst, gm) = res["cpu"], res["cuda"]
    pairs = [(f"encoder.{n}", cp, gp) for (n, cp), gp in zip(cst.encoder.named_parameters(),
                                                            gst.encoder.parameters())
             if not n.startswith("downsample.")] + [("heads.W", cst.heads.W, gst.heads.W)]
    err = grads_vs_cpu(pairs, cm, gm, ["cpc_loss"])
    emit("cpc_vs_cpu", dtype="float32", batch=4, samples=CN, metrics_cpu=cm, metrics_card=gm,
         launches_card=card_counts, max_err=err, tol=TRAIN_VS_CPU_TOL)
    check(card_counts == per_cpc_step, f"CPC card step launches {card_counts}, expected {per_cpc_step}")
    for k, bar in TRAIN_VS_CPU_TOL.items():
        check(err[k] <= bar, f"CPC step card vs CPU {k}: {err[k]} > {bar}")
    del res, cst, gst
    torch.cuda.empty_cache()

    # 7. long audio: exact single-shot inference over four time shards ------
    # 600 s of stereo (T50 = 30,000) on a mesh that repeats the one card, so
    # every shard runs the offset attention kernel at its own offset
    shards = CP_SHARDS
    n_long = int(LONG_S * SR)
    T50_long = n_long // 320
    mesh = make_mesh(n_data=shards, devices=[torch.device("cuda")] * shards)
    per_cp_call = dict(no_launch, gru_recurrence=shards, flash_alibi_offset=sites * shards)
    lnet = VapNet(conf)
    lnet.load_state_dict(state)
    lnet.to("cuda").requires_grad_(False)
    long_wave = torch.as_tensor((0.1 * rng.standard_normal((1, 2, n_long))).astype(np.float32), device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        single = {c.dtype: forward(lnet, long_wave, c) for c in (conf, conf16)}
    sync()
    single_s = time.perf_counter() - t0

    def long_call(c, impl, expected):
        """forward_context_parallel, held against the single-device forward
        on the card, and probs_context_parallel, each with the counters read
        around it. Returns the probs call's counts."""
        if impl:
            os.environ["VAP_CONV_IMPL"] = impl
        try:
            reset_counts()
            out = forward_context_parallel(lnet, long_wave, c, mesh)
            sync()
            fwd_counts = read_counts()
            reset_counts()
            probs = probs_context_parallel(lnet, long_wave, c, mesh)
            sync()
            counts = read_counts()
        finally:
            os.environ.pop("VAP_CONV_IMPL", None)
        what = f"context parallel {c.dtype} conv {impl or 'default'}"
        check_probs(probs, 1, what, T=T50_long)
        want = single[c.dtype]
        errs = {k: max_err(out[k], want[k]) for k in ("logits", "vad")}
        if c.dtype == "float32":
            ok = all(e <= CP_F32_TOL for e in errs.values())
        else:  # the JAX bf16 bar: |got - want| <= 0.05 + 0.1 |want|
            ok = all(bool(((out[k] - want[k]).abs() <= 0.05 + 0.1 * want[k].abs()).all()) for k in errs)
        emit("context_parallel", dtype=c.dtype, conv_impl=impl or "default", audio_s=LONG_S, shards=shards,
             t50=T50_long, launches=counts, max_abs_err_vs_single_device=errs,
             tol=CP_F32_TOL if c.dtype == "float32" else "0.05 + 0.1 |want|")
        check(fwd_counts == expected and counts == expected,
              f"{what}: launches {fwd_counts} / {counts}, expected {expected}")
        check(ok, f"{what}: against the single-device forward {errs}")
        return counts

    cp_counts = {}
    for c in (conf, conf16):
        cp_counts[c.dtype] = long_call(c, None, per_cp_call)
        cp_counts[(c.dtype, "fused")] = long_call(c, "fused", dict(per_cp_call, conv01=shards))
        torch.cuda.empty_cache()
    # the bf16 single shot: one 600 s file per call, host clock
    torch.cuda.reset_peak_memory_stats()
    probs_context_parallel(lnet, long_wave, conf16, mesh)  # warm-up
    sync()
    iters = 2
    t0 = time.perf_counter()
    for _ in range(iters):
        probs_context_parallel(lnet, long_wave, conf16, mesh)
    sync()
    dt = time.perf_counter() - t0
    emit("long_audio_throughput", metric="audio_seconds_per_second", value=LONG_S * iters / dt,
         seconds_per_file=dt / iters, audio_s=LONG_S, shards=shards, dtype="bfloat16", iters=iters,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi,
         single_device_forward_seconds_f32_and_bf16=single_s,
         note="one card runs the four shards in turn; the waveform already on the card")
    profile(lambda: probs_context_parallel(lnet, long_wave, conf16, mesh), "probs_context_parallel",
            audio_s=LONG_S, shards=shards, dtype="bfloat16")
    del single, long_wave
    torch.cuda.empty_cache()

    # 8. the conv0 + conv1 kernel in stereo inference (VAP_CONV_IMPL=fused) --
    m16 = VapModel(conf16, state, device="cuda")
    reqs = requests(B, 2)
    per_fused = dict(per_forward, conv_stack=0, conv01=1)

    def served(impl):
        if impl:
            os.environ["VAP_CONV_IMPL"] = impl
        try:
            m16.probs(reqs[0])  # warm-up
            sync()
            reset_counts()
            t0 = time.perf_counter()
            outs = [m16.probs(w) for w in reqs]
            sync()
            return outs, read_counts(), time.perf_counter() - t0
        finally:
            os.environ.pop("VAP_CONV_IMPL", None)

    turns = []
    for impl in ("fused", None, None, "fused"):  # in turns, on one card
        outs, counts, dt = served(impl)
        turns.append({"conv_impl": impl or "default", "audio_seconds_per_second": B * CHUNK_S * len(reqs) / dt})
        expected = per_fused if impl else per_forward
        check(counts == {k: v * len(reqs) for k, v in expected.items()},
              f"conv impl {impl}: launches {counts}, expected {expected} per request")
        if impl:
            fused_outs, fused_counts = outs, counts
        else:
            default_outs = outs
    p_err = max(max_err(f[k], d[k]) for f, d in zip(fused_outs, default_outs) for k in ("p_now", "p_future"))
    emit("conv_impl", batch=B, chunk_s=CHUNK_S, dtype="bfloat16", turns=turns, launches=fused_counts,
         max_abs_err_p_vs_default=p_err, tol=VS_CPU_BF16_TOL, card=smi)
    check(p_err <= VS_CPU_BF16_TOL, f"VAP_CONV_IMPL=fused p_now/p_future vs the default path: {p_err}")
    del m16, reqs, fused_outs, default_outs, outs
    torch.cuda.empty_cache()

    # 9. the mono (VAD-conditioned) model, with the history conditioning ---
    mconf = VapMonoConfig(va_history=True)
    mstate = ckpt.params_from_jax(ckpt.random_params_tree(mconf, seed=0), mconf)
    MB = 8
    mwave = (0.1 * rng.standard_normal((MB, 1, n))).astype(np.float32)
    mva = (rng.random((MB, T50 + 100, 2)) < 0.4).astype(np.float32)
    mvah = rng.random((MB, T50 + 100, mconf.va_history_bins)).astype(np.float32)
    reset_counts()
    mono_card = VapMonoModel(mconf, mstate, device="cuda").probs(mwave, mva, mvah)
    sync()
    mono_counts = read_counts()
    mono_cpu = VapMonoModel(mconf, mstate, device="cpu").probs(mwave, mva, mvah)
    mono_err = {k: max_err(mono_card[k].cpu(), mono_cpu[k]) for k in ("p_now", "p_future")}
    per_mono = dict(no_launch, conv_stack=5, gru_downsample=1, flash_alibi=mconf.channel_layers + mconf.cross_layers)
    emit("mono", dtype="float32", batch=MB, chunk_s=CHUNK_S, va_history=True, launches=mono_counts,
         max_abs_err_vs_cpu=mono_err, tol=MONO_VS_CPU_TOL)
    check(mono_card["p_now"].shape == (MB, T50, 2), "mono shapes")
    check(mono_counts == per_mono, f"mono launches {mono_counts}, expected {per_mono}")
    for k, e in mono_err.items():
        check(e <= MONO_VS_CPU_TOL, f"mono card vs CPU {k}: {e}")
    del mono_card, mono_cpu
    torch.cuda.empty_cache()

    # 10. kernel times -----------------------------------------------------------
    kernels = []
    net16 = net.to("cuda", torch.bfloat16)
    enc16 = net16.encoder
    R = 2 * B
    dt16 = torch.bfloat16

    # conv stack at R=128 x 320000
    lw16 = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc16.gEncoder]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dt16)
    # kernel vs plain at the main path's shape, on the inputs timed below
    err = compare("conv_stack", k1.fused_conv_stack(lw16, x), k1.reference_stack(lw16, x),
                  [R, n], dt16)
    ms = cuda_ms(lambda: k1.fused_conv_stack(lw16, x))
    plain = cuda_ms(lambda: k1.reference_stack(lw16, x), reps=2, warmup=1)
    torch.cuda.empty_cache()
    specs = k1.CPC_CONV_SPECS

    def conv1d_lib():
        zt = x[:, None, :]
        for (w, b, nw, nb), (_, s, p) in zip(lw16, specs):
            zt = F.conv1d(zt, w.permute(2, 1, 0), b, stride=s, padding=p)
            zt = torch.relu(channel_norm(zt.transpose(1, 2), nw, nb)).transpose(1, 2)
        return zt

    lib = cuda_ms(conv1d_lib, reps=2, warmup=1)
    flops, n_l, c_in = 0.0, n, 1
    for k, s, p in specs:
        n_l = (n_l + 2 * p - k) // s + 1
        flops += 2.0 * R * n_l * 256 * k * c_in
        c_in = 256
    weights = sum(t.numel() for l in lw16 for t in l) * 2
    bnd, by = bound_ms(flops, R * n * 2 + R * n_l * 256 * 2 + weights)
    kernels.append(dict(
        name="conv_stack", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/conv_stack.cu",
        replaces="voiceactivityprojection_tpu/ops/conv_stack_fused.py:101",
        launches=launches["conv_stack"], launches_per_train_step=train_counts[0]["conv_stack"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        backward_max_abs_err_f32=conv_bwd[0], backward_ms=conv_bwd[1], backward_plain_ms=conv_bwd[2],
        backward_note="float32, R=8 x 320000, forward + backward: autograd through the plain stack "
                      "on the saved inputs (JAX conv_stack_fused.py:467-470), against autograd of "
                      "reference_stack; on no main path"))
    del x
    torch.cuda.empty_cache()

    # GRU + downsample at R=128 x 2000 steps
    H = 256
    g, d = enc16.gAR, enc16.downsample
    T100 = 2 * T50
    xp = (0.5 * torch.randn(R, T100, 3 * H, generator=gen)).to("cuda", dt16)
    h0 = torch.zeros(R, H, device="cuda", dtype=dt16)
    args = [xp, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    err = compare("gru_downsample", k2.gru_downsample_fused(*args),
                  k2.gru_downsample_reference(*args), [R, T100, 3 * H], dt16)
    ms = cuda_ms(lambda: k2.gru_downsample_fused(*args), reps=3, warmup=1)
    plain = cuda_ms(lambda: k2.gru_downsample_reference(*args), reps=1, warmup=1)
    gru_lib = torch.nn.GRU(H, H, batch_first=True).to("cuda", dt16).requires_grad_(False)
    with torch.no_grad():
        gru_lib.weight_ih_l0.copy_(g.w_ih.T)
        gru_lib.weight_hh_l0.copy_(g.w_hh.T)
        gru_lib.bias_ih_l0.copy_(g.b_ih)
        gru_lib.bias_hh_l0.copy_(g.b_hh)
    z = torch.relu(torch.randn(R, T100, H, generator=gen)).to("cuda", dt16)
    w_d = d.conv.w.permute(2, 1, 0)

    def gru_ds_lib():
        ys, _ = gru_lib(z)
        y = F.conv1d(F.pad(ys.transpose(1, 2), (4, 0)), w_d, d.conv.b, stride=2)
        return F.gelu(layer_norm(y.transpose(1, 2), d.ln.w, d.ln.b))

    with torch.no_grad():
        lib = cuda_ms(gru_ds_lib, reps=3, warmup=1)
    flops = R * T100 * 2.0 * H * 3 * H + R * T50 * 2.0 * 5 * H * H
    nbytes = (xp.numel() + R * T50 * H) * 2 + (3 * H * H + 5 * H * H) * 2
    bnd, by = bound_ms(flops, nbytes)
    kernels.append(dict(
        name="gru_downsample", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_downsample.cu",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:94",
        launches=launches["gru_downsample"], launches_per_train_step=train_counts[0]["gru_downsample"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        library_note="torch.nn.GRU (includes the x @ W_ih projection) + F.conv1d downsample + LN + GELU"))
    del xp, z
    torch.cuda.empty_cache()

    # GRU recurrence at the train step's R=32 x 2000 steps
    RT = 2 * TB
    xp = (0.5 * torch.randn(RT, T100, 3 * H, generator=gen)).to("cuda", dt16)
    h0 = torch.zeros(RT, H, device="cuda", dtype=dt16)
    args = [xp, g.w_hh, g.b_hh, h0]
    ms = cuda_ms(lambda: k3.gru_recurrence(*args), reps=3, warmup=1)
    plain = cuda_ms(lambda: k3.gru_recurrence_reference(*args), reps=1, warmup=1)
    zt = torch.relu(torch.randn(RT, T100, H, generator=gen)).to("cuda", dt16)
    with torch.no_grad():
        lib = cuda_ms(lambda: gru_lib(zt), reps=3, warmup=1)
    flops = RT * T100 * 2.0 * H * 3 * H
    nbytes = (xp.numel() + RT * T100 * H + RT * H) * 2 + (3 * H * H + 3 * H) * 2
    bnd, by = bound_ms(flops, nbytes)
    kernels.append(dict(
        name="gru_recurrence", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_recurrence.cu",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:49",
        launches=train_counts[0]["gru_recurrence"] * len(train_counts), launches_per_train_step=train_counts[0]["gru_recurrence"],
        max_abs_err=errs[("gru_recurrence", dt16)], max_abs_err_f32=errs[("gru_recurrence", torch.float32)],
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        us_per_step=ms * 1e3 / T100,
        library_note="torch.nn.GRU forward (includes the x @ W_ih projection)"))
    del xp, zt, gru_lib
    torch.cuda.empty_cache()

    # GRU backward at the unfrozen step's R=32 x 2000 (bfloat16) and the CPC
    # step's R=32 x 128 (float32)
    def gru_backward_times(Rb, Tb, dtype):
        w_hh = state["encoder.gAR.w_hh"].to("cuda", dtype)
        b_hh = state["encoder.gAR.b_hh"].to("cuda", dtype)
        xpb = (0.5 * torch.randn(Rb, Tb, 3 * H, generator=gen)).to("cuda", dtype)
        h0b = torch.zeros(Rb, H, device="cuda", dtype=dtype)
        ys, _ = k3.gru_recurrence(xpb, w_hh, b_hh, h0b)
        dys = torch.randn(Rb, Tb, H, generator=gen).to("cuda", dtype)
        args = [xpb, w_hh, b_hh, h0b, ys, dys]
        ms = cuda_ms(lambda: k3.gru_backward(*args), reps=3, warmup=1)
        plain = cuda_ms(lambda: k3.gru_backward_reference(*args), reps=1, warmup=1)
        # yardstick: cuDNN's GRU backward with the same weights (forward +
        # backward less forward; it also computes dW_ih and dx, which the
        # port leaves to torch.matmul outside the kernel)
        lib_gru = torch.nn.GRU(H, H, batch_first=True).to("cuda", dtype)
        with torch.no_grad():
            lib_gru.weight_hh_l0.copy_(w_hh.T)
            lib_gru.bias_hh_l0.copy_(b_hh)
        zb = torch.relu(torch.randn(Rb, Tb, H, generator=gen)).to("cuda", dtype).requires_grad_()
        lib_leaves = [zb, *lib_gru.parameters()]
        fwd = cuda_ms(lambda: lib_gru(zb)[0], reps=3, warmup=1)
        fwd_bwd = cuda_ms(lambda: torch.autograd.grad(lib_gru(zb)[0], lib_leaves, dys), reps=3, warmup=1)
        esize = torch.finfo(dtype).bits // 8
        # each step recomputes h @ W_hh, forms dgates @ W_hh^T and adds h^T dgates
        flops = 3 * Rb * Tb * 2.0 * H * 3 * H
        nbytes = esize * (2 * Rb * Tb * 3 * H + 2 * Rb * Tb * H + 2 * (3 * H * H + 3 * H) + 2 * Rb * H)
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype == dt16 else PEAK_F32_FLOPS)
        return dict(shape=[Rb, Tb, 3 * H], dtype=str(dtype), ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=fwd_bwd - fwd, us_per_step=ms * 1e3 / Tb)

    k9_train = gru_backward_times(RT, T100, dt16)
    torch.cuda.empty_cache()
    k9_cpc = gru_backward_times(CB, cpc.encoded_frames(CN), torch.float32)
    torch.cuda.empty_cache()
    kernels.append(dict(
        name="gru_backward", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_backward.cu",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:300",
        launches=sum(c["gru_backward"] for c in unfrozen_counts),
        launches_cpc=sum(c["gru_backward"] for c in cpc_counts),
        max_abs_err=errs[("gru_backward", dt16)], max_abs_err_f32=errs[("gru_backward", torch.float32)],
        **{k: k9_train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "us_per_step")},
        at_cpc_shape=k9_cpc,
        library_note="cuDNN torch.nn.GRU, forward + backward less forward (also computes dW_ih and dx)"))

    # training attention at the train step's B=16, H=4, T=1000, Dh=64, rate 0.1
    Hh, Dh, T = conf.num_heads, conf.dim // conf.num_heads, T50
    rate = conf.dropout
    q, kk, v, do = (torch.randn(TB, Hh, T, Dh, generator=gen).to("cuda", dt16) for _ in range(4))
    slopes = alibi_slopes(Hh).to(dt16).to("cuda")
    scale = 1.0 / math.sqrt(conf.dim)
    out, lse = ft.flash_train_forward(q, kk, v, slopes, 5, scale, rate)
    pairs = T * (T + 1) / 2
    ms_f = cuda_ms(lambda: ft.flash_train_forward(q, kk, v, slopes, 5, scale, rate), reps=10)
    plain_f = cuda_ms(lambda: ft.train_forward_reference(q, kk, v, slopes, 5, scale, rate), reps=3)
    ms_b = cuda_ms(lambda: ft.flash_train_backward(q, kk, v, slopes, 5, out, lse, do, scale, rate), reps=10)
    delta = (do.float() * out.float()).sum(-1).reshape(TB * Hh, T)
    plain_b = cuda_ms(lambda: ft.train_backward_reference(q, kk, v, do, lse, delta, slopes, 5, scale, rate),
                      reps=3)
    i = torch.arange(T, device="cuda")
    rel = (i[None, :] - i[:, None]).float()
    mask = (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf")).to(dt16)
    leaves = [t.clone().requires_grad_() for t in (q, kk, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate, scale=scale)
    lib_f = cuda_ms(lambda: sdpa().detach(), reps=10)
    o_lib = sdpa()
    lib_b = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True), reps=10)
    io = TB * Hh * T * Dh * 2
    bnd_f, by_f = bound_ms(TB * Hh * 2.0 * 2 * Dh * pairs, 4 * io + TB * Hh * T * 4)
    # S = QK^T recomputed, dP, dV, dQ, dK: five products over the causal pairs
    bnd_b, by_b = bound_ms(TB * Hh * 5 * 2.0 * Dh * pairs, 7 * io + 2 * TB * Hh * T * 4)
    kernels.append(dict(
        name="flash_train_forward", route="cuda",
        source="voiceactivityprojection_tpu_torch/csrc/flash_alibi_train.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi_train.py:122",
        launches=train_counts[0]["flash_train_forward"] * len(train_counts),
        launches_per_train_step=train_counts[0]["flash_train_forward"],
        max_abs_err=errs[("flash_train_forward", dt16)], max_abs_err_f32=errs[("flash_train_forward", torch.float32)],
        ms=ms_f, plain_ms=plain_f, bound_ms=bnd_f, bound_by=by_f, library_ms=lib_f,
        library_note="F.scaled_dot_product_attention, float ALiBi + causal mask, dropout_p=0.1"))
    kernels.append(dict(
        name="flash_train_backward", route="cuda",
        source="voiceactivityprojection_tpu_torch/csrc/flash_alibi_train.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi_train.py:366",
        also_replaces=["voiceactivityprojection_tpu/ops/flash_alibi_train.py:242",
                       "voiceactivityprojection_tpu/ops/flash_alibi_train.py:297"],
        launches=train_counts[0]["flash_train_backward"] * len(train_counts),
        launches_per_train_step=train_counts[0]["flash_train_backward"],
        max_abs_err=errs[("flash_train_backward", dt16)], max_abs_err_f32=errs[("flash_train_backward", torch.float32)],
        ms=ms_b, plain_ms=plain_b, bound_ms=bnd_b, bound_by=by_b, library_ms=lib_b,
        library_note="autograd backward of the same F.scaled_dot_product_attention call"))
    del q, kk, v, do, out, lse, leaves, o_lib, delta
    torch.cuda.empty_cache()

    # inference attention at B=64, H=4, T=1000, Dh=64
    q, kk, v = (torch.randn(B, Hh, T, Dh, generator=gen).to("cuda", dt16) for _ in range(3))
    err = compare("flash_alibi", k4.flash_alibi_attention(q, kk, v, slopes, scale),
                  k4.dense_reference(q, kk, v, slopes, scale), [B, Hh, T, Dh], dt16)
    ms = cuda_ms(lambda: k4.flash_alibi_attention(q, kk, v, slopes, scale), reps=10)
    plain = cuda_ms(lambda: k4.dense_reference(q, kk, v, slopes, scale), reps=5)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask, scale=scale), reps=10)
    bnd, by = bound_ms(B * Hh * 2.0 * 2 * Dh * pairs, 4.0 * B * Hh * T * Dh * 2)
    kernels.append(dict(
        name="flash_alibi", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:122",
        also_replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:54",
        launches=launches["flash_alibi"], launches_per_train_step=train_counts[0]["flash_alibi"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib))
    del q, kk, v
    torch.cuda.empty_cache()

    # offset attention: one attention site of the 600 s call, the four
    # shards' launches (Tq = 7,500 rows at offsets 0, 7,500, 15,000, 22,500
    # of Tk = 30,000 keys)
    Tk = T50_long
    Tq = Tk // shards
    offs = [d * Tq for d in range(shards)]
    qs = [torch.randn(1, Hh, Tq, Dh, generator=gen).to("cuda", dt16) for _ in offs]
    kk, v = (torch.randn(1, Hh, Tk, Dh, generator=gen).to("cuda", dt16) for _ in range(2))
    err = max(compare("flash_alibi_offset", k4.flash_alibi_attention_offset(q, kk, v, slopes, scale, off),
                      k4.dense_offset_reference(q, kk, v, slopes, scale, off), [1, Hh, Tq, Dh], dt16,
                      Tk=Tk, offset=off)
              for q, off in zip(qs, offs))
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: [k4.flash_alibi_attention_offset(q, kk, v, slopes, scale, o) for q, o in zip(qs, offs)],
                 reps=5)
    plain = cuda_ms(lambda: [k4.dense_offset_reference(q, kk, v, slopes, scale, o) for q, o in zip(qs, offs)],
                    reps=2, warmup=1)
    torch.cuda.empty_cache()
    j = torch.arange(Tk, device="cuda")

    def offset_mask(off):
        rel = (j[None, :] - (off + torch.arange(Tq, device="cuda"))[:, None]).float()
        return (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf")).to(dt16)

    masks = [offset_mask(o) for o in offs]
    lib = cuda_ms(lambda: [F.scaled_dot_product_attention(q, kk, v, attn_mask=m, scale=scale)
                           for q, m in zip(qs, masks)], reps=5)
    flops = sum(4.0 * Dh * Hh * (Tq * o + Tq * (Tq + 1) / 2) for o in offs)
    nbytes = sum((Tq + 2 * Tk) * Hh * Dh * 2 + Tq * Hh * Dh * 2 for _ in offs)
    bnd, by = bound_ms(flops, nbytes)
    kernels.append(dict(
        name="flash_alibi_offset", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:590",
        launches=cp_counts["bfloat16"]["flash_alibi_offset"], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=lib,
        shape=f"one site of the {LONG_S:.0f} s call: {shards} launches, Tq={Tq} at offsets {offs} of Tk={Tk}, "
              f"H={Hh}, bf16", launches_per_call_note="per probs_context_parallel call (14 sites x 4 shards)",
        library_note="F.scaled_dot_product_attention per shard, float offset-ALiBi + causal mask"))
    del qs, kk, v, masks
    torch.cuda.empty_cache()

    # conv0 + conv1 at R=128 x 320000 (the B=64 request of VAP_CONV_IMPL=fused)
    lw01 = lw16[:2]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dt16)
    err = compare("conv01", k11.fused_conv01(lw01, x), k11.reference_unfused(lw01, x), [R, n], dt16)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: k11.fused_conv01(lw01, x))
    plain = cuda_ms(lambda: k11.reference_unfused(lw01, x), reps=2, warmup=1)
    torch.cuda.empty_cache()

    def conv01_lib():
        zt = x[:, None, :]
        for (w, b, nw, nb), (_, s, p) in zip(lw01, specs):
            zt = F.conv1d(zt, w.permute(2, 1, 0), b, stride=s, padding=p)
            zt = torch.relu(channel_norm(zt.transpose(1, 2), nw, nb)).transpose(1, 2)
        return zt

    lib = cuda_ms(conv01_lib, reps=2, warmup=1)
    n0 = (n + 2 * k11.P0 - k11.K0) // k11.S0 + 1
    n1 = k11.out_len(n)
    flops = 2.0 * R * (n0 * k11.K0 * 256 + n1 * k11.K1 * 256 * 256)
    weights = sum(t.numel() for l in lw01 for t in l) * 2
    bnd, by = bound_ms(flops, R * n * 2 + R * n1 * 256 * 2 + weights)
    kernels.append(dict(
        name="conv01", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/conv_fused.cu",
        replaces="voiceactivityprojection_tpu/ops/conv_fused.py:82",
        launches=cp_counts[("bfloat16", "fused")]["conv01"], launches_per_request=fused_counts["conv01"] // 2,
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        backward_max_abs_err_f32=conv01_bwd,
        launches_note="per probs_context_parallel call under VAP_CONV_IMPL=fused (one per shard)",
        library_note="cuDNN F.conv1d x 2 + ChannelNorm + ReLU"))
    del x
    for kern in kernels:
        kern["launches_per_unfrozen_step"] = unfrozen_counts[0][kern["name"]]
        kern["launches_per_cpc_step"] = cpc_counts[0][kern["name"]]
        check(kern["launches"] > 0, f"{kern['name']} ran on the main path")
    emit("timing", card=smi, dtype="bfloat16", batch=B, train_batch=TB,
         per_forward={k: launches[k] // 3 for k in launches}, per_train_step=train_counts[0],
         per_unfrozen_step=unfrozen_counts[0], per_cpc_step=cpc_counts[0],
         per_context_parallel_call=cp_counts["bfloat16"],
         seconds_total=time.perf_counter() - t_start)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump({"report": REPORT, "kernels": kernels, "build_logs": logs}, f, indent=1)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

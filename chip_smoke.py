#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit;
2. build: compiles every CUDA kernel of ``voiceactivityprojection_tpu_torch/csrc``;
3. kernels vs their plain PyTorch versions on the card at main-path shapes
   (conv stack R=8 x 320000 samples and a ragged length; GRU+downsample
   2B=8 x 2000 steps and an odd length; attention B=8, H=4, T=1000 and
   T=3000), in float32 with TF32 off and in bfloat16;
4. the slice: ``VapModel(VapConfig())`` on the card with weights drawn from a
   seed in the JAX params layout, serving requests of (B, 2, 320000) through
   ``probs`` in float32 and bfloat16, with every kernel's launch counter
   read around the bfloat16 run, and one request checked against the same
   port on the CPU (plain path, float32);
5. times: audio-seconds/s of ``probs`` at B=64, 20 s chunks, bfloat16; each
   kernel's time with CUDA events beside its bound, its plain version's time
   and one PyTorch library call that computes the same function (timed as a
   yardstick only; the port never calls it).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
A full report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_forward(model, wave) -> None:
    """One request under torch.profiler: device busy time per kernel name
    and the device's idle share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.as_tensor(wave, device="cuda")
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.probs(x)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:80], [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", batch=int(x.shape[0]), wall_ms=wall_ms,
         device_busy_ms=busy_ms if busy_ms else "not measured",
         idle_share=1 - busy_ms / wall_ms if busy_ms else "not measured",
         top_kernels=[{"name": k, "ms": ms, "count": c} for k, (ms, c) in top])


# ------------------------------------------------------------------ kernels --
# Tolerances, kernel vs plain version on the same inputs (max abs error).
# float32: the same arithmetic summed in another order (measured on an
# H100: conv 5.5e-6, GRU+downsample 5.6e-6, attention 4.8e-7).
F32_TOL = {"conv_stack": 1e-4, "gru_downsample": 5e-5, "flash_alibi": 5e-6}
# bfloat16: a sum that lands on the other side of a rounding boundary moves
# an output by one bf16 step (2^-7 of its magnitude's power of two). The
# tolerance is that many steps at the largest output magnitude: attention
# rounds p and the output (2); GRU+downsample the LayerNorm output before
# GELU and the output (2); the conv stack rounds every layer's output and,
# in the plain version, each conv sum before its ChannelNorm, and a step
# moves the next layer's statistics (4).
BF16_STEPS = {"conv_stack": 4, "gru_downsample": 2, "flash_alibi": 2}


def compare(name, got, want, shape, dtype) -> float:
    sync()
    err = max_err(got, want)
    if dtype == torch.float32:
        tol = F32_TOL[name]
    else:
        top = max(float(want.float().abs().max()), 1.0)
        tol = BF16_STEPS[name] * 2.0 ** (math.floor(math.log2(top)) - 7)
    emit("kernel_check", kernel=name, shape=shape, dtype=str(dtype), max_abs_err=err, tol=tol)
    check(err <= tol, f"{name} {dtype} {shape}: {err} > {tol}")
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


# the port on the card vs the same port on the CPU (float32, plain path):
# the JAX package's bars against the reference; bf16 on the card vs f32 on
# the CPU is held to the bf16 slice test's bound (tests/test_torch_model.py)
VS_CPU_TOL = {"logits": 1e-3, "p_now": 2e-4, "p_future": 2e-4, "H": 1e-3}
VS_CPU_BF16_TOL = 2e-3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from voiceactivityprojection_tpu_torch import VapConfig, VapModel
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapNet, _compute_cast
    from voiceactivityprojection_tpu_torch.ops import _build
    from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
    from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
    from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
    from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
    from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, layer_norm

    port = {"k1": k1, "k2": k2, "k4": k4, "alibi_slopes": alibi_slopes}
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

    conf = VapConfig()
    state = ckpt.params_from_jax(ckpt.random_params_tree(conf, seed=0), conf)
    net = VapNet(conf)
    net.load_state_dict(state)
    enc = net.encoder.to("cuda")
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    gen = torch.Generator().manual_seed(0)

    # 3. kernels vs plain ------------------------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        for n in (320_000, 12_345):
            conv_stack_case(port, layers, 8, n, dtype, gen)
        for T in (2000, 1999):
            gru_ds_case(port, enc, 8, T, dtype, gen)
        for T in (1000, 3000):
            attention_case(port, 8, 4, T, 64, dtype, gen)
    torch.cuda.empty_cache()

    # 4. the slice -------------------------------------------------------------
    counters = {"conv_stack": k1.fused_conv_stack, "gru_downsample": k2.gru_downsample_fused,
                "flash_alibi": k4.flash_alibi_attention}
    per_forward = {"conv_stack": 5, "gru_downsample": 1,
                   "flash_alibi": 2 * conf.channel_layers + 4 * conf.cross_layers}
    n = int(CHUNK_S * SR)
    T50 = n // 320
    rng = np.random.default_rng(1)

    def requests(B, count):
        return [(0.1 * rng.standard_normal((B, 2, n))).astype(np.float32) for _ in range(count)]

    def check_probs(out, B, what):
        check(out["p_now"].shape == (B, T50, 2) and out["H"].shape == (B, T50), f"{what} shapes")
        for key in ("probs", "vad", "p_now", "p_future", "H"):
            check(bool(torch.isfinite(out[key]).all()), f"{what} {key} finite")
        s = out["probs"].sum(-1)
        check(float((s - 1).abs().max()) < 1e-3, f"{what} probs sum to 1")
        check(float(out["p_now"].min()) >= 0 and float(out["p_now"].max()) <= 1, f"{what} p_now in [0, 1]")

    def serve(model, reqs, B, what):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        outs = [model.probs(w) for w in reqs]
        sync()
        dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
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
    del m32
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

    # 5. times -----------------------------------------------------------------
    iters = 2 * len(reqs)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        m16.probs(reqs[i % len(reqs)])
    sync()
    dt = time.perf_counter() - t0
    audio_s_per_s = B * CHUNK_S * iters / dt
    emit("throughput", metric="audio_seconds_per_second", value=audio_s_per_s, batch=B,
         chunk_s=CHUNK_S, dtype="bfloat16", iters=iters, seconds=dt, card=smi)
    profile_forward(m16, reqs[0])

    kernels = []
    net16, _ = _compute_cast(net.to("cuda"), torch.zeros(0), conf16)
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
        launches=launches["conv_stack"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib))
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
    gru_lib = torch.nn.GRU(H, H, batch_first=True).to("cuda", dt16)
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
        launches=launches["gru_downsample"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        library_note="torch.nn.GRU (includes the x @ W_ih projection) + F.conv1d downsample + LN + GELU"))
    del xp, z, gru_lib
    torch.cuda.empty_cache()

    # attention at B=64, H=4, T=1000, Dh=64
    Hh, Dh, T = conf.num_heads, conf.dim // conf.num_heads, T50
    q, kk, v = (torch.randn(B, Hh, T, Dh, generator=gen).to("cuda", dt16) for _ in range(3))
    slopes = alibi_slopes(Hh).to(dt16).to("cuda")
    scale = 1.0 / math.sqrt(conf.dim)
    err = compare("flash_alibi", k4.flash_alibi_attention(q, kk, v, slopes, scale),
                  k4.dense_reference(q, kk, v, slopes, scale), [B, Hh, T, Dh], dt16)
    ms = cuda_ms(lambda: k4.flash_alibi_attention(q, kk, v, slopes, scale), reps=10)
    plain = cuda_ms(lambda: k4.dense_reference(q, kk, v, slopes, scale), reps=5)
    i = torch.arange(T, device="cuda")
    rel = (i[None, :] - i[:, None]).float()
    mask = (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf")).to(dt16)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask, scale=scale), reps=10)
    flops = B * Hh * 2.0 * 2 * Dh * T * (T + 1) / 2
    bnd, by = bound_ms(flops, 4.0 * B * Hh * T * Dh * 2)
    kernels.append(dict(
        name="flash_alibi", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:122",
        also_replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:54",
        launches=launches["flash_alibi"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib))
    del q, kk, v
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} ran on the main path")
    emit("timing", card=smi, dtype="bfloat16", batch=B,
         per_forward={k: launches[k] // len(reqs) for k in launches},
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

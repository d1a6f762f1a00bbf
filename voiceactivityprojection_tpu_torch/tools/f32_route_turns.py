"""The float32 routes of K1, K2, K3, K9, K11 and the attention kernels
beside the CUDA-core kernels they took over from, in turns, on the card.

    python3 -m voiceactivityprojection_tpu_torch.tools.f32_route_turns [--parent DIR] [--kernels LIST]

At the B = 64 x 20 s request's shapes (R = 128 rows), float32, weights drawn
from ``--seed``:

- K1: ``fused_conv_stack`` (conv1-conv4 on the 3xTF32 ``wgmma`` kernel)
  and the same stack on the CUDA-core ``conv_cn_relu_kernel`` at every
  layer, launched through the library's ``vap_conv_cn_relu``;
- K2 at H = 256: ``gru_downsample_fused`` (the f32 cluster kernel) and the
  block kernel ``gru_ds_kernel`` through ``vap_gru_downsample``;
- K3 at H = 256 at the frozen step's R = 32 x 2000 and at the 600 s call's
  shard shape (R = 2 x 15,000): ``gru_recurrence`` (the f32 cluster kernel)
  and the block kernel ``gru_kernel`` through ``vap_gru_recurrence``;
- K9 at H = 256 at the unfrozen step's R = 32 x 2000 and the CPC step's
  R = 32 x 128: ``gru_backward`` (the f32 cluster design) and the block
  kernels through ``vap_gru_backward``, held to the plain version at 1e-5
  of each output's largest magnitude;
- K11 at the request's R = 128 x 320,000 (``VAP_CONV_IMPL=fused``):
  ``fused_conv01`` (the 3xTF32 kernel) and, with ``--parent``, the parent
  tree's ``conv01_kernel`` on the CUDA cores through its ``vap_conv01``.

Then the attention kernels in float32 at the main path's shapes, randn
inputs from ``--seed``: K4 at a request's B=64, H=4, T=1000; K5 at B=1,
T=3000; K10 at one site of the 600 s call (4 shards of Tq=7,500 at their
offsets of Tk=30,000 keys); K6 and K7/K8 at the frozen step's B=16,
T=1000, rate 0.1. This tree's library runs the 3xTF32 kernels; the
CUDA-core kernels they replaced are no longer in it, so ``--parent DIR``
names a checkout of a tree that has them (the commit before them): its
``csrc/flash_alibi.cu``, ``csrc/flash_alibi_train.cu`` and
``csrc/conv_fused.cu`` are built into ``build/parent/`` and called through
the same C interface. Without it the attention and K11 lines time the new
kernels alone. ``--kernels`` names the lines to run (default all).

Each route's output is held against the plain version at the float32 bar
(1e-4 for the stack, 5e-5 for K2 and the attention backward, 5e-6 for K3
and the attention forward, out and lse) before it is timed. The two routes are timed in turns
(new, old, old, new; CUDA events, mean of ``--reps``), so that both see
the same clocks. Prints one JSON line per kernel, with the card's name and
power limit. Needs an NVIDIA H100 and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

ROWS = 128  # a B = 64 stereo request
SAMPLES = 320_000  # 20 s at 16 kHz
STEPS = 2_000  # its 100 Hz frames
TOL = {"conv_stack": 1e-4, "conv01": 1e-4, "gru_downsample": 5e-5, "gru_recurrence": 5e-6, "flash_alibi": 5e-6,
       "flash_alibi_offset": 5e-6, "flash_train_forward": 5e-6, "flash_train_backward": 5e-5}
ATTN_SOURCES = ("flash_alibi", "flash_alibi_train")
PARENT_SOURCES = ATTN_SOURCES + ("conv_fused",)
KERNELS = ("conv_stack", "gru_downsample", "gru_recurrence", "gru_backward", "conv01", "attention")
GRU_BACKWARD_REL = 1e-5  # K9's float32 bar: of each output's largest magnitude, at least 1


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(new, old, reps: int) -> dict:
    times = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        times[which].append(cuda_ms(new if which == "new" else old, reps))
    return times


def raise_on_launch(rc: int, what: str) -> None:
    """Raise on a failed launch through a library that may be another
    tree's, whose kernels this tree's launch ledger does not declare."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch (cudaGetLastError)")


def checked(name: str, got, want) -> float:
    """The largest error of ``got`` against the plain version's ``want``
    (two tensors, or two sequences of them), raised on when over the bar."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not (all(bool(torch.isfinite(g).all()) for g in got) and err <= TOL[name]):
        raise RuntimeError(f"{name}: {err} from the plain version, bar {TOL[name]}")
    return err


def cuda_core_stack(layers, x: torch.Tensor) -> torch.Tensor:
    """The float32 stack on ``conv_cn_relu_kernel`` at every layer."""
    z = x
    for (w, b, nw, nb), (k, s, p) in zip(layers, k1.CPC_CONV_SPECS):
        R, n_in = z.shape[:2]
        c_in = 1 if z.ndim == 2 else z.shape[2]
        n_out = (n_in + 2 * p - k) // s + 1
        out = torch.empty(R, n_out, k1.COUT, device=z.device)
        rc = k1._lib().vap_conv_cn_relu(z.data_ptr(), w.data_ptr(), b.data_ptr(), nw.data_ptr(), nb.data_ptr(),
                                        out.data_ptr(), R, n_in, n_out, c_in, k, s, p, 0, _build.stream_handle(z))
        _build.check_launch(rc, "conv_stack", "cuda cores")
        z = out
    return z


def conv_turns(state, gen, reps: int) -> dict:
    layers = [tuple(state[f"encoder.gEncoder.{i}.{p}"].cuda() for p in ("conv.w", "conv.b", "norm.w", "norm.b"))
              for i in range(len(k1.CPC_CONV_SPECS))]
    x = (0.1 * torch.randn(ROWS, SAMPLES, generator=gen)).cuda()
    want = k1.reference_stack(layers, x)
    errs = {"new": checked("conv_stack", k1.fused_conv_stack(layers, x), want),
            "old": checked("conv_stack", cuda_core_stack(layers, x), want)}
    del want
    torch.cuda.empty_cache()
    times = in_turns(lambda: k1.fused_conv_stack(layers, x), lambda: cuda_core_stack(layers, x), reps)
    return {"kernel": "conv_stack", "shape": [ROWS, SAMPLES], "new": "3xTF32 wgmma (conv1-conv4)",
            "old": "conv_cn_relu_kernel at every layer", "ms_in_turns": times, "max_abs_err": errs}


def gru_turns(state, gen, reps: int) -> dict:
    H = state["encoder.gAR.w_hh"].shape[0]
    args = [(0.5 * torch.randn(ROWS, STEPS, 3 * H, generator=gen)).cuda(),
            *(state[f"encoder.gAR.{k}"].cuda() for k in ("w_hh", "b_hh")), torch.zeros(ROWS, H, device="cuda"),
            *(state[f"encoder.downsample.{k}"].cuda() for k in ("conv.w", "conv.b", "ln.w", "ln.b"))]
    args = [a.contiguous() for a in args]
    out = torch.empty(ROWS, (STEPS + 1) // 2, H, device="cuda")

    def block():
        rc = k2._lib().vap_gru_downsample(*(a.data_ptr() for a in args), out.data_ptr(), ROWS, STEPS, H, 0,
                                          _build.stream_handle(out))
        _build.check_launch(rc, "gru_downsample", "block")
        return out

    want = k2.gru_downsample_reference(*args)
    errs = {"new": checked("gru_downsample", k2.gru_downsample_fused(*args), want),
            "old": checked("gru_downsample", block(), want)}
    times = in_turns(lambda: k2.gru_downsample_fused(*args), block, reps)
    tiling = k2.fused_tiling(ROWS, H, torch.float32)
    return {"kernel": "gru_downsample", "shape": [ROWS, STEPS, 3 * H],
            "new": f"f32 cluster kernel, {tiling.rows} rows a cluster", "old": "gru_ds_kernel (block)",
            "ms_in_turns": times, "max_abs_err": errs}


def k3_turns(state, gen, reps: int) -> list:
    """K3 in float32 at the frozen step's and the 600 s shard's shapes: the
    f32 cluster kernel and the block kernel, h0 nonzero."""
    H = state["encoder.gAR.w_hh"].shape[0]
    w_hh, b_hh = (state[f"encoder.gAR.{k}"].cuda().contiguous() for k in ("w_hh", "b_hh"))
    lines = []
    for R, T in ((32, STEPS), (2, 15_000)):
        args = [(0.5 * torch.randn(R, T, 3 * H, generator=gen)).cuda(), w_hh, b_hh,
                (0.1 * torch.randn(R, H, generator=gen)).cuda()]
        ys = torch.empty(R, T, H, device="cuda")

        def block():
            rc = k3._lib().vap_gru_recurrence(*(a.data_ptr() for a in args), ys.data_ptr(), R, T, H, 0,
                                              _build.stream_handle(ys))
            _build.check_launch(rc, "gru_recurrence", "block")
            return ys

        want, _ = k3.gru_recurrence_reference(*args)
        errs = {"new": checked("gru_recurrence", k3.gru_recurrence(*args)[0], want),
                "old": checked("gru_recurrence", block(), want)}
        del want
        times = in_turns(lambda: k3.gru_recurrence(*args), block, reps)
        tiling = k3.forward_tiling(R, H, torch.float32)
        lines.append({"kernel": "gru_recurrence", "shape": [R, T, 3 * H],
                      "new": f"f32 cluster kernel, {tiling.tiles} clusters of {tiling.rows} rows",
                      "old": "gru_kernel (block)", "ms_in_turns": times, "max_abs_err": errs})
        del args, ys
        torch.cuda.empty_cache()
    return lines


def k9_turns(state, gen, reps: int) -> list:
    """K9 in float32 at the unfrozen step's and the CPC step's shapes: the
    f32 cluster design and the block kernels, h0 nonzero, ys from K3."""
    H = state["encoder.gAR.w_hh"].shape[0]
    w_hh, b_hh = (state[f"encoder.gAR.{k}"].cuda().contiguous() for k in ("w_hh", "b_hh"))
    w_hh_t = w_hh.t().contiguous()
    lines = []
    for R, T in ((32, STEPS), (32, 128)):
        args = [(0.5 * torch.randn(R, T, 3 * H, generator=gen)).cuda(), w_hh, b_hh,
                (0.1 * torch.randn(R, H, generator=gen)).cuda()]
        ys, _ = k3.gru_recurrence(*args)
        dys = torch.randn(R, T, H, generator=gen).cuda()
        splits = k3.weight_splits(R * T, H)
        dxp, dgates = torch.empty_like(args[0]), torch.empty(R, T, 3 * H, device="cuda")
        dh0, dwb = torch.empty(R, H, device="cuda"), torch.empty(H + 1, 3 * H, device="cuda")
        partial = torch.empty(splits, H + 1, 3 * H, device="cuda")

        def block():
            rc = k3._backward_lib().vap_gru_backward(
                args[0].data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), args[3].data_ptr(),
                ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(), dgates.data_ptr(), dh0.data_ptr(), partial.data_ptr(),
                dwb.data_ptr(), R, T, H, splits, 0, _build.stream_handle(dxp))
            _build.check_launch(rc, "gru_backward", "block")
            return dxp, dwb[:H], dwb[H], dh0

        want = k3.gru_backward_reference(*args, ys, dys)
        errs = {}
        for which, got in (("new", k3.gru_backward(*args, ys, dys)), ("old", block())):
            errs[which] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            bars = [GRU_BACKWARD_REL * max(float(w.abs().max()), 1.0) for w in want]
            if not all(float((g - w).abs().max()) <= b for g, w, b in zip(got, want, bars)):
                raise RuntimeError(f"gru_backward {which}: {errs[which]} from the plain version, bars {bars}")
        del want
        times = in_turns(lambda: k3.gru_backward(*args, ys, dys), block, reps)
        tiling = k3.backward_tiling(R, H, torch.float32)
        lines.append({"kernel": "gru_backward", "shape": [R, T, 3 * H],
                      "new": f"f32 cluster design, {tiling.tiles} clusters of {tiling.rows} rows",
                      "old": "gru_bwd_recurrence_kernel + gru_bwd_weights_kernel + the slice sum (block)",
                      "ms_in_turns": times, "max_abs_err": errs})
        del args, ys, dys, dxp, dgates, partial
        torch.cuda.empty_cache()
    return lines


def k11_turns(state, gen, reps: int, old_lib) -> dict:
    """K11 in float32 at the request's shape: the 3xTF32 kernel and, where
    ``old_lib`` (the parent's conv_fused library) is given, its
    conv01_kernel."""
    layers = [tuple(state[f"encoder.gEncoder.{i}.{p}"].cuda() for p in ("conv.w", "conv.b", "norm.w", "norm.b"))
              for i in range(2)]
    x = (0.1 * torch.randn(ROWS, SAMPLES, generator=gen)).cuda()
    n1 = k11.out_len(SAMPLES)
    out = torch.empty(ROWS, n1, k11.C, device="cuda")

    def old():
        rc = old_lib.vap_conv01(x.data_ptr(), *(t.data_ptr() for l in layers for t in l), out.data_ptr(), ROWS,
                                SAMPLES, n1, 0, _build.stream_handle(x))
        raise_on_launch(rc, "parent vap_conv01")
        return out

    want = k11.reference_unfused(layers, x)
    errs = {"new": checked("conv01", k11.fused_conv01(layers, x), want)}
    if old_lib is not None:
        errs["old"] = checked("conv01", old(), want)
    del want
    torch.cuda.empty_cache()
    new = lambda: k11.fused_conv01(layers, x)
    times = in_turns(new, old, reps) if old_lib is not None else {"new": [cuda_ms(new, reps)]}
    return {"kernel": "conv01", "shape": [ROWS, SAMPLES], "new": "3xTF32 wgmma (conv1), conv0 in f32 FFMA",
            "old": "conv01_kernel of the parent tree (CUDA cores)" if old_lib is not None else "not run (no --parent)",
            "ms_in_turns": times, "max_abs_err": errs}


def parent_libs(parent: str) -> dict:
    """The attention and K11 libraries of another checkout (``parent``),
    built with this tree's flags into ``build/parent/``, with the C
    interfaces' argument types."""
    csrc = Path(parent) / "voiceactivityprojection_tpu_torch" / "csrc"
    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in PARENT_SOURCES:
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {csrc / name}.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    fwd = [ctypes.c_void_p] * 5
    libs["flash_alibi"].vap_flash_alibi.argtypes = fwd + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                                 ctypes.c_void_p]
    libs["flash_alibi"].vap_flash_alibi_offset.argtypes = fwd + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                                        ctypes.c_void_p]
    common = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    libs["flash_alibi_train"].vap_flash_train_fwd.argtypes = [ctypes.c_void_p] * 6 + common
    libs["flash_alibi_train"].vap_flash_train_bwd.argtypes = [ctypes.c_void_p] * 10 + common
    libs["conv_fused"].vap_conv01.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    libs["conv_fused"].vap_conv01.restype = ctypes.c_int
    return libs


def attention(lib, q, k, v, slopes, scale, offset=None) -> torch.Tensor:
    """One call of ``vap_flash_alibi`` (or, with an offset,
    ``vap_flash_alibi_offset``) of ``lib`` in float32."""
    B, H, Tq, Dh = q.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), out.data_ptr())
    tail = (float(scale), 0, _build.stream_handle(q))
    if offset is None:
        rc = lib.vap_flash_alibi(*ptrs, B * H, H, Tq, Dh, *tail)
    else:
        rc = lib.vap_flash_alibi_offset(*ptrs, B * H, H, Tq, k.shape[2], offset, Dh, *tail)
    raise_on_launch(rc, "vap_flash_alibi")
    return out


def forward(lib, q, k, v, slopes, seed, scale, rate):
    """One call of ``vap_flash_train_fwd`` of ``lib`` in float32: (out, lse)."""
    B, H, T, Dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, T, device=q.device)
    rc = lib.vap_flash_train_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), B * H, H, T, Dh, float(scale), *ft._dropout_args(seed, rate), 0,
                                 _build.stream_handle(q))
    raise_on_launch(rc, "vap_flash_train_fwd")
    return out, lse


def backward(lib, q, k, v, do, lse, delta, slopes, seed, scale, rate):
    """One call of ``vap_flash_train_bwd`` of ``lib`` in float32."""
    B, H, T, Dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = lib.vap_flash_train_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), slopes.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 B * H, H, T, Dh, float(scale), *ft._dropout_args(seed, rate), 0,
                                 _build.stream_handle(q))
    raise_on_launch(rc, "vap_flash_train_bwd")
    return dq, dk, dv


def attention_turns(old_libs, gen, reps: int):
    """K4, K5, K10, K6 and K7/K8 in float32: this tree's kernels and, where
    ``old_libs`` holds them, the parent's, each checked then timed (K6's
    out and lse, each at the forward bar)."""
    new_libs = {"flash_alibi": k4._lib(), "flash_alibi_train": ft._lib()}
    H, Dh = 4, 64
    scale = 1.0 / math.sqrt(H * Dh)
    slopes = alibi_slopes(H).cuda()
    rn = lambda *shape: torch.randn(*shape, generator=gen).cuda()

    def turns(kernel, shape, run, want_fn):
        want = want_fn()
        errs = {"new": checked(kernel, run(new_libs), want)}
        if old_libs:
            errs["old"] = checked(kernel, run(old_libs), want)
        del want
        torch.cuda.empty_cache()
        new = lambda: run(new_libs)
        times = in_turns(new, lambda: run(old_libs), reps) if old_libs else {"new": [cuda_ms(new, reps)]}
        return {"kernel": kernel, "shape": shape, "new": "3xTF32 wgmma",
                "old": "CUDA-core kernel of the parent tree" if old_libs else "not run (no --parent)",
                "ms_in_turns": times, "max_abs_err": errs}

    lines = []
    for name, B, T in (("flash_alibi (K4, a request)", 64, 1000), ("flash_alibi_t3000 (K5)", 1, 3000)):
        q, k, v = rn(B, H, T, Dh), rn(B, H, T, Dh), rn(B, H, T, Dh)
        lines.append(dict(turns("flash_alibi", [B, H, T, Dh],
                                lambda libs: (attention(libs["flash_alibi"], q, k, v, slopes, scale),),
                                lambda: (k4.dense_reference(q, k, v, slopes, scale),)), name=name))
        del q, k, v
    Tk, shards = 30_000, 4
    Tq = Tk // shards
    k, v = rn(1, H, Tk, Dh), rn(1, H, Tk, Dh)
    qs = [rn(1, H, Tq, Dh) for _ in range(shards)]
    offs = [d * Tq for d in range(shards)]
    lines.append(dict(turns(
        "flash_alibi_offset", f"one site of the 600 s call: {shards} launches, Tq={Tq} at {offs} of Tk={Tk}",
        lambda libs: [attention(libs["flash_alibi"], q, k, v, slopes, scale, o) for q, o in zip(qs, offs)],
        lambda: [k4.dense_offset_reference(q, k, v, slopes, scale, o) for q, o in zip(qs, offs)]),
        name="flash_alibi_offset (K10)"))
    del k, v, qs
    B, T, rate, seed = 16, 1000, 0.1, 5
    q, k, v, do = (rn(B, H, T, Dh) for _ in range(4))
    lines.append(dict(turns(
        "flash_train_forward", [B, H, T, Dh],
        lambda libs: forward(libs["flash_alibi_train"], q, k, v, slopes, seed, scale, rate),
        lambda: ft.train_forward_reference(q, k, v, slopes, seed, scale, rate)),
        name="flash_train_forward (K6, the frozen step)", rate=rate))
    out, lse = ft.flash_train_forward(q, k, v, slopes, seed, scale, rate)
    delta = (do * out).sum(-1).reshape(B * H, T)
    lines.append(dict(turns(
        "flash_train_backward", [B, H, T, Dh],
        lambda libs: backward(libs["flash_alibi_train"], q, k, v, do, lse, delta, slopes, seed, scale, rate),
        lambda: ft.train_backward_reference(q, k, v, do, lse, delta, slopes, seed, scale, rate)),
        name="flash_train_backward (K7/K8, the frozen step)", rate=rate))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parent", default=None,
                    help="a checkout whose attention and K11 sources hold the CUDA-core float32 kernels, timed "
                         "in turns")
    ap.add_argument("--kernels", default=",".join(KERNELS), help=f"comma-separated lines to run, of {KERNELS}")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(kernels - set(KERNELS))}")
    resolve_device("cuda")  # the kernels run only on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    conf = VapConfig()
    state = params_from_jax(random_params_tree(conf, seed=args.seed), conf)
    gen = torch.Generator().manual_seed(args.seed)
    for name, turns in (("conv_stack", conv_turns), ("gru_downsample", gru_turns)):
        if name in kernels:
            print(json.dumps({**turns(state, gen, args.reps), "card": card}), flush=True)
            torch.cuda.empty_cache()
    for name, turns in (("gru_recurrence", k3_turns), ("gru_backward", k9_turns)):
        for line in turns(state, gen, args.reps) if name in kernels else ():
            print(json.dumps({**line, "card": card}), flush=True)
    old = parent_libs(args.parent) if args.parent else None
    if "conv01" in kernels:
        print(json.dumps({**k11_turns(state, gen, args.reps, old["conv_fused"] if old else None), "card": card}),
              flush=True)
        torch.cuda.empty_cache()
    for line in attention_turns(old, gen, args.reps) if "attention" in kernels else ():
        print(json.dumps({**line, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

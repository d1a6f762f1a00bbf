"""The float32 routes of K1 and K2 beside the CUDA-core kernels they took
over from, in turns, on the card.

    python3 -m voiceactivityprojection_tpu_torch.tools.f32_route_turns

At the B = 64 x 20 s request's shapes (R = 128 rows), float32, weights drawn
from ``--seed``:

- K1: ``fused_conv_stack`` (conv1-conv4 on the 3xTF32 ``wgmma`` kernel)
  and the same stack on the CUDA-core ``conv_cn_relu_kernel`` at every
  layer, launched through the library's ``vap_conv_cn_relu``;
- K2 at H = 256: ``gru_downsample_fused`` (the f32 cluster kernel) and the
  block kernel ``gru_ds_kernel`` through ``vap_gru_downsample``.

Each route's output is held against the plain version at the float32 bar
(1e-4 for the stack, 5e-5 for K2) before it is timed. The two routes are
timed in turns (new, old, old, new; CUDA events, mean of ``--reps``), so
that both see the same clocks. Prints one JSON line per kernel, with the
card's name and power limit. Needs an NVIDIA H100 and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

ROWS = 128  # a B = 64 stereo request
SAMPLES = 320_000  # 20 s at 16 kHz
STEPS = 2_000  # its 100 Hz frames
TOL = {"conv_stack": 1e-4, "gru_downsample": 5e-5}


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


def checked(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= TOL[name]):
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
                                        out.data_ptr(), R, n_in, n_out, c_in, k, s, p, 0, _build.stream_handle())
        _build.check_launch(rc, "vap_conv_cn_relu")
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
                                          _build.stream_handle())
        _build.check_launch(rc, "vap_gru_downsample")
        return out

    want = k2.gru_downsample_reference(*args)
    errs = {"new": checked("gru_downsample", k2.gru_downsample_fused(*args), want),
            "old": checked("gru_downsample", block(), want)}
    times = in_turns(lambda: k2.gru_downsample_fused(*args), block, reps)
    tiling = k2.fused_tiling(ROWS, H, torch.float32)
    return {"kernel": "gru_downsample", "shape": [ROWS, STEPS, 3 * H],
            "new": f"f32 cluster kernel, {tiling.rows} rows a cluster", "old": "gru_ds_kernel (block)",
            "ms_in_turns": times, "max_abs_err": errs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    resolve_device("cuda")  # the kernels run only on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    conf = VapConfig()
    state = params_from_jax(random_params_tree(conf, seed=args.seed), conf)
    gen = torch.Generator().manual_seed(args.seed)
    for turns in (conv_turns, gru_turns):
        print(json.dumps({**turns(state, gen, args.reps), "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Each stage of the stereo forward timed on its own (JAX:
examples/profile_stages.py), at the inference request's shape by default:
bfloat16, B=64 x 20 s (encoder rows R=128, T50=1000).

    python -m voiceactivityprojection_tpu_torch.tools.profile_stages [batch] [--device cuda|cpu]

Stages: the full forward with and without ``probs_from_logits``; the conv
stack kernel (K1, R=2B); the GRU fused with the downsample (K2, the
inference path), the GRU recurrence alone (K3) and the plain downsample;
the channel GPT (1 layer) and the stereo GPT (3 layers) on B rows; the
heads; one attention pass (K4) on B and 2B rows; ``probs_from_logits``.
The stages past the encoder take seeded random inputs of their shapes.
Each is timed by ``tools/stage_timer.py`` (CUDA events over 10 chained
calls after 3 on the card; the host clock on the CPU) with its kernel
launches a call, and where ``utils/flops.py`` counts its FLOPs the
TFLOP/s and share of the card's bf16 peak. Weights are the port's seed-0
draw. Runs on the card unless ``--device cpu`` (without a card the
default raises). ``profile_stages`` returns each stage's record.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

N_SAMPLES = 320_000  # 20 s at 16 kHz


def profile_stages(batch: int = 64, device="cuda", conf: Optional[VapConfig] = None, n_samples: int = N_SAMPLES,
                   iters: int = 10) -> Dict[str, Dict]:
    """{stage name: stage_timer record} at ``batch`` x ``n_samples``."""
    from voiceactivityprojection_tpu_torch.models.encoder import _downsample
    from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo
    from voiceactivityprojection_tpu_torch.models.vap import VapModel, forward, probs_from_logits
    from voiceactivityprojection_tpu_torch.ops.attention import attention
    from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import fused_conv_stack
    from voiceactivityprojection_tpu_torch.ops.gru import gru
    from voiceactivityprojection_tpu_torch.ops.gru_downsample import gru_downsample_fused
    from voiceactivityprojection_tpu_torch.tools.stage_timer import time_stage
    from voiceactivityprojection_tpu_torch.utils.flops import device_peak_tflops, stereo_forward_flops

    dev = resolve_device(device)
    conf = conf or VapConfig(dtype="bfloat16")
    model = VapModel(conf, device=dev)
    net = model.net
    cdt = next(net.parameters()).dtype
    B, t100 = batch, n_samples // 160
    t50 = t100 // 2
    rng = np.random.default_rng(0)
    on = lambda a, dt=cdt: torch.as_tensor(a, device=dev).to(dt)
    wav = on(rng.normal(size=(B, 2, n_samples)).astype(np.float32) * 0.1, torch.float32)
    rows = wav.reshape(B * 2, n_samples).to(cdt)
    z100 = on(rng.normal(size=(B * 2, t100, conf.encoder_dim)).astype(np.float32))
    x1 = on(rng.normal(size=(B, t50, conf.dim)).astype(np.float32))
    x2 = on(rng.normal(size=(B, t50, conf.dim)).astype(np.float32))
    logits = on(rng.normal(size=(B, t50, conf.n_classes)).astype(np.float32), torch.float32)
    vad = on(rng.normal(size=(B, t50, 2)).astype(np.float32), torch.float32)

    enc, heads = net.encoder, conf.num_heads
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    g, d = enc.gAR, enc.downsample
    h0 = torch.zeros(B * 2, g.w_hh.shape[0], dtype=cdt, device=dev)
    mha = net.ar_channel.layers[0].mha
    fl = stereo_forward_flops(n_samples, conf.dim, conf.channel_layers, conf.cross_layers)
    G = lambda key: B * fl[key] / 1e9
    kw = dict(device=dev, iters=iters, peak=device_peak_tflops(dev))

    x12 = torch.cat([x1, x2], 0)

    def heads_():
        va = net.va_classifier
        v = torch.cat([x1 @ va.w.T + va.b, x2 @ va.w.T + va.b], dim=-1)
        return (x1 @ net.vap_head.w.T + net.vap_head.b).float(), v.float()

    stages = [
        ("full forward+probs", lambda: model.probs(wav)["p_now"], G("total")),
        ("full forward", lambda: forward(net, wav, conf)["logits"], G("total")),
        ("conv stack (fused, R=2B)", lambda: fused_conv_stack(layers, rows), G("conv_stack")),
        ("gru+downsample (fused, R=2B)",
         lambda: gru_downsample_fused(z100 @ g.w_ih + g.b_ih, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b),
         G("gru") + G("downsample")),
        ("gru (R=2B)", lambda: gru(z100, g.w_ih, g.w_hh, g.b_ih, g.b_hh)[0], G("gru")),
        ("downsample (R=2B)", lambda: _downsample(d, z100), G("downsample")),
        ("ar_channel GPT 1L (B)", lambda: apply_gpt(net.ar_channel, x1, num_heads=heads)["x"], G("ar_channel") / 2),
        ("ar stereo GPT 3L (B)", lambda: apply_gpt_stereo(net.ar, x1, x2, num_heads=heads)["x"], G("ar_stereo")),
        ("heads (B)", heads_, None),
        ("one attention pass (B)", lambda: attention(mha, x1, x1, heads)[0], None),
        ("one attention pass (2B)", lambda: attention(mha, x12, x12, heads)[0], None),
        ("probs_from_logits", lambda: probs_from_logits(logits, vad, conf)["p_now"], None),
    ]
    out = {}
    with torch.inference_mode():
        for name, fn, gflops in stages:
            out[name] = time_stage(name, fn, gflops=gflops, **kw)
    print(f"# B={B} total={out['full forward+probs']['ms']:.2f} ms", flush=True)
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the stereo forward's stages timed one by one (PyTorch port)")
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    profile_stages(args.batch, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Analytic FLOP counts of the VAP forward and train step (MFU).

Counterpart of ``voiceactivityprojection_tpu/utils/flops.py``: matmul and
conv terms only, a multiply-accumulate as 2 FLOPs (norms, GELU and softmax
are under 1 % of the total); attention's score and value products counted
over the causal half, T(T+1)/2 pairs, which is what the flash kernels
compute. ``device_peak_tflops`` is the card's dense bfloat16 tensor-core
peak, keyed on ``torch.cuda.get_device_name()``, and None on the CPU or an
unknown card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# (kernel, stride, in_ch) per conv layer; out_ch = dim for all
_CONV_SPECS = ((10, 5, 1), (8, 4, None), (4, 2, None), (4, 2, None), (4, 2, None))


def _conv_stack_flops(n_samples: int, dim: int) -> float:
    total = 0.0
    t = n_samples
    for k, s, c_in in _CONV_SPECS:
        c_in = dim if c_in is None else c_in
        t = t // s  # symmetric padding keeps ceil/floor ~t/s; fine at this scale
        total += 2.0 * t * k * c_in * dim
    return total


def _attention_flops(t: int, dim: int, causal: bool = True) -> float:
    """QKV+output projections + score/value matmuls for one attention site."""
    proj = 4 * 2.0 * t * dim * dim
    pairs = t * (t + 1) / 2.0 if causal else float(t) * t
    scores = 2 * 2.0 * pairs * dim  # QK^T and PV, summed over heads = dim
    return proj + scores


def _layer_flops(t: int, dim: int, cross: bool) -> float:
    ffn = 2 * 2.0 * t * dim * (3 * dim)
    n_attn = 2 if cross else 1
    return n_attn * _attention_flops(t, dim) + ffn


def stereo_forward_flops(
    n_samples: int, dim: int = 256, channel_layers: int = 1, cross_layers: int = 3,
) -> Dict[str, float]:
    """FLOPs for ONE stereo VAP forward (B=1), by stage. n_samples is the
    per-channel sample count (e.g. 320_000 for 20 s @ 16 kHz)."""
    t100 = n_samples // 160  # conv stack downsampling 160x -> 100 Hz
    t50 = t100 // 2

    conv = 2 * _conv_stack_flops(n_samples, dim)  # two channels
    # GRU per step: x-projection + h-projection, each (dim -> 3*dim)
    gru = 2 * (2 * 2.0 * t100 * dim * (3 * dim))
    down = 2 * (2.0 * t50 * 5 * dim * dim)
    ar_channel = 2 * channel_layers * _layer_flops(t50, dim, cross=False)
    ar_stereo = 2 * cross_layers * _layer_flops(t50, dim, cross=True)
    combinator = 2 * (2.0 * t50 * dim * dim)  # h0_a + h0_b
    heads = 2 * (2.0 * t50 * dim * 1) + 2.0 * t50 * dim * 256
    stages = {
        "conv_stack": conv,
        "gru": gru,
        "downsample": down,
        "ar_channel": ar_channel,
        "ar_stereo": ar_stereo,
        "combinator_heads": combinator + heads,
    }
    stages["total"] = sum(stages.values())
    return stages


def stereo_train_flops(
    n_samples: int,
    dim: int = 256,
    channel_layers: int = 1,
    cross_layers: int = 3,
    frozen_encoder: bool = True,
    flash_recompute: bool = True,
) -> Dict[str, float]:
    """FLOPs for ONE stereo training step (B=1): forward + backward
    (+ the flash-attention backward's in-kernel forward recompute).

    Backward accounting (matmul terms): a matmul/conv inside the trained
    subgraph costs 2x its forward (input-grad dX = dY W^T plus weight-grad
    dW = X^T dY, each the same shape product as the forward). With a
    frozen encoder (reference EncoderCPC.freeze(), vap/encoder.py:39-42)
    the conv stack and GRU have NO backward at all (their params carry no
    tangents and their input is the waveform constant); the learned
    downsample trains but sits at the gradient boundary, so only its
    weight-grad (1x forward) is needed. The flash training kernel
    (ops/flash_alibi_train.py) recomputes the forward scores inside the
    backward, FlashAttention-2 style: +1x the score/value matmul FLOPs
    per attention site when flash_recompute."""
    fwd = stereo_forward_flops(n_samples, dim, channel_layers, cross_layers)
    t50 = (n_samples // 160) // 2

    trained_tail = fwd["ar_channel"] + fwd["ar_stereo"] + fwd["combinator_heads"]
    if frozen_encoder:
        backward = 2.0 * trained_tail + 1.0 * fwd["downsample"]
    else:
        # dX of conv0 is negligible (c_in=1); counted anyway for simplicity
        backward = 2.0 * (
            fwd["conv_stack"] + fwd["gru"] + fwd["downsample"] + trained_tail
        )

    recompute = 0.0
    if flash_recompute:
        pairs = t50 * (t50 + 1) / 2.0
        per_site_scores = 2 * 2.0 * pairs * dim  # QK^T + PV, summed heads
        # twin channel stacks: 1 self-attn site per channel layer per
        # channel; cross layers: self + cross per channel
        n_sites = 2 * channel_layers + 4 * cross_layers
        recompute = n_sites * per_site_scores

    out = {
        "forward": fwd["total"],
        "backward": backward,
        "flash_recompute": recompute,
    }
    out["total"] = sum(out.values())
    return out


def mono_forward_flops(
    n_samples: int, dim: int = 256, channel_layers: int = 1, cross_layers: int = 3,
) -> Dict[str, float]:
    """FLOPs for ONE mono VAP forward (B=1): single-channel encoder, the
    VAD-conditioning projection, channel_layers + cross_layers PLAIN GPT
    layers (no stereo/cross sites, vap/model.py:330-353), vap head only
    (no VA classifier)."""
    st = stereo_forward_flops(n_samples, dim, channel_layers, cross_layers)
    t50 = (n_samples // 160) // 2
    layers = (channel_layers + cross_layers) * _layer_flops(t50, dim, cross=False)
    cond = 2.0 * t50 * 2 * dim  # va_condition Linear(2 -> dim)
    head = 2.0 * t50 * dim * 256
    stages = {
        "conv_stack": st["conv_stack"] / 2,
        "gru": st["gru"] / 2,
        "downsample": st["downsample"] / 2,
        "gpt": layers,
        "cond_heads": cond + head,
    }
    stages["total"] = sum(stages.values())
    return stages


# dense bfloat16 tensor-core peak per card, TFLOP/s (the vendor's figures)
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,  # H100 SXM
}


def device_peak_tflops(device: Optional[torch.device] = None) -> Optional[float]:
    """bfloat16 peak of the CUDA ``device`` (the current one by default), or
    None without CUDA or for a card not in the table."""
    if not torch.cuda.is_available() or (device is not None and torch.device(device).type != "cuda"):
        return None
    return PEAK_BF16_TFLOPS.get(torch.cuda.get_device_name(device))

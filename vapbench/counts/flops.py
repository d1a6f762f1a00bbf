"""Operations and bytes of the benchmark's calls and kernels, from shapes.

The forward and train-step arithmetic is a frozen copy of the port's
``utils/flops.py``: matmul and conv terms only, a multiply-accumulate as 2
FLOPs (norms, GELU and softmax are under 1 % of the total), attention's
score and value products over the causal half, T(T+1)/2 pairs, which is
what the flash kernels compute. Completed here with the CPC step, the
KV-streaming tick and each roofline kernel's bound, where bytes count each
input read once and each output written once, whatever a kernel reads
again.
"""

from __future__ import annotations

from typing import Dict

F32 = 4  # bytes a float32 element

# (kernel, stride, in_ch) per conv layer; out_ch = dim for all
_CONV_SPECS = ((10, 5, 1), (8, 4, None), (4, 2, None), (4, 2, None), (4, 2, None))
# (kernel, stride, pad) of the CPC conv stack, as the model pads it
CPC_CONV_SPECS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))


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

    A matmul or conv inside the trained subgraph costs 2x its forward in
    the backward (dX and dW). With a frozen encoder the conv stack and GRU
    have no backward; the trained downsample sits at the gradient
    boundary, so only its weight gradient (1x forward) is needed. The
    flash backward recomputes the scores: +1x the score/value FLOPs a
    site."""
    fwd = stereo_forward_flops(n_samples, dim, channel_layers, cross_layers)
    t50 = (n_samples // 160) // 2

    trained_tail = fwd["ar_channel"] + fwd["ar_stereo"] + fwd["combinator_heads"]
    if frozen_encoder:
        backward = 2.0 * trained_tail + 1.0 * fwd["downsample"]
    else:
        backward = 2.0 * (
            fwd["conv_stack"] + fwd["gru"] + fwd["downsample"] + trained_tail
        )

    recompute = 0.0
    if flash_recompute:
        pairs = t50 * (t50 + 1) / 2.0
        per_site_scores = 2 * 2.0 * pairs * dim  # QK^T + PV, summed heads
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
    VAD-conditioning projection, channel_layers + cross_layers plain GPT
    layers, the VAP head only."""
    st = stereo_forward_flops(n_samples, dim, channel_layers, cross_layers)
    t50 = (n_samples // 160) // 2
    layers = (channel_layers + cross_layers) * _layer_flops(t50, dim, cross=False)
    cond = 2.0 * t50 * 2 * dim
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


# ---------------------------------------------------------------- completed --
def conv_out_len(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv_stack_kernel(rows: int, n_samples: int, dim: int = 256) -> Dict[str, float]:
    """K1, the conv stack forward on ``rows`` rows of ``n_samples``: the five
    convs' products at the model's padding; bytes: the samples read once,
    the 100 Hz features written once, the weights read once."""
    flops, t, c_in, weights = 0.0, n_samples, 1, 0
    for k, s, p in CPC_CONV_SPECS:
        t = conv_out_len(t, k, s, p)
        flops += 2.0 * t * k * c_in * dim
        weights += k * c_in * dim + 3 * dim
        c_in = dim
    return {"flops": rows * flops, "bytes": F32 * (rows * n_samples + rows * t * dim + weights)}


def gru_backward_kernel(rows: int, steps: int, hidden: int = 256) -> Dict[str, float]:
    """K9, the GRU backward over ``rows`` x ``steps``: the dh product with
    W_hh a step and the dW_hh product (2 x 2 R T H 3H); bytes: the upstream
    gradient, the saved outputs and gate inputs read once, the input
    gradient written once, W_hh read and its gradient written once."""
    g3 = 3 * hidden
    flops = 2 * 2.0 * rows * steps * hidden * g3
    reads = rows * steps * (hidden + hidden + g3) + hidden * g3
    writes = rows * steps * g3 + hidden * g3 + g3
    return {"flops": flops, "bytes": F32 * (reads + writes)}


def flash_train_kernels(batch: int, heads: int, t: int, head_dim: int, sites: int) -> Dict[str, float]:
    """K6 + K7/K8 over ``sites`` attention sites a step: forward QK^T and PV,
    backward the score recompute, dV, dP, dQ and dK, each over the causal
    half; bytes: q, k, v, out, lse read or written by the forward, and q, k,
    v, out, dout, lse, delta read and dq, dk, dv written by the backward."""
    pairs = t * (t + 1) / 2.0
    per_product = 2.0 * batch * heads * pairs * head_dim
    flops = sites * 7 * per_product
    bhtd = batch * heads * t * head_dim
    bht = batch * heads * t
    fwd_bytes = 4 * bhtd + bht
    bwd_bytes = 5 * bhtd + 2 * bht + 3 * bhtd
    return {"flops": flops, "bytes": F32 * sites * (fwd_bytes + bwd_bytes)}


def infer_call(batch: int, n_samples: int, dim: int = 256, channel_layers: int = 1,
               cross_layers: int = 3, n_classes: int = 256, weight_count: int = 0) -> Dict[str, float]:
    """One ``VapModel.probs`` call on ``batch`` stereo chunks: the forward's
    FLOPs; bytes: the samples read once, the outputs (probs, p_now,
    p_future, vad, H) written once, the weights read once."""
    t50 = -(-n_samples // 320)
    flops = batch * stereo_forward_flops(n_samples, dim, channel_layers, cross_layers)["total"]
    outputs = batch * t50 * (n_classes + 2 + 2 + 2 + 1)
    return {"flops": flops, "bytes": F32 * (batch * 2 * n_samples + outputs + weight_count)}


def train_step(batch: int, n_samples: int, dim: int = 256, channel_layers: int = 1,
               cross_layers: int = 3, weight_count: int = 0, trained_count: int = 0) -> Dict[str, float]:
    """One frozen-encoder train step on ``batch`` stereo chunks:
    ``stereo_train_flops``; bytes: the samples and labels read once, the
    weights read once, and the trained weights, their gradients and
    AdamW's two moments read and written once."""
    t50 = -(-n_samples // 320)
    flops = batch * stereo_train_flops(n_samples, dim, channel_layers, cross_layers)["total"]
    labels = batch * (t50 + 100) * 2
    moved = batch * 2 * n_samples + labels + weight_count + 2 * 4 * trained_count
    return {"flops": flops, "bytes": F32 * moved}


def cpc_step(batch: int, n_samples: int, dim: int = 256, n_predicts: int = 12, n_negatives: int = 128,
             weight_count: int = 0) -> Dict[str, float]:
    """One CPC step on ``batch`` mono windows: the conv stack and the GRU
    forward and backward (3x the forward: dX and dW), the K bilinear
    predictions and the positive and negative scores forward and backward
    (3x); bytes: the samples read once, the negative indices read once,
    the weights, their gradients and Adam's two moments read and written
    once."""
    t, c_in, conv = n_samples, 1, 0.0
    for k, s, p in CPC_CONV_SPECS:
        t = conv_out_len(t, k, s, p)
        conv += 2.0 * t * k * c_in * dim
        c_in = dim
    gru = 2 * 2.0 * t * dim * 3 * dim
    tc = t - n_predicts
    preds = 2.0 * tc * dim * dim * n_predicts
    scores = 2.0 * tc * (1 + n_negatives) * dim * n_predicts
    flops = 3 * batch * (conv + gru + preds + scores)
    negs = batch * tc * n_negatives * 2  # int64 indices as two words
    moved = batch * n_samples + negs + weight_count + 2 * 4 * weight_count
    return {"flops": flops, "bytes": F32 * moved}


def kv_tick(streams: int, context: int, dim: int = 256, heads: int = 4, channel_layers: int = 1,
            cross_layers: int = 3, n_classes: int = 256, hop: int = 320, weight_count: int = 0) -> Dict[str, float]:
    """One ``BatchedKVStreamer.push`` of one frame to ``streams`` dialogs at
    ``context`` ring slots. FLOPs a stream and channel: the streaming
    encoder's frame (convs on the hop, the GRU's two steps, the
    downsample), each layer's projections, one attention row a site over
    every slot (scores and values), the FFN, and the combinator and heads.
    Bytes: every K/V ring read once (14 at the default depth), one slot of
    each written, the hop's samples read, the outputs written, the weights
    read once."""
    t, c_in, enc = hop, 1, 0.0
    for k, s, _ in CPC_CONV_SPECS:
        t = t // s
        enc += 2.0 * t * k * c_in * dim
        c_in = dim
    enc += 2 * 2 * 2.0 * dim * 3 * dim + 2.0 * 5 * dim * dim  # two GRU steps, one downsample frame
    site = 4 * 2.0 * dim * dim + 2 * 2.0 * context * dim
    ffn = 2 * 2.0 * dim * 3 * dim
    layers = channel_layers * (site + ffn) + cross_layers * (2 * site + ffn)
    heads_f = 2 * 2.0 * dim * dim + 2 * 2.0 * dim + 2.0 * dim * n_classes
    flops = streams * (2 * (enc + layers) + heads_f)
    rings = 2 * channel_layers + 4 * cross_layers
    ring_elems = streams * 2 * context * dim  # (S, 2 channels, H, T, Dh) = S * 2 * T * dim
    moved = (rings * ring_elems + rings * streams * 2 * dim + streams * 2 * hop
             + streams * (2 + 2 + 2) + weight_count)
    return {"flops": flops, "bytes": F32 * moved, "ring_bytes": F32 * rings * ring_elems}


def kv_ring_bytes_per_dialog(context: int, dim: int = 256, channel_layers: int = 1, cross_layers: int = 3) -> int:
    """Bytes of the K/V rings one dialog holds: 14 rings of 2 channels x
    ``context`` slots x ``dim`` float32 at the default depth."""
    return F32 * (2 * channel_layers + 4 * cross_layers) * 2 * context * dim

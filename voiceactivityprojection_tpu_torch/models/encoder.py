"""CPC audio encoder: conv stack -> GRU -> causal downsample (50 Hz).

Counterpart of ``voiceactivityprojection_tpu/models/encoder.py:44-182``:

  conv stack (k=10,8,4,4,4; s=5,4,2,2,2; symmetric pad 3,2,1,1,1;
              ChannelNorm + ReLU after each)         -> 100 Hz, 256 ch
  x_proj = z @ W_ih + b_ih                           (torch.matmul)
  GRU from h0 = 0, causal downsample conv (k=5, s=2)
      + LayerNorm + GELU                             -> 50 Hz, 256 ch

Three paths, chosen by the caller as in the JAX package: inference runs
the conv stack kernel (``ops/conv_stack_fused.py``) and the GRU fused with
its downsample epilogue (``ops/gru_downsample.py``); frozen-encoder
training runs the conv stack kernel, ``gru`` (the recurrence kernel,
``ops/gru_recurrence.py``, on the card) and the plain downsample, which
trains; unfrozen training (and CPC pretraining, ``train/cpc_pretrain.py``)
runs the plain conv stack (the JAX package's XLA convs), ``gru`` (on the
card the recurrence kernel, differentiated by the GRU backward kernel) and
the plain downsample. On CPU tensors every kernel wrapper takes its plain
PyTorch version.

Two environment knobs override the conv stage and the GRU epilogue, as in
the JAX encoder (``_conv_stack`` :81-120, ``apply_encoder`` :158-169):
``VAP_CONV_IMPL`` = ``xla`` (the plain stack), ``fused`` (the conv0 + conv1
kernel, ``ops/conv_fused.py``, then the plain layers 2-4) or
``fused_stack`` (the conv stack kernel whatever the caller asked); unset,
the caller's ``fused_auto`` decides. Any other value raises, where JAX
falls back to its XLA convs. ``VAP_GRU_DS`` other than ``fused`` (the
default) turns the GRU + downsample kernel off: inference then runs
``gru`` and the plain downsample.

Streaming (JAX: encoder.py:188-258): ``apply_encoder_streaming`` encodes a
chunk of samples from an ``EncoderState`` (conv tails, GRU hidden,
downsample tail), the strictly causal, approximate variant
(``encoder_mode="causal"`` of the streamers in ``inference/``). Its convs
run plain (a hop is a few hundred samples, too short for the conv stack
kernel, as in JAX); its GRU is ``gru`` from the carried hidden state, on
the card the recurrence kernel (K3) with that h0.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voiceactivityprojection_tpu_torch.ops.conv import causal_conv1d, channel_norm, conv1d, layer_norm
from voiceactivityprojection_tpu_torch.ops.conv_fused import fused_conv01, fused_conv01_supported
from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import (
    CPC_CONV_SPECS,
    fused_conv_stack,
    plain_layers,
    reference_stack,
)
from voiceactivityprojection_tpu_torch.ops.gru import gru
from voiceactivityprojection_tpu_torch.ops.gru_downsample import (
    DOWNSAMPLE_KERNEL,
    DOWNSAMPLE_STRIDE,
    gru_downsample_fused,
)
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup

__all__ = [
    "CONV_IMPLS", "CPC_CONV_SPECS", "Encoder", "EncoderState", "apply_encoder",
    "apply_encoder_streaming", "init_encoder_state",
]

CONV_IMPLS = ("xla", "fused", "fused_stack")  # the values VAP_CONV_IMPL takes


class ConvNormLayer(nn.Module):
    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.conv = ParamGroup(w=(k, c_in, c_out), b=(c_out,))
        self.norm = ParamGroup(w=(c_out,), b=(c_out,))


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = ParamGroup(w=(DOWNSAMPLE_KERNEL, dim, dim), b=(dim,))
        self.ln = ParamGroup(w=(dim,), b=(dim,))


class Encoder(nn.Module):
    """Parameters named as the JAX ``init_encoder`` tree:
    ``gEncoder[i].{conv,norm}``, ``gAR.{w_ih,w_hh,b_ih,b_hh}``,
    ``downsample.{conv,ln}``."""

    def __init__(self, dim: int = 256):
        super().__init__()
        c_in = 1
        layers = []
        for k, _, _ in CPC_CONV_SPECS:
            layers.append(ConvNormLayer(k, c_in, dim))
            c_in = dim
        self.gEncoder = nn.ModuleList(layers)
        self.gAR = ParamGroup(
            w_ih=(dim, 3 * dim), w_hh=(dim, 3 * dim), b_ih=(3 * dim,), b_hh=(3 * dim,)
        )
        self.downsample = Downsample(dim)


def _downsample(d: Downsample, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) at 100 Hz -> (B, ceil(T/2), C) at 50 Hz (JAX: encoder.py:123)."""
    x = causal_conv1d(x, d.conv.w, d.conv.b, stride=DOWNSAMPLE_STRIDE)
    return F.gelu(layer_norm(x, d.ln.w, d.ln.b))


def _conv_stack(enc: Encoder, x: torch.Tensor, fused_auto: bool = False) -> torch.Tensor:
    """(R, n) samples -> (R, n/160, C) features at 100 Hz (JAX: encoder.py:81-120).

    ``VAP_CONV_IMPL=fused_stack``, or the knob unset with ``fused_auto``,
    runs the conv stack kernel; ``fused`` runs the conv0 + conv1 kernel
    where the first two layers have its shapes, then the plain layers 2-4;
    ``xla``, or the knob unset without ``fused_auto``, the plain stack."""
    impl = os.environ.get("VAP_CONV_IMPL")
    if impl is not None and impl not in CONV_IMPLS:
        raise ValueError(f"VAP_CONV_IMPL={impl!r}: expected one of {CONV_IMPLS} or unset")
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    if impl == "fused_stack" or (impl is None and fused_auto):
        return fused_conv_stack(layers, x)
    if impl == "fused" and fused_conv01_supported(layers):
        return plain_layers(layers[2:], fused_conv01(layers, x), CPC_CONV_SPECS[2:])
    return reference_stack(layers, x)


def apply_encoder(
    enc: Encoder,
    waveform: torch.Tensor,
    fused_auto: bool = False,
    fuse_downsample: bool = True,
) -> torch.Tensor:
    """waveform (B, n) or (B, 1, n) -> (B, ceil(n/320), C) at 50 Hz.

    ``fused_auto`` takes the conv stack kernel (the caller's promise that no
    gradient flows into the conv stack: inference or a frozen encoder);
    without it the plain conv stack runs (``VAP_CONV_IMPL`` overrides both,
    see ``_conv_stack``). ``fuse_downsample`` with ``fused_auto`` takes the
    GRU + downsample kernel (inference) unless ``VAP_GRU_DS`` turns it off;
    otherwise ``gru`` (the recurrence kernel on the card) and the plain,
    trainable downsample run (JAX: encoder.py:131-182)."""
    if waveform.ndim == 3:
        if waveform.shape[1] != 1:
            raise ValueError(f"expected a mono channel, got {tuple(waveform.shape)}")
        waveform = waveform[:, 0]
    z = _conv_stack(enc, waveform.contiguous(), fused_auto=fused_auto)
    g, d = enc.gAR, enc.downsample
    if fused_auto and fuse_downsample and os.environ.get("VAP_GRU_DS", "fused") == "fused":
        x_proj = z @ g.w_ih + g.b_ih
        h0 = torch.zeros(z.shape[0], g.w_hh.shape[0], dtype=z.dtype, device=z.device)
        return gru_downsample_fused(
            x_proj, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b
        )
    z, _ = gru(z, g.w_ih, g.w_hh, g.b_ih, g.b_hh)
    return _downsample(d, z)


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------
class EncoderState(NamedTuple):
    """Carry of incremental encoding (JAX: encoder.py:188-201).

    conv_tails: per conv layer, the last max(k - s, p) input columns seen
                (seeded with zeros: the first chunk's left padding);
    gru_h:      (B, H) GRU hidden, contiguous (the recurrence kernel's h0);
    down_tail:  the last k - s = 3 downsample-input frames.
    """

    conv_tails: Tuple[torch.Tensor, ...]
    gru_h: torch.Tensor
    down_tail: torch.Tensor


def init_encoder_state(enc: Encoder, batch: int, dtype: torch.dtype = torch.float32) -> EncoderState:
    """Zeroed tails and hidden state on the encoder's device."""
    device = enc.gAR.w_hh.device
    dim = enc.gAR.w_hh.shape[0]
    tails, c_in = [], 1
    for k, s, p in CPC_CONV_SPECS:
        tails.append(torch.zeros(batch, max(k - s, p), c_in, dtype=dtype, device=device))
        c_in = dim
    keep = DOWNSAMPLE_KERNEL - DOWNSAMPLE_STRIDE
    return EncoderState(
        conv_tails=tuple(tails),
        gru_h=torch.zeros(batch, dim, dtype=dtype, device=device),
        down_tail=torch.zeros(batch, keep, dim, dtype=dtype, device=device),
    )


def apply_encoder_streaming(
    enc: Encoder, chunk: torch.Tensor, state: EncoderState
) -> Tuple[torch.Tensor, EncoderState]:
    """chunk (B, n), n a multiple of 320 -> (features (B, n/320, C), new state).

    The approximate fast path of JAX (encoder.py:220-258): every layer
    prepends its tail and convolves unpadded, so each chunk gives exactly
    n/320 frames, offset by a few samples from the symmetrically padded
    batch forward where k - s > p. ``models/encoder_streaming_exact.py``
    reproduces the batch frames."""
    x = chunk[..., None]
    new_tails = []
    for layer, (k, s, _), tail in zip(enc.gEncoder, CPC_CONV_SPECS, state.conv_tails):
        x = torch.cat([tail, x], dim=1)
        keep = max(k - s, 0)
        new_tails.append(x[:, x.shape[1] - keep:])
        x = conv1d(x, layer.conv.w, layer.conv.b, stride=s)
        x = torch.relu(channel_norm(x, layer.norm.w, layer.norm.b))
    g, d = enc.gAR, enc.downsample
    z, h = gru(x, g.w_ih, g.w_hh, g.b_ih, g.b_hh, h0=state.gru_h)
    zc = torch.cat([state.down_tail, z], dim=1)
    down_tail = zc[:, zc.shape[1] - (DOWNSAMPLE_KERNEL - DOWNSAMPLE_STRIDE):]
    y = conv1d(zc, d.conv.w, d.conv.b, stride=DOWNSAMPLE_STRIDE)
    y = F.gelu(layer_norm(y, d.ln.w, d.ln.b))
    return y, EncoderState(tuple(new_tails), h.contiguous(), down_tail)

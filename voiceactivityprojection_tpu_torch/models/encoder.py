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
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from voiceactivityprojection_tpu_torch.ops.conv import causal_conv1d, layer_norm
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

__all__ = ["CONV_IMPLS", "CPC_CONV_SPECS", "Encoder", "apply_encoder"]

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

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from voiceactivityprojection_tpu_torch.ops.conv import causal_conv1d, layer_norm
from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import (
    CPC_CONV_SPECS,
    fused_conv_stack,
    reference_stack,
)
from voiceactivityprojection_tpu_torch.ops.gru import gru
from voiceactivityprojection_tpu_torch.ops.gru_downsample import (
    DOWNSAMPLE_KERNEL,
    DOWNSAMPLE_STRIDE,
    gru_downsample_fused,
)
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup

__all__ = ["CPC_CONV_SPECS", "Encoder", "apply_encoder"]


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


def apply_encoder(
    enc: Encoder,
    waveform: torch.Tensor,
    fused_auto: bool = False,
    fuse_downsample: bool = True,
) -> torch.Tensor:
    """waveform (B, n) or (B, 1, n) -> (B, ceil(n/320), C) at 50 Hz.

    ``fused_auto`` takes the conv stack kernel (the caller's promise that no
    gradient flows into the conv stack: inference or a frozen encoder);
    without it the plain conv stack runs. ``fuse_downsample`` with
    ``fused_auto`` takes the GRU + downsample kernel (inference); otherwise
    ``gru`` (the recurrence kernel on the card) and the plain, trainable
    downsample run (JAX: encoder.py:131-182)."""
    if waveform.ndim == 3:
        if waveform.shape[1] != 1:
            raise ValueError(f"expected a mono channel, got {tuple(waveform.shape)}")
        waveform = waveform[:, 0]
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    x = waveform.contiguous()
    z = fused_conv_stack(layers, x) if fused_auto else reference_stack(layers, x)
    g, d = enc.gAR, enc.downsample
    if fused_auto and fuse_downsample:
        x_proj = z @ g.w_ih + g.b_ih
        h0 = torch.zeros(z.shape[0], g.w_hh.shape[0], dtype=z.dtype, device=z.device)
        return gru_downsample_fused(
            x_proj, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b
        )
    z, _ = gru(z, g.w_ih, g.w_hh, g.b_ih, g.b_hh)
    return _downsample(d, z)

"""CPC audio encoder: conv stack -> GRU -> causal downsample (50 Hz).

Counterpart of ``voiceactivityprojection_tpu/models/encoder.py:44-182``
(inference path: ``apply_encoder`` with ``fused_auto`` and
``fuse_downsample``):

  conv stack (k=10,8,4,4,4; s=5,4,2,2,2; symmetric pad 3,2,1,1,1;
              ChannelNorm + ReLU after each)         -> 100 Hz, 256 ch
  x_proj = z @ W_ih + b_ih                           (torch.matmul)
  GRU from h0 = 0, causal downsample conv (k=5, s=2)
      + LayerNorm + GELU                             -> 50 Hz, 256 ch

The conv stack is one kernel wrapper (``ops/conv_stack_fused.py``) and the
GRU with its downsample epilogue another (``ops/gru_downsample.py``); on
CPU tensors both take their plain PyTorch versions.
"""

from __future__ import annotations

import torch
from torch import nn

from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import (
    CPC_CONV_SPECS,
    fused_conv_stack,
)
from voiceactivityprojection_tpu_torch.ops.gru_downsample import (
    DOWNSAMPLE_KERNEL,
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


def apply_encoder(enc: Encoder, waveform: torch.Tensor) -> torch.Tensor:
    """waveform (B, n) or (B, 1, n) -> (B, ceil(n/320), C) at 50 Hz."""
    if waveform.ndim == 3:
        if waveform.shape[1] != 1:
            raise ValueError(f"expected a mono channel, got {tuple(waveform.shape)}")
        waveform = waveform[:, 0]
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    z = fused_conv_stack(layers, waveform.contiguous())
    g, d = enc.gAR, enc.downsample
    x_proj = z @ g.w_ih + g.b_ih
    h0 = torch.zeros(z.shape[0], g.w_hh.shape[0], dtype=z.dtype, device=z.device)
    return gru_downsample_fused(
        x_proj, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b
    )

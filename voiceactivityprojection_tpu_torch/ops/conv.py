"""1-D convolution and normalisation, feature-last layout.

Counterpart of ``voiceactivityprojection_tpu/ops/conv.py:27-91``. Every
function takes (B, T, C) activations and (K, Cin, Cout) conv weights, the
JAX package's layouts.

``conv1d`` is written as im2col (``Tensor.unfold``) plus one matrix
product, the plain version of the conv contraction that the conv-stack
kernel (``ops/conv_stack_fused.py``) computes by hand.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Tuple[int, int] = (0, 0),
    dilation: int = 1,
) -> torch.Tensor:
    """x: (B, T, Cin); w: (K, Cin, Cout); returns (B, T', Cout)."""
    k, c_in, c_out = w.shape
    x = F.pad(x, (0, 0, padding[0], padding[1]))
    span = (k - 1) * dilation + 1
    cols = x.unfold(1, span, stride)  # (B, T', Cin, span)
    if dilation > 1:
        cols = cols[..., ::dilation]
    B, t_out = cols.shape[:2]
    cols = cols.transpose(2, 3).reshape(B, t_out, k * c_in)
    out = cols @ w.reshape(k * c_in, c_out)
    if b is not None:
        out = out + b
    return out


def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Left-pad (K-1)*dilation, no right pad (JAX: ops/conv.py:49-59)."""
    pad = (w.shape[0] - 1) * max(dilation, 1)
    return conv1d(x, w, b, stride=stride, padding=(pad, 0), dilation=dilation)


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def channel_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Normalise over the feature axis with *unbiased* variance
    (JAX: ops/conv.py:62-78); statistics in at least float32."""
    dtype = x.dtype
    xf = x.to(_stat_dtype(dtype))
    c = x.shape[-1]
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0) * (c / (c - 1))
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight + bias).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the feature axis, biased variance
    (JAX: ops/conv.py:81-91); statistics in at least float32."""
    dtype = x.dtype
    xf = x.to(_stat_dtype(dtype))
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight + bias).to(dtype)

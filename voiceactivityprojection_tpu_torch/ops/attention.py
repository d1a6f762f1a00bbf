"""Multi-head causal attention with ALiBi biases.

Counterpart of ``voiceactivityprojection_tpu/ops/attention.py:33-213``:

* scale = 1/sqrt(FULL model dim), not the head dim (attention.py:90);
* bias ``slope_h * (j - i)`` for key j <= query i, -inf above the diagonal;
* slopes from Press et al.'s power-of-2 recipe, kept in the weights as
  the non-trainable ``m``.

``attention`` dispatches like the JAX function: CUDA tensors without a
request for the weights go to the hand-written kernels (with attention
dropout or a gradient asked for ``ops/flash_alibi_train.py``, else the
inference kernel ``ops/flash_alibi.py``); everything else takes
``attention_dense``. The Q/K/V/output projections
stay ``torch.matmul``, as the JAX package leaves them to XLA outside its
kernels. Attention dropout drops the softmax weights by the kernels'
coordinate-hash mask on every path, so the card and the CPU agree for one
seed; the JAX dense path draws ``jax.random.bernoulli`` instead
(attention.py:130-132).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.flash_alibi import flash_alibi_attention
from voiceactivityprojection_tpu_torch.ops.flash_alibi_train import (
    flash_alibi_attention_train,
    keep_mask,
)
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Press et al. ALiBi slopes (JAX: attention.py:33-48)."""

    def power_of_2(n: int):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = power_of_2(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = (
            power_of_2(closest)
            + alibi_slopes(2 * closest).tolist()[0::2][: num_heads - closest]
        )
    return torch.tensor(slopes, dtype=torch.float32)


class MHA(nn.Module):
    """Bias-free Q/K/V/output projections (``w`` is (out, in)) plus the
    slopes ``m`` as a buffer (JAX: ``init_mha``, attention.py:51-62)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, ParamGroup(w=(dim, dim)))
        self.register_buffer("m", alibi_slopes(num_heads))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _dropout_seed(generator: torch.Generator) -> int:
    """Per-call seed of the attention dropout mask, an int32 in [0, 2^31 - 1)
    (JAX: attention.py:191-193), drawn from a CPU generator: no device sync."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def attention_dense(
    p: MHA,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    num_heads: int,
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q_in: (B, T, D) query source; kv_in: (B, T, D) key/value source on
    the same timeline. Scores and softmax in at least float32; the
    weights are cast to v's dtype before the value product. With
    ``dropout_rate`` > 0 and a CPU ``generator`` the weights are dropped by
    the kernels' coordinate-hash mask (``ops/flash_alibi_train.py``) for a
    seed drawn from it, where the JAX dense path draws Bernoulli bits."""
    B, T, D = q_in.shape
    scale = 1.0 / math.sqrt(D)
    q = _split_heads(q_in @ p.query.w.T, num_heads)
    k = _split_heads(kv_in @ p.key.w.T, num_heads)
    v = _split_heads(kv_in @ p.value.w.T, num_heads)

    sdt = torch.promote_types(q.dtype, torch.float32)
    scores = (q.to(sdt) @ k.to(sdt).transpose(-1, -2)) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(kv_in.shape[1], device=q.device)[None, :]
    bias = p.m.to(sdt)[:, None, None] * (j - i)
    scores = (scores + bias).masked_fill(j > i, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    w = weights
    if dropout_rate > 0.0 and generator is not None:
        keep = keep_mask(B, num_heads, T, _dropout_seed(generator), dropout_rate, q.device)
        w = torch.where(keep, w / (1.0 - dropout_rate), 0.0)
    out = _merge_heads(w @ v) @ p.proj.w.T
    return out, (weights if return_weights else None)


def attention(
    p: MHA,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    num_heads: int,
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching entry point (JAX: attention.py:139-213): CUDA tensors
    without a request for the weights go to the training kernels when
    dropout is on (``dropout_rate`` > 0 and a CPU ``generator`` for the
    per-call seed) or a gradient is asked for (then at rate 0 if dropout is
    off), and to the inference kernel otherwise; everything else takes
    ``attention_dense``."""
    if q_in.is_cuda and not return_weights:
        scale = 1.0 / math.sqrt(q_in.shape[-1])
        q = _split_heads(q_in @ p.query.w.T, num_heads).contiguous()
        k = _split_heads(kv_in @ p.key.w.T, num_heads).contiguous()
        v = _split_heads(kv_in @ p.value.w.T, num_heads).contiguous()
        dropping = dropout_rate > 0.0 and generator is not None
        if dropping or _build.grad_requested(q, k, v):
            seed = _dropout_seed(generator) if dropping else 0
            rate = float(dropout_rate) if dropping else 0.0
            out = flash_alibi_attention_train(q, k, v, p.m, seed, scale, rate)
        else:
            out = flash_alibi_attention(q, k, v, p.m, scale)
        return _merge_heads(out) @ p.proj.w.T, None
    return attention_dense(
        p, q_in, kv_in, num_heads, return_weights=return_weights,
        dropout_rate=dropout_rate, generator=generator,
    )

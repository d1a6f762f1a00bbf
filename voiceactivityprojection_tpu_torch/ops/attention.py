"""Multi-head causal attention with ALiBi biases.

Counterpart of ``voiceactivityprojection_tpu/ops/attention.py:33-213``:

* scale = 1/sqrt(FULL model dim), not the head dim (attention.py:90);
* bias ``slope_h * (j - i)`` for key j <= query i, -inf above the diagonal;
* slopes from Press et al.'s power-of-2 recipe, kept in the weights as
  the non-trainable ``m``.

``attention`` dispatches like the JAX function, on ``impl`` (the config's
``attn_impl``) through ``use_kernels``: ``"auto"`` sends CUDA tensors
without a request for the weights to the hand-written kernels, ``"pallas"``
sends every call to the kernel wrappers (which take their plain versions on
CPU tensors) and raises where they cannot serve it, ``"xla"`` takes
``attention_dense`` on any device. The kernels are built for the head
widths in ``KERNEL_HEAD_DIMS``; a call on the card at another width raises
under ``"auto"`` and ``"pallas"`` rather than leave the kernels, and runs
under ``"xla"``. On the kernel route, with attention
dropout or a gradient asked for, ``ops/flash_alibi_train.py`` runs, else
the inference kernel ``ops/flash_alibi.py``. The Q/K/V/output projections
go through ``ops/linear.py`` ``linear_tf32x3`` (K13 on a float32 CUDA
tensor: q, k, v in one launch for self-attention, k and v in one for
cross-attention; ``x @ w.T`` otherwise), where the JAX package leaves
them to XLA. Attention dropout drops the softmax weights by the kernels'
coordinate-hash mask on every path, so the card and the CPU agree for one
seed; the JAX dense path draws ``jax.random.bernoulli`` instead
(attention.py:130-132). Two divergences from JAX: an unknown ``impl``
raises (JAX takes the dense path), and on the card a head width outside
``KERNEL_HEAD_DIMS`` raises unless ``impl="xla"`` (JAX's Pallas kernels
read any width).

Under tensor parallelism (``parallel/tp.py``) an ``MHA`` holds this rank's
``num_heads / n_model`` heads: q/k/v project to that share of the width,
the head width is read from the projection (not from the input, which
stays whole), the scale stays 1/sqrt(full dim), and the output projection's
partial sum is reduced over the model ranks before it is returned.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.flash_alibi import HEAD_DIMS, flash_alibi_attention
from voiceactivityprojection_tpu_torch.ops.flash_alibi_train import (
    flash_alibi_attention_train,
    keep_mask,
)
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutShard
from voiceactivityprojection_tpu_torch.ops.linear import linear_tf32x3
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.parallel.tp import (
    ModelShard, copy_to_model, local_heads, model_shard, reduce_from_model,
)

ATTN_IMPLS = ("auto", "xla", "pallas")
# head widths (model dim / heads) the attention kernels are instantiated for
KERNEL_HEAD_DIMS = HEAD_DIMS


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


def _dropout_seed(generator: torch.Generator, heads: int = 1, shard: Optional[DropoutShard] = None,
                  tp: Optional[ModelShard] = None) -> int:
    """Per-call seed of the attention dropout mask, an int32 in [0, 2^31 - 1)
    (JAX: attention.py:191-193), drawn from a CPU generator: no device sync;
    moved to a rank's rows of the global batch under ``shard``, folded with
    the model rank under ``tp`` (``ops/dropout.py``)."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    if shard is None and tp is None:
        return seed
    return (shard or DropoutShard()).attention_seed(seed, heads, tp)


def _qkv(p: MHA, q_in: torch.Tensor, kv_in: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The q, k, v projections (B, T, width): one launch of K13 for
    self-attention, two (q; k and v) for cross-attention."""
    if kv_in is q_in:
        return linear_tf32x3(q_in, (p.query.w, p.key.w, p.value.w))
    return (linear_tf32x3(q_in, p.query.w), *linear_tf32x3(kv_in, (p.key.w, p.value.w)))


def _out_proj(p: MHA, o: torch.Tensor, tp: Optional[ModelShard], residual: Optional[torch.Tensor]) -> torch.Tensor:
    """``residual +`` the output projection reduced over the model ranks;
    on one rank the residual is added in the projection's epilogue."""
    if tp is None:
        return linear_tf32x3(o, p.proj.w, residual=residual)
    out = reduce_from_model(linear_tf32x3(o, p.proj.w), tp)
    return out if residual is None else residual + out


def attention_dense(
    p: MHA,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    num_heads: int,
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    shard: Optional[DropoutShard] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q_in: (B, T, D) query source; kv_in: (B, T, D) key/value source on
    the same timeline; ``num_heads`` the heads ``p`` holds. Scores and
    softmax in at least float32; the weights are cast to v's dtype before
    the value product. With ``dropout_rate`` > 0 and a CPU ``generator``
    the weights are dropped by the kernels' coordinate-hash mask
    (``ops/flash_alibi_train.py``) for a seed drawn from it, where the JAX
    dense path draws Bernoulli bits. Returns the output projection before
    any reduction over model ranks."""
    B, T, D = q_in.shape
    scale = 1.0 / math.sqrt(D)
    q, k, v = (_split_heads(t, num_heads) for t in _qkv(p, q_in, kv_in))

    sdt = torch.promote_types(q.dtype, torch.float32)
    scores = (q.to(sdt) @ k.to(sdt).transpose(-1, -2)) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(kv_in.shape[1], device=q.device)[None, :]
    bias = p.m.to(sdt)[:, None, None] * (j - i)
    scores = (scores + bias).masked_fill(j > i, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    w = weights
    if dropout_rate > 0.0 and generator is not None:
        seed = _dropout_seed(generator, num_heads, shard, model_shard(p))
        keep = keep_mask(B, num_heads, T, seed, dropout_rate, q.device)
        w = torch.where(keep, w / (1.0 - dropout_rate), 0.0)
    out = linear_tf32x3(_merge_heads(w @ v), p.proj.w)
    return out, (weights if return_weights else None)


def use_kernels(impl: str, is_cuda: bool, head_dim: int, return_weights: bool) -> bool:
    """The dispatch rule of ``attention`` (JAX: attention.py:155-178):
    whether a call goes to the kernel wrappers (True) or to
    ``attention_dense``. Raises ``ValueError`` for an ``impl`` outside
    ``ATTN_IMPLS``, for ``"pallas"`` with weights, and for a call on the
    card at a head width outside ``KERNEL_HEAD_DIMS`` that is not
    ``"xla"`` and asks for no weights."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl == "xla":
        return False
    if return_weights:
        if impl == "pallas":
            raise ValueError(
                "impl='pallas' cannot return attention weights (the flash kernels never "
                "materialize them); use impl='auto' or 'xla'"
            )
        return False
    if is_cuda and head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"impl={impl!r}: the attention kernels take head width {KERNEL_HEAD_DIMS}, "
            f"got {head_dim}; use impl='xla' for dense attention"
        )
    return is_cuda or impl == "pallas"


def attention(
    p: MHA,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    num_heads: int,
    impl: str = "auto",
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    shard: Optional[DropoutShard] = None,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching entry point (JAX: attention.py:139-213), routed by
    ``use_kernels``. On the kernel route the training kernels run when
    dropout is on (``dropout_rate`` > 0 and a CPU ``generator`` for the
    per-call seed) or a gradient is asked for (then at rate 0 if dropout is
    off), the inference kernel otherwise; the wrappers take their plain
    versions on CPU tensors. Every other call takes ``attention_dense``.
    ``num_heads`` is the model's; a tensor-parallel ``p`` holds its share of
    them (``parallel/tp.py``), and ``shard`` places the dropout mask of a
    rank's rows (``ops/dropout.py``). With ``residual`` (B, T, D) the
    output is ``residual +`` the attention (the caller's add where no
    dropout lies between)."""
    heads, tp = local_heads(p, num_heads)
    head_dim = p.query.w.shape[0] // heads  # the projection's width: under TP the input stays whole
    self_attention = kv_in is q_in
    q_in = copy_to_model(q_in, tp)
    kv_in = q_in if self_attention else copy_to_model(kv_in, tp)
    if use_kernels(impl, q_in.is_cuda, head_dim, return_weights):
        scale = 1.0 / math.sqrt(q_in.shape[-1])
        q, k, v = (_split_heads(t, heads).contiguous() for t in _qkv(p, q_in, kv_in))
        dropping = dropout_rate > 0.0 and generator is not None
        if dropping or _build.grad_requested(q, k, v):
            seed = _dropout_seed(generator, heads, shard, tp) if dropping else 0
            rate = float(dropout_rate) if dropping else 0.0
            out = flash_alibi_attention_train(q, k, v, p.m, seed, scale, rate)
        else:
            out = flash_alibi_attention(q, k, v, p.m, scale)
        return _out_proj(p, _merge_heads(out), tp, residual), None
    out, weights = attention_dense(
        p, q_in, kv_in, heads, return_weights=return_weights,
        dropout_rate=dropout_rate, generator=generator, shard=shard,
    )
    out = reduce_from_model(out, tp)
    return (out if residual is None else residual + out), weights

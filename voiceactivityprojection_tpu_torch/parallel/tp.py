"""Tensor parallelism over processes: Megatron shards of the attention and
FFN weights along the ``"model"`` axis of a ``ProcessLayout``.

Counterpart of ``voiceactivityprojection_tpu/parallel/tp.py``
(``_layer_specs`` :25, ``tp_param_specs`` :49, ``shard_params_tp`` :67):

  attention q/k/v are row-parallel (each rank projects to its heads),
  the output projection is column-parallel (it contracts them back to a
  partial sum), FFN ``w_in`` rows and ``w_out`` columns likewise;

everything else (norms, heads, encoder, combinator) stays replicated. JAX
places the tree with ``NamedSharding``s and GSPMD inserts one all-reduce
per attention and FFN block. Here each rank holds plain local tensors (the
kernels are ctypes launches on raw pointers, which a ``DTensor`` would not
reach) and the reduce points are explicit, Megatron's pair of autograd
functions around each block (``ops/attention.py``, ``models/transformer.py``
``_ffn``): ``copy_to_model`` (identity forward, all-reduce of the gradient)
on the block's input and ``reduce_from_model`` (all-reduce forward, identity
backward) on its output, before the dropout and the residual add. So the
replicated weights get equal gradients on every model rank.

One divergence: JAX replicates the ALiBi slopes ``m`` and GSPMD indexes
them; here a rank keeps its heads' slopes, ``m[h0 : h0 + H / n_model]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

# P("model", None) -> 0, P(None, "model") -> 1, P() -> None
_MHA_SPECS = {"query.w": 0, "key.w": 0, "value.w": 0, "proj.w": 1, "m": None}
_FFN_SPECS = {"w_in.w": 0, "w_out.w": 1}
_LN_NAMES = ("w", "b")


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A sharded block's ``"model"`` axis: the group its partial sums are
    reduced over, its size and this rank's place in it (which the dropout
    masks read, ``ops/dropout.py``)."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int = 0


def _layer_specs(prefix: str, cross: bool) -> Dict[str, Optional[int]]:
    """One transformer layer's names (JAX ``_layer_specs`` :25)."""
    specs: Dict[str, Optional[int]] = {}
    lns = ("ln_self_attn", "ln_ffnetwork") + (("ln_src_attn",) if cross else ())
    for ln in lns:
        specs.update({f"{prefix}{ln}.{n}": None for n in _LN_NAMES})
    for mha in ("mha",) + (("mha_cross",) if cross else ()):
        specs.update({f"{prefix}{mha}.{n}": d for n, d in _MHA_SPECS.items()})
    specs.update({f"{prefix}ffn.{n}": d for n, d in _FFN_SPECS.items()})
    return specs


def _names(net_or_state: Union[nn.Module, Dict[str, torch.Tensor]]) -> Iterable[str]:
    if isinstance(net_or_state, nn.Module):
        return [n for n, _ in net_or_state.named_parameters()] + [n for n, _ in net_or_state.named_buffers()]
    return list(net_or_state)


def tp_param_specs(net_or_state: Union[nn.Module, Dict[str, torch.Tensor]]) -> Dict[str, Optional[int]]:
    """Per weight name (parameters and the ``m`` buffers), the dimension
    sharded over ``"model"`` or None where it is replicated (JAX
    ``tp_param_specs`` :49): the layers of ``ar`` and ``ar_channel``."""
    names = _names(net_or_state)
    layer_specs: Dict[str, Optional[int]] = {}
    for stack in ("ar", "ar_channel"):
        idx = sorted({int(n.split(".")[2]) for n in names if n.startswith(f"{stack}.layers.")})
        for i in idx:
            prefix = f"{stack}.layers.{i}."
            layer_specs.update(_layer_specs(prefix, cross=any(n.startswith(prefix + "mha_cross.") for n in names)))
    return {n: layer_specs.get(n) for n in names}


def _slice(t: torch.Tensor, dim: int, rank: int, n_model: int, what: str) -> torch.Tensor:
    if t.shape[dim] % n_model:
        raise ValueError(f"{what}: dimension {dim} of {tuple(t.shape)} does not divide over {n_model} model ranks")
    size = t.shape[dim] // n_model
    return t.narrow(dim, rank * size, size).clone()


def _sharded_modules(net: nn.Module):
    """(name, module) of every MHA and FFN of the transformer stacks."""
    for name, mod in net.named_modules():
        parts = name.split(".")
        if len(parts) == 4 and parts[0] in ("ar", "ar_channel") and parts[3] in ("mha", "mha_cross", "ffn"):
            yield name, mod


def shard_params_tp(
    net_or_state: Union[nn.Module, Dict[str, torch.Tensor]],
    rank: int,
    n_model: int,
    group: Optional[dist.ProcessGroup] = None,
):
    """Model rank ``rank``'s shard of a net (in place; returns the net) or
    of a state dict (returns a new dict) (JAX ``shard_params_tp`` :67): the
    specs' dimensions narrowed to ``1 / n_model``, and the slopes ``m`` to
    the rank's heads. On a net the MHA and FFN modules then carry a
    ``ModelShard`` (attribute ``tp``) with ``group``, the ``"model"``
    group whose partial sums they reduce (with ``n_model`` 1 only where a
    group is given). Raises unless ``n_model`` divides the heads (the
    slopes' count) and the widths it shards."""
    if not 0 <= rank < n_model:
        raise ValueError(f"model rank {rank} outside [0, {n_model})")
    specs = tp_param_specs(net_or_state)
    state = dict(net_or_state.state_dict()) if isinstance(net_or_state, nn.Module) else dict(net_or_state)
    out = {}
    for name, t in state.items():
        dim = specs.get(name)
        if name.endswith(".m") and name in specs:  # the slopes: this rank's heads
            if t.shape[0] % n_model:
                raise ValueError(f"{name}: {t.shape[0]} heads do not divide over {n_model} model ranks")
            dim = 0
        out[name] = t if dim is None else _slice(t, dim, rank, n_model, name)
    if not isinstance(net_or_state, nn.Module):
        return out
    net = net_or_state
    for name, p in net.named_parameters():
        if specs.get(name) is not None:
            p.data = out[name].to(p.device)
    for mod_name, mod in _sharded_modules(net):
        if hasattr(mod, "m"):
            mod.m = out[f"{mod_name}.m"].to(mod.m.device)
        if n_model > 1 or group is not None:  # a group of one still reduces (a check on one card)
            mod.tp = ModelShard(group, n_model, rank)
    return net


def model_shard(module: nn.Module) -> Optional[ModelShard]:
    """The module's ``ModelShard``, or None where it is not sharded."""
    return getattr(module, "tp", None)


def _all_reduce(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum over the model group, reduced in at least float32."""
    y = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=shard.group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """A sharded block's input: itself, and its gradient summed over the
    model ranks (each rank's heads contribute a part)."""
    return x if shard is None else _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """A sharded block's partial output summed over the model ranks; the
    gradient passes through unchanged."""
    return x if shard is None else _ReduceFromModel.apply(x, shard)


def local_heads(module: nn.Module, num_heads: int) -> Tuple[int, Optional[ModelShard]]:
    """The heads an attention module holds on this rank, and its shard."""
    shard = model_shard(module)
    return (num_heads if shard is None else num_heads // shard.size), shard

"""GPT-style transformer stacks with ALiBi attention.

Counterpart of ``voiceactivityprojection_tpu/models/transformer.py:68-311``:

* pre-LN layer: LN -> self-attn -> residual
  [-> LN -> cross-attn (Q from x, K = V = src, the other channel's
  PRE-layer value, deliberately un-normalised) -> residual]
  -> LN -> FFN (exact-erf GELU, dff = 3 * dim, no biases) -> residual
* the stereo layer runs the same weights twice with the roles swapped
  (the twin pass, not the channel-stacked ``_batched`` variant)
* the combinator: GELU(LN(x1 W_a)) + GELU(LN(x2 W_b)), one shared LN.

Every projection goes through ``ops/linear.py`` ``linear_tf32x3`` (K13
on a float32 CUDA tensor, ``x @ w.T`` otherwise). Dropout (training) is
applied at the JAX package's sites when a ``DropoutRng`` is given
(``ops/dropout.py``); without one the residual adds run in the output
projections' epilogues. Under tensor parallelism
(``parallel/tp.py``) the attention and the FFN reduce their partial outputs
over the model ranks before the dropout and the residual add. Under ``attention_out`` the
stacks also return every layer's attention weights (the dense path, also
on the card).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voiceactivityprojection_tpu_torch.ops.attention import MHA, attention
from voiceactivityprojection_tpu_torch.ops.conv import layer_norm
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng
from voiceactivityprojection_tpu_torch.ops.linear import linear_tf32x3
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.parallel.tp import copy_to_model, model_shard, reduce_from_model


class FFN(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.w_in = ParamGroup(w=(ffn_dim, dim))
        self.w_out = ParamGroup(w=(dim, ffn_dim))


class TransformerLayer(nn.Module):
    """Names as the JAX ``init_transformer_layer`` tree."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, cross_attention: bool = False):
        super().__init__()
        self.ln_self_attn = ParamGroup(w=(dim,), b=(dim,))
        self.ln_ffnetwork = ParamGroup(w=(dim,), b=(dim,))
        self.mha = MHA(dim, num_heads)
        self.ffn = FFN(dim, ffn_dim)
        if cross_attention:
            self.ln_src_attn = ParamGroup(w=(dim,), b=(dim,))
            self.mha_cross = MHA(dim, num_heads)


class GPT(nn.Module):
    def __init__(self, dim: int, num_layers: int, num_heads: int, dff_k: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(dim, int(dim * dff_k), num_heads) for _ in range(num_layers)
        )


class Combinator(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.h0_a = ParamGroup(w=(dim, dim))
        self.h0_b = ParamGroup(w=(dim, dim))
        self.ln = ParamGroup(w=(dim,), b=(dim,))


class GPTStereo(nn.Module):
    def __init__(self, dim: int, num_layers: int, num_heads: int, dff_k: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(dim, int(dim * dff_k), num_heads, cross_attention=True)
            for _ in range(num_layers)
        )
        self.combinator = Combinator(dim)


def _identity(x: torch.Tensor, tp=None) -> torch.Tensor:
    return x


def _ffn(p: FFN, x: torch.Tensor, z: torch.Tensor, drop=_identity) -> torch.Tensor:
    """x + drop(FFN(z)); without dropout or model ranks the residual is
    added in the down-projection's epilogue."""
    tp = model_shard(p)  # w_in rows and w_out columns over the model ranks
    h = drop(linear_tf32x3(copy_to_model(z, tp), p.w_in.w, gelu=True), tp)
    if drop is _identity and tp is None:
        return linear_tf32x3(h, p.w_out.w, residual=x)
    return x + drop(reduce_from_model(linear_tf32x3(h, p.w_out.w), tp))


def apply_transformer_layer(
    p: TransformerLayer,
    x: torch.Tensor,
    src: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    dropout: float = 0.0,
    rng: Optional[DropoutRng] = None,
    attn_impl: str = "auto",
    return_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Returns (x, self-attention weights, cross-attention weights), the
    weights (B, H, T, T) under ``return_weights`` and None otherwise (and
    the cross weights None without ``src``). With ``rng``, dropout at
    ``dropout`` on the attention weights and at six elementwise sites: after
    each attention's output projection and on its residual branch, on the
    FFN hidden and on the FFN output (JAX: transformer.py:75-111), drawn in
    that order; the FFN hidden of a tensor-parallel rank takes its block of
    the full-width mask. ``attn_impl`` routes both attentions (``ops/attention.py``
    ``use_kernels``: weights take the dense path)."""
    drop = (lambda t, tp=None: rng.dropout(t, dropout, tp)) if rng is not None else _identity
    gen, shard = (rng.seeds, rng.shard) if rng is not None else (None, None)
    kw = dict(impl=attn_impl, return_weights=return_weights, dropout_rate=dropout, generator=gen, shard=shard)

    def add(x, out):  # x + drop(drop(out)), or the residual was added in the output projection
        return out if rng is None else x + drop(drop(out))

    z = layer_norm(x, p.ln_self_attn.w, p.ln_self_attn.b)
    sa, sa_w = attention(p.mha, z, z, num_heads, residual=x if rng is None else None, **kw)
    x = add(x, sa)
    ca_w = None
    if src is not None and hasattr(p, "mha_cross"):
        z = layer_norm(x, p.ln_src_attn.w, p.ln_src_attn.b)
        ca, ca_w = attention(p.mha_cross, z, src, num_heads, residual=x if rng is None else None, **kw)
        x = add(x, ca)
    z = layer_norm(x, p.ln_ffnetwork.w, p.ln_ffnetwork.b)
    return _ffn(p.ffn, x, z, drop), sa_w, ca_w


def apply_stereo_layer(p: TransformerLayer, x1, x2, *, num_heads: int, dropout: float = 0.0,
                       rng: Optional[DropoutRng] = None, attn_impl: str = "auto", return_weights: bool = False):
    """Shared-weight twin pass; each side's src is the other side's
    pre-layer value. Returns z1, z2 and (sa1, ca1, sa2, ca2)."""
    kw = dict(num_heads=num_heads, dropout=dropout, rng=rng, attn_impl=attn_impl, return_weights=return_weights)
    z1, sa1, ca1 = apply_transformer_layer(p, x1, src=x2, **kw)
    z2, sa2, ca2 = apply_transformer_layer(p, x2, src=x1, **kw)
    return z1, z2, (sa1, ca1, sa2, ca2)


def apply_gpt(p: GPT, x: torch.Tensor, *, num_heads: int, dropout: float = 0.0,
              rng: Optional[DropoutRng] = None, attn_impl: str = "auto",
              attention_out: bool = False) -> Dict[str, torch.Tensor]:
    """{"x"}, and under ``attention_out`` "attn", every layer's weights
    (B, L, H, T, T)."""
    attns: List[torch.Tensor] = []
    for layer in p.layers:
        x, sa, _ = apply_transformer_layer(layer, x, num_heads=num_heads, dropout=dropout, rng=rng,
                                           attn_impl=attn_impl, return_weights=attention_out)
        attns.append(sa)
    ret = {"x": x}
    if attention_out:
        ret["attn"] = torch.stack(attns, dim=1)
    return ret


def apply_combinator(p: Combinator, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    ha = F.gelu(layer_norm(linear_tf32x3(x1, p.h0_a.w), p.ln.w, p.ln.b))
    hb = F.gelu(layer_norm(linear_tf32x3(x2, p.h0_b.w), p.ln.w, p.ln.b))
    return ha + hb


def apply_gpt_stereo(
    p: GPTStereo, x1: torch.Tensor, x2: torch.Tensor, *, num_heads: int,
    dropout: float = 0.0, rng: Optional[DropoutRng] = None, attn_impl: str = "auto",
    attention_out: bool = False,
) -> Dict[str, torch.Tensor]:
    """{"x", "x1", "x2"}, and under ``attention_out`` "self_attn" and
    "cross_attn", each (B, 2, L, H, T, T): channel 0's pass, then channel 1's."""
    weights: List[tuple] = []
    for layer in p.layers:
        x1, x2, w = apply_stereo_layer(layer, x1, x2, num_heads=num_heads, dropout=dropout, rng=rng,
                                       attn_impl=attn_impl, return_weights=attention_out)
        weights.append(w)
    ret = {"x": apply_combinator(p.combinator, x1, x2), "x1": x1, "x2": x2}
    if attention_out:
        def stack(i: int, j: int) -> torch.Tensor:
            return torch.stack([torch.stack([w[i] for w in weights], dim=1),
                                torch.stack([w[j] for w in weights], dim=1)], dim=1)

        ret["self_attn"] = stack(0, 2)
        ret["cross_attn"] = stack(1, 3)
    return ret

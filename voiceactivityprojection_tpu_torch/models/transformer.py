"""GPT-style transformer stacks with ALiBi attention.

Counterpart of ``voiceactivityprojection_tpu/models/transformer.py:68-311``:

* pre-LN layer: LN -> self-attn -> residual
  [-> LN -> cross-attn (Q from x, K = V = src, the other channel's
  PRE-layer value, deliberately un-normalised) -> residual]
  -> LN -> FFN (exact-erf GELU, dff = 3 * dim, no biases) -> residual
* the stereo layer runs the same weights twice with the roles swapped
  (the twin pass, not the channel-stacked ``_batched`` variant)
* the combinator: GELU(LN(x1 W_a)) + GELU(LN(x2 W_b)), one shared LN.

Dropout (training) is applied at the JAX package's sites when a
``DropoutRng`` is given (``ops/dropout.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from voiceactivityprojection_tpu_torch.ops.attention import MHA, attention
from voiceactivityprojection_tpu_torch.ops.conv import layer_norm
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup


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


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _ffn(p: FFN, x: torch.Tensor, drop=_identity) -> torch.Tensor:
    return drop(F.gelu(x @ p.w_in.w.T)) @ p.w_out.w.T


def apply_transformer_layer(
    p: TransformerLayer,
    x: torch.Tensor,
    src: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    dropout: float = 0.0,
    rng: Optional[DropoutRng] = None,
) -> torch.Tensor:
    """With ``rng``, dropout at ``dropout`` on the attention weights and at
    six elementwise sites: after each attention's output projection and on
    its residual branch, on the FFN hidden and on the FFN output
    (JAX: transformer.py:75-111), drawn in that order."""
    drop = (lambda t: rng.dropout(t, dropout)) if rng is not None else _identity
    gen = rng.seeds if rng is not None else None
    z = layer_norm(x, p.ln_self_attn.w, p.ln_self_attn.b)
    sa = attention(p.mha, z, z, num_heads, dropout_rate=dropout, generator=gen)[0]
    x = x + drop(drop(sa))
    if src is not None and hasattr(p, "mha_cross"):
        z = layer_norm(x, p.ln_src_attn.w, p.ln_src_attn.b)
        ca = attention(p.mha_cross, z, src, num_heads, dropout_rate=dropout, generator=gen)[0]
        x = x + drop(drop(ca))
    z = layer_norm(x, p.ln_ffnetwork.w, p.ln_ffnetwork.b)
    return x + drop(_ffn(p.ffn, z, drop))


def apply_stereo_layer(p: TransformerLayer, x1, x2, *, num_heads: int, dropout: float = 0.0,
                       rng: Optional[DropoutRng] = None):
    """Shared-weight twin pass; each side's src is the other side's
    pre-layer value."""
    z1 = apply_transformer_layer(p, x1, src=x2, num_heads=num_heads, dropout=dropout, rng=rng)
    z2 = apply_transformer_layer(p, x2, src=x1, num_heads=num_heads, dropout=dropout, rng=rng)
    return z1, z2


def apply_gpt(p: GPT, x: torch.Tensor, *, num_heads: int, dropout: float = 0.0,
              rng: Optional[DropoutRng] = None) -> Dict[str, torch.Tensor]:
    for layer in p.layers:
        x = apply_transformer_layer(layer, x, num_heads=num_heads, dropout=dropout, rng=rng)
    return {"x": x}


def apply_combinator(p: Combinator, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    ha = F.gelu(layer_norm(x1 @ p.h0_a.w.T, p.ln.w, p.ln.b))
    hb = F.gelu(layer_norm(x2 @ p.h0_b.w.T, p.ln.w, p.ln.b))
    return ha + hb


def apply_gpt_stereo(
    p: GPTStereo, x1: torch.Tensor, x2: torch.Tensor, *, num_heads: int,
    dropout: float = 0.0, rng: Optional[DropoutRng] = None,
) -> Dict[str, torch.Tensor]:
    for layer in p.layers:
        x1, x2 = apply_stereo_layer(layer, x1, x2, num_heads=num_heads, dropout=dropout, rng=rng)
    return {"x": apply_combinator(p.combinator, x1, x2), "x1": x1, "x2": x2}

"""Plain float32 PyTorch reference of the stereo VAP model, its outputs,
labels, losses and the KV streamer's semantics.

Written from the model's description (Ekstedt & Skantze 2022; the
ErikEkstedt/VoiceActivityProjection ``VapConfig`` defaults) with nothing
of the program under test: torch convolutions, matmuls and a step loop for
the GRU, dense attention. Weights come as a dict keyed by the program's
parameter names (``encoder.gEncoder.0.conv.w`` ...), in its layouts: a conv
``w`` is (kernel, in, out), a linear ``w`` (out, in), the GRU's ``w_ih`` and
``w_hh`` (in, 3H) with gates in the order r, z, n.

* Encoder: five convs (k 10, 8, 4, 4, 4; stride 5, 4, 2, 2, 2; symmetric
  pad 3, 2, 1, 1, 1), each followed by ChannelNorm (unbiased variance over
  the channels, eps 1e-5) and ReLU; a GRU of 256 from zero; a causal conv
  (k 5, stride 2, left pad 4) with LayerNorm and exact GELU: 50 Hz.
* Transformer: pre-LN layers, attention scaled by 1/sqrt(model dim) with
  the ALiBi bias slope_h * (j - i) over keys j <= i (and, for the
  streamer, i - j < window), bias-free projections, FFN of 3 x dim with
  exact GELU. A stereo layer runs twice with shared weights, each channel's
  cross-attention taking K and V from the other channel's value before the
  layer. The combinator adds GELU(LN(x1 A)) and GELU(LN(x2 B)) under one
  LN.
* Training dropout is replayed from the step's CPU generator, as the
  program's contract draws it (``DropoutReplay``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

CONV_SPECS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))
DOWN_K, DOWN_S = 5, 2
EPS = 1e-5
_M32 = 0xFFFFFFFF


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Press et al.'s slopes for a power-of-two head count."""
    start = 2.0 ** (-(2.0 ** -(math.log2(num_heads) - 3)))
    return torch.tensor([start * start ** i for i in range(num_heads)], dtype=torch.float32)


def _norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, unbiased: bool) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    if unbiased:
        var = var * (x.shape[-1] / (x.shape[-1] - 1))
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def layer_norm(x, w, b):
    return _norm(x, w, b, unbiased=False)


# ------------------------------------------------------------------ encoder --
def conv_stack(p: Params, wave: torch.Tensor, prefix: str = "encoder.") -> torch.Tensor:
    """(R, n) samples -> (R, T100, C)."""
    x = wave[:, None, :]
    for i, (_, s, pad) in enumerate(CONV_SPECS):
        g = f"{prefix}gEncoder.{i}."
        x = F.conv1d(x, p[g + "conv.w"].permute(2, 1, 0), p[g + "conv.b"], stride=s, padding=pad)
        x = torch.relu(_norm(x.transpose(1, 2), p[g + "norm.w"], p[g + "norm.b"], unbiased=True)).transpose(1, 2)
    return x.transpose(1, 2)


def gru(p: Params, x: torch.Tensor, prefix: str = "encoder.") -> torch.Tensor:
    """(R, T, C) -> (R, T, H) from h0 = 0, one step at a time."""
    w_ih, w_hh = p[prefix + "gAR.w_ih"], p[prefix + "gAR.w_hh"]
    b_ih, b_hh = p[prefix + "gAR.b_ih"], p[prefix + "gAR.b_hh"]
    xp = x @ w_ih + b_ih
    h = x.new_zeros(x.shape[0], w_hh.shape[0])
    out = []
    for t in range(x.shape[1]):
        xr, xz, xn = xp[:, t].chunk(3, -1)
        hr, hz, hn = (h @ w_hh + b_hh).chunk(3, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h = (1 - z) * torch.tanh(xn + r * hn) + z * h
        out.append(h)
    return torch.stack(out, 1)


def downsample(p: Params, z: torch.Tensor, prefix: str = "encoder.") -> torch.Tensor:
    """(R, T100, C) -> (R, ceil(T100 / 2), C), causal."""
    w, b = p[prefix + "downsample.conv.w"], p[prefix + "downsample.conv.b"]
    y = F.conv1d(F.pad(z.transpose(1, 2), (DOWN_K - 1, 0)), w.permute(2, 1, 0), b, stride=DOWN_S)
    return F.gelu(layer_norm(y.transpose(1, 2), p[prefix + "downsample.ln.w"], p[prefix + "downsample.ln.b"]))


def encoder(p: Params, wave: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """(R, n) -> (R, T50, C) without gradients, ``rows`` rows at a time."""
    with torch.no_grad():
        return torch.cat([downsample(p, gru(p, conv_stack(p, wave[i:i + rows])))
                          for i in range(0, wave.shape[0], rows)])


# ------------------------------------------------------------------ dropout --
def _hash_keep(bh, q, k, seed: int, rate: float) -> torch.Tensor:
    """The attention mask's lowbias32 hash of (batch*head, query, key, seed),
    uint32 arithmetic in int64: kept where hash >= rate * 2^32."""
    x = (bh * 0x9E3779B1) & _M32
    x = (x + ((q * 0x85EBCA6B) & _M32)) & _M32
    x = (x + ((k * 0xC2B2AE35) & _M32)) & _M32
    x = (x + (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x >= min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


class DropoutReplay:
    """A training forward's dropout, drawn as the program's contract draws
    it from the step's CPU generator: first a 62-bit seed for the
    elementwise masks' generator on the activations' device, then, in the
    order of the layers, one 31-bit seed a call of attention, whose mask is
    the coordinate hash; the elementwise masks come from uniform draws of
    each site's shape in the order the sites run."""

    def __init__(self, generator: torch.Generator, device: torch.device, rate: float):
        self.cpu, self.rate = generator, rate
        self.dev = torch.Generator(device=device)
        self.dev.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=generator)))

    def elementwise(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.dev, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def attention_mask(self, B: int, H: int, T: int, device) -> torch.Tensor:
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.cpu))
        bh = torch.arange(B * H, device=device, dtype=torch.int64).reshape(B, H, 1, 1)
        i = torch.arange(T, device=device, dtype=torch.int64)
        return _hash_keep(bh, i[:, None], i[None, :], seed, self.rate)


# -------------------------------------------------------------- transformer --
def attention(p: Params, g: str, q_in, kv_in, H: int, window: Optional[int] = None,
              drop: Optional[DropoutReplay] = None) -> torch.Tensor:
    B, T, D = q_in.shape
    split = lambda t: t.reshape(B, T, H, D // H).transpose(1, 2)  # noqa: E731
    q = split(q_in @ p[g + "query.w"].T)
    k = split(kv_in @ p[g + "key.w"].T)
    v = split(kv_in @ p[g + "value.w"].T)
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    slopes = alibi_slopes(H).to(q.device)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D) + slopes[:, None, None] * (j - i)
    hidden = j > i if window is None else (j > i) | (i - j >= window)
    w = torch.softmax(s.masked_fill(hidden, float("-inf")), -1)
    if drop is not None:
        w = torch.where(drop.attention_mask(B, H, T, q.device), w / (1.0 - drop.rate), 0.0)
    return (w @ v).transpose(1, 2).reshape(B, T, D) @ p[g + "proj.w"].T


def layer(p: Params, g: str, x, src, H: int, window=None, drop: Optional[DropoutReplay] = None):
    d = drop.elementwise if drop is not None else (lambda t: t)
    z = layer_norm(x, p[g + "ln_self_attn.w"], p[g + "ln_self_attn.b"])
    x = x + d(d(attention(p, g + "mha.", z, z, H, window, drop)))
    if src is not None:
        z = layer_norm(x, p[g + "ln_src_attn.w"], p[g + "ln_src_attn.b"])
        x = x + d(d(attention(p, g + "mha_cross.", z, src, H, window, drop)))
    z = layer_norm(x, p[g + "ln_ffnetwork.w"], p[g + "ln_ffnetwork.b"])
    h = d(F.gelu(z @ p[g + "ffn.w_in.w"].T))
    return x + d(h @ p[g + "ffn.w_out.w"].T)


def n_layers(p: Params, group: str) -> int:
    return len({k.split(".")[2] for k in p if k.startswith(group + ".layers.")})


def transformer(p: Params, x1, x2, H: int, window=None, drop=None) -> Dict[str, torch.Tensor]:
    """Channel GPT on each channel, then the stereo GPT and the heads:
    {"logits", "vad_logits"}."""
    for c in range(n_layers(p, "ar_channel")):
        x1 = layer(p, f"ar_channel.layers.{c}.", x1, None, H, window, drop)
    for c in range(n_layers(p, "ar_channel")):
        x2 = layer(p, f"ar_channel.layers.{c}.", x2, None, H, window, drop)
    for c in range(n_layers(p, "ar")):
        g = f"ar.layers.{c}."
        x1, x2 = layer(p, g, x1, x2, H, window, drop), layer(p, g, x2, x1, H, window, drop)
    ln = (p["ar.combinator.ln.w"], p["ar.combinator.ln.b"])
    x = (F.gelu(layer_norm(x1 @ p["ar.combinator.h0_a.w"].T, *ln))
         + F.gelu(layer_norm(x2 @ p["ar.combinator.h0_b.w"].T, *ln)))
    va_w, va_b = p["va_classifier.w"], p["va_classifier.b"]
    vad = torch.cat([x1 @ va_w.T + va_b, x2 @ va_w.T + va_b], -1)
    return {"logits": x @ p["vap_head.w"].T + p["vap_head.b"], "vad_logits": vad}


# ------------------------------------------------------------------ outputs --
def _aggregate(probs: torch.Tensor, first: int, last: int, n_bins: int = 4) -> torch.Tensor:
    """P(speaker active in bins first..last), normalised over the two
    speakers with a 1e-5 floor on the sum."""
    idx = torch.arange(probs.shape[-1], device=probs.device)
    bits = ((idx[:, None] >> torch.arange(2 * n_bins, device=probs.device)) & 1).reshape(-1, 2, n_bins)
    p = probs @ bits[:, :, first:last + 1].sum(-1).to(probs.dtype)
    return p / (p.sum(-1, keepdim=True) + 1e-5)


def outputs(logits: torch.Tensor, vad_logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    probs = torch.softmax(logits, -1)
    return {"p_now": _aggregate(probs, 0, 1), "p_future": _aggregate(probs, 2, 3),
            "vad": torch.sigmoid(vad_logits)}


def probs(p: Params, wave: torch.Tensor, H: int, rows: int = 8) -> Dict[str, torch.Tensor]:
    """(B, 2, n) -> p_now, p_future (B, T50, 2), vad (B, T50, 2), without
    gradients, ``rows`` dialogs at a time."""
    outs: List[Dict[str, torch.Tensor]] = []
    with torch.no_grad():
        for i in range(0, wave.shape[0], rows):
            w = wave[i:i + rows]
            b = w.shape[0]
            z = encoder(p, w.reshape(2 * b, -1))
            z = z.reshape(b, 2, *z.shape[1:])
            outs.append(outputs(**transformer(p, z[:, 0], z[:, 1], H)))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# ------------------------------------------------------------- training loss --
def labels(vad: torch.Tensor, bin_frames: Sequence[int]) -> torch.Tensor:
    """(B, N + horizon, 2) voice activity -> (B, N) class of the 2 x 4 bins,
    a bin active where at least half of its future frames are."""
    n = vad.shape[1] - sum(bin_frames)
    cs = torch.cat([torch.zeros_like(vad[:, :1]), torch.cumsum(vad, 1)], 1)
    bins, start = [], 0
    for f in bin_frames:
        a, b = start, start + f
        bins.append(((cs[:, 1 + b:1 + b + n] - cs[:, 1 + a:1 + a + n]) / float(f)) >= 0.5)
        start = b
    bits = torch.stack(bins, -1).reshape(vad.shape[0], n, 2 * len(bin_frames)).to(torch.int64)
    return (bits << torch.arange(bits.shape[-1], device=vad.device)).sum(-1)


def train_loss(p: Params, wave: torch.Tensor, vad: torch.Tensor, H: int, bin_frames: Sequence[int],
               drop: Optional[DropoutReplay]) -> torch.Tensor:
    """The frozen-encoder training loss: CE over the 256 classes plus the VAD
    BCE, with gradients into the downsample and everything after it."""
    B = wave.shape[0]
    with torch.no_grad():
        z = torch.cat([gru(p, conv_stack(p, wave[i:i + 8].reshape(-1, wave.shape[-1])))
                       for i in range(0, B, 8)])
    x = downsample(p, z).reshape(B, 2, -1, z.shape[-1])
    out = transformer(p, x[:, 0], x[:, 1], H, drop=drop)
    lab = labels(vad, bin_frames)
    logp = torch.log_softmax(out["logits"][:, :lab.shape[1]], -1)
    lvap = -logp.gather(-1, lab[..., None])[..., 0].mean()
    zl, y = out["vad_logits"], vad[:, :out["vad_logits"].shape[1]]
    lvad = (zl.clamp_min(0) - zl * y + torch.log1p(torch.exp(-zl.abs()))).mean()
    return lvap + lvad


# ---------------------------------------------------------------- streaming --
def stream_outputs(p: Params, wave: torch.Tensor, frames: int, H: int, window: int) -> Dict[str, torch.Tensor]:
    """The KV streamer's outputs for dialogs (S, 2, n) over their first
    ``frames`` frames: the encoder over the whole audio (its frames depend
    on a few samples ahead), then every layer attending to its last
    ``window`` frames."""
    S = wave.shape[0]
    with torch.no_grad():
        z = encoder(p, wave.reshape(2 * S, -1))[:, :frames]
        z = z.reshape(S, 2, frames, -1)
        return outputs(**transformer(p, z[:, 0], z[:, 1], H, window=window))

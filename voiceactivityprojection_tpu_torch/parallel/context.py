"""Context (sequence) parallelism: exact single-shot inference on long audio
with the time axis split over the shards of a mesh.

Counterpart of ``voiceactivityprojection_tpu/parallel/context.py:67-442``.
The reference caps single-shot audio at about 164 s on a 24 GB GPU and
falls back to overlapped chunks with seam approximations; here shard d of D
holds 50 Hz frames [d T50/D, (d+1) T50/D) and the result is the
single-device forward, up to summation order:

* conv stack: no exchange. Each shard runs the conv stage (``_conv_stack``
  with ``fused_auto`` off, as JAX: the plain stack unless ``VAP_CONV_IMPL``
  selects a kernel) on its samples plus ``MARGIN_FRAMES`` 100 Hz frames of
  margin per side and crops them; the edge shards slice flush with the
  signal so that the stack's own zero padding applies there.
* GRU: the carry is relayed, shard d starting ``gru`` (the recurrence
  kernel on the card) from shard d-1's last state, handed over in the
  compute dtype.
* causal downsample (k=5, s=2): a 4-frame halo from the previous shard,
  zeros on shard 0 (the causal left padding).
* attention: Q/K/V projected per shard; every shard's K/V gathered along
  time onto each device (one ``torch.cat`` per distinct device); then the
  offset attention kernel (``ops/flash_alibi.py``
  ``flash_alibi_attention_offset``) with ``q_offset = d * T50/D`` on CUDA
  tensors, its plain version on CPU tensors.
* LayerNorm, FFN, combinator, heads: pointwise over time.

One controller drives every shard in turn (``parallel/mesh.py``); a mesh
may repeat one device, so one card runs every shard of a 4-shard mesh.
The net is copied once to each distinct device that does not hold it and
its weights cast to the compute dtype (``_compute_params``, as the plain
forward casts them), one tree per device; outputs come back concatenated along time on the
mesh's first device. Restrictions, as in JAX: batch 1 (one long file),
inference only, T50 divisible by the number of shards (pad the waveform to
a multiple of 320 * D samples with ``pad_waveform_for_mesh``).
"""

from __future__ import annotations

import copy
import math
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.config import VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import _unflatten
from voiceactivityprojection_tpu_torch.models.encoder import _conv_stack
from voiceactivityprojection_tpu_torch.models.transformer import _ffn, apply_combinator
from voiceactivityprojection_tpu_torch.models.vap import (
    _DTYPES,
    _compute_params,
    forward,
    forward_mono,
    probs_from_logits,
    uses_history,
    va_conditioning,
)
from voiceactivityprojection_tpu_torch.ops.attention import _merge_heads, _split_heads
from voiceactivityprojection_tpu_torch.ops.conv import conv1d, layer_norm
from voiceactivityprojection_tpu_torch.ops.flash_alibi import flash_alibi_attention_offset
from voiceactivityprojection_tpu_torch.ops.gru import gru
from voiceactivityprojection_tpu_torch.ops.gru_downsample import DOWNSAMPLE_KERNEL, DOWNSAMPLE_STRIDE
from voiceactivityprojection_tpu_torch.parallel.mesh import Mesh

CPC_DOWNSAMPLE = 160  # samples per 100 Hz frame
TOTAL_DOWNSAMPLE = 320  # samples per 50 Hz frame
MARGIN_FRAMES = 4  # 100 Hz margin per side; 4 * 160 = 640 >= the conv stack's
#                    312-sample right receptive-field extent


# ------------------------------------------------------------------ weights --
def _namespace(tree: Any) -> Any:
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: _namespace(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return [_namespace(v) for v in tree]
    return tree


def _replicas(net: torch.nn.Module, devices: Sequence[torch.device]) -> Dict:
    """{device: the net itself where its weights lie on that device, else
    one copy there}, for each distinct device of the mesh."""
    return {dev: net if all(t.device == dev for t in net.parameters()) else copy.deepcopy(net).to(dev)
            for dev in dict.fromkeys(devices)}


def _sharded_weights(net: torch.nn.Module, conf: VapConfig, devices: Sequence[torch.device]) -> List:
    """Each shard's weights in the compute dtype (``_compute_params`` of its
    device's replica), as attribute trees that the sharded stages read like
    the modules; shards on one device share one tree."""
    trees = {dev: _namespace(_unflatten(_compute_params(rep, conf)))
             for dev, rep in _replicas(net, devices).items()}
    return [trees[dev] for dev in devices]


# ---------------------------------------------------------- sharded stages --
def _conv_features_local(enc: Any, wav_rows: torch.Tensor, t100_loc: int, d: int, n_dev: int,
                         device: torch.device) -> torch.Tensor:
    """wav_rows: (rows, n + 2 M 160) samples with M zero margin frames per
    side. Returns shard d's exact (rows, t100_loc, C) conv features (JAX:
    context.py:75-109): interior shards slice [F0 - M, F0 + t100_loc + M)
    frames and crop M per side; shard 0 slices flush with the signal's start
    (crop 0) and the last shard with its end (crop 2M), because a conv of
    margin zeros is not the stack's zero padding in activation space."""
    m = MARGIN_FRAMES
    margin = m * CPC_DOWNSAMPLE
    n = wav_rows.shape[1] - 2 * margin
    size = (t100_loc + 2 * m) * CPC_DOWNSAMPLE
    if d == 0:
        start, off = margin, 0
    elif d == n_dev - 1:
        start, off = n + margin - size, 2 * m
    else:
        start, off = d * t100_loc * CPC_DOWNSAMPLE, m
    samples = wav_rows[:, start:start + size].to(device).contiguous()
    return _conv_stack(enc, samples)[:, off:off + t100_loc]


def _gru_relay(encs: Sequence[Any], zs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The GRU over the time-split features: shard d runs from shard d-1's
    last state (zeros on shard 0), the carry handed over in the compute
    dtype (JAX: context.py:112-140)."""
    ys, carry = [], None
    for enc, z in zip(encs, zs):
        g = enc.gAR
        if carry is None:
            h0 = torch.zeros(z.shape[0], g.w_hh.shape[0], dtype=z.dtype, device=z.device)
        else:
            h0 = carry.to(z.device).contiguous()
        y, carry = gru(z, g.w_ih, g.w_hh, g.b_ih, g.b_hh, h0=h0)
        ys.append(y)
    return ys


def _downsample_local(encs: Sequence[Any], ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The causal k=5, s=2 downsample + LayerNorm + GELU with a 4-frame halo
    from the previous shard, zeros on shard 0 (JAX: context.py:143-155)."""
    k = DOWNSAMPLE_KERNEL - 1
    out = []
    for d, (enc, y) in enumerate(zip(encs, ys)):
        halo = torch.zeros_like(y[:, :k]) if d == 0 else ys[d - 1][:, -k:].to(y.device)
        ds = enc.downsample
        z = conv1d(torch.cat([halo, y], dim=1), ds.conv.w, ds.conv.b, stride=DOWNSAMPLE_STRIDE)
        out.append(F.gelu(layer_norm(z, ds.ln.w, ds.ln.b)))
    return out


def _attn_ctx(mhas: Sequence[Any], q_ins: Sequence[torch.Tensor], kv_ins: Sequence[torch.Tensor],
              num_heads: int, t50_loc: int) -> List[torch.Tensor]:
    """Causal ALiBi attention where shard d holds query rows [d t50_loc,
    (d+1) t50_loc) of the timeline (JAX: context.py:158-190): local Q/K/V
    projections, K/V gathered along time, the offset kernel on CUDA tensors
    (its plain version on CPU tensors), the output projection. Scale
    1/sqrt(model dim), slopes as given (non-trainable)."""
    scale = 1.0 / math.sqrt(q_ins[0].shape[-1])
    ks = [_split_heads(kv @ p.key.w.T, num_heads) for p, kv in zip(mhas, kv_ins)]
    vs = [_split_heads(kv @ p.value.w.T, num_heads) for p, kv in zip(mhas, kv_ins)]
    gathered: Dict[torch.device, Any] = {}
    out = []
    for d, (p, q_in) in enumerate(zip(mhas, q_ins)):
        dev = q_in.device
        if dev not in gathered:
            gathered[dev] = tuple(torch.cat([t.to(dev) for t in ts], dim=2) for ts in (ks, vs))
        k, v = gathered[dev]
        q = _split_heads(q_in @ p.query.w.T, num_heads).contiguous()
        o = flash_alibi_attention_offset(q, k, v, p.m, scale, d * t50_loc)
        out.append(_merge_heads(o) @ p.proj.w.T)
    return out


def _layer_ctx(layers: Sequence[Any], xs: Sequence[torch.Tensor],
               srcs: Optional[Sequence[torch.Tensor]], num_heads: int,
               t50_loc: int) -> List[torch.Tensor]:
    """The pre-LN transformer layer on every shard's rows (inference; the
    port's ``apply_transformer_layer`` with the attention split over
    shards, JAX: context.py:193-204)."""
    zs = [layer_norm(x, l.ln_self_attn.w, l.ln_self_attn.b) for l, x in zip(layers, xs)]
    att = _attn_ctx([l.mha for l in layers], zs, zs, num_heads, t50_loc)
    xs = [x + a for x, a in zip(xs, att)]
    if srcs is not None and hasattr(layers[0], "mha_cross"):
        zs = [layer_norm(x, l.ln_src_attn.w, l.ln_src_attn.b) for l, x in zip(layers, xs)]
        att = _attn_ctx([l.mha_cross for l in layers], zs, srcs, num_heads, t50_loc)
        xs = [x + a for x, a in zip(xs, att)]
    return [x + _ffn(l.ffn, layer_norm(x, l.ln_ffnetwork.w, l.ln_ffnetwork.b))
            for l, x in zip(layers, xs)]


def _encode_sharded(encs: Sequence[Any], wav_pad: torch.Tensor, t50_loc: int,
                    devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard's (rows, t50_loc, C) encoder output."""
    n_dev = len(devices)
    zs = [_conv_features_local(enc, wav_pad, 2 * t50_loc, d, n_dev, dev)
          for d, (enc, dev) in enumerate(zip(encs, devices))]
    return _downsample_local(encs, _gru_relay(encs, zs))


def _gpt_sharded(gpts: Sequence[Any], xs: List[torch.Tensor], num_heads: int,
                 t50_loc: int) -> List[torch.Tensor]:
    """A plain GPT (self-attention layers) on every shard's rows."""
    for layers in zip(*(g.layers for g in gpts)):
        xs = _layer_ctx(layers, xs, None, num_heads, t50_loc)
    return xs


# ------------------------------------------------------------- entry points --
def pad_waveform_for_mesh(waveform: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Right-pad (..., n) samples with zeros to a multiple of 320 * n_dev;
    an aligned input comes back as it is."""
    pad = (-waveform.shape[-1]) % (TOTAL_DOWNSAMPLE * n_dev)
    return F.pad(waveform, (0, pad)) if pad else waveform


def _check_split(n: int, n_dev: int) -> int:
    if n % (TOTAL_DOWNSAMPLE * n_dev):
        raise ValueError(
            f"n={n} must be a multiple of {TOTAL_DOWNSAMPLE * n_dev} (320 samples x {n_dev} "
            f"shards); use pad_waveform_for_mesh"
        )
    t50 = n // TOTAL_DOWNSAMPLE
    if n_dev > 1 and 2 * (t50 // n_dev) < MARGIN_FRAMES:
        raise ValueError(f"chunks too small: need >= {MARGIN_FRAMES} 100 Hz frames per shard")
    return t50


def _padded(wav: torch.Tensor, conf: VapConfig) -> torch.Tensor:
    margin = MARGIN_FRAMES * CPC_DOWNSAMPLE
    return F.pad(wav.to(_DTYPES[conf.dtype]), (margin, margin))


@torch.inference_mode()
def forward_context_parallel(
    net: torch.nn.Module, waveform: torch.Tensor, conf: VapConfig, mesh: Mesh
) -> Dict[str, torch.Tensor]:
    """Single-shot stereo forward of ``net`` (a ``VapNet``) with time split
    over the shards of ``mesh``. waveform: (1, 2, n) or (2, n) with n a
    multiple of 320 * shards. Returns {"logits": (1, T50, heads), "vad":
    (1, T50, 2)}, float32, on the mesh's first device: the plain ``forward``
    up to summation order (JAX: context.py:255-294)."""
    wav = torch.as_tensor(waveform)
    if wav.ndim == 3 and wav.shape[0] == 1:
        wav = wav[0]
    if wav.ndim != 2 or wav.shape[0] != 2:
        raise ValueError(f"expected (1, 2, n) or (2, n) stereo samples, got {tuple(waveform.shape)}")
    devices = mesh.devices
    n_dev = len(devices)
    t50 = _check_split(wav.shape[-1], n_dev)
    if n_dev == 1:  # one shard: the plain forward is the answer
        dev = devices[0]
        out = forward(_replicas(net, devices)[dev], wav[None].to(dev), conf)
        return {"logits": out["logits"], "vad": out["vad"]}

    ws = _sharded_weights(net, conf, devices)
    t50_loc = t50 // n_dev
    z50 = _encode_sharded([w.encoder for w in ws], _padded(wav, conf), t50_loc, devices)
    x1s, x2s = [z[:1] for z in z50], [z[1:] for z in z50]
    nh = conf.num_heads
    x1s = _gpt_sharded([w.ar_channel for w in ws], x1s, nh, t50_loc)
    x2s = _gpt_sharded([w.ar_channel for w in ws], x2s, nh, t50_loc)
    for layers in zip(*(w.ar.layers for w in ws)):
        n1 = _layer_ctx(layers, x1s, x2s, nh, t50_loc)
        x2s = _layer_ctx(layers, x2s, x1s, nh, t50_loc)
        x1s = n1
    logits, vad = [], []
    for w, x1, x2 in zip(ws, x1s, x2s):
        x = apply_combinator(w.ar.combinator, x1, x2)
        va = w.va_classifier
        vad.append(torch.cat([x1 @ va.w.T + va.b, x2 @ va.w.T + va.b], dim=-1).float().to(devices[0]))
        logits.append((x @ w.vap_head.w.T + w.vap_head.b).float().to(devices[0]))
    return {"logits": torch.cat(logits, dim=1), "vad": torch.cat(vad, dim=1)}


def probs_context_parallel(
    net: torch.nn.Module, waveform: torch.Tensor, conf: VapConfig, mesh: Mesh
) -> Dict[str, torch.Tensor]:
    """The context-parallel counterpart of ``VapModel.probs`` (JAX:
    context.py:432-441)."""
    out = forward_context_parallel(net, waveform, conf, mesh)
    return probs_from_logits(out["logits"], out["vad"], conf)


@torch.inference_mode()
def forward_mono_context_parallel(
    net: torch.nn.Module,
    waveform: torch.Tensor,
    va: torch.Tensor,
    conf: VapMonoConfig,
    mesh: Mesh,
    va_history: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Mono (VAD-conditioned) forward of ``net`` (a ``VapMonoNet``) with
    time split over the shards of ``mesh``. waveform: (1, 1, n), (1, n) or
    (n,); va: (1, Tva, 2) or (Tva, 2) with Tva >= T50; an optional
    va_history (1, Tvah, bins) adds the history conditioning, sliced like va.
    Returns {"logits": (1, T50, n_classes), "vad": va[:, :T50]}: the plain
    ``forward_mono`` up to summation order (JAX: context.py:358-412)."""
    wav = torch.as_tensor(waveform).reshape(1, -1)
    va = torch.as_tensor(va)
    va = va[None] if va.ndim == 2 else va
    devices = mesh.devices
    n_dev = len(devices)
    t50 = _check_split(wav.shape[-1], n_dev)
    if va.shape[1] < t50:
        raise ValueError(f"va covers {va.shape[1]} frames, the audio {t50}")
    hist = None
    if uses_history(net, conf, va_history):
        hist = torch.as_tensor(va_history)
        hist = hist[None] if hist.ndim == 2 else hist
        if hist.shape[1] < t50:
            raise ValueError(f"va_history covers {hist.shape[1]} frames, the audio {t50}")
    if n_dev == 1:
        dev = devices[0]
        out = forward_mono(_replicas(net, devices)[dev], wav.to(dev), va.to(dev), conf,
                           va_history=None if hist is None else hist.to(dev))
        return {"logits": out["logits"][:, :t50], "vad": va[:, :t50]}

    ws = _sharded_weights(net, conf, devices)
    t50_loc = t50 // n_dev
    xs = _encode_sharded([w.encoder for w in ws], _padded(wav, conf), t50_loc, devices)
    for d, (w, dev) in enumerate(zip(ws, devices)):
        frames = slice(d * t50_loc, (d + 1) * t50_loc)
        h = None if hist is None else hist[:, frames].to(dev)
        xs[d] = xs[d] + va_conditioning(w, va[:, frames].to(dev), h).to(xs[d].dtype)
    xs = _gpt_sharded([w.ar_channel for w in ws], xs, conf.num_heads, t50_loc)
    xs = _gpt_sharded([w.ar for w in ws], xs, conf.num_heads, t50_loc)
    logits = [(x @ w.vap_head.w.T + w.vap_head.b).float().to(devices[0]) for w, x in zip(ws, xs)]
    return {"logits": torch.cat(logits, dim=1), "vad": va[:, :t50]}

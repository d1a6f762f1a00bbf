"""VAP model assembly: stereo (``VapNet``, ``VapModel``) and mono
(``VapMonoNet``, ``VapMonoModel``), the encoder -> GPTs -> heads ->
probabilities.

Counterpart of ``voiceactivityprojection_tpu/models/vap.py`` (``_compute_cast``
:120 as ``_compute_params``, ``forward`` :131 with its training branch,
``forward_mono`` :209, ``probs_from_logits`` :272, ``VapModel`` :376, the
mono probabilities :469-478 and ``VapMonoModel`` :481):

  stereo: shared CPC encoder on each channel (both channels in one batch)
          -> per-channel GPT ``ar_channel`` -> cross-channel GPTStereo ``ar``
          -> ``va_classifier`` on x1 / x2 and ``vap_head`` on the combined x.
  mono:   the encoder on one channel + VAD conditioning (``va_condition``
          [+ ``va_cond_history``] -> LayerNorm, in float32, joined in the
          compute dtype) -> two plain GPTs -> ``vap_head``.

``VapModel`` and ``VapMonoModel`` run on the card unless they are given
another device; without CUDA their default raises. Training calls
``forward`` with a generator (``train/step.py``), with the pretrained CPC
frozen or, under ``freeze_encoder=False``, trained too, on either device.
Labels and loss in ``probs(..., vad=...)``, ``VapModel.vad``, the mono
train steps and the non-discrete representations come with later slices.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from voiceactivityprojection_tpu_torch.config import VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.models.encoder import Encoder, apply_encoder
from voiceactivityprojection_tpu_torch.models.transformer import (
    GPT,
    GPTStereo,
    apply_gpt,
    apply_gpt_stereo,
)
from voiceactivityprojection_tpu_torch.ops.codebook import (
    entropy_bits,
    probs_next_speaker_aggregate,
)
from voiceactivityprojection_tpu_torch.ops.conv import layer_norm
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_FROZEN = ("encoder.gEncoder.", "encoder.gAR.")  # the pretrained CPC under freeze_encoder


class VapNet(nn.Module):
    """All weights of the stereo model, named as the JAX ``init_vap`` tree.
    Call through ``forward(net, waveform, conf, generator)``, which chooses
    the weights the module computes with."""

    def __init__(self, conf: VapConfig):
        super().__init__()
        self.encoder = Encoder(conf.encoder_dim)
        self.ar_channel = GPT(conf.dim, conf.channel_layers, conf.num_heads)
        self.ar = GPTStereo(conf.dim, conf.cross_layers, conf.num_heads)
        self.va_classifier = ParamGroup(w=(1, conf.dim), b=(1,))
        self.vap_head = ParamGroup(w=(conf.head_dim, conf.dim), b=(conf.head_dim,))

    def forward(
        self, waveform: torch.Tensor, conf: VapConfig, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        training = generator is not None
        drop = conf.dropout if training else 0.0
        rng = DropoutRng(generator, waveform.device) if training else None
        x1, x2 = encode_audio(
            self, waveform,
            fused_auto=not training or conf.freeze_encoder,
            # the GRU + downsample kernel has no backward: inference only
            fuse_downsample=not training,
        )
        h = conf.num_heads
        o1 = apply_gpt(self.ar_channel, x1, num_heads=h, dropout=drop, rng=rng)["x"]
        o2 = apply_gpt(self.ar_channel, x2, num_heads=h, dropout=drop, rng=rng)["x"]
        out = apply_gpt_stereo(self.ar, o1, o2, num_heads=h, dropout=drop, rng=rng)
        va = self.va_classifier
        v1 = out["x1"] @ va.w.T + va.b
        v2 = out["x2"] @ va.w.T + va.b
        vad = torch.cat([v1, v2], dim=-1)
        logits = out["x"] @ self.vap_head.w.T + self.vap_head.b
        return {"logits": logits.float(), "vad": vad.float()}


class VapMonoNet(nn.Module):
    """All weights of the mono model, named as the JAX ``init_vap_mono``
    tree (vap.py:70-91). Call through ``forward_mono``."""

    def __init__(self, conf: VapMonoConfig):
        super().__init__()
        dim = conf.dim
        self.encoder = Encoder(conf.encoder_dim)
        self.ar_channel = GPT(dim, conf.channel_layers, conf.num_heads)
        self.ar = GPT(dim, conf.cross_layers, conf.num_heads)
        self.va_condition = ParamGroup(w=(dim, 2), b=(dim,))
        self.va_cond_ln = ParamGroup(w=(dim,), b=(dim,))
        self.vap_head = ParamGroup(w=(conf.n_classes, dim), b=(conf.n_classes,))
        if conf.va_history:
            self.va_cond_history = ParamGroup(w=(dim, conf.va_history_bins), b=(dim,))

    def forward(
        self,
        waveform: torch.Tensor,
        va: torch.Tensor,
        conf: VapMonoConfig,
        va_history: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        training = generator is not None
        drop = conf.dropout if training else 0.0
        rng = DropoutRng(generator, waveform.device) if training else None
        x = apply_encoder(
            self.encoder, waveform,
            fused_auto=not training or conf.freeze_encoder, fuse_downsample=not training,
        )
        cond = va_conditioning(self, va, va_history if uses_history(self, conf, va_history) else None)
        n = min(x.shape[1], cond.shape[1])
        x = x[:, :n] + cond[:, :n].to(x.dtype)
        h = conf.num_heads
        x = apply_gpt(self.ar_channel, x, num_heads=h, dropout=drop, rng=rng)["x"]
        x = apply_gpt(self.ar, x, num_heads=h, dropout=drop, rng=rng)["x"]
        logits = x @ self.vap_head.w.T + self.vap_head.b
        return {"logits": logits.float(), "vad": va}


def uses_history(net: Any, conf: VapMonoConfig, va_history: Optional[torch.Tensor]) -> bool:
    """Whether the history conditioning applies (JAX: vap.py:246)."""
    return bool(conf.va_history) and va_history is not None and hasattr(net, "va_cond_history")


def va_conditioning(
    net: Any, va: torch.Tensor, va_history: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """VAD conditioning in float32 (JAX: vap.py:243-251): ``va`` (B, T, 2)
    [and ``va_history`` (B, T, bins)] -> LayerNorm of their projections,
    (B, T, dim), with the weights in whatever dtype they are computed in."""
    f = lambda t: t.to(torch.float32)
    c = net.va_condition
    cond = f(va) @ f(c.w).T + f(c.b)
    if va_history is not None:
        hist = net.va_cond_history
        cond = cond + (f(va_history) @ f(hist.w).T + f(hist.b))
    return layer_norm(cond, f(net.va_cond_ln.w), f(net.va_cond_ln.b))


def _compute_params(net: nn.Module, conf: VapConfig) -> Dict[str, torch.Tensor]:
    """The tensors the forward computes with, by name: under
    ``freeze_encoder`` the pretrained CPC (gEncoder, gAR) detached, so no
    gradient reaches it while the downsample trains (JAX: vap.py:152-167);
    in bfloat16 mode every float32 tensor (the ALiBi slopes too) cast, on
    the autograd graph, so the gradients arrive at the float32 weights (JAX
    casts inside ``value_and_grad``, vap.py:120-128 and :144). Norm
    statistics, softmax and the outputs stay float32."""
    if conf.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {conf.dtype!r}")
    out = {}
    for name, t in itertools.chain(net.named_parameters(), net.named_buffers()):
        if conf.freeze_encoder and name.startswith(_FROZEN):
            t = t.detach()
        if conf.dtype == "bfloat16" and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        out[name] = t
    return out


def encode_audio(
    net: VapNet, waveform: torch.Tensor, fused_auto: bool = False, fuse_downsample: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, n) -> per-channel (B, T, C) features; both channels go through
    the shared encoder as one batch of 2B rows."""
    if waveform.ndim != 3 or waveform.shape[1] != 2:
        raise ValueError(f"expected (B, 2, n_samples), got {tuple(waveform.shape)}")
    B = waveform.shape[0]
    z = apply_encoder(
        net.encoder, waveform.reshape(B * 2, waveform.shape[-1]),
        fused_auto=fused_auto, fuse_downsample=fuse_downsample,
    )
    z = z.reshape(B, 2, *z.shape[1:])
    return z[:, 0], z[:, 1]


def forward(
    net: VapNet,
    waveform: torch.Tensor,
    conf: VapConfig,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """waveform (B, 2, n) -> {"logits": (B, T, 256), "vad": (B, T, 2)},
    both float32 in either compute dtype (JAX: vap.py:131-206).

    With a CPU ``generator`` this is the training forward: dropout at
    ``conf.dropout``, drawn from the generator in a fixed order, and the
    encoder paths of training (``apply_encoder``). Without one it is the
    inference forward."""
    params = _compute_params(net, conf)
    if conf.dtype == "bfloat16":
        waveform = waveform.to(torch.bfloat16)
    return torch.func.functional_call(net, params, (waveform, conf, generator))


def forward_mono(
    net: VapMonoNet,
    waveform: torch.Tensor,
    va: torch.Tensor,
    conf: VapMonoConfig,
    va_history: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """waveform (B, n) or (B, 1, n), va (B, Tva, 2) [, va_history (B, Tvah,
    bins)] -> {"logits": (B, min(T, Tva), n_classes) float32, "vad": va}
    (JAX: vap.py:209-266): the freeze scope and casts of ``forward``."""
    if waveform.ndim == 3:
        if waveform.shape[1] != 1:
            raise ValueError(f"expected (B, 1, n), got {tuple(waveform.shape)}")
        waveform = waveform[:, 0]
    params = _compute_params(net, conf)
    if conf.dtype == "bfloat16":
        waveform = waveform.to(torch.bfloat16)
    return torch.func.functional_call(net, params, (waveform, va, conf, va_history, generator))


def mono_probs(logits: torch.Tensor, va: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The mono model's derived outputs (JAX: vap.py:469-478)."""
    probs = torch.softmax(logits, dim=-1)
    return {
        "probs": probs,
        "vad": va,
        "p_now": probs_next_speaker_aggregate(probs, 0, 1),
        "p_future": probs_next_speaker_aggregate(probs, 2, 3),
        "H": entropy_bits(probs),
    }


def probs_from_logits(
    logits: torch.Tensor, vad_logits: torch.Tensor, conf: VapConfig
) -> Dict[str, torch.Tensor]:
    """softmax + entropy + p_now / p_future for the discrete (256-way)
    representation (JAX: vap.py:272-299)."""
    if conf.representation != "discrete":
        raise NotImplementedError(
            f"representation {conf.representation!r} is not ported yet"
        )
    probs = torch.softmax(logits, dim=-1)
    return {
        "probs": probs,
        "vad": torch.sigmoid(vad_logits),
        "p_now": probs_next_speaker_aggregate(probs, 0, 1),
        "p_future": probs_next_speaker_aggregate(probs, 2, 3),
        "H": entropy_bits(probs),
    }


class _Model:
    """Config + weights on one device, the weights kept in the compute dtype.

    ``state`` is the port's state dict (``params_from_jax`` output); without
    it the weights are drawn from seed 0 in the JAX layout
    (``random_params_tree``). ``device=None`` means ``cuda``."""

    _net_cls: type = VapNet
    _conf_cls: type = VapConfig

    def __init__(
        self,
        conf: Optional[VapConfig] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        device: Union[str, torch.device, None] = None,
    ):
        from voiceactivityprojection_tpu_torch.models.checkpoint import (
            params_from_jax,
            random_params_tree,
        )

        self.conf = conf or self._conf_cls()
        self.device = resolve_device(device)
        if state is None:
            state = params_from_jax(random_params_tree(self.conf), self.conf)
        if self.conf.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.conf.dtype!r}")
        net = self._net_cls(self.conf)
        net.load_state_dict(state, strict=True)
        # inference keeps the weights in the compute dtype, cast once
        self.net = net.to(self.device, _DTYPES[self.conf.dtype]).eval()

    @classmethod
    def from_jax_params(
        cls,
        tree: Any,
        conf: Optional[VapConfig] = None,
        device: Union[str, torch.device, None] = None,
    ):
        """From the JAX params pytree as nested dicts/lists of numpy arrays."""
        from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax

        conf = conf or cls._conf_cls()
        return cls(conf, params_from_jax(tree, conf), device=device)

    @property
    def sample_rate(self) -> int:
        return self.conf.sample_rate

    @property
    def frame_hz(self) -> int:
        return self.conf.frame_hz

    def _input(self, waveform) -> torch.Tensor:
        x = torch.as_tensor(waveform, device=self.device)
        return x if x.dtype in _DTYPES.values() else x.to(torch.float32)


class VapModel(_Model):
    """Stereo VAP model: config + weights on one device."""

    @torch.inference_mode()
    def forward(self, waveform) -> Dict[str, torch.Tensor]:
        return forward(self.net, self._input(waveform), self.conf)

    __call__ = forward

    @torch.inference_mode()
    def probs(self, waveform) -> Dict[str, torch.Tensor]:
        out = forward(self.net, self._input(waveform), self.conf)
        return probs_from_logits(out["logits"], out["vad"], self.conf)


class VapMonoModel(_Model):
    """Mono VAP model with VAD conditioning: config + weights on one device
    (JAX: vap.py:481-512). ``va_history`` conditions the model where the
    config and the weights have it."""

    _net_cls = VapMonoNet
    _conf_cls = VapMonoConfig

    @torch.inference_mode()
    def forward(self, waveform, va, va_history=None) -> Dict[str, torch.Tensor]:
        hist = None if va_history is None else self._input(va_history)
        return forward_mono(self.net, self._input(waveform), self._input(va), self.conf, va_history=hist)

    __call__ = forward

    @torch.inference_mode()
    def probs(self, waveform, va, va_history=None) -> Dict[str, torch.Tensor]:
        out = self.forward(waveform, va, va_history)
        return mono_probs(out["logits"], out["vad"])

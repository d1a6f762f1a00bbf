"""Stereo VAP model: encoder per channel -> GPTs -> heads -> probabilities.

Counterpart of ``voiceactivityprojection_tpu/models/vap.py`` (``_compute_cast``
:120, ``forward`` :131, ``probs_from_logits`` :272, ``VapModel`` :376),
inference only:

  shared CPC encoder on each channel (both channels in one batch)
  -> per-channel GPT ``ar_channel`` -> cross-channel GPTStereo ``ar``
  -> ``va_classifier`` on x1 / x2 and ``vap_head`` on the combined x.

``VapModel`` runs on the card unless it is given another device; without
CUDA its default raises. Labels and loss (``probs(..., vad=...)``),
``VapModel.vad`` and the non-discrete representations come with later
slices.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from voiceactivityprojection_tpu_torch.config import VapConfig
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
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VapNet(nn.Module):
    """All weights of the stereo model, named as the JAX ``init_vap`` tree."""

    def __init__(self, conf: VapConfig):
        super().__init__()
        self.encoder = Encoder(conf.encoder_dim)
        self.ar_channel = GPT(conf.dim, conf.channel_layers, conf.num_heads)
        self.ar = GPTStereo(conf.dim, conf.cross_layers, conf.num_heads)
        self.va_classifier = ParamGroup(w=(1, conf.dim), b=(1,))
        self.vap_head = ParamGroup(w=(conf.head_dim, conf.dim), b=(conf.head_dim,))


def _compute_cast(
    net: VapNet, waveform: torch.Tensor, conf: VapConfig
) -> Tuple[VapNet, torch.Tensor]:
    """Mixed precision: in bfloat16 mode every float32 weight (the ALiBi
    slopes too) and the waveform are cast to bfloat16; norm statistics,
    softmax and the outputs stay float32 (JAX: vap.py:120-128)."""
    if conf.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {conf.dtype!r}")
    if conf.dtype == "bfloat16":
        if any(t.dtype == torch.float32 for t in net.state_dict().values()):
            net = copy.deepcopy(net).to(torch.bfloat16)
        return net, waveform.to(torch.bfloat16)
    return net, waveform


def encode_audio(net: VapNet, waveform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, n) -> per-channel (B, T, C) features; both channels go through
    the shared encoder as one batch of 2B rows."""
    if waveform.ndim != 3 or waveform.shape[1] != 2:
        raise ValueError(f"expected (B, 2, n_samples), got {tuple(waveform.shape)}")
    B = waveform.shape[0]
    z = apply_encoder(net.encoder, waveform.reshape(B * 2, waveform.shape[-1]))
    z = z.reshape(B, 2, *z.shape[1:])
    return z[:, 0], z[:, 1]


def forward(net: VapNet, waveform: torch.Tensor, conf: VapConfig) -> Dict[str, torch.Tensor]:
    """waveform (B, 2, n) -> {"logits": (B, T, 256), "vad": (B, T, 2)},
    both float32 in either compute dtype."""
    net, waveform = _compute_cast(net, waveform, conf)
    x1, x2 = encode_audio(net, waveform)
    h = conf.num_heads
    o1 = apply_gpt(net.ar_channel, x1, num_heads=h)["x"]
    o2 = apply_gpt(net.ar_channel, x2, num_heads=h)["x"]
    out = apply_gpt_stereo(net.ar, o1, o2, num_heads=h)
    va = net.va_classifier
    v1 = out["x1"] @ va.w.T + va.b
    v2 = out["x2"] @ va.w.T + va.b
    vad = torch.cat([v1, v2], dim=-1)
    logits = out["x"] @ net.vap_head.w.T + net.vap_head.b
    return {"logits": logits.float(), "vad": vad.float()}


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


class VapModel:
    """Stereo VAP model: config + weights on one device.

    ``state`` is the port's state dict (``params_from_jax`` output); without
    it the weights are drawn from seed 0 in the JAX layout
    (``random_params_tree``). ``device=None`` means ``cuda``.
    """

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

        self.conf = conf or VapConfig()
        self.device = resolve_device(device)
        if state is None:
            state = params_from_jax(random_params_tree(self.conf), self.conf)
        net = VapNet(self.conf)
        net.load_state_dict(state, strict=True)
        net, _ = _compute_cast(net, torch.zeros(0), self.conf)
        self.net = net.to(self.device).eval()

    @classmethod
    def from_jax_params(
        cls,
        tree: Any,
        conf: Optional[VapConfig] = None,
        device: Union[str, torch.device, None] = None,
    ) -> "VapModel":
        """From the JAX params pytree as nested dicts/lists of numpy arrays."""
        from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax

        conf = conf or VapConfig()
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

    @torch.inference_mode()
    def forward(self, waveform) -> Dict[str, torch.Tensor]:
        return forward(self.net, self._input(waveform), self.conf)

    __call__ = forward

    @torch.inference_mode()
    def probs(self, waveform) -> Dict[str, torch.Tensor]:
        out = forward(self.net, self._input(waveform), self.conf)
        return probs_from_logits(out["logits"], out["vad"], self.conf)

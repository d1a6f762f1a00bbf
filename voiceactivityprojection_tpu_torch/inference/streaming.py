"""Streaming (real-time) VAP over a rolling context window.

Counterpart of ``voiceactivityprojection_tpu/inference/streaming.py``. Each
hop of ``hop_frames`` x 320 samples a channel:

* the encoder runs incrementally: by default the exact streaming encoder
  (``models/encoder_streaming_exact.py``), whose frames equal the batch
  forward's; ``encoder_mode="causal"`` takes the strictly causal
  ``apply_encoder_streaming`` (``models/encoder.py``);
* the new frames enter a (2, context_frames, C) feature ring on the model's
  device (``torch.roll`` and a slice write), so the transformer always sees
  one shape;
* the per-channel GPT runs once per channel (B=1) and the stereo GPT over
  the ring, with the config's ``attn_impl`` passed through (JAX :64-69): on
  the card every attention site is the attention kernel (K4; K5's shapes
  past 20.48 s of context), 14 a hop at ``VapConfig()``.

The feature ring starts at zeros, that is silence before the dialog.

The streamers compute in float32, as JAX's do: JAX's streaming steps run
on the float32 params whatever ``conf.dtype`` says. The port's ``VapModel``
keeps its weights in the compute dtype, so a streamer takes a model built
with ``dtype="float32"`` and raises on another (``streaming_net``); the
``run_sds`` and ``serve --mode stream`` entry points build their model in
float32 whatever ``--vap_dtype`` asks. Every push runs under
``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict

import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models.encoder import (
    apply_encoder_streaming,
    init_encoder_state,
)
from voiceactivityprojection_tpu_torch.models.encoder_streaming_exact import (
    SAMPLES_PER_FRAME,
    ExactStreamingEncoder,
)
from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops.codebook import entropy_bits, probs_next_speaker_aggregate

__all__ = ["ENCODER_MODES", "SAMPLES_PER_FRAME", "StreamingVap", "streaming_net"]

ENCODER_MODES = ("exact", "causal")


def streaming_net(model) -> VapNet:
    """The model's weights, which a streamer computes with: float32 only."""
    dtype = model.net.encoder.gAR.w_hh.dtype
    if dtype != torch.float32:
        raise ValueError(
            f"the streamers compute in float32 (as the JAX package's do); got a model with {dtype} "
            "weights: build it with VapConfig(dtype='float32')"
        )
    return model.net


def check_encoder_mode(mode: str) -> str:
    if mode not in ENCODER_MODES:
        raise ValueError(f"encoder_mode must be one of {ENCODER_MODES}, got {mode!r}")
    return mode


def _window_step(
    net: VapNet, feats: torch.Tensor, new_feats: torch.Tensor, conf: VapConfig, hop_frames: int
):
    """Roll the (2, T, C) feature ring by the (2, hop_frames, C) new frames
    and run the transformer and heads over it (JAX: streaming.py:44-81).
    Returns the new ring and the outputs, (T, 2) / (T,) a key."""
    feats = torch.roll(feats, -hop_frames, dims=1)
    feats[:, feats.shape[1] - hop_frames:] = new_feats
    kw = dict(num_heads=conf.num_heads, attn_impl=conf.attn_impl)
    o1 = apply_gpt(net.ar_channel, feats[:1], **kw)["x"]
    o2 = apply_gpt(net.ar_channel, feats[1:], **kw)["x"]
    out = apply_gpt_stereo(net.ar, o1, o2, **kw)
    va = net.va_classifier
    v1 = out["x1"] @ va.w.T + va.b
    v2 = out["x2"] @ va.w.T + va.b
    logits = out["x"] @ net.vap_head.w.T + net.vap_head.b
    probs = torch.softmax(logits.float(), dim=-1)
    ret = {
        "p_now": probs_next_speaker_aggregate(probs, 0, 1)[0],
        "p_future": probs_next_speaker_aggregate(probs, 2, 3)[0],
        "vad": torch.sigmoid(torch.cat([v1, v2], dim=-1))[0],
        "H": entropy_bits(probs)[0],
    }
    return feats, ret


class StreamingVap:
    """Incremental stereo VAP over a rolling context window.

        s = StreamingVap(model, context_time=20.0, hop_frames=1)
        s.reset()
        out = s.push(chunk)   # chunk: (2, hop_frames * 320) float32
        out["p_now"]          # (context_frames, 2): the last rows are the newest

    ``encoder_mode``: ``"exact"`` (frames equal the batch forward's) or
    ``"causal"`` (no lookahead, slightly offset features). Another mode
    raises, where JAX takes any other value as causal."""

    def __init__(self, model, context_time: float = 20.0, hop_frames: int = 1, encoder_mode: str = "exact"):
        self.model = model
        self.net = streaming_net(model)
        self.conf: VapConfig = model.conf
        self.device = model.device
        self.hop_frames = hop_frames
        self.hop_samples = hop_frames * SAMPLES_PER_FRAME
        self.context_frames = int(context_time * self.conf.frame_hz)
        self.encoder_mode = check_encoder_mode(encoder_mode)
        self._enc = None
        self._enc_state = None
        self.feats = None
        self.frames_seen = 0

    @torch.inference_mode()
    def reset(self) -> None:
        if self.encoder_mode == "exact":
            self._enc = ExactStreamingEncoder(self.net.encoder, batch=2)
        else:
            self._enc_state = init_encoder_state(self.net.encoder, batch=2)
        self.feats = torch.zeros(2, self.context_frames, self.conf.dim, device=self.device)
        self.frames_seen = 0

    @torch.inference_mode()
    def push(self, chunk) -> Dict[str, torch.Tensor]:
        """Encode ``hop_frames * 320`` new samples a channel; returns the
        window's outputs, on the model's device."""
        if self.feats is None:
            self.reset()
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        if tuple(chunk.shape) != (2, self.hop_samples):
            raise ValueError(f"expected (2, {self.hop_samples}), got {tuple(chunk.shape)}")
        if self.encoder_mode == "exact":
            new_feats = self._enc.push(chunk)
        else:
            new_feats, self._enc_state = apply_encoder_streaming(self.net.encoder, chunk, self._enc_state)
        n_new = new_feats.shape[1]
        self.feats, out = _window_step(self.net, self.feats, new_feats, self.conf, n_new)
        self.frames_seen += n_new
        return out

    @property
    def warmed_up(self) -> bool:
        return self.frames_seen >= self.context_frames

"""KV-cache streaming VAP: constant transformer work per new frame.

Counterpart of ``voiceactivityprojection_tpu/inference/streaming_kv.py``.
``StreamingVap`` re-runs the transformer over the whole context each hop;
here every attention site keeps K/V rings, so a new frame costs one
attention row per site plus one frame of LayerNorm, FFN and head work.

The rings are circular: one slot written per frame at a write cursor that
all streams share (``steps``, a host int), with a per-stream count of valid
frames (``n``, a device tensor), so one stream can be reset by zeroing its
count. Every state tensor has a leading stream axis S, so
``BatchedKVStreamer`` advances S dialogs one frame per step. The rings are
written in place (JAX replaces them functionally; XLA also writes in
place). ``_kv_push`` is a Python loop over the hop's frames where JAX has
``lax.scan``.

Semantics (JAX :22-40): until ``context_frames`` frames have been seen the
outputs equal the batch forward over the true prefix; afterwards each layer
attends to its last ``context_frames`` keys (a per-layer sliding window,
with ALiBi over the longer relative distances).

Kept from JAX (``ops/attention.py``, ``models/transformer.py``): the score
scale 1/sqrt(full model dim) (:136-157); the ALiBi bias -slope * age of a
slot; pre-LN layers; the cross-attention K/V projected from the other
channel's PRE-layer value, not normalised (:171, :183-189); the causal mask
j <= i, so the current frame is visible to the other channel's
cross-attention; the combinator and heads per frame. JAX reads the cross
rings with the channel axis swapped (``ck_ring[:, ::-1]``, :193-196); the
port's row reads ring channel 1 - c for query channel c by index, the same
slots without copying the rings.

JAX computes the attention row with two XLA einsums outside its Pallas
kernels. The port computes it with ``ops/kv_attention.py``
``kv_attention_row``: on the card one hand-written kernel reads each row's
K and V rings once, with the slot ages and the mask computed inside it
(K12), beside the GRU recurrence (K3) in the streaming encoder; on the CPU
its plain version, the two ``torch.einsum``s.

The streamers compute in float32 (``inference/streaming.py``
``streaming_net``). ``BatchedKVStreamer.reset_stream`` replaces no state
tensor but writes into two; a server calls it from the thread that pushes
(``inference/server.py`` ``VapStreamServer._tick``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.streaming import (
    SAMPLES_PER_FRAME,
    check_encoder_mode,
    streaming_net,
)
from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder_streaming, init_encoder_state
from voiceactivityprojection_tpu_torch.models.encoder_streaming_exact import ExactStreamingEncoder
from voiceactivityprojection_tpu_torch.models.transformer import TransformerLayer, apply_combinator
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops.codebook import entropy_bits, probs_next_speaker_aggregate
from voiceactivityprojection_tpu_torch.ops.conv import layer_norm
from voiceactivityprojection_tpu_torch.ops.kv_attention import kv_attention_row
from voiceactivityprojection_tpu_torch.utils.profiling import count_h2d, span

__all__ = ["BatchedKVStreamer", "KVStreamingVap", "init_kv_state"]

State = Dict[str, Any]


def _ring(streams: int, num_heads: int, T: int, head_dim: int, device) -> torch.Tensor:
    # axes: (stream, speaker channel, head, time slot, head dim)
    return torch.zeros(streams, 2, num_heads, T, head_dim, dtype=torch.float32, device=device)


def init_kv_state(conf: VapConfig, context_frames: int, streams: int = 1, device="cpu") -> State:
    """Zeroed K/V rings for every attention site, the shared write cursor
    ``steps`` (host int) and the per-stream valid count ``n`` (S,) int32
    (JAX: streaming_kv.py:74-104)."""
    H = conf.num_heads
    Dh = conf.dim // H
    T = context_frames
    ring = lambda: _ring(streams, H, T, Dh, device)  # noqa: E731
    return {
        "steps": 0,
        "n": torch.zeros(streams, dtype=torch.int32, device=device),
        "ar_channel": [{"k": ring(), "v": ring()} for _ in range(conf.channel_layers)],
        # the cross rings hold THIS channel's projections of its own
        # pre-layer value; the other channel's query reads them
        "ar": [{"k": ring(), "v": ring(), "ck": ring(), "cv": ring()} for _ in range(conf.cross_layers)],
    }


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    # (..., D) -> (..., H, Dh)
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def _write_ring(ring: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write one (S, 2, H, Dh) frame into time slot ``pos``, in place."""
    ring[:, :, :, pos] = new
    return ring


def _layer_step(
    layer: TransformerLayer, x: torch.Tensor, rings: State, pos: int, n_valid: torch.Tensor, num_heads: int,
    dim: int, cross: bool,
) -> torch.Tensor:
    """One pre-LN layer on an (S, 2, D) frame batch (JAX :160-206). In a
    cross layer channel c's query reads channel 1 - c's cross rings: the
    twin pass of the stereo layer."""
    orig = x  # the pre-layer value: the cross-attention's K/V source
    z = layer_norm(x, layer.ln_self_attn.w, layer.ln_self_attn.b)
    mha = layer.mha
    q = _heads(z @ mha.query.w.T, num_heads)
    k_ring = _write_ring(rings["k"], _heads(z @ mha.key.w.T, num_heads), pos)
    v_ring = _write_ring(rings["v"], _heads(z @ mha.value.w.T, num_heads), pos)
    x = x + kv_attention_row(q, k_ring, v_ring, mha.m, pos, n_valid, dim) @ mha.proj.w.T
    if cross:
        mc = layer.mha_cross
        # each channel appends ITS OWN un-normalised pre-layer projections
        ck_ring = _write_ring(rings["ck"], _heads(orig @ mc.key.w.T, num_heads), pos)
        cv_ring = _write_ring(rings["cv"], _heads(orig @ mc.value.w.T, num_heads), pos)
        z = layer_norm(x, layer.ln_src_attn.w, layer.ln_src_attn.b)
        q = _heads(z @ mc.query.w.T, num_heads)
        # the other channel's ring: query channel c reads ring channel 1 - c
        ca = kv_attention_row(q, ck_ring, cv_ring, mc.m, pos, n_valid, dim, swap=True)
        x = x + ca @ mc.proj.w.T
    z = layer_norm(x, layer.ln_ffnetwork.w, layer.ln_ffnetwork.b)
    return x + F.gelu(z @ layer.ffn.w_in.w.T) @ layer.ffn.w_out.w.T


def _frame_step(net: VapNet, state: State, feats: torch.Tensor, conf: VapConfig) -> Dict[str, torch.Tensor]:
    """Advance every ring by one frame, feats (S, 2, D); updates ``state``
    in place and returns the frame's outputs, (S, ...) a key (JAX :209-255)."""
    H, D = conf.num_heads, conf.dim
    T = (state["ar_channel"] or state["ar"])[0]["k"].shape[3]
    pos = state["steps"] % T
    n_valid = torch.clamp(state["n"] + 1, max=T)
    x = feats
    for layer, rings in zip(net.ar_channel.layers, state["ar_channel"]):
        with span("kv.layer"):
            x = _layer_step(layer, x, rings, pos, n_valid, H, D, cross=False)
    for layer, rings in zip(net.ar.layers, state["ar"]):
        with span("kv.layer"):
            x = _layer_step(layer, x, rings, pos, n_valid, H, D, cross=True)
    with span("kv.heads"):
        x1, x2 = x[:, :1], x[:, 1:]  # (S, 1, D) each
        combined = apply_combinator(net.ar.combinator, x1, x2)
        va = net.va_classifier
        v1 = x1 @ va.w.T + va.b
        v2 = x2 @ va.w.T + va.b
        logits = combined @ net.vap_head.w.T + net.vap_head.b
        probs = torch.softmax(logits.float(), dim=-1)
        state["steps"] += 1
        state["n"] = n_valid
        return {
            "p_now": probs_next_speaker_aggregate(probs, 0, 1)[:, 0],
            "p_future": probs_next_speaker_aggregate(probs, 2, 3)[:, 0],
            "vad": torch.sigmoid(torch.cat([v1, v2], dim=-1))[:, 0],
            "H": entropy_bits(probs)[:, 0],
            "logits": logits[:, 0],
        }


def _kv_push(net: VapNet, state: State, new_feats: torch.Tensor, conf: VapConfig) -> Dict[str, torch.Tensor]:
    """``_frame_step`` over (S, 2, n_new, C) new frames, in order; outputs
    stacked (n_new, S, ...) (JAX :258-270)."""
    outs = [_frame_step(net, state, new_feats[:, :, t], conf) for t in range(new_feats.shape[2])]
    if outs:
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    S = new_feats.shape[0]
    trail = {"p_now": (2,), "p_future": (2,), "vad": (2,), "H": (), "logits": (conf.head_dim,)}
    return {k: torch.zeros(0, S, *shape, device=new_feats.device) for k, shape in trail.items()}


def _chunk_on(chunk, device) -> torch.Tensor:
    """A hop's audio as float32 on the streamer's device."""
    with span("kv.h2d"):
        count_h2d(chunk)
        return torch.as_tensor(chunk, dtype=torch.float32, device=device)


class KVStreamingVap:
    """Incremental stereo VAP with K/V caches, one dialog.

        s = KVStreamingVap(model, context_time=20.0)
        s.reset()
        out = s.push(chunk)    # chunk: (2, hop_frames * 320) float32
        out["p_now"]           # (n_new, 2): one row per NEW frame

    Unlike ``StreamingVap`` the outputs cover the new frames only, and before
    the context fills they equal the batch forward on the true prefix (no
    silence before the dialog)."""

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
        self.state: Optional[State] = None
        self.frames_seen = 0

    @torch.inference_mode()
    def reset(self) -> None:
        if self.encoder_mode == "exact":
            self._enc = ExactStreamingEncoder(self.net.encoder, batch=2)
        else:
            self._enc_state = init_encoder_state(self.net.encoder, batch=2)
        self.state = init_kv_state(self.conf, self.context_frames, streams=1, device=self.device)
        self.frames_seen = 0

    @torch.inference_mode()
    def push(self, chunk) -> Dict[str, torch.Tensor]:
        if self.state is None:
            self.reset()
        with span("kv.push"):
            chunk = _chunk_on(chunk, self.device)
            if tuple(chunk.shape) != (2, self.hop_samples):
                raise ValueError(f"expected (2, {self.hop_samples}), got {tuple(chunk.shape)}")
            with span("kv.encoder"):
                if self.encoder_mode == "exact":
                    new_feats = self._enc.push(chunk)
                else:
                    new_feats, self._enc_state = apply_encoder_streaming(self.net.encoder, chunk, self._enc_state)
            return self.push_features(new_feats)

    @torch.inference_mode()
    def push_features(self, new_feats) -> Dict[str, torch.Tensor]:
        """Advance the caches from (2, n, C) features (for tests and for
        pipelines with their own encoder)."""
        if self.state is None:
            self.reset()
        new_feats = torch.as_tensor(new_feats, dtype=torch.float32, device=self.device)
        out = _kv_push(self.net, self.state, new_feats[None], self.conf)
        self.frames_seen += new_feats.shape[1]
        return {k: v[:, 0] for k, v in out.items()}  # drop the stream axis


class BatchedKVStreamer:
    """S dialogs advanced one hop per push (the serving shape).

    The streams hop in lockstep (they share the write cursor). A slot is
    recycled for a new dialog with ``reset_stream(i)``. Waveform pushes run
    the exact streaming encoder over a (2S)-row batch: on the card one K3
    launch at R = 2S a hop.

        b = BatchedKVStreamer(model, streams=64, context_time=20.0)
        out = b.push(chunks)   # (S, 2, hop_frames * 320)
        out["p_now"]           # (n_new, S, 2)
    """

    def __init__(self, model, streams: int, context_time: float = 20.0, hop_frames: int = 1):
        self.model = model
        self.net = streaming_net(model)
        self.conf: VapConfig = model.conf
        self.device = model.device
        self.streams = streams
        self.hop_frames = hop_frames
        self.hop_samples = hop_frames * SAMPLES_PER_FRAME
        self.context_frames = int(context_time * self.conf.frame_hz)
        self._enc: Optional[ExactStreamingEncoder] = None
        self.state: Optional[State] = None

    @torch.inference_mode()
    def reset(self) -> None:
        self._enc = ExactStreamingEncoder(self.net.encoder, batch=2 * self.streams)
        self.state = init_kv_state(self.conf, self.context_frames, self.streams, device=self.device)

    @torch.inference_mode()
    def reset_stream(self, i: int) -> None:
        """Recycle slot i for a new dialog: its valid count goes to 0, which
        masks its stale ring contents, and the encoder's rows 2i and 2i + 1
        (conv tails, GRU hidden, downsample tail) go to zeros, so the new
        dialog is not conditioned on the previous caller's audio. Call it
        from the thread that pushes (JAX :364-384)."""
        if self.state is not None:
            self.state["n"][i] = 0
        if self._enc is not None:
            self._enc.reset_rows([2 * i, 2 * i + 1])

    @torch.inference_mode()
    def push(self, chunks) -> Dict[str, torch.Tensor]:
        if self.state is None:
            self.reset()
        with span("kv.push"):
            chunks = _chunk_on(chunks, self.device)
            S = self.streams
            if tuple(chunks.shape) != (S, 2, self.hop_samples):
                raise ValueError(f"expected ({S}, 2, {self.hop_samples}), got {tuple(chunks.shape)}")
            with span("kv.encoder"):
                feats = self._enc.push(chunks.reshape(2 * S, self.hop_samples))
            return self.push_features(feats.reshape(S, 2, *feats.shape[1:]))

    @torch.inference_mode()
    def push_features(self, new_feats) -> Dict[str, torch.Tensor]:
        """(S, 2, n, C) features -> outputs (n, S, ...) a key."""
        if self.state is None:
            self.reset()
        new_feats = torch.as_tensor(new_feats, dtype=torch.float32, device=self.device)
        return _kv_push(self.net, self.state, new_feats, self.conf)

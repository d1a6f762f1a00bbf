"""KV-cache streaming VAP: constant transformer work per new frame.

Counterpart of ``voiceactivityprojection_tpu/inference/streaming_kv.py``.
``StreamingVap`` re-runs the transformer over the whole context each hop;
here every attention site keeps K/V rings, so a new frame costs one
attention row per site plus one frame of LayerNorm, FFN and head work.

The rings are circular: one slot written per frame at a write cursor that
all streams share (``steps``, a device int64, with ``frames`` its count on
the host), with a per-stream count of valid frames (``n``, a device
tensor), so one stream can be reset by zeroing its count. Every state
tensor has a leading stream axis S, so ``BatchedKVStreamer`` advances S
dialogs one frame per step. The rings and every other state tensor are
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

On the card a frame runs as CUDA graphs (``_Graphs``): the exact
encoder's steady pass, each layer and the heads, one graph each, replayed
under the spans the eager code opens (``kv.encoder``, ``kv.layer``,
``kv.heads``). The host reads nothing inside a frame: the cursor, the
valid counts and the encoder's state stay on the card at fixed addresses,
the hop's audio arrives through pinned buffers without blocking the host,
and the codebook's weights are on the card since their first use. So a
tick costs the host a staging copy, a few graph launches and the copies
of the outputs out of the graphs' buffers, and the card runs the frame at
its own pace. The graphs are captured on the first steady frame after a
reset (that frame runs eagerly first, on the capture stream), bound to
the state they were captured with; a ``reset()`` zeroes that state in
place and keeps the graphs. The first push after a reset (the encoder's
prime pass) and every CPU tensor run the same code eagerly, and a replay
runs the same kernels on the same values in the same order.

The streamers compute in float32 (``inference/streaming.py``
``streaming_net``). ``BatchedKVStreamer.reset_stream`` replaces no state
tensor but writes into two; a server calls it from the thread that pushes
(``inference/server.py`` ``VapStreamServer._tick``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.streaming import (
    SAMPLES_PER_FRAME,
    check_encoder_mode,
    streaming_net,
)
from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder_streaming, init_encoder_state
from voiceactivityprojection_tpu_torch.models.encoder_streaming_exact import ExactStreamingEncoder, advance
from voiceactivityprojection_tpu_torch.models.transformer import TransformerLayer
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.codebook import entropy_bits, probs_next_speaker_aggregate
from voiceactivityprojection_tpu_torch.ops.conv import layer_norm
from voiceactivityprojection_tpu_torch.ops.kv_attention import kv_attention_row
from voiceactivityprojection_tpu_torch.utils.profiling import count_h2d, span, suspended

__all__ = ["BatchedKVStreamer", "KVStreamingVap", "init_kv_state"]

State = Dict[str, Any]


def _ring(streams: int, num_heads: int, T: int, head_dim: int, device) -> torch.Tensor:
    # axes: (stream, speaker channel, head, time slot, head dim)
    return torch.zeros(streams, 2, num_heads, T, head_dim, dtype=torch.float32, device=device)


def init_kv_state(conf: VapConfig, context_frames: int, streams: int = 1, device="cpu") -> State:
    """Zeroed K/V rings for every attention site, the shared write cursor
    ``steps`` (1,) int64 on the device and ``frames``, the frames written,
    on the host, and the per-stream valid count ``n`` (S,) int32
    (JAX: streaming_kv.py:74-104)."""
    H = conf.num_heads
    Dh = conf.dim // H
    T = context_frames
    ring = lambda: _ring(streams, H, T, Dh, device)  # noqa: E731
    return {
        "steps": torch.zeros(1, dtype=torch.int64, device=device),
        "frames": 0,
        "n": torch.zeros(streams, dtype=torch.int32, device=device),
        "ar_channel": [{"k": ring(), "v": ring()} for _ in range(conf.channel_layers)],
        # the cross rings hold THIS channel's projections of its own
        # pre-layer value; the other channel's query reads them
        "ar": [{"k": ring(), "v": ring(), "ck": ring(), "cv": ring()} for _ in range(conf.cross_layers)],
    }


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    # (..., D) -> (..., H, Dh)
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def _zero_kv_state(state: State) -> None:
    """``init_kv_state``'s values, written into ``state``'s tensors."""
    for t in (state["steps"], state["n"], *(r for site in state["ar_channel"] + state["ar"] for r in site.values())):
        t.zero_()
    state["frames"] = 0


def _write_ring(ring: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one (S, 2, H, Dh) frame into time slot ``pos`` ((1,) int64 on
    the ring's device), in place."""
    return ring.index_copy_(3, pos, new.unsqueeze(3))


def _layer_step(
    layer: TransformerLayer, x: torch.Tensor, rings: State, pos: torch.Tensor, n_valid: torch.Tensor,
    num_heads: int, dim: int, cross: bool,
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


def _frame_stages(net: VapNet, state: State, conf: VapConfig) -> List[Tuple[str, Callable]]:
    """A frame as its traced stages in order, (span name, stage): each
    layer, then the heads. A stage takes what the one before it returned
    (the first the frame's features, (S, 2, D)); the heads return the
    outputs. The first stage reads the cursor: the slot this frame writes,
    ``steps`` mod T, and the valid counts with it; the heads advance
    ``steps`` and ``n``. The host reads no value of the card's, so each
    stage can be captured as a CUDA graph (JAX :209-255)."""
    H, D = conf.num_heads, conf.dim
    T = (state["ar_channel"] or state["ar"])[0]["k"].shape[3]
    cursor: Dict[str, torch.Tensor] = {}

    def read_cursor() -> Dict[str, torch.Tensor]:
        if not cursor:
            cursor["pos"] = torch.remainder(state["steps"], T)
            cursor["n"] = torch.clamp(state["n"] + 1, max=T)
        return cursor

    def layer(mod: TransformerLayer, rings: State, cross: bool) -> Callable:
        def stage(x: torch.Tensor) -> torch.Tensor:
            c = read_cursor()
            return _layer_step(mod, x, rings, c["pos"], c["n"], H, D, cross)
        return stage

    def heads(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        n_valid = read_cursor()["n"]
        x1, x2 = x[:, :1], x[:, 1:]  # (S, 1, D) each
        cb = net.ar.combinator  # the combinator, its products on torch.matmul like _layer_step's
        combined = (F.gelu(layer_norm(x1 @ cb.h0_a.w.T, cb.ln.w, cb.ln.b))
                    + F.gelu(layer_norm(x2 @ cb.h0_b.w.T, cb.ln.w, cb.ln.b)))
        va = net.va_classifier
        v1 = x1 @ va.w.T + va.b
        v2 = x2 @ va.w.T + va.b
        logits = combined @ net.vap_head.w.T + net.vap_head.b
        probs = torch.softmax(logits.float(), dim=-1)
        state["steps"].add_(1)
        state["n"].copy_(n_valid)
        return {
            "p_now": probs_next_speaker_aggregate(probs, 0, 1)[:, 0],
            "p_future": probs_next_speaker_aggregate(probs, 2, 3)[:, 0],
            "vad": torch.sigmoid(torch.cat([v1, v2], dim=-1))[:, 0],
            "H": entropy_bits(probs)[:, 0],
            "logits": logits[:, 0],
        }

    layers = [(m, r, False) for m, r in zip(net.ar_channel.layers, state["ar_channel"])]
    layers += [(m, r, True) for m, r in zip(net.ar.layers, state["ar"])]
    return [("kv.layer", layer(m, r, cross)) for m, r, cross in layers] + [("kv.heads", heads)]


def _run_stages(stages: Sequence[Tuple[Optional[str], Callable]], x):
    """The stages in order, each under its span (none for a None name)."""
    for name, stage in stages:
        if name is None:
            x = stage(x)
        else:
            with span(name):
                x = stage(x)
    return x


def _frame_step(
    net: VapNet, state: State, feats: torch.Tensor, conf: VapConfig, graphs: Optional[_Graphs] = None
) -> Dict[str, torch.Tensor]:
    """Advance every ring by one frame, feats (S, 2, D); updates ``state``
    in place and returns the frame's outputs, (S, ...) a key (JAX
    :209-255). With ``graphs`` (on the card) the frame replays the graphs
    bound to ``state``, captured here on its first steady frame; its
    outputs are then the graphs' buffers, which the next frame rewrites."""
    if graphs is None:
        out = _run_stages(_frame_stages(net, state, conf), feats)
    else:
        out = graphs.run("frame", (net, state), lambda: _frame_stages(net, state, conf), feats,
                         capture=state["frames"] > 0)
    state["frames"] += 1
    return out


def _kv_push(
    net: VapNet, state: State, new_feats: torch.Tensor, conf: VapConfig, graphs: Optional[_Graphs] = None
) -> Dict[str, torch.Tensor]:
    """``_frame_step`` over (S, 2, n_new, C) new frames, in order; outputs
    stacked (n_new, S, ...), each frame's copied out before the next one
    runs (JAX :258-270)."""
    n_new = new_feats.shape[2]
    outs: Dict[str, torch.Tensor] = {}
    for t in range(n_new):
        o = _frame_step(net, state, new_feats[:, :, t], conf, graphs)
        for k, v in o.items():
            if k not in outs:
                outs[k] = v.new_empty((n_new, *v.shape))
            outs[k][t].copy_(v)
    if outs:
        return outs
    S = new_feats.shape[0]
    trail = {"p_now": (2,), "p_future": (2,), "vad": (2,), "H": (), "logits": (conf.head_dim,)}
    return {k: torch.zeros(0, S, *shape, device=new_feats.device) for k, shape in trail.items()}


class _Captured:
    """Stages captured in order as CUDA graphs, one a stage, each reading
    what the one before it left (the first reads ``x``, a buffer of the
    caller's), into ``pool``. ``replay`` copies its input into ``x`` unless
    it is ``x``'s memory, then launches the graphs, each under its span,
    and returns the last stage's buffers. A capture launches nothing: its
    launches are taken back from the launch ledger (``ops/_build.py``), and
    each replay adds them, so the ledger counts the launches the card runs
    (a profile names them: ``chip_smoke.py`` phase 15 (d),
    ``tests/test_torch_kv_graph.py``)."""

    def __init__(self, stages: Sequence[Tuple[Optional[str], Callable]], x: torch.Tensor, pool):
        self.x = x
        self.graphs = []
        with suspended():  # a capture records no event
            for name, stage in stages:
                before = _build.launch_counts()
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    x = stage(x)
                finally:
                    g.capture_end()
                ran = _build.launches_since(before)
                _build.add_launches(ran, -1)
                self.graphs.append((name, g, {op: row for op, row in ran.items() if any(row.values())}))
        self.out = x

    def replay(self, x: torch.Tensor):
        if x.data_ptr() != self.x.data_ptr() or x.stride() != self.x.stride():
            self.x.copy_(x)
        for name, g, launches in self.graphs:
            if name is None:
                g.replay()
            else:
                with span(name):
                    g.replay()
            _build.add_launches(launches)
        return self.out


class _Graphs:
    """A streamer's CUDA graphs on the card: for each part (``frame``,
    ``encoder``) the stages captured against the objects they were bound
    to (``key``, compared by identity), in one memory pool, on a capture
    stream of their own. ``captures`` and ``replays`` count graph sets."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.bound: Dict[str, Tuple[tuple, _Captured]] = {}
        self.captures = 0
        self.replays = 0

    def key(self, part: str) -> Optional[tuple]:
        got = self.bound.get(part)
        return got[0] if got else None

    def run(self, part: str, key: tuple, stages: Callable[[], Sequence], x: torch.Tensor, capture: bool,
            static: Optional[torch.Tensor] = None):
        """``part``'s stages on ``x``: replayed where they were captured
        against ``key`` at x's shape; else, where ``capture``, run eagerly
        on the capture stream and captured against ``static`` (a buffer of
        x's shape that outlives the graphs; a new one by default); else run
        eagerly."""
        got = self.bound.get(part)
        if got is not None and got[1].x.shape == x.shape and all(a is b for a, b in zip(got[0], key)):
            self.replays += 1
            return got[1].replay(x)
        if not capture:
            return _run_stages(stages(), x)
        self.bound.pop(part, None)
        static = torch.empty_like(x, memory_format=torch.contiguous_format) if static is None else static
        here = torch.cuda.current_stream()
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = _run_stages(stages(), x)  # this call's result; warms the capture stream up
            self.bound[part] = (key, _Captured(stages(), static, self.pool))
        here.wait_stream(self.stream)
        for t in out.values() if isinstance(out, dict) else (out,):
            t.record_stream(here)
        self.captures += 1
        return out


class _Staging:
    """A hop's host audio on its way into ``dest`` (float32) on the card:
    two pinned buffers used in turn, each copied without blocking the host;
    a buffer is rewritten only once its previous copy has finished. The
    host's copy into a pinned buffer is numpy's, on the calling thread:
    torch's CPU copy wakes its thread pool, whose workers, asleep while the
    host waits for the card, now and then take milliseconds to start."""

    def __init__(self, dest: torch.Tensor):
        self.dest = dest
        self.host = [torch.empty(dest.shape, dtype=dest.dtype, pin_memory=True) for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]  # waiting on one never recorded returns at once
        self.turn = 0

    def put(self, chunk) -> torch.Tensor:
        if isinstance(chunk, torch.Tensor):
            if chunk.is_cuda and chunk.shape == self.dest.shape:
                return self.dest.copy_(chunk)
            chunk = chunk.detach().cpu().to(self.dest.dtype).numpy()  # numpy has no bfloat16
        src = np.asarray(chunk)
        if src.shape != tuple(self.dest.shape):  # the caller's shape check raises
            return torch.as_tensor(src, dtype=self.dest.dtype, device=self.dest.device)
        i, self.turn = self.turn, self.turn ^ 1
        self.copied[i].synchronize()
        np.copyto(self.host[i].numpy(), src, casting="unsafe")
        self.dest.copy_(self.host[i], non_blocking=True)
        self.copied[i].record()
        return self.dest


def _encode(graphs: Optional[_Graphs], enc: ExactStreamingEncoder, x: torch.Tensor) -> torch.Tensor:
    """The exact encoder on a hop x (B, n), the streamer's input buffer on
    its device: the prime pass eagerly, a steady pass from the graph bound
    to ``enc`` and its state, captured against x's memory."""
    if graphs is None or not enc.primed:
        return enc.push(x)

    def steady(chunk: torch.Tensor) -> torch.Tensor:
        return advance(enc.enc, chunk[..., None], enc.state, False)

    y = graphs.run("encoder", (enc, enc.state), lambda: [(None, steady)], x, capture=True, static=x)
    enc.frames_emitted += y.shape[1]
    return y


def _chunk_on(chunk, device, staging: Optional[_Staging] = None) -> torch.Tensor:
    """A hop's audio as float32 on the streamer's device: on the card
    through ``staging`` into the streamer's input buffer."""
    with span("kv.h2d"):
        count_h2d(chunk)
        if staging is not None:
            return staging.put(chunk)
        return torch.as_tensor(chunk, dtype=torch.float32, device=device)


def _on_card(device, hop_shape: tuple) -> Tuple[Optional[_Graphs], Optional[_Staging]]:
    """A streamer's graphs and its input's staging on a CUDA device; none
    on the CPU."""
    if torch.device(device).type != "cuda":
        return None, None
    return _Graphs(device), _Staging(torch.zeros(hop_shape, dtype=torch.float32, device=device))


def _bound_state(graphs: Optional[_Graphs], conf: VapConfig, context_frames: int, streams: int, device) -> State:
    """A zeroed K/V state: the one the frame's graphs are bound to, zeroed
    in place, or a new one."""
    key = graphs.key("frame") if graphs is not None else None
    if key is not None:
        _zero_kv_state(key[1])
        return key[1]
    return init_kv_state(conf, context_frames, streams, device=device)


def _bound_encoder(graphs: Optional[_Graphs], encoder, batch: int) -> ExactStreamingEncoder:
    """A reset exact encoder: the one the encoder's graph is bound to, its
    state zeroed in place, or a new one."""
    key = graphs.key("encoder") if graphs is not None else None
    if key is not None:
        key[0].reset()
        return key[0]
    return ExactStreamingEncoder(encoder, batch=batch)


class KVStreamingVap:
    """Incremental stereo VAP with K/V caches, one dialog.

        s = KVStreamingVap(model, context_time=20.0)
        s.reset()
        out = s.push(chunk)    # chunk: (2, hop_frames * 320) float32
        out["p_now"]           # (n_new, 2): one row per NEW frame

    Unlike ``StreamingVap`` the outputs cover the new frames only, and before
    the context fills they equal the batch forward on the true prefix (no
    silence before the dialog). On the card the frames (and the exact
    encoder's steady passes) replay CUDA graphs; the outputs are the
    caller's, never rewritten by a later push."""

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
        self._graphs, self._staging = _on_card(self.device, (2, self.hop_samples))

    @torch.inference_mode()
    def reset(self) -> None:
        if self.encoder_mode == "exact":
            self._enc = _bound_encoder(self._graphs, self.net.encoder, 2)
        else:
            self._enc_state = init_encoder_state(self.net.encoder, batch=2)
        self.state = _bound_state(self._graphs, self.conf, self.context_frames, 1, self.device)
        self.frames_seen = 0

    @torch.inference_mode()
    def push(self, chunk) -> Dict[str, torch.Tensor]:
        if self.state is None:
            self.reset()
        with span("kv.push"):
            chunk = _chunk_on(chunk, self.device, self._staging)
            if tuple(chunk.shape) != (2, self.hop_samples):
                raise ValueError(f"expected (2, {self.hop_samples}), got {tuple(chunk.shape)}")
            with span("kv.encoder"):
                if self.encoder_mode == "exact":
                    new_feats = _encode(self._graphs, self._enc, chunk)
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
        out = _kv_push(self.net, self.state, new_feats[None], self.conf, self._graphs)
        self.frames_seen += new_feats.shape[1]
        return {k: v[:, 0] for k, v in out.items()}  # drop the stream axis


class BatchedKVStreamer:
    """S dialogs advanced one hop per push (the serving shape).

    The streams hop in lockstep (they share the write cursor). A slot is
    recycled for a new dialog with ``reset_stream(i)``. Waveform pushes run
    the exact streaming encoder over a (2S)-row batch: on the card one K3
    launch at R = 2S a hop. On the card a tick replays CUDA graphs: the
    encoder's steady pass, each layer and the heads.

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
        self._graphs, self._staging = _on_card(self.device, (streams, 2, self.hop_samples))

    @torch.inference_mode()
    def reset(self) -> None:
        """Every stream fresh. On the card the state and the encoder the
        graphs were captured against are zeroed in place and kept, so the
        graphs replay without a new capture."""
        self._enc = _bound_encoder(self._graphs, self.net.encoder, 2 * self.streams)
        self.state = _bound_state(self._graphs, self.conf, self.context_frames, self.streams, self.device)

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
            chunks = _chunk_on(chunks, self.device, self._staging)
            S = self.streams
            if tuple(chunks.shape) != (S, 2, self.hop_samples):
                raise ValueError(f"expected ({S}, 2, {self.hop_samples}), got {tuple(chunks.shape)}")
            with span("kv.encoder"):
                feats = _encode(self._graphs, self._enc, chunks.reshape(2 * S, self.hop_samples))
            return self.push_features(feats.reshape(S, 2, *feats.shape[1:]))

    @torch.inference_mode()
    def push_features(self, new_feats) -> Dict[str, torch.Tensor]:
        """(S, 2, n, C) features -> outputs (n, S, ...) a key."""
        if self.state is None:
            self.reset()
        new_feats = torch.as_tensor(new_feats, dtype=torch.float32, device=self.device)
        return _kv_push(self.net, self.state, new_feats, self.conf, self._graphs)

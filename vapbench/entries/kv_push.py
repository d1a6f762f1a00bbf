"""Streaming: ``BatchedKVStreamer.push`` advancing S live dialogs one hop
a tick, the serving shape of a spoken-dialogue server. Each tick's chunks
arrive as a host array (S, 2, hop samples) and its ``p_now``,
``p_future`` and ``vad`` go back to the host, as a stream server's tick
sends them. A tick's time runs from the push to its outputs on the host.
The dialogs start fresh at the window's start; a dialog's audio repeats
the pool's ``pool_ticks`` hops.

The comparison: for ``check_streams`` dialogs drawn from the seed, every
tick's outputs against the plain reference over the dialog's audio: the
encoder over the whole of it, each layer attending to its last
``context_seconds`` of frames."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from vapbench import harness, traffic
from vapbench.counts import flops
from vapbench.entries import common
from vapbench.reference import vap as ref

KEYS = ("p_now", "p_future", "vad")
LOOKAHEAD_HOPS = 4  # audio past the last tick the reference's encoder sees


@dataclass
class State:
    ctx: harness.Context
    conf: object
    streamer: Optional[object]
    weights: Dict[str, torch.Tensor]
    pool: np.ndarray  # (P, S, 2, hop) float32 on the host
    picks: np.ndarray
    tick: int = 0
    kept: List[Dict[str, np.ndarray]] = field(default_factory=list)
    failed: int = 0


def setup(ctx):
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    t = ctx.traffic
    conf, net, w = common.vap_model(ctx)
    model = VapModel.over_net(net.eval(), conf)
    streamer = BatchedKVStreamer(model, streams=t["streams"], context_time=t["context_seconds"], hop_frames=1)
    gen = traffic.generator(ctx.device, ctx.word(common.STREAM_INPUTS))
    audio = traffic.dialogs(gen, t["streams"], t["pool_ticks"], t, ctx.device)[0]
    pool = audio.reshape(t["streams"], 2, t["pool_ticks"], traffic.FRAME).permute(2, 0, 1, 3).contiguous()
    rng = np.random.default_rng(ctx.word(3))
    picks = np.sort(rng.choice(t["streams"], size=t["check_streams"], replace=False))
    st = State(ctx, conf, streamer, w, pool.cpu().numpy(), picks)
    ctx.note("inputs")
    for _ in range(t["warmup_ticks"]):  # every shape of a tick; then fresh dialogs
        call(st)
    ctx.note("warm-up ticks")
    streamer.state = None
    streamer._enc = None
    common.free_device()
    streamer.reset()
    st.tick, st.kept, st.failed = 0, [], 0
    return st


def call(st: State) -> None:
    out = st.streamer.push(st.pool[st.tick % len(st.pool)])
    host = {k: out[k][0].cpu().numpy() for k in KEYS}
    st.failed += int(not all(np.isfinite(v).all() for v in host.values()))
    st.kept.append({k: v[st.picks] for k, v in host.items()})
    st.tick += 1


def finish(st: State) -> None:
    pass


def end_to_end(st: State, window: Dict) -> Dict[str, float]:
    return {"tick_p95_ms": 1e3 * float(np.percentile(window["call_s"], 95))}


def counts(st: State) -> Dict:
    t, c = st.ctx.traffic, st.conf
    n_weights = sum(v.numel() for v in st.weights.values())
    context = int(t["context_seconds"] * c.frame_hz)
    return {"call": flops.kv_tick(t["streams"], context, c.dim, c.num_heads, c.channel_layers, c.cross_layers,
                                  c.n_classes, traffic.FRAME, n_weights)}


def stages(st: State) -> Dict:
    return {}


def release(st: State) -> None:
    st.streamer = None
    common.free_device()


def dialog_audio(st: State, ticks: int) -> torch.Tensor:
    """(picks, 2, ticks * hop): the sampled dialogs' audio as pushed."""
    idx = np.arange(ticks) % len(st.pool)
    chunks = st.pool[idx][:, st.picks]  # (ticks, picks, 2, hop)
    return torch.from_numpy(np.ascontiguousarray(chunks.transpose(1, 2, 0, 3))).reshape(len(st.picks), 2, -1)


def reference(st: State, ticks: int) -> Dict[str, np.ndarray]:
    c, t = st.conf, st.ctx.traffic
    wave = dialog_audio(st, ticks + LOOKAHEAD_HOPS).to(st.ctx.device)
    out = ref.stream_outputs(st.weights, wave, ticks, c.num_heads, int(t["context_seconds"] * c.frame_hz))
    return {k: v.transpose(0, 1).cpu().numpy() for k, v in out.items()}  # (ticks, picks, 2)


def check(st: State, control: bool = False) -> List[tuple]:
    """Max abs gap of p_now / p_future and of vad over every tick of the
    sampled dialogs."""
    ticks = len(st.kept)
    with harness.tf32(False):
        want = reference(st, ticks)
    if control:
        with harness.tf32(True):
            got = reference(st, ticks)
    else:
        got = {k: np.stack([o[k] for o in st.kept]) for k in KEYS}
    limits = st.ctx.workload["checks"]
    gap_p = common.max_abs([(got["p_now"], want["p_now"]), (got["p_future"], want["p_future"])])
    gap_v = common.max_abs([(got["vad"], want["vad"])])
    return [("p_max_abs", gap_p, limits["p_max_abs"]), ("vad_max_abs", gap_v, limits["vad_max_abs"])]

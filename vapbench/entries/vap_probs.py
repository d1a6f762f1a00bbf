"""Batched inference: ``VapModel.probs`` on B stereo chunks a call, each
call's ``p_now``, ``p_future`` and ``vad`` brought to the host, as
evaluation does. A call's copies to the host run while the next call is
enqueued (two pinned slots); the window's rate counts the calls whose
outputs reached the host.

The comparison: the plain reference's outputs for ``check_batches`` of
the pool's batches, drawn from the seed, against every call of the window
that ran on them."""

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


@dataclass
class State:
    ctx: harness.Context
    conf: object
    net: Optional[torch.nn.Module]
    model: object
    weights: Dict[str, torch.Tensor]
    pool: List[torch.Tensor]
    slots: List[Dict[str, torch.Tensor]]
    i: int = 0
    pending: Optional[tuple] = None
    outputs: List[Dict[str, np.ndarray]] = field(default_factory=list)


def setup(ctx):
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    t = ctx.traffic
    conf, net, w = common.vap_model(ctx)
    net.eval()
    frames = int(t["chunk_seconds"] * conf.frame_hz)
    gen = traffic.generator(ctx.device, ctx.word(common.STREAM_INPUTS))
    pool = [traffic.dialogs(gen, t["batch"], frames, t, ctx.device)[0] for _ in range(t["pool"])]
    pin = ctx.device.type == "cuda"
    shape = (t["batch"], frames, 2)
    slots = [{k: torch.empty(shape, pin_memory=pin) for k in KEYS} for _ in range(2)]
    st = State(ctx, conf, net, VapModel.over_net(net, conf), w, pool, slots)
    for _ in range(2):  # warm-up: the window's one shape
        call(st)
    finish(st)
    st.outputs.clear()
    st.i = 0
    return st


def _collect(st: State) -> None:
    if st.pending is None:
        return
    event, slot = st.pending
    if event is not None:
        event.synchronize()
    st.outputs.append({k: slot[k].numpy().copy() for k in KEYS})
    st.pending = None


def call(st: State) -> None:
    out = st.model.probs(st.pool[st.i % len(st.pool)])
    slot = st.slots[st.i % 2]
    cuda = st.ctx.device.type == "cuda"
    for k in KEYS:
        slot[k].copy_(out[k], non_blocking=cuda)
    event = torch.cuda.Event() if cuda else None
    if event is not None:
        event.record()
    _collect(st)
    st.pending = (event, slot)
    st.i += 1


def finish(st: State) -> None:
    _collect(st)


def end_to_end(st: State, window: Dict) -> Dict[str, float]:
    t = st.ctx.traffic
    audio_s = len(st.outputs) * t["batch"] * t["chunk_seconds"]
    return {"infer_audio_s_per_s": audio_s / window["elapsed_s"]}


def counts(st: State) -> Dict:
    t, c = st.ctx.traffic, st.conf
    n = int(t["chunk_seconds"] * c.sample_rate)
    n_weights = sum(v.numel() for v in st.weights.values())
    return {
        "call": flops.infer_call(t["batch"], n, c.dim, c.channel_layers, c.cross_layers, c.n_classes, n_weights),
        "kernels": {"conv_stack": flops.conv_stack_kernel(2 * t["batch"], n, c.encoder_dim)},
    }


def stages(st: State) -> Dict:
    from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo
    from voiceactivityprojection_tpu_torch.models.vap import encode_audio

    w, net, c = st.pool[0], st.net, st.conf
    with torch.inference_mode():
        x1, x2 = encode_audio(net, w, fused_auto=True, fuse_downsample=True)

    @torch.inference_mode()
    def encoder():
        return encode_audio(net, w, fused_auto=True, fuse_downsample=True)

    @torch.inference_mode()
    def transformer():
        kw = dict(num_heads=c.num_heads, attn_impl=c.attn_impl)
        o1 = apply_gpt(net.ar_channel, x1, **kw)["x"]
        o2 = apply_gpt(net.ar_channel, x2, **kw)["x"]
        return apply_gpt_stereo(net.ar, o1, o2, **kw)

    return {"encoder": encoder, "transformer": transformer}


def release(st: State) -> None:
    st.net = st.model = None
    st.slots = []
    common.free_device()


def check(st: State, control: bool = False) -> List[tuple]:
    """Max abs gap of p_now / p_future and of vad from the reference, over
    every call on the sampled batches."""
    ctx, t = st.ctx, st.ctx.traffic
    rng = np.random.default_rng(ctx.word(3))
    n_pool = min(len(st.pool), max(1, len(st.outputs)))
    picks = sorted(rng.choice(n_pool, size=min(t["check_batches"], n_pool), replace=False).tolist())
    heads = st.conf.num_heads
    gap_p, gap_v = 0.0, 0.0
    for b in picks:
        with harness.tf32(False):
            want = {k: v.cpu().numpy() for k, v in ref.probs(st.weights, st.pool[b], heads).items()}
        if control:
            with harness.tf32(True):
                got = [{k: v.cpu().numpy() for k, v in ref.probs(st.weights, st.pool[b], heads).items()}]
        else:
            got = [o for i, o in enumerate(st.outputs) if i % len(st.pool) == b]
        for o in got:
            gap_p = max(gap_p, common.max_abs([(o["p_now"], want["p_now"]), (o["p_future"], want["p_future"])]))
            gap_v = max(gap_v, common.max_abs([(o["vad"], want["vad"])]))
    limits = ctx.workload["checks"]
    return [("p_max_abs", gap_p, limits["p_max_abs"]), ("vad_max_abs", gap_v, limits["vad_max_abs"])]

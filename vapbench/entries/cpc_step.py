"""CPC pretraining: ``make_cpc_train_step`` on B mono windows a step, 12
predictions against 128 negatives drawn each step by the program from a
CPU generator the benchmark seeds per step, Adam. Losses stay on the
device until the window ends.

Set-up builds the one training state, drives it through its first three
steps with the window's own call on distinct windows, and hands it to the
window. The comparison follows those three steps with the plain
reference: each step's loss, the first gradient as Adam holds it after
step 1 (its first moment over 1 - beta1) and the change of the weights
after step 3, the last two by their worst leaf."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from vapbench import harness, traffic, weights
from vapbench.counts import flops
from vapbench.entries import common
from vapbench.reference import cpc as ref
from vapbench.reference.optim import Adam

FOLLOWED = 3  # steps the reference follows


@dataclass
class State:
    ctx: harness.Context
    model: Dict
    program: Optional[object]
    step_fn: Optional[object]
    w0: Dict[str, torch.Tensor]
    pool: List[torch.Tensor]
    step: int = 0
    losses: List[torch.Tensor] = field(default_factory=list)
    first_grad: Dict[str, torch.Tensor] = field(default_factory=dict)
    change: Dict[str, torch.Tensor] = field(default_factory=dict)
    followed_losses: List[float] = field(default_factory=list)
    failed: int = 0


def _program(ctx, m):
    from voiceactivityprojection_tpu_torch.models.encoder import Encoder
    from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
    from voiceactivityprojection_tpu_torch.train.cpc_pretrain import init_cpc_train_state

    enc = Encoder(m["hiddenEncoder"]).to(ctx.device)
    heads = ParamGroup(W=(m["nPredicts"], m["hiddenGar"], m["hiddenEncoder"])).to(ctx.device)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.word(common.STREAM_WEIGHTS))
    w0 = weights.draw(weights.shapes_of(enc, "encoder.") + weights.shapes_of(heads, "heads."), gen, ctx.device)
    weights.load_into(enc, w0, "encoder.")
    weights.load_into(heads, w0, "heads.")
    state = init_cpc_train_state(enc, heads, learning_rate=m["learningRate"], device=ctx.device)
    names = {id(p): "encoder." + n for n, p in enc.named_parameters()}
    names.update({id(p): "heads." + n for n, p in heads.named_parameters()})
    return state, names, w0


def step_generator(ctx, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s negatives."""
    return torch.Generator().manual_seed(ctx.word(4, step) % 2 ** 63)


def setup(ctx):
    from voiceactivityprojection_tpu_torch.train.cpc_pretrain import make_cpc_train_step

    m, t = ctx.config["model"], ctx.traffic
    program, names, w0 = _program(ctx, m)
    gen = traffic.generator(ctx.device, ctx.word(common.STREAM_INPUTS))
    frames = m["sizeWindow"] // traffic.FRAME
    pool = [traffic.dialogs(gen, t["batch"], frames, t, ctx.device)[0][:, 0].contiguous() for _ in range(t["pool"])]
    ctx.note("weights and inputs")
    st = State(ctx, m, program, make_cpc_train_step(m["nPredicts"], m["negativeSamplingExt"]), w0, pool)
    beta1 = m["beta1"]
    for s in range(FOLLOWED):  # the followed steps are the warm-up
        call(st)
        ctx.sync()
        ctx.note(f"step {s + 1}")
        if s == 0:
            opt = st.program.opt
            st.first_grad = {names[id(p)]: opt.state[p]["exp_avg"].detach() / (1 - beta1)
                             for g in opt.param_groups for p in g["params"] if p in opt.state}
    st.change = {names[id(p)]: p.detach() - w0[names[id(p)]]
                 for g in st.program.opt.param_groups for p in g["params"]}
    ctx.sync()
    st.followed_losses = [float(x) for x in st.losses]
    st.losses.clear()
    return st


def call(st: State) -> None:
    wave = st.pool[st.step % len(st.pool)]
    metrics = st.step_fn(st.program, wave, step_generator(st.ctx, st.step))
    st.losses.append(metrics["cpc_loss"])
    st.step += 1


def finish(st: State) -> None:
    st.ctx.sync()
    if st.losses:
        st.failed = int((~torch.isfinite(torch.stack(st.losses))).sum())


def end_to_end(st: State, window: Dict) -> Dict[str, float]:
    audio_s = window["calls"] * st.ctx.traffic["batch"] * st.model["sizeWindow"] / 16000
    return {"train_audio_s_per_s": audio_s / window["elapsed_s"]}


def counts(st: State) -> Dict:
    m, B = st.model, st.ctx.traffic["batch"]
    n_weights = sum(v.numel() for v in st.w0.values())
    T = ref.encoded_frames(m["sizeWindow"])
    return {
        "call": flops.cpc_step(B, m["sizeWindow"], m["hiddenEncoder"], m["nPredicts"], m["negativeSamplingExt"],
                               n_weights),
        "kernels": {"gru_backward": flops.gru_backward_kernel(B, T, m["hiddenGar"])},
    }


def stages(st: State) -> Dict:
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain

    m, prog = st.model, st.program
    wave = st.pool[0]
    with torch.no_grad():
        z, c = cpc_pretrain.cpc_forward(prog.encoder, wave)
    B, n = wave.shape
    neg = ref.negatives(torch.Generator().manual_seed(st.ctx.word(5) % 2 ** 63), B, n, m["nPredicts"],
                        m["negativeSamplingExt"])
    z, c = z.requires_grad_(), c.requires_grad_()

    def cpc_loss():
        # the loss layer alone: the encoder's outputs stand in for its forward
        real = cpc_pretrain.cpc_forward
        cpc_pretrain.cpc_forward = lambda enc, w: (z, c)
        try:
            loss, _ = cpc_pretrain.cpc_loss(prog.encoder, prog.heads, wave, neg, m["nPredicts"])
        finally:
            cpc_pretrain.cpc_forward = real
        loss.backward()

    return {"cpc_loss": cpc_loss, "optimizer": prog.opt.step}


def release(st: State) -> None:
    st.program = st.step_fn = None
    st.losses = []
    common.free_device()


def reference_steps(st: State, tf32: bool):
    """Losses, first gradient and change after the followed steps, from the
    benchmark's initial weights."""
    m = st.model
    p = {n: v.clone() for n, v in st.w0.items()}
    opt = Adam(m["learningRate"], (m["beta1"], m["beta2"]), m["epsilon"])
    losses, first = [], {}
    with harness.tf32(tf32):
        for s in range(FOLLOWED):
            wave = st.pool[s % len(st.pool)]
            B, n = wave.shape
            neg = ref.negatives(step_generator(st.ctx, s), B, n, m["nPredicts"], m["negativeSamplingExt"])
            leaves = {k: v.requires_grad_() for k, v in p.items()}
            loss = ref.loss(leaves, wave, neg, m["nPredicts"])
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            g = {k: gr for k, gr in zip(leaves, grads) if gr is not None}
            p = {k: v.detach() for k, v in leaves.items()}
            opt.step(p, g)
            losses.append(float(loss.detach()))
            if s == 0:
                first = g
    return losses, first, {k: p[k] - st.w0[k] for k in first}


def check(st: State, control: bool = False) -> List[tuple]:
    losses, first, change = reference_steps(st, tf32=False)
    if control:
        got_losses, got_first, got_change = reference_steps(st, tf32=True)
    else:
        got_losses, got_first, got_change = st.followed_losses, st.first_grad, st.change
    leaves = common.moving_leaves(first)
    limits = st.ctx.workload["checks"]
    for what, prog, want in (("grad", got_first, first), ("update", got_change, change)):
        print(f"worst {what} leaves: {common.worst_leaves(prog, want, leaves)}; median leaf "
              f"{common.leaf_gap(prog, want, leaves, 'median')!r}", file=sys.stderr)
    return [
        ("loss_gap", common.loss_gap(got_losses, losses), limits["loss_gap"]),
        ("grad_gap", common.leaf_gap(got_first, first, leaves), limits["grad_gap"]),
        ("update_gap", common.leaf_gap(got_change, change, leaves, st.ctx.workload["update_leaf"]),
         limits["update_gap"]),
    ]

"""Training turn-taking models: ``make_train_step`` with the pretrained
encoder frozen (the flagship recipe), AdamW at ``OptConfig``'s defaults,
dropout 0.1, B stereo chunks a step with VAD labels from the synthetic
dialogs' activity. A pool of batches sits on the device; each step gets a
CPU generator the benchmark seeds per step, from which the program draws
its dropout. Losses stay on the device until the window ends.

Set-up builds the one training state, drives it through its first three
steps with the window's own call on distinct batches, and hands it to the
window. The comparison follows those three steps with the plain reference,
which replays the dropout from the same per-step seeds: each step's loss,
the first gradient as AdamW holds it after step 1 and the change of the
trained weights after step 3, the last two by their worst leaf."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from vapbench import harness, traffic
from vapbench.counts import flops
from vapbench.entries import common
from vapbench.reference import vap as ref
from vapbench.reference.optim import Adam

FOLLOWED = 3
FROZEN = ("encoder.gEncoder.", "encoder.gAR.")


@dataclass
class State:
    ctx: harness.Context
    conf: object
    net: Optional[torch.nn.Module]
    opt: Optional[torch.optim.Optimizer]
    step_fn: Optional[object]
    w0: Dict[str, torch.Tensor]
    pool: List[Dict[str, torch.Tensor]]
    step: int = 0
    losses: List[torch.Tensor] = field(default_factory=list)
    first_grad: Dict[str, torch.Tensor] = field(default_factory=dict)
    change: Dict[str, torch.Tensor] = field(default_factory=dict)
    followed_losses: List[float] = field(default_factory=list)
    failed: int = 0


def step_generator(ctx, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s dropout."""
    return torch.Generator().manual_seed(ctx.word(4, step) % 2 ** 63)


def setup(ctx):
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.train.step import make_optimizer, make_train_step

    t, o = ctx.traffic, ctx.config["optimizer"]
    conf, net, w0 = common.vap_model(ctx)
    opt = make_optimizer(OptConfig(learning_rate=o["learning_rate"], betas=tuple(o["betas"]),
                                   weight_decay=o["weight_decay"]), net, conf.freeze_encoder)
    gen = traffic.generator(ctx.device, ctx.word(common.STREAM_INPUTS))
    frames = int(t["chunk_seconds"] * conf.frame_hz)
    pool = []
    for _ in range(t["pool"]):
        audio, activity = traffic.dialogs(gen, t["batch"], frames, t, ctx.device, conf.horizon_frames)
        pool.append({"waveform": audio, "vad": activity})
    ctx.note("weights and inputs")
    names = {id(p): n for n, p in net.named_parameters()}
    st = State(ctx, conf, net, opt, make_train_step(conf, opt), w0, pool)
    for s in range(FOLLOWED):  # the followed steps are the warm-up
        call(st)
        ctx.sync()
        ctx.note(f"step {s + 1}")
        if s == 0:
            st.first_grad = {names[id(p)]: opt.state[p]["exp_avg"].detach() / (1 - o["betas"][0])
                             for g in opt.param_groups for p in g["params"] if p in opt.state}
    st.change = {names[id(p)]: p.detach() - w0[names[id(p)]] for g in opt.param_groups for p in g["params"]}
    ctx.sync()
    st.followed_losses = [float(x) for x in st.losses]
    st.losses.clear()
    return st


def call(st: State) -> None:
    batch = st.pool[st.step % len(st.pool)]
    metrics = st.step_fn(st.net, batch, step_generator(st.ctx, st.step))
    st.losses.append(metrics["loss"])
    st.step += 1


def finish(st: State) -> None:
    st.ctx.sync()
    if st.losses:
        st.failed = int((~torch.isfinite(torch.stack(st.losses))).sum())


def end_to_end(st: State, window: Dict) -> Dict[str, float]:
    t = st.ctx.traffic
    return {"train_audio_s_per_s": window["calls"] * t["batch"] * t["chunk_seconds"] / window["elapsed_s"]}


def counts(st: State) -> Dict:
    t, c = st.ctx.traffic, st.conf
    n = int(t["chunk_seconds"] * c.sample_rate)
    n_weights = sum(v.numel() for v in st.w0.values())
    n_trained = sum(v.numel() for k, v in st.w0.items() if not k.startswith(FROZEN))
    t50 = n // 320
    sites = 2 * c.channel_layers + 4 * c.cross_layers
    return {
        "call": flops.train_step(t["batch"], n, c.dim, c.channel_layers, c.cross_layers, n_weights, n_trained),
        "kernels": {"flash_train": flops.flash_train_kernels(t["batch"], c.num_heads, t50, c.dim // c.num_heads,
                                                             sites)},
    }


def stages(st: State) -> Dict:
    return {"optimizer": st.opt.step}


def release(st: State) -> None:
    st.net = st.opt = st.step_fn = None
    st.losses = []
    common.free_device()


def reference_steps(st: State, tf32: bool):
    """Losses, first gradient and change of the trained leaves after the
    followed steps, from the benchmark's initial weights."""
    o, c = st.ctx.config["optimizer"], st.conf
    p = {n: v.clone() for n, v in st.w0.items()}
    trained = [n for n in p if not n.startswith(FROZEN)]
    opt = Adam(o["learning_rate"], tuple(o["betas"]), o["eps"], o["weight_decay"])
    losses, first = [], {}
    with harness.tf32(tf32):
        for s in range(FOLLOWED):
            batch = st.pool[s % len(st.pool)]
            leaves = {k: (v.requires_grad_() if k in trained else v) for k, v in p.items()}
            drop = ref.DropoutReplay(step_generator(st.ctx, s), st.ctx.device, c.dropout)
            loss = ref.train_loss(leaves, batch["waveform"], batch["vad"], c.num_heads, c.bin_frames, drop)
            grads = torch.autograd.grad(loss, [leaves[k] for k in trained])
            g = dict(zip(trained, grads))
            p = {k: v.detach() for k, v in leaves.items()}
            opt.step(p, g)
            losses.append(float(loss.detach()))
            if s == 0:
                first = g
    return losses, first, {k: p[k] - st.w0[k] for k in trained}


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

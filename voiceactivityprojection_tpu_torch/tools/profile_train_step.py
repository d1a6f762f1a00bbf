"""The training step split into stages (JAX: examples/profile_train_step.py),
at the bare step's shape by default: B=16 x 20 s, bfloat16 compute, float32
weights, AdamW, the encoder frozen.

    python -m voiceactivityprojection_tpu_torch.tools.profile_train_step [batch] [--deep] [--unfrozen]
        [--iters 20] [--device cuda|cpu]

Stages:

  aug        the device augmentation alone (channel flip and noise: choice 1)
  fwd        the loss's training forward (dropout on), no gradient
  grad       the loss and its backward
  step       the full augmented train step (``make_train_step_augmented``)

``--deep`` splits it further:

  enc_fwd    the encoder forward alone: frozen, the conv stack kernel (K1)
             and the GRU recurrence (K3) with the plain downsample, no
             backward; unfrozen, the plain conv stack (``VAP_CONV_IMPL``
             routes it)
  labels     the projection-window labels
  tf_fwd     the transformer section (channel GPT twice, stereo GPT, heads,
             losses) from the encoder's features
  tf_grad    tf_fwd and its backward (tf_bwd = tf_grad - tf_fwd)
  attn site  one training attention site (B, 4, T, 64), forward (K6) and
             forward + backward (K7/K8); the model has 14
  opt        the AdamW update alone, over the section's real gradients

``--unfrozen`` profiles the step that trains the encoder: ``--deep`` then
adds ``enc_grad`` (the encoder's forward and backward against a fixed
output cotangent), ``conv_fwd`` / ``conv_grad`` (the conv stack alone) and
``gru_fwd`` / ``gru_grad`` (the GRU alone from the conv features: K3, and
K9 for the backward). Each stage is timed by ``tools/stage_timer.py`` (CUDA
events over ``--iters`` chained calls after a third as many on the card;
the host clock on the CPU) with its kernel launches a call; the summary
adds the step's MFU by ``utils/flops.py``. Weights are the port's seed-0
draw; the stages that train (step, opt) train copies. Runs on the card
unless ``--device cpu`` (without a card the default raises).
``profile_train_step`` returns each stage's record and the summary.
"""

from __future__ import annotations

import argparse
import copy
import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

SR = 16_000
CHUNK_S = 20.0


class _TransformerSection(nn.Module):
    """The step's loss from the encoder's features (x1, x2): the forward
    past the encoder, with the dropout drawn in the full forward's order."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x1, x2, vad, conf: VapConfig, generator: Optional[torch.Generator]):
        from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo
        from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng
        from voiceactivityprojection_tpu_torch.ops.losses import loss_vad
        from voiceactivityprojection_tpu_torch.train.step import vap_loss_for_representation

        net = self.net
        rng = DropoutRng(generator, x1.device) if generator is not None else None
        kw = dict(num_heads=conf.num_heads, dropout=conf.dropout if rng is not None else 0.0, rng=rng,
                  attn_impl=conf.attn_impl)
        o1 = apply_gpt(net.ar_channel, x1, **kw)
        o2 = apply_gpt(net.ar_channel, x2, **kw)
        out = apply_gpt_stereo(net.ar, o1["x"], o2["x"], **kw)
        va = net.va_classifier
        vlog = torch.cat([out["x1"] @ va.w.T + va.b, out["x2"] @ va.w.T + va.b], dim=-1).float()
        logits = (out["x"] @ net.vap_head.w.T + net.vap_head.b).float()
        return vap_loss_for_representation(conf, logits, vad) + loss_vad(vlog, vad)


def _batch(B: int, n_samples: int, vad_frames: int, device: torch.device) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    return {
        "waveform": torch.as_tensor(rng.normal(size=(B, 2, n_samples)).astype(np.float32) * 0.1, device=device),
        "vad": torch.as_tensor((rng.random((B, vad_frames, 2)) < 0.4).astype(np.float32), device=device),
    }


def profile_train_step(batch: int = 16, deep: bool = False, unfrozen: bool = False, iters: int = 20, device="cuda",
                       conf: Optional[VapConfig] = None, n_samples: int = int(CHUNK_S * SR),
                       vad_frames: int = int((CHUNK_S + 2) * 50)) -> Dict:
    """``{"stages": {key: stage_timer record}, "summary": {...}}``; ``conf``
    (default ``VapConfig(dtype="bfloat16")``, frozen unless ``unfrozen``)
    overrides the model."""
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
    from voiceactivityprojection_tpu_torch.models.vap import VapNet
    from voiceactivityprojection_tpu_torch.tools.stage_timer import time_stage
    from voiceactivityprojection_tpu_torch.train.augment import augment_on_device, draw_augment
    from voiceactivityprojection_tpu_torch.train.step import (
        TrainState,
        loss_fn,
        make_optimizer,
        make_train_step_augmented,
    )

    dev = resolve_device(device)
    conf = conf or VapConfig(dtype="bfloat16", freeze_encoder=not unfrozen)
    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=0), conf))
    net.to(dev)
    B = batch
    data = _batch(B, n_samples, vad_frames, dev)
    wu = max(1, iters // 3)
    stages: Dict[str, Dict] = {}

    def timed(key: str, name: str, fn):
        stages[key] = time_stage(name, fn, dev, iters=iters, warmup=wu, width=28)
        return stages[key]["ms"]

    aug_kw = dict(noise_amplitude=0.01, sample_rate=SR, frame_hz=50)
    shape = tuple(data["waveform"].shape)

    def aug():
        draws = draw_augment(torch.Generator().manual_seed(1), 1, shape, do_flip=True, flip_prob=0.5, do_mask=False,
                             mask_prob=0.5, noise_device=dev)
        return augment_on_device(data, draws, 1, **aug_kw)["waveform"]

    def fwd():
        with torch.no_grad():
            return loss_fn(net, data, conf, torch.Generator().manual_seed(1))[0]

    def grad():
        net.zero_grad(set_to_none=True)
        loss = loss_fn(net, data, conf, torch.Generator().manual_seed(1))[0]
        loss.backward()
        return loss.detach()

    step_net = copy.deepcopy(net)
    state = TrainState(step_net, make_optimizer(OptConfig(), step_net, conf.freeze_encoder))
    step = make_train_step_augmented(conf, do_flip=True, flip_prob=0.5, do_mask=False, mask_prob=0.5, **aug_kw)

    def run_step():
        return step(state, data, 1, 1)[1]["loss"]

    t_aug = timed("aug", "augment (noise branch)", aug)
    t_fwd = timed("fwd", "loss forward", fwd)
    t_grad = timed("grad", "loss and backward", grad)
    t_step = timed("step", "full augmented train step", run_step)
    del step_net, state
    summary = {"batch": B, "dtype": conf.dtype, "frozen": conf.freeze_encoder, "backward_ms": t_grad - t_fwd,
               "overhead_ms": t_step - t_grad - t_aug}
    print(f"\n# decomposition (B={B}): backward = grad - fwd = {summary['backward_ms']:.2f} ms; "
          f"optimizer+augment+dispatch overhead = step - grad - aug = {summary['overhead_ms']:.2f} ms", flush=True)
    if deep:
        summary.update(_deep(net, conf, data, dev, timed, t_step=t_step, t_aug=t_aug))
    return {"stages": stages, "summary": summary}


def _deep(net, conf: VapConfig, data, dev, timed, *, t_step: float, t_aug: float) -> Dict:
    """The level-2 split (module docstring); returns the deep summary."""
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder
    from voiceactivityprojection_tpu_torch.models.vap import _compute_params
    from voiceactivityprojection_tpu_torch.ops.codebook import get_labels
    from voiceactivityprojection_tpu_torch.ops.flash_alibi_train import flash_alibi_attention_train
    from voiceactivityprojection_tpu_torch.train.step import make_optimizer
    from voiceactivityprojection_tpu_torch.utils.flops import (
        device_peak_tflops,
        stereo_forward_flops,
        stereo_train_flops,
    )

    print("\n# ---- deep (level-2) decomposition ----")
    cdt = torch.bfloat16 if conf.dtype == "bfloat16" else torch.float32
    B, n = data["waveform"].shape[0], data["waveform"].shape[-1]
    # the encoder in the compute dtype: the cast weights the step's forward computes with
    enc = copy.deepcopy(net.encoder).to(cdt)
    both = data["waveform"].to(cdt).reshape(B * 2, n)

    def enc_fwd():
        with torch.no_grad():
            z = apply_encoder(enc, both, fused_auto=conf.freeze_encoder, fuse_downsample=False)
        return z.reshape(B, 2, *z.shape[1:])

    tag = "frozen, no bwd" if conf.freeze_encoder else "unfrozen, plain"
    t_enc = timed("enc_fwd", f"enc_fwd ({tag})", enc_fwd)
    t_enc_grad = float("nan")
    if not conf.freeze_encoder:
        t_enc_grad = _unfrozen_encoder_split(enc, both, timed)

    t_lab = timed("labels", "labels (projection windows)", lambda: get_labels(data["vad"], conf.bin_frames))

    z = enc_fwd()
    x1, x2 = z[:, 0], z[:, 1]
    section = _TransformerSection(net)

    def tf_loss(generator):
        params = {"net." + k: v for k, v in _compute_params(net, conf).items()}
        return torch.func.functional_call(section, params, (x1, x2, data["vad"], conf, generator))

    def tf_fwd():
        with torch.no_grad():
            return tf_loss(torch.Generator().manual_seed(1))

    def tf_grad():
        net.zero_grad(set_to_none=True)
        loss = tf_loss(torch.Generator().manual_seed(1))
        loss.backward()
        return loss.detach()

    t_tf_fwd = timed("tf_fwd", "tf_fwd (transformer+heads+loss)", tf_fwd)
    t_tf_grad = timed("tf_grad", "tf_grad (fwd+bwd)", tf_grad)

    # one training attention site at the model's shape
    H, T, D = conf.num_heads, x1.shape[1], conf.dim // conf.num_heads
    rngq = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rngq.normal(size=(B, H, T, D)).astype(np.float32) * 0.05, device=dev).to(cdt)
               for _ in range(3))
    slopes = _compute_params(net, conf)["ar_channel.layers.0.mha.m"].detach()
    scale = 1.0 / math.sqrt(conf.dim)  # the full-dim scale (reference modules.py:52)

    def site_fwd():
        with torch.no_grad():
            return flash_alibi_attention_train(q, k, v, slopes, 7, scale, conf.dropout).float().sum()

    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def site_grad():
        out = flash_alibi_attention_train(qg, kg, vg, slopes, 7, scale, conf.dropout).float().sum()
        return torch.autograd.grad(out, (qg, kg, vg))

    t_site_f = timed("attn_site_fwd", f"attn site fwd (B,{H},T,{D})", site_fwd)
    t_site_g = timed("attn_site_grad", "attn site fwd+bwd", site_grad)

    # the optimizer alone, over the section's gradients (zeros elsewhere, as JAX's update sees them)
    tf_grad()
    opt_net = copy.deepcopy(net)  # a copy takes no gradients: set them
    for p, q in zip(net.parameters(), opt_net.parameters()):
        q.grad = torch.zeros_like(q) if p.grad is None else p.grad.clone()
    net.zero_grad(set_to_none=True)
    opt = make_optimizer(OptConfig(), opt_net, conf.freeze_encoder)

    def run_opt():
        opt.step()
        return opt_net.vap_head.b

    t_opt = timed("opt", "optimizer (AdamW update)", run_opt)
    del opt_net, opt

    n_sites = 2 * conf.channel_layers + 4 * conf.cross_layers
    t_tf_bwd = t_tf_grad - t_tf_fwd
    enc_cost = t_enc if conf.freeze_encoder or math.isnan(t_enc_grad) else t_enc_grad
    resid = t_step - t_aug - enc_cost - t_tf_grad - t_opt
    peak = device_peak_tflops(dev) or float("nan")
    st = stereo_forward_flops(n, conf.dim, conf.channel_layers, conf.cross_layers)
    enc_fl = (st["conv_stack"] + st["gru"] + st["downsample"]) * B
    tf_fl = (st["ar_channel"] + st["ar_stereo"] + st["combinator_heads"]) * B
    tr = stereo_train_flops(n, conf.dim, conf.channel_layers, conf.cross_layers, frozen_encoder=conf.freeze_encoder)
    tfs = lambda flops, ms: flops / (ms * 1e-3) / 1e12
    step_tfs = tfs(tr["total"] * B, t_step)
    print(f"\n# deep summary (B={B}):")
    print(f"#   enc_fwd {t_enc:.2f} ms ({tfs(enc_fl, t_enc):.1f} TF/s = {tfs(enc_fl, t_enc) / peak * 100:.0f}% peak)")
    print(f"#   tf_fwd {t_tf_fwd:.2f} ms ({tfs(tf_fl, t_tf_fwd):.1f} TF/s = {tfs(tf_fl, t_tf_fwd) / peak * 100:.0f}% "
          f"peak), tf_bwd {t_tf_bwd:.2f} ms (~2x fwd FLOPs -> {tfs(2 * tf_fl, t_tf_bwd):.1f} TF/s)")
    print(f"#   attn: {n_sites} sites x (fwd {t_site_f:.2f} / bwd {t_site_g - t_site_f:.2f} ms) = "
          f"{n_sites * t_site_f:.1f} fwd / {n_sites * (t_site_g - t_site_f):.1f} bwd ms if serial")
    print(f"#   labels {t_lab:.2f}  opt {t_opt:.2f}  aug {t_aug:.2f} ms")
    enc_name = "enc" if conf.freeze_encoder else "enc_grad"
    print(f"#   step {t_step:.2f} = aug {t_aug:.2f} + {enc_name} {enc_cost:.2f} + tf_grad {t_tf_grad:.2f} + opt "
          f"{t_opt:.2f} + residual {resid:.2f} ms (residual = downsample bwd + launches outside the pieces)")
    print(f"#   step MFU ({'frozen' if conf.freeze_encoder else 'unfrozen'} accounting): "
          f"{tr['total'] * B / 1e9:.1f} GF/step -> {step_tfs:.1f} TF/s = {step_tfs / peak * 100:.1f}% peak",
          flush=True)
    return {"tf_bwd_ms": t_tf_bwd, "attn_sites": n_sites, "residual_ms": resid, "step_tflops": step_tfs,
            "step_peak_pct": step_tfs / peak * 100}


def _unfrozen_encoder_split(enc: nn.Module, both: torch.Tensor, timed) -> float:
    """The unfrozen encoder's forward and backward, and its conv stack and
    GRU pieces, each against a fixed output cotangent; returns enc_grad's
    ms."""
    from voiceactivityprojection_tpu_torch.models.encoder import _conv_stack, apply_encoder
    from voiceactivityprojection_tpu_torch.ops.gru import gru

    params = [p for p in enc.parameters()]
    g = enc.gAR
    rng = np.random.default_rng(2)
    with torch.no_grad():
        z_shape = apply_encoder(enc, both, fused_auto=False, fuse_downsample=False).shape
        feats = _conv_stack(enc, both)
    ct = torch.as_tensor(rng.normal(size=tuple(z_shape)).astype(np.float32), device=both.device)
    ct_c = torch.as_tensor(rng.normal(size=tuple(feats.shape)).astype(np.float32), device=both.device)

    def enc_grad():
        loss = (apply_encoder(enc, both, fused_auto=False, fuse_downsample=False).float() * ct).sum()
        return torch.autograd.grad(loss, params)

    def conv_fwd():
        with torch.no_grad():
            return _conv_stack(enc, both)

    conv_params = list(enc.gEncoder.parameters())

    def conv_grad():
        loss = (_conv_stack(enc, both).float() * ct_c).sum()
        return torch.autograd.grad(loss, conv_params)

    gru_params = [g.w_ih, g.w_hh, g.b_ih, g.b_hh]

    def gru_fwd():
        with torch.no_grad():
            return gru(feats, *gru_params)[0]

    def gru_grad():
        loss = (gru(feats, *gru_params)[0].float() * ct_c).sum()
        return torch.autograd.grad(loss, gru_params)

    t_enc_grad = timed("enc_grad", "enc_grad (fwd+bwd, cotangent)", enc_grad)
    t_conv_fwd = timed("conv_fwd", "conv_fwd (stack only)", conv_fwd)
    t_conv_grad = timed("conv_grad", "conv_grad (fwd+bwd)", conv_grad)
    t_gru_fwd = timed("gru_fwd", "gru_fwd (from conv feats)", gru_fwd)
    t_gru_grad = timed("gru_grad", "gru_grad (fwd+bwd)", gru_grad)
    print(f"#   enc_bwd = enc_grad - enc_fwd; pieces: conv bwd {t_conv_grad - t_conv_fwd:.2f} ms, gru bwd "
          f"{t_gru_grad - t_gru_fwd:.2f} ms", flush=True)
    return t_enc_grad


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the training step split into stages (PyTorch port)")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("--deep", action="store_true")
    ap.add_argument("--unfrozen", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    profile_train_step(args.batch, args.deep, args.unfrozen, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training and eval steps: the multitask loss, AdamW with the frozen CPC
left out, and the plateau learning-rate schedule.

Counterpart of ``voiceactivityprojection_tpu/train/step.py:41-131, 211-307``:

  labels = get_labels(batch["vad"])          # 256-way projection indices
  out    = forward(net, batch["waveform"], conf, generator)
  loss   = CE(logits, labels) + BCE(vad_logits, vad)
  AdamW(lr 3.63e-4, betas (0.9, 0.999), eps 1e-8, weight decay 1e-3 on
  every trained weight, biases and norms too), ReduceLROnPlateau on the
  validation loss.

``torch.optim.AdamW`` makes optax's ``adamw`` update,
``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. The JAX optimizer
masks the frozen leaves with ``set_to_zero``; here they are left out of the
optimizer, and the ALiBi slopes ``m`` are buffers, outside it too. The
step runs eagerly on the device of the weights (the card by default, as
``VapModel``), with the encoder frozen or not. Mono, the augmented step and the training loop come with
later slices.

    net = VapNet(conf); net.load_state_dict(state); net.to("cuda")
    opt = make_optimizer(OptConfig(), net, conf.freeze_encoder)
    step = make_train_step(conf, opt)
    metrics = step(net, {"waveform": w, "vad": vad}, torch.Generator().manual_seed(0))
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.models.vap import _FROZEN, VapNet, forward
from voiceactivityprojection_tpu_torch.ops.codebook import get_labels
from voiceactivityprojection_tpu_torch.ops.losses import loss_vad, loss_vap

Batch = Dict[str, torch.Tensor]


def make_optimizer(opt_conf: OptConfig, net: VapNet, freeze_encoder: bool = True) -> torch.optim.AdamW:
    """AdamW over every parameter but, under ``freeze_encoder``, the
    pretrained CPC (gEncoder conv stack and gAR GRU); the downsample always
    trains (JAX: train/step.py:41-81)."""
    params = [p for name, p in net.named_parameters()
              if not (freeze_encoder and name.startswith(_FROZEN))]
    return torch.optim.AdamW(
        params, lr=opt_conf.learning_rate, betas=tuple(opt_conf.betas), eps=1e-8,
        weight_decay=opt_conf.weight_decay,
    )


def _on(net: VapNet, batch) -> Batch:
    device = next(net.parameters()).device
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_fn(
    net: VapNet, batch: Batch, conf: VapConfig, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multitask loss ``lvap + lvad`` and ``{"vap_loss", "vad_loss"}``
    (JAX: train/step.py:104-115); the discrete representation only."""
    if conf.representation != "discrete":
        raise NotImplementedError(f"representation {conf.representation!r} is not ported yet")
    out = forward(net, batch["waveform"], conf, generator)
    lvap = loss_vap(out["logits"], get_labels(batch["vad"], conf.bin_frames))
    lvad = loss_vad(out["vad"], batch["vad"])
    return lvap + lvad, {"vap_loss": lvap, "vad_loss": lvad}


def make_train_step(conf: VapConfig, opt: torch.optim.Optimizer):
    """Returns ``(net, batch, generator) -> metrics``: loss, gradients and
    one optimizer update, in place on ``net``. ``batch`` holds
    ``waveform`` (B, 2, n) and ``vad`` (B, n/320 + horizon, 2), tensors or
    arrays; ``generator`` is the step's CPU ``torch.Generator``. Metrics
    are tensors on the device (reading them waits for the step)."""

    def train_step(net: VapNet, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = _on(net, batch)
        opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(net, batch, conf, generator)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return train_step


def make_eval_step(conf: VapConfig):
    """Returns ``(net, batch) -> {vap_loss, vad_loss, logits, vad_logits}``,
    the inference forward without gradients (JAX: train/step.py:211-227)."""

    @torch.no_grad()
    def eval_step(net: VapNet, batch) -> Dict[str, torch.Tensor]:
        batch = _on(net, batch)
        out = forward(net, batch["waveform"], conf)
        return {
            "vap_loss": loss_vap(out["logits"], get_labels(batch["vad"], conf.bin_frames)),
            "vad_loss": loss_vad(out["vad"], batch["vad"]),
            "logits": out["logits"],
            "vad_logits": out["vad"],
        }

    return eval_step


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Host-side learning-rate change for the plateau schedule."""
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


class ReduceLROnPlateau:
    """Plateau schedule (torch semantics: factor, patience, min mode),
    stepped once per validation."""

    def __init__(self, factor: float = 0.5, patience: int = 2, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, opt: torch.optim.Optimizer, value: float) -> torch.optim.Optimizer:
        improved = self.best is None or (
            value < self.best if self.mode == "min" else value > self.best
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
            return opt
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return set_learning_rate(opt, get_learning_rate(opt) * self.factor)
        return opt


class EarlyStopping:
    """Early stop after ``patience`` validations without improvement."""

    def __init__(self, patience: int = 10, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        improved = self.best is None or (
            value < self.best if self.mode == "min" else value > self.best
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience

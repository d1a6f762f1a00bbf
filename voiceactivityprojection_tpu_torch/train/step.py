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
``VapModel``), with the encoder frozen or not.

    net = VapNet(conf); net.load_state_dict(state); net.to("cuda")
    opt = make_optimizer(OptConfig(), net, conf.freeze_encoder)
    step = make_train_step(conf, opt)
    metrics = step(net, {"waveform": w, "vad": vad}, torch.Generator().manual_seed(0))

The Trainer's step, ``make_train_step_augmented`` (JAX: step.py:134-174),
adds the device augmentation (``train/augment.py``) and draws all of a
step's randomness from ``step_generators(seed, state.step)``, as JAX folds
the step into its base key: a resumed run replays the straight one. The
mono model's steps (JAX: step.py:177-249) are ``loss_fn_mono``,
``make_train_step_mono`` and ``make_eval_step_mono``.

Data parallelism (JAX: the batch sharded over the mesh's ``"data"`` axis
and XLA's gradient ``psum``): every train step takes a ``layout``
(``parallel/mesh.py`` ``ProcessLayout``), is given this rank's rows of the
global batch, and between ``backward`` and the optimizer's update replaces
the trained gradients by their mean over the data ranks. The losses are
means over the local rows, so that mean is the global batch's gradient when
the shards are equal, which ``shard_batch`` enforces. The returned metrics
are the global batch's, the same on every rank. The dropout masks are placed
by the rank's rows (``ops/dropout.py``) and the augmentation is drawn at the
global batch's shape, each rank keeping its rows. ``net`` is not wrapped in
``DistributedDataParallel``: the forward is a function call on its weights
(``models/vap.py`` ``forward``), which DDP's hooks never see.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.models.vap import _FROZEN, VapNet, forward, forward_mono
from voiceactivityprojection_tpu_torch.train import augment
from voiceactivityprojection_tpu_torch.ops import objective_variants as ov
from voiceactivityprojection_tpu_torch.ops.codebook import get_labels
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutShard
from voiceactivityprojection_tpu_torch.ops.losses import loss_vad, loss_vap
from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout
from voiceactivityprojection_tpu_torch.utils.profiling import count_h2d, span

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
    for v in batch.values():
        count_h2d(v)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _shard(layout: Optional[ProcessLayout], batch: Batch) -> Optional[DropoutShard]:
    return None if layout is None else layout.dropout_shard(len(batch["waveform"]))


def _update(opt: torch.optim.Optimizer, layout: Optional[ProcessLayout]) -> None:
    """The optimizer's update, from gradients averaged over the data ranks."""
    with span("train.optimizer"):
        if layout is not None:
            layout.all_reduce_gradients(p for group in opt.param_groups for p in group["params"])
        opt.step()


def _metrics(loss: torch.Tensor, aux: Dict[str, torch.Tensor], layout: Optional[ProcessLayout]) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
    return metrics if layout is None else layout.mean_metrics(metrics)


def vap_loss_for_representation(conf: VapConfig, logits: torch.Tensor, vad: torch.Tensor) -> torch.Tensor:
    """The VAP term of the config's objective representation (JAX:
    train/step.py:88-101)."""
    if conf.representation == "discrete":
        return loss_vap(logits, get_labels(vad, conf.bin_frames))
    if conf.representation == "independent":
        return ov.loss_vap_independent(logits, ov.get_labels_independent(vad, conf.bin_frames))
    if conf.representation == "comparative":
        return ov.loss_vap_comparative(logits, ov.get_labels_comparative(vad, conf.bin_frames))
    raise ValueError(conf.representation)


def loss_fn(
    net: VapNet, batch: Batch, conf: VapConfig, generator: Optional[torch.Generator] = None,
    shard: Optional[DropoutShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multitask loss ``lvap + lvad`` and ``{"vap_loss", "vad_loss"}``
    (JAX: train/step.py:104-115), the VAP term of the config's
    representation."""
    out = forward(net, batch["waveform"], conf, generator, shard=shard)
    lvap = vap_loss_for_representation(conf, out["logits"], batch["vad"])
    lvad = loss_vad(out["vad"], batch["vad"])
    return lvap + lvad, {"vap_loss": lvap, "vad_loss": lvad}


def make_train_step(conf: VapConfig, opt: torch.optim.Optimizer, layout: Optional[ProcessLayout] = None):
    """Returns ``(net, batch, generator) -> metrics``: loss, gradients and
    one optimizer update, in place on ``net``. ``batch`` holds
    ``waveform`` (B, 2, n) and ``vad`` (B, n/320 + horizon, 2), tensors or
    arrays (under ``layout``, this rank's rows); ``generator`` is the step's
    CPU ``torch.Generator``, the same on every rank. Metrics are tensors on
    the device (reading them waits for the step)."""

    def train_step(net: VapNet, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            batch = _on(net, batch)
            opt.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, aux = loss_fn(net, batch, conf, generator, _shard(layout, batch))
            with span("train.backward"):
                loss.backward()
            _update(opt, layout)
            return _metrics(loss, aux, layout)

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


@dataclasses.dataclass
class TrainState:
    """The weights (trained in place), their optimizer and the number of
    steps taken (JAX: ``TrainState``, step.py:35-38)."""

    net: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def step_generators(seed: int, step: int) -> Tuple[torch.Generator, torch.Generator]:
    """The randomness of train step ``step`` of a run seeded ``seed``: two
    CPU generators, the augmentation's and the forward's dropout, a fixed
    function of the pair as JAX's ``fold_in(key(seed), step)`` then
    ``split``. numpy's ``SeedSequence((seed, step))`` hashes the pair into
    two 32-bit words (a CPU generator keeps only 32 bits of a seed), which
    seed the two generators in that order."""
    words = np.random.SeedSequence((seed, step)).generate_state(2)
    return torch.Generator().manual_seed(int(words[0])), torch.Generator().manual_seed(int(words[1]))


def make_train_step_augmented(
    conf: VapConfig,
    *,
    mono: bool = False,
    do_flip: bool,
    flip_prob: float,
    do_mask: bool,
    mask_prob: float,
    noise_amplitude: float,
    sample_rate: int,
    frame_hz: int,
    pitch_steps: Tuple[int, ...] = (),
    layout: Optional[ProcessLayout] = None,
):
    """Returns ``(state, batch, seed, choice) -> (state, metrics)``: the
    device augmentation of ``choice`` (``Augmentation.plan``), the loss,
    its gradients and one ``state.opt`` update, in place on ``state.net``, with
    every draw from ``step_generators(seed, state.step)`` (JAX:
    step.py:134-174). Metrics are tensors on the device. Under ``layout``
    the batch is this rank's rows and the augmentation is drawn for the
    global batch, of which the rank keeps its rows."""
    lf = loss_fn_mono if mono else loss_fn
    aug_kw = dict(noise_amplitude=noise_amplitude, sample_rate=sample_rate, frame_hz=frame_hz,
                  pitch_steps=pitch_steps)

    def train_step(state: TrainState, batch, seed: int, choice: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            aug_gen, drop_gen = step_generators(seed, state.step)
            batch = _on(state.net, batch)
            shape = tuple(batch["waveform"].shape)
            n_data = 1 if layout is None else layout.n_data
            draws = augment.draw_augment(
                aug_gen, choice, (shape[0] * n_data, *shape[1:]), do_flip=do_flip, flip_prob=flip_prob,
                do_mask=do_mask, mask_prob=mask_prob, noise_device=batch["waveform"].device,
            )
            if layout is not None:
                draws = draws.rows(layout.rows(shape[0] * n_data))
            batch = augment.augment_on_device(batch, draws, choice, **aug_kw)
            state.opt.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, aux = lf(state.net, batch, conf, drop_gen, _shard(layout, batch))
            with span("train.backward"):
                loss.backward()
            _update(state.opt, layout)
            state.step += 1
            return state, _metrics(loss, aux, layout)

    return train_step


def loss_fn_mono(
    net: nn.Module, batch: Batch, conf, generator: Optional[torch.Generator] = None,
    shard: Optional[DropoutShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mono model's loss: the VAP term only, the VAD being an input
    (JAX: step.py:177-196); ``batch["vah"]``, where the loader gives it,
    conditions the forward."""
    labels = get_labels(batch["vad"], conf.bin_frames)
    out = forward_mono(net, batch["waveform"], batch["vad"], conf, va_history=batch.get("vah"),
                       generator=generator, shard=shard)
    lvap = loss_vap(out["logits"], labels)
    return lvap, {"vap_loss": lvap, "vad_loss": torch.zeros((), device=lvap.device)}


def make_train_step_mono(conf, opt: torch.optim.Optimizer, layout: Optional[ProcessLayout] = None):
    """``make_train_step`` for the mono model (JAX: step.py:199-208)."""

    def train_step(net: nn.Module, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            batch = _on(net, batch)
            opt.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, aux = loss_fn_mono(net, batch, conf, generator, _shard(layout, batch))
            with span("train.backward"):
                loss.backward()
            _update(opt, layout)
            return _metrics(loss, aux, layout)

    return train_step


def make_eval_step_mono(conf):
    """``make_eval_step`` for the mono model (JAX: step.py:230-249)."""

    @torch.no_grad()
    def eval_step(net: nn.Module, batch) -> Dict[str, torch.Tensor]:
        batch = _on(net, batch)
        out = forward_mono(net, batch["waveform"], batch["vad"], conf, va_history=batch.get("vah"))
        lvap = loss_vap(out["logits"], get_labels(batch["vad"], conf.bin_frames))
        return {
            "vap_loss": lvap,
            "vad_loss": torch.zeros((), device=lvap.device),
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

"""Self-supervised CPC pretraining of the audio encoder.

Counterpart of ``voiceactivityprojection_tpu/train/cpc_pretrain.py``:
contrastive predictive coding (InfoNCE) over the encoder's conv stack and
GRU, with the CPC_audio defaults (12 predicted steps, 128 negatives, Adam
at 2e-4). For each context vector c_t and step k in 1..K the bilinear head
W_k scores the true future encoding z_{t+k} against negatives drawn
uniformly from the batch's encodings; the loss is the softmax cross
entropy with the positive in slot 0.

The negatives' draw is split out of the loss (``sample_negatives``, from
the step's CPU generator), so the same indices can be handed to both
frameworks. On the card the step runs the plain conv stack (or what
``VAP_CONV_IMPL`` selects) and ``gru``: the recurrence kernel forward and
the GRU backward kernel. The heads' predictions are one einsum on either
device; their scoring (``ops/cpc_infonce.py`` ``infonce``) runs on the
card as the InfoNCE kernel pair K14 (float32, C = 256, K <= 16), which
gathers each context row's negatives from z in L2, and everywhere else
(the CPU, other dtypes or widths) as the plain version
``infonce_reference``, the einsums the JAX package runs. On the card the
encodings' gradient is summed with atomic adds, so its summation order
changes from run to run; the loss and the heads' gradient are the same bit
for bit.

    enc = encoder_from_jax(tree)                   # or a pretrained Encoder
    heads = init_cpc_heads(torch.Generator().manual_seed(0), 12, 256, 256)
    state = init_cpc_train_state(enc, heads)       # on the card by default
    step = make_cpc_train_step(n_predicts=12, n_negatives=128)
    metrics = step(state, waveform, torch.Generator().manual_seed(1))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

from voiceactivityprojection_tpu_torch.models.encoder import Encoder, _conv_stack
from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import CPC_CONV_SPECS
from voiceactivityprojection_tpu_torch.ops.cpc_infonce import infonce
from voiceactivityprojection_tpu_torch.ops.gru import gru
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout
from voiceactivityprojection_tpu_torch.utils.device import resolve_device
from voiceactivityprojection_tpu_torch.utils.profiling import count_h2d, span


def init_cpc_heads(
    generator: torch.Generator, n_predicts: int, ar_dim: int, enc_dim: int
) -> ParamGroup:
    """``W`` (K, ar_dim, enc_dim), normal with scale 1/sqrt(ar_dim) (JAX:
    cpc_pretrain.py:33-40), on the CPU."""
    heads = ParamGroup(W=(n_predicts, ar_dim, enc_dim))
    with torch.no_grad():
        heads.W.copy_(torch.randn(heads.W.shape, generator=generator) / math.sqrt(ar_dim))
    return heads


def encoded_frames(n_samples: int) -> int:
    """Frames at 100 Hz that the conv stack makes of ``n_samples``."""
    n = n_samples
    for k, s, p in CPC_CONV_SPECS:
        n = (n + 2 * p - k) // s + 1
    return n


def cpc_forward(encoder: Encoder, waveform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """waveform (B, n) -> (z (B, T, C) encodings at 100 Hz, c (B, T, C)
    context): the encoder's conv stage (the plain stack unless
    ``VAP_CONV_IMPL`` says otherwise) and the GRU (JAX: cpc_pretrain.py:43-47)."""
    z = _conv_stack(encoder, waveform)
    g = encoder.gAR
    c, _ = gru(z, g.w_ih, g.w_hh, g.b_ih, g.b_hh)
    return z, c


def sample_negatives(
    generator: torch.Generator, batch: int, contexts: int, n_negatives: int, n_encodings: int
) -> torch.Tensor:
    """(B, Tc, N) indices, uniform over the batch's B*T encodings (CPC_audio
    'samespeaker' batches are one speaker's), drawn on the CPU."""
    return torch.randint(0, n_encodings, (batch, contexts, n_negatives), generator=generator)


def cpc_loss(
    encoder: Encoder,
    heads: ParamGroup,
    waveform: torch.Tensor,
    neg_idx: torch.Tensor,
    n_predicts: int = 12,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE over K future steps with negatives ``neg_idx`` (B, Tc, N)
    into the flattened (B*T) encodings, Tc = T - K (JAX:
    cpc_pretrain.py:50-87). The scoring is ``infonce``'s: K14 on the card,
    the plain einsums elsewhere."""
    with span("cpc.encoder"):
        z, c = cpc_forward(encoder, waveform)
    Tc = z.shape[1] - n_predicts
    with span("cpc.negatives_h2d"):
        count_h2d(neg_idx)
        idx = neg_idx.to(z.device)
    with span("cpc.loss"):
        preds = torch.einsum("btc,kcd->kbtd", c[:, :Tc], heads.W)  # (K, B, Tc, C)
        return infonce(z, preds, idx)


def make_cpc_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 2e-4) -> torch.optim.Adam:
    """Adam with the CPC_audio defaults (JAX: cpc_pretrain.py:97-99, optax's
    ``adam`` update)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class CpcTrainState:
    """The encoder and heads (trained in place), their optimizer and the
    number of steps taken (JAX: ``CpcTrainState``, cpc_pretrain.py:90-94)."""

    encoder: Encoder
    heads: ParamGroup
    opt: torch.optim.Optimizer
    step: int = 0


def init_cpc_train_state(
    encoder: Encoder,
    heads: ParamGroup,
    learning_rate: float = 2e-4,
    device: Union[str, torch.device, None] = None,
) -> CpcTrainState:
    """Moves the encoder and heads to ``device`` (the card unless another is
    named) and builds Adam over all their weights. The downsample, which
    CPC never runs, gets no gradient, and Adam skips it (JAX's Adam leaves it
    unchanged on zero gradients)."""
    dev = resolve_device(device)
    encoder.to(dev)
    heads.to(dev)
    opt = make_cpc_optimizer([*encoder.parameters(), *heads.parameters()], learning_rate)
    return CpcTrainState(encoder, heads, opt)


def make_cpc_train_step(n_predicts: int = 12, n_negatives: int = 128, layout: Optional[ProcessLayout] = None):
    """Returns ``(state, waveform, generator) -> metrics``: the loss on
    waveform (B, n), its gradients and one Adam update, in place on the
    state; ``generator`` is the step's CPU ``torch.Generator`` for the
    negatives (JAX: cpc_pretrain.py:111-125). Metrics are tensors on the
    device. Under ``layout`` (``parallel/mesh.py``) the waveform is this
    rank's rows, the gradients are averaged over the data ranks before the
    update and the metrics are the global means; each rank draws its
    negatives from its own rows (one process draws them from the whole
    batch)."""

    def step(state: CpcTrainState, waveform, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            device = state.heads.W.device
            waveform = torch.as_tensor(waveform, device=device)
            B, n = waveform.shape
            T = encoded_frames(n)
            with span("cpc.negatives"):
                neg_idx = sample_negatives(generator, B, T - n_predicts, n_negatives, B * T)
            state.opt.zero_grad(set_to_none=True)
            loss, aux = cpc_loss(state.encoder, state.heads, waveform, neg_idx, n_predicts)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                if layout is not None:
                    layout.all_reduce_gradients(p for group in state.opt.param_groups for p in group["params"])
                state.opt.step()
            state.step += 1
            metrics = {k: v.detach() for k, v in aux.items()}
            return metrics if layout is None else layout.mean_metrics(metrics)

    return step

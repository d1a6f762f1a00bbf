"""Plain float32 PyTorch reference of CPC pretraining (Oord et al. 2018;
CPC_audio, Riviere et al. 2020): the encoder's conv stack and GRU, 12
bilinear prediction heads, InfoNCE against 128 negatives drawn uniformly
from the batch's encodings, Adam.

The negatives are drawn as the cell's traffic states it: one
``torch.randint(0, B * T, (B, T - K, N))`` a step from that step's CPU
generator, which the reference seeds itself.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vapbench.reference import vap

Params = Dict[str, torch.Tensor]


def encoded_frames(n_samples: int) -> int:
    n = n_samples
    for k, s, p in vap.CONV_SPECS:
        n = (n + 2 * p - k) // s + 1
    return n


def negatives(generator: torch.Generator, batch: int, n_samples: int, n_predicts: int, n_negatives: int) -> torch.Tensor:
    T = encoded_frames(n_samples)
    return torch.randint(0, batch * T, (batch, T - n_predicts, n_negatives), generator=generator)


def loss(p: Params, wave: torch.Tensor, neg_idx: torch.Tensor, n_predicts: int) -> torch.Tensor:
    """InfoNCE averaged over the K prediction steps; ``p`` holds the
    encoder's weights under ``encoder.`` and the heads as ``heads.W``
    (K, C, C)."""
    z = vap.conv_stack(p, wave)
    c = vap.gru(p, z)
    B, T, C = z.shape
    Tc = T - n_predicts
    negs = z.reshape(B * T, C)[neg_idx.to(z.device)]
    total = z.new_zeros(())
    for k in range(1, n_predicts + 1):
        pred = c[:, :Tc] @ p["heads.W"][k - 1]
        pos = (pred * z[:, k:Tc + k]).sum(-1, keepdim=True)
        neg = torch.einsum("btc,btnc->btn", pred, negs)
        total = total - F.log_softmax(torch.cat([pos, neg], -1), -1)[..., 0].mean()
    return total / n_predicts

"""Multitask losses: 256-way cross-entropy over projection labels plus the
per-speaker VAD binary cross-entropy.

Counterpart of ``voiceactivityprojection_tpu/ops/losses.py:13-44``: logits
are trimmed to the label length, the VAD to the logits' length.
"""

from __future__ import annotations

import torch


def loss_vap(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """logits (B, T, n_classes), labels (B, N) with N <= T -> cross-entropy
    over the first N frames."""
    if logits.ndim != 3 or labels.ndim != 2:
        raise ValueError(f"expected logits (B, T, C) and labels (B, N), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    n = labels.shape[1]
    logp = torch.log_softmax(logits[:, :n], dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction!r}")


def loss_vad(vad_logits: torch.Tensor, vad: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits, mean over every element."""
    z, y = vad_logits, vad[:, : vad_logits.shape[-2]]
    return (z.clamp_min(0.0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()

"""The other two VAP objective representations: independent and comparative
(JAX: ops/objective_variants.py:29-116).

* independent: each of the 2 x n_bins projection-window bins is its own
  Bernoulli (head width 8, BCE); next-speaker probabilities weight the bin
  probabilities by bin width.
* comparative: one scalar, speaker A's share of the activity in the
  projection window (head width 1, BCE with soft targets); p_now and
  p_future are (p, 1 - p).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from voiceactivityprojection_tpu_torch.ops.codebook import extract_projection_bins

HEAD_DIMS = {"discrete": 256, "independent": 8, "comparative": 1}


def _bce_with_logits(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return z.clamp_min(0.0) - z * y + torch.log1p(torch.exp(-z.abs()))


# ---------------------------------------------------------------- independent --
def get_labels_independent(
    va: torch.Tensor, bin_frames: Sequence[int], threshold_ratio: float = 0.5
) -> torch.Tensor:
    """(B, N, 2) -> (B, N - horizon, 2, n_bins) binary bin labels."""
    return extract_projection_bins(va, bin_frames, threshold_ratio)


def loss_vap_independent(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """logits (B, T, 8) against labels (B, N, 2, n_bins), over the first N
    frames."""
    B, N = labels.shape[:2]
    per = _bce_with_logits(logits[:, :N], labels.reshape(B, N, -1))
    if reduction == "mean":
        return per.mean()
    if reduction == "none":
        return per.mean(-1)
    raise ValueError(reduction)


def probs_independent(
    logits: torch.Tensor, bin_frames: Sequence[int], from_bin: int = 0, to_bin: int = 3
) -> torch.Tensor:
    """(B, T, 8) -> (B, T, 2): each speaker's bin probabilities weighted by
    bin width, normalised over the speakers."""
    n_bins = len(tuple(bin_frames))
    p = torch.sigmoid(logits).reshape(*logits.shape[:-1], 2, n_bins)
    w = torch.as_tensor(list(bin_frames), dtype=p.dtype, device=p.device)[from_bin : to_bin + 1]
    act = (p[..., from_bin : to_bin + 1] * w).sum(-1)
    return act / (act.sum(-1, keepdim=True) + 1e-5)


def get_probs_independent(logits: torch.Tensor, bin_frames: Sequence[int]) -> Dict[str, torch.Tensor]:
    return {
        "p_now": probs_independent(logits, bin_frames, 0, 1),
        "p_future": probs_independent(logits, bin_frames, 2, 3),
        "p_tot": probs_independent(logits, bin_frames, 0, 3),
    }


# ---------------------------------------------------------------- comparative --
def get_labels_comparative(va: torch.Tensor, bin_frames: Sequence[int]) -> torch.Tensor:
    """(B, N, 2) -> (B, N - horizon) soft label: speaker A's share of the
    activity in the projection window, 0.5 where both are silent."""
    horizon = sum(int(b) for b in bin_frames)
    n_labels = va.shape[1] - horizon
    cs = torch.cumsum(va, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    tot = cs[:, 1 + horizon : 1 + horizon + n_labels] - cs[:, 1 : 1 + n_labels]
    a, b = tot[..., 0], tot[..., 1]
    return torch.where(a + b > 0, a / (a + b + 1e-9), torch.full_like(a, 0.5))


def loss_vap_comparative(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """logits (B, T, 1) against soft labels (B, N)."""
    per = _bce_with_logits(logits[:, : labels.shape[1], 0], labels)
    if reduction == "mean":
        return per.mean()
    if reduction == "none":
        return per
    raise ValueError(reduction)


def get_probs_comparative(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    p_a = torch.sigmoid(logits[..., 0])
    p = torch.stack([p_a, 1.0 - p_a], dim=-1)
    return {"p_now": p, "p_future": p, "p_tot": p}

"""VAP label space: binary codebook and next-speaker aggregation.

Counterpart of ``voiceactivityprojection_tpu/ops/codebook.py:107-179``.
Class index bit (c * n_bins + b), LSB first, is (channel c, bin b).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def codebook_matrix(n_bins: int = 4, dtype=np.float32) -> np.ndarray:
    """All (n_classes, 2, n_bins) states as a host-side constant."""
    n_classes = 2 ** (2 * n_bins)
    idx = np.arange(n_classes)
    bits = (idx[:, None] >> np.arange(2 * n_bins)) & 1
    return bits.reshape(n_classes, 2, n_bins).astype(dtype)


def _aggregate_weights(
    from_bin: int,
    to_bin: int,
    n_bins: int = 4,
    bin_frames: Optional[Sequence[int]] = None,
    scale_with_bins: bool = False,
    dtype=np.float32,
) -> np.ndarray:
    """(n_classes, 2) per-state speaker-activity weights."""
    states = codebook_matrix(n_bins, dtype)
    if scale_with_bins:
        if bin_frames is None:
            raise ValueError("scale_with_bins needs bin_frames")
        states = states * np.asarray(bin_frames, dtype=dtype)
    return states[:, :, from_bin : to_bin + 1].sum(-1)


def probs_next_speaker_aggregate(
    probs: torch.Tensor,
    from_bin: int = 0,
    to_bin: int = 3,
    bin_frames: Optional[Sequence[int]] = None,
    scale_with_bins: bool = False,
    n_bins: int = 4,
) -> torch.Tensor:
    """(B, T, n_classes) -> (B, T, 2), normalised with the reference's
    +1e-5 denominator."""
    if probs.ndim != 3:
        raise ValueError(f"expected (B, T, n_classes), got {tuple(probs.shape)}")
    abp = torch.as_tensor(
        _aggregate_weights(from_bin, to_bin, n_bins, bin_frames, scale_with_bins),
        device=probs.device,
    ).to(probs.dtype)
    p_all = probs @ abp
    return p_all / (p_all.sum(-1, keepdim=True) + 1e-5)


def entropy_bits(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy in bits; 0 * log2(0) := 0."""
    pos = probs > 0
    logp = torch.where(pos, torch.log2(torch.where(pos, probs, torch.ones_like(probs))), 0.0)
    return -(probs * logp).sum(dim=dim)

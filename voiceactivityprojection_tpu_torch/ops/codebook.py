"""VAP label space: projection windows, binary codebook, next-speaker
aggregation.

Counterpart of ``voiceactivityprojection_tpu/ops/codebook.py:32-179``.
Class index bit (c * n_bins + b), LSB first, is (channel c, bin b). Labels
come from an exclusive cumulative sum of the VAD along time, so a bin's
activity over ``va[t+1+a : t+1+b]`` is ``cs[t+1+b] - cs[t+1+a]``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _bin_edges(bin_frames: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    edges = []
    start = 0
    for b in bin_frames:
        edges.append((start, start + b))
        start += b
    return tuple(edges)


def extract_projection_bins(
    va: torch.Tensor, bin_frames: Sequence[int], threshold_ratio: float = 0.5
) -> torch.Tensor:
    """(B, N, 2) binary VAD -> (B, N - horizon, 2, n_bins) bins: bin b of
    label frame t is active when the mean of its window of
    ``va[t+1 : t+1+horizon]`` is at least ``threshold_ratio``."""
    bin_frames = tuple(int(b) for b in bin_frames)
    horizon = sum(bin_frames)
    n_labels = va.shape[1] - horizon
    if n_labels <= 0:
        raise ValueError(f"Need more than horizon={horizon} frames, got {va.shape[1]}")
    cs = torch.cumsum(va, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    outs = []
    for a, b in _bin_edges(bin_frames):
        ratio = (cs[:, 1 + b : 1 + b + n_labels] - cs[:, 1 + a : 1 + a + n_labels]) / float(b - a)
        outs.append((ratio >= threshold_ratio).to(va.dtype))
    return torch.stack(outs, dim=-1)


def codebook_encode(proj_bins: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    """(..., 2, n_bins) binary -> (...,) int32 class index (the nearest code
    of a binary input is the input itself: the sum of bit_i * 2^i)."""
    *lead, c, nb = proj_bins.shape
    if c != 2 or nb != n_bins:
        raise ValueError(f"expected (..., 2, {n_bins}), got {tuple(proj_bins.shape)}")
    flat = proj_bins.reshape(*lead, c * nb)
    powers = 2.0 ** torch.arange(c * nb, dtype=flat.dtype, device=flat.device)
    return (flat * powers).sum(-1).to(torch.int32)


def codebook_decode(idx: torch.Tensor, n_bins: int = 4, dtype=torch.float32) -> torch.Tensor:
    """(...,) int -> (..., 2, n_bins) binary states."""
    total = 2 * n_bins
    bits = (idx[..., None] >> torch.arange(total, dtype=idx.dtype, device=idx.device)) & 1
    return bits.reshape(*idx.shape, 2, n_bins).to(dtype)


def get_labels(
    va: torch.Tensor, bin_frames: Sequence[int], threshold_ratio: float = 0.5
) -> torch.Tensor:
    """(B, N, 2) VAD -> (B, N - horizon) int32 labels."""
    bins = extract_projection_bins(va, bin_frames, threshold_ratio)
    return codebook_encode(bins, n_bins=len(tuple(bin_frames)))


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

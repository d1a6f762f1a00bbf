"""Voice-activity algebra (JAX: ops/vad.py).

Two tiers:

* on the device, on torch tensors: dialog states and the model-VAD
  morphology (``vad_fill_silences``, ``vad_omit_spikes``). A frame's run
  length comes from the index of the nearest frame outside its run on
  either side: ``torch.cummax`` of the marked indices along time for the
  previous one (-1 where there is none) and ``cummin`` on the flipped axis
  for the next one (T where there is none), so a run at either edge counts
  its true length. The JAX package takes ``associative_scan(max / min)``.
* on the host, in numpy: run-length encoding, ``vad_list`` <-> one-hot
  frames and the activity-history feature of the mono model.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.utils.units import time_to_frames

VadList = List[List[List[float]]]


# ------------------------------------------------------------ dialog states --
def get_dialog_states(vad: torch.Tensor) -> torch.Tensor:
    """(..., 2) VAD -> (...,) int32 state: 0 only A, 1 silence, 2 both,
    3 only B (``2 vad_B - vad_A + 1``)."""
    return (2 * vad[..., 1] - vad[..., 0]).to(torch.int32) + 1


def get_dialog_states_np(vad: np.ndarray) -> np.ndarray:
    return (2 * vad[..., 1] - vad[..., 0]).astype(np.int64) + 1


# ------------------------------------------------------ run-length encoding --
def find_island_idx_len(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run-length encoding of a 1-D array: (start indices, durations, values)."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D array, got shape {x.shape}")
    n = len(x)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, x
    change = np.nonzero(x[1:] != x[:-1])[0]
    ends = np.concatenate([change, [n - 1]])
    starts = np.concatenate([[0], change + 1]).astype(np.int64)
    durs = ends - starts + 1
    return starts, durs.astype(np.int64), x[ends]


# ------------------------------------------------------------- morphology --
def _prev_active_idx(active: torch.Tensor) -> torch.Tensor:
    """Per frame, the index of the latest frame at or before it where
    ``active`` holds, -1 where there is none; along the last axis."""
    idx = torch.arange(active.shape[-1], device=active.device)
    marked = torch.where(active, idx, torch.full_like(idx, -1))
    return torch.cummax(marked, dim=-1).values


def _next_active_idx(active: torch.Tensor) -> torch.Tensor:
    """Per frame, the index of the first frame at or after it where
    ``active`` holds, T where there is none."""
    T = active.shape[-1]
    idx = torch.arange(T, device=active.device)
    marked = torch.where(active, idx, torch.full_like(idx, T))
    return torch.cummin(marked.flip(-1), dim=-1).values.flip(-1)


def _fill_short_runs(x: torch.Tensor, value: float, max_len: int) -> torch.Tensor:
    """Runs of ``x == value`` along the last axis no longer than ``max_len``
    take the other value."""
    if max_len <= 0:
        return x
    in_run = x == value
    other = ~in_run
    run_len = _next_active_idx(other) - _prev_active_idx(other) - 1
    return torch.where(in_run & (run_len <= max_len), torch.full_like(x, 1.0 - value), x)


def vad_fill_silences(vad: torch.Tensor, max_fill_time: float = 0.02, frame_hz: float = 50) -> torch.Tensor:
    """Silences of at most ``max_fill_time`` filled; vad (..., T, 2) binary
    float (frames by Python ``round``)."""
    x = _fill_short_runs(vad.movedim(-2, -1), value=0.0, max_len=round(max_fill_time * frame_hz))
    return x.movedim(-1, -2)


def vad_omit_spikes(vad: torch.Tensor, max_omit_time: float = 0.02, frame_hz: float = 50) -> torch.Tensor:
    """Activity spikes of at most ``max_omit_time`` removed."""
    x = _fill_short_runs(vad.movedim(-2, -1), value=1.0, max_len=round(max_omit_time * frame_hz))
    return x.movedim(-1, -2)


# ------------------------------------------------- vad_list <-> one-hot --
def add_zero_channel(w: np.ndarray) -> np.ndarray:
    """A silent channel appended as speaker B: (..., 1, n) -> (..., 2, n)."""
    return np.concatenate([w, np.zeros_like(w)], axis=-2)


def vad_list_to_onehot(
    vad_list: VadList,
    duration: float,
    hop_time: float = 0,
    frame_hz: float = 0,
    channel_first: bool = False,
) -> np.ndarray:
    """Per-speaker [start, end] seconds -> (frames, 2) float32 one-hot."""
    if not (hop_time > 0 or frame_hz > 0):
        raise ValueError("give hop_time or frame_hz")
    if frame_hz > 0:
        hop_time = 1 / frame_hz
    vad = np.zeros((time_to_frames(duration, hop_time), 2), dtype=np.float32)
    for ch, ch_vad in enumerate(vad_list):
        for s_t, e_t in ch_vad:
            vad[time_to_frames(s_t, hop_time):time_to_frames(e_t, hop_time), ch] = 1.0
    return vad.T if channel_first else vad


def get_activity_history(vad: np.ndarray, bin_end_frames: Tuple[int, ...]) -> np.ndarray:
    """The mono model's VAD-history feature: for each frame t, speaker 0's
    share of the activity in ``len(bin_end_frames) + 1`` trailing windows
    bounded by the strictly decreasing offsets ``bin_end_frames`` (window 0
    is everything up to t - b0, the last one (t - b_last, t]); 0.5 where a
    window holds no activity. vad (T, 2) -> (T, k + 1) float32."""
    vad = np.asarray(vad, dtype=np.float64)
    if vad.ndim != 2 or vad.shape[1] != 2:
        raise ValueError(f"expected (T, 2), got {vad.shape}")
    b = [int(x) for x in bin_end_frames]
    if not (all(x > 0 for x in b) and all(a > c for a, c in zip(b, b[1:]))):
        raise ValueError(f"bin_end_frames must be positive strictly decreasing, got {b}")
    T = vad.shape[0]
    cs = np.cumsum(vad, axis=0)  # inclusive prefix sums per speaker

    def shifted(offset: int) -> np.ndarray:
        """cs[t - offset], 0 before the start."""
        out = np.zeros_like(cs)
        if offset < T:
            out[offset:] = cs[:-offset]
        return out

    edges = [shifted(x) for x in b] + [cs]  # window right edges, oldest first
    sums = [edges[0]] + [r - l for l, r in zip(edges[:-1], edges[1:])]
    acts = np.stack(sums, axis=1)  # (T, k + 1, 2)
    total = acts.sum(-1)
    ratio = np.where(total > 0, acts[..., 0] / np.maximum(total, 1e-9), 0.5)
    return ratio.astype(np.float32)


def vad_onehot_to_vad_list(
    vad: np.ndarray, frame_hz: int = 50, ipu_thresh_time: float = 0.1
) -> List[VadList]:
    """(B, T, 2) -> per batch row [[[start, end], ...] per speaker], gaps
    shorter than ``ipu_thresh_time`` merged."""
    vad = np.asarray(vad)
    if vad.ndim != 3:
        raise ValueError(f"expected (B, T, 2), got {vad.shape}")
    out: List[VadList] = []
    for b in range(vad.shape[0]):
        vl: VadList = []
        for ch in range(2):
            idx, dur, val = find_island_idx_len(vad[b, :, ch])
            on = val == 1
            merged: List[List[float]] = []
            for s, e in zip(idx[on] / frame_hz, (idx[on] + dur[on]) / frame_hz):
                s, e = round(float(s), 2), round(float(e), 2)
                if merged and s - merged[-1][1] < ipu_thresh_time:
                    merged[-1][1] = e
                else:
                    merged.append([s, e])
            vl.append(merged)
        out.append(vl)
    return out


def get_vad_list_subset(vad_list: VadList, start_time: float, end_time: float) -> VadList:
    """A vad_list clipped to [start_time, end_time], in time relative to
    ``start_time``."""
    duration = end_time - start_time
    subset: VadList = [[], []]
    for ch, segs in enumerate(vad_list):
        for s, e in segs:
            if e < start_time:
                continue
            if s > end_time:
                break
            rs, re = round(s - start_time, 2), round(e - start_time, 2)
            subset[ch].append([max(rs, 0.0), min(re, duration)])
    return subset

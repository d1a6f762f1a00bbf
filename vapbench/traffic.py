"""The one generator of the benchmark's inputs: synthetic dialogs drawn on
the device from a seed, shaped by a cell's traffic parameters.

A dialog is two channels of noise whose loudness follows each speaker's
voice activity: segments of ``segment_frames`` 20 ms frames, each speaker
active in a segment with probability ``p_active``, silent frames at
``silence_gain`` of the speech level ``amplitude``. The activity, at 50 Hz
and ``horizon_frames`` past the audio, is also the training cells' VAD
label. Every draw comes from one ``torch.Generator`` on the device, in a
few large calls.
"""

from __future__ import annotations

from typing import Dict

import torch

SAMPLE_RATE = 16_000
FRAME = 320  # samples of a 50 Hz frame


def dialogs(gen: torch.Generator, batch: int, frames: int, traffic: Dict, device, horizon_frames: int = 0):
    """(audio (batch, 2, frames * 320) float32, activity (batch,
    frames + horizon_frames, 2) float32)."""
    seg = int(traffic["segment_frames"])
    total = frames + horizon_frames
    n_seg = -(-total // seg)
    active = (torch.rand(batch, 2, n_seg, generator=gen, device=device) < traffic["p_active"]).float()
    activity = active.repeat_interleave(seg, dim=2)[:, :, :total]
    gain = traffic["silence_gain"] + (1.0 - traffic["silence_gain"]) * activity[:, :, :frames]
    noise = torch.randn(batch, 2, frames * FRAME, generator=gen, device=device)
    audio = traffic["amplitude"] * noise * gain.repeat_interleave(FRAME, dim=2)
    return audio, activity.transpose(1, 2).contiguous()


def generator(device, word: int) -> torch.Generator:
    """A generator on ``device`` seeded from one 63-bit word."""
    g = torch.Generator(device=device)
    g.manual_seed(int(word))
    return g

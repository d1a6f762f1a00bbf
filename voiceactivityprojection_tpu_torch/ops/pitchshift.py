"""Tempo-preserving pitch shift on the device (phase vocoder + resample),
and the short-time Fourier transform pair it and the frequency mask use.

Counterpart of ``voiceactivityprojection_tpu/ops/pitchshift.py``: STFT ->
phase-vocoder time stretch by rate = 2^(-steps/12) -> inverse STFT ->
windowed-sinc resample back to the original length (the same duration and
tempo, F0 scaled), the algorithm of torchaudio's ``pitch_shift`` that the
reference's training augmentation uses.

``stft`` / ``istft`` have the semantics of ``jax.scipy.signal.stft`` /
``istft`` as the JAX package calls them (scipy's): a periodic Hann window of
``nperseg`` samples, ``nperseg // 2`` zeros on each side (``boundary=
"zeros"``), zeros at the end up to a whole number of hops (``padded``),
the one-sided spectrum scaled by 1 / sum(window) (``"spectrum"``); the
inverse overlap-adds the windowed frames and divides by the overlap-added
squared window where it exceeds 1e-10. They are built on
``torch.fft.rfft`` / ``irfft`` (``torch.stft`` centres with reflect padding
and does not scale, so it is not used).

The phases are float64: the phase accumulated over frames reaches ~1e5
rad, where one float32 step is ~0.01 rad, so JAX's float32 sum carries
rounding that moves its output by up to ~2e-3 on 0.1-rms noise, and with
the order of summation and the last bit of each angle; in float64 the port
is within 1e-6 of an exact computation and the same on every device. The rest is float32 as in JAX, the resample positions
computed as XLA computes ``arange(n) / rate`` (i * (1 / rate) in float32),
since their float32 rounding sets most of the distance from an exact
computation. JAX's FFT gives the DC bin of a frame of -0 samples as -0,
phase pi, and its output then depends on the sign of the silence; here a
signed zero has phase 0 (tests/test_torch_augment.py holds both sides
against a float64 computation and records that divergence).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

N_FFT = 512
HOP = 128
_RESAMPLE_TAPS = 16  # windowed-sinc interpolation taps (8 each side)


def hann(n: int, device=None) -> torch.Tensor:
    """The periodic Hann window sin(pi i / n)^2, i < n, float32."""
    i = np.arange(n, dtype=np.float64)
    return torch.from_numpy(np.sin(np.pi * i / n) ** 2).to(device=device, dtype=torch.float32)


def stft(x: torch.Tensor, nperseg: int, noverlap: int) -> torch.Tensor:
    """x (..., n) float32 -> complex64 (..., nperseg // 2 + 1, frames)."""
    step = nperseg - noverlap
    half = nperseg // 2
    x = torch.nn.functional.pad(x, (half, half))
    nadd = (-(x.shape[-1] - nperseg) % step) % nperseg
    if nadd:
        x = torch.nn.functional.pad(x, (0, nadd))
    win = hann(nperseg, x.device)
    frames = x.unfold(-1, nperseg, step) * win  # (..., frames, nperseg)
    z = torch.fft.rfft(frames, n=nperseg, dim=-1) / win.sum()
    return z.transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, step: int) -> torch.Tensor:
    """(..., frames, length) -> (..., step * (frames - 1) + length)."""
    *lead, n_frames, length = frames.shape
    out_len = step * (n_frames - 1) + length
    flat = frames.reshape(-1, n_frames, length).transpose(1, 2)  # (B, length, frames)
    out = torch.nn.functional.fold(
        flat, output_size=(1, out_len), kernel_size=(1, length), stride=(1, step)
    )
    return out.reshape(*lead, out_len)


def istft(z: torch.Tensor, nperseg: int, noverlap: int) -> torch.Tensor:
    """complex (..., nperseg // 2 + 1, frames) -> float32 (..., step * (frames - 1))."""
    step = nperseg - noverlap
    win = hann(nperseg, z.device)
    xsubs = torch.fft.irfft(z, n=nperseg, dim=-2)[..., :nperseg, :] * win.sum()
    frames = (xsubs * win[:, None]).transpose(-1, -2)  # (..., frames, nperseg)
    x = _overlap_add(frames, step)
    n_frames = z.shape[-1]
    norm = _overlap_add((win * win).expand(n_frames, nperseg), step)
    half = nperseg // 2
    x = x[..., half:-half]
    norm = norm[..., half:-half]
    return x / torch.where(norm > 1e-10, norm, torch.ones_like(norm))


def stretch_steps(n_frames: int, rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output frames' fractional positions ``arange(0, n_frames, rate)``
    as JAX makes them (float32), split into (int64 index, float32 alpha)."""
    t = torch.from_numpy(np.arange(0, n_frames, rate, dtype=np.float32))
    return t.long(), torch.remainder(t, 1.0)


def _angle(z: torch.Tensor) -> torch.Tensor:
    """arg(z) in float64, signed zeros taken as +0 (the phase of a silent
    bin is 0 whatever sign an FFT gives its zeros)."""
    return torch.atan2(z.imag.double() + 0.0, z.real.double() + 0.0)


def read_positions(n: int, rate: float, device=None) -> torch.Tensor:
    """i / rate for i < n in float32 as XLA computes ``arange(n) / rate``:
    i times the float32 reciprocal of the float32 rate."""
    inv_rate = float(np.float32(1.0) / np.float32(rate))
    return torch.arange(n, device=device, dtype=torch.float32) * inv_rate


def _phase_vocoder(spec: torch.Tensor, rate: float, hop: int, n_fft: int) -> torch.Tensor:
    """Time-stretch a complex STFT (..., F, T) by ``rate``: ceil(T / rate)
    output frames, magnitudes interpolated, phases advanced by the wrapped
    instantaneous frequency (torchaudio's ``phase_vocoder``; JAX:
    pitchshift.py:32-63), the phases in float64."""
    F = spec.shape[-2]
    phase_advance = torch.linspace(0.0, math.pi * hop, F, dtype=torch.float64, device=spec.device)[:, None]
    idx0, alphas = stretch_steps(spec.shape[-1], rate)
    idx0, alphas = idx0.to(spec.device), alphas.to(spec.device)

    spec_p = torch.nn.functional.pad(spec, (0, 2))
    spec_0 = spec_p[..., idx0]
    spec_1 = spec_p[..., idx0 + 1]

    phase = _angle(spec_1) - _angle(spec_0) - phase_advance
    phase = phase - 2.0 * math.pi * torch.round(phase / (2.0 * math.pi))
    phase = phase + phase_advance
    phase = torch.cat([_angle(spec[..., :1]), phase[..., :-1]], dim=-1)
    phase_acc = torch.cumsum(phase, dim=-1)

    mag = alphas * spec_1.abs() + (1.0 - alphas) * spec_0.abs()
    return torch.complex(mag * torch.cos(phase_acc).float(), mag * torch.sin(phase_acc).float())


def _sinc_resample_positions(y: torch.Tensor, positions: torch.Tensor, taps: int = _RESAMPLE_TAPS) -> torch.Tensor:
    """y (..., L) at fractional sample ``positions`` (n,) by Hann-windowed
    sinc interpolation over ``taps`` neighbours (JAX: pitchshift.py:66-80).
    The gather holds (..., n, taps) float32."""
    L = y.shape[-1]
    base = torch.floor(positions)
    frac = positions - base
    k = torch.arange(-(taps // 2 - 1), taps // 2 + 1, device=y.device)
    idx = (base.long()[:, None] + k[None, :]).clamp(0, L - 1)
    x = k[None, :].float() - frac[:, None]
    window = 0.5 * (1.0 + torch.cos(math.pi * x / (taps // 2)))
    window = torch.where(x.abs() <= taps // 2, window, torch.zeros_like(window))
    w = torch.sinc(x) * window
    w = w / w.sum(-1, keepdim=True)
    return (y[..., idx] * w).sum(-1)


def pitch_shift_semitones(waveform: torch.Tensor, n_steps: int, sample_rate: int = 16_000) -> torch.Tensor:
    """Shift pitch by ``n_steps`` semitones, keeping duration and tempo
    (JAX: pitchshift.py:83-106). waveform (..., n), float32 or bfloat16
    (computed in float32, returned in its dtype)."""
    if n_steps == 0:
        return waveform
    rate = 2.0 ** (-float(n_steps) / 12.0)
    shape = waveform.shape
    n = shape[-1]
    x = waveform.reshape(-1, n).float()

    z = stft(x, N_FFT, N_FFT - HOP)
    y = istft(_phase_vocoder(z, rate, HOP, N_FFT), N_FFT, N_FFT - HOP)

    # output[i] = y(i / rate): the stretched signal read at the shifted rate
    positions = torch.clamp(read_positions(n, rate, x.device), max=y.shape[-1] - 1.0)
    out = _sinc_resample_positions(y, positions)
    return out.reshape(shape).to(waveform.dtype)

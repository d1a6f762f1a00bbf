"""Batch mutations and waveform augmentations of training.

Counterpart of ``voiceactivityprojection_tpu/train/augment.py``: the
stereo channel flip with its VAD (the reference's ``SymmetricSpeakers``),
silencing a channel where its VAD is off, Gaussian noise, a frequency-band
mask and the pitch shift, composed as the reference's ``Augmentation``
composes them (with ``probability``, one of pitch shift, noise, frequency
mask or all three, a quarter each).

Each random function is split in two: a draw from an explicit
``torch.Generator`` (``draw_bits``, ``draw_noise``, ``draw_band``,
``draw_augment``) and a function of the tensors and those draws alone
(``flip_channels``, ``mask_vad_channels``, ``add_gaussian_noise``,
``frequency_mask``, ``augment_on_device``). The flip and mask bits and the
band's width and start come from the step's CPU generator; the noise is
drawn on the waveform's device from a generator seeded from it. Where JAX
draws from a key, the tests hand the JAX draws to the second half.

``Augmentation.plan`` draws from ``np.random.default_rng(seed)`` exactly as
JAX's does. ``pitch_mode="vocoder"`` (the default) shifts pitch on the
device inside the train step (``ops/pitchshift.py``); ``"resample"``
resamples on the host (``ops/audio.resample``: pitch and tempo move
together); ``"psola"`` shifts each channel on the host by TD-PSOLA
(``ops/prosody.shift_pitch``: tempo and VAD alignment kept), inside the
Trainer's batch preparation, before the copy to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.ops.pitchshift import istft, pitch_shift_semitones, stft

Batch = Dict[str, torch.Tensor]


def draw_bits(generator: torch.Generator, prob: float, batch_size: int) -> torch.Tensor:
    """(B,) bool on the CPU, each set with probability ``prob``: which
    samples swap their channels, or have their VAD mask applied."""
    return torch.rand(batch_size, generator=generator) < prob


def flip_channels(batch: Batch, flip: torch.Tensor) -> Batch:
    """Swap the two waveform channels and the two VAD channels of the
    samples where ``flip`` is set (JAX: augment.py:28-40)."""
    f = flip.to(batch["waveform"].device)[:, None, None]
    out = dict(batch)
    out["waveform"] = torch.where(f, batch["waveform"].flip(1), batch["waveform"])
    out["vad"] = torch.where(f, batch["vad"].flip(2), batch["vad"])
    return out


def mask_vad_channels(
    batch: Batch, apply: torch.Tensor, sample_rate: int = 16_000, frame_hz: int = 50, scale: float = 0.0
) -> Batch:
    """In the samples where ``apply`` is set, scale each channel's waveform
    by ``scale`` wherever that channel's VAD is off (JAX: augment.py:43-74).
    ``apply`` is (B,) bool (``draw_bits``)."""
    wf, vad = batch["waveform"], batch["vad"]
    n = wf.shape[-1]
    hop = sample_rate // frame_hz
    active = vad[:, : n // hop].transpose(1, 2).repeat_interleave(hop, dim=-1)
    if active.shape[-1] < n:
        active = torch.nn.functional.pad(active, (0, n - active.shape[-1]), value=1.0)
    masked = torch.where(active > 0, wf, scale * wf)
    out = dict(batch)
    out["waveform"] = torch.where(apply.to(wf.device)[:, None, None], masked, wf)
    return out


def draw_noise(
    generator: torch.Generator, shape: Sequence[int], device: torch.device
) -> torch.Tensor:
    """Standard normal noise of ``shape`` (float32) on ``device``, from a
    generator there seeded from the CPU ``generator``."""
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))
    return torch.randn(tuple(shape), generator=dev_gen, device=device)


def add_gaussian_noise(waveform: torch.Tensor, noise: torch.Tensor, amplitude: float = 0.01) -> torch.Tensor:
    """``waveform + amplitude * noise`` with one rounding, as XLA fuses it
    (JAX: augment.py:77-82)."""
    return torch.add(waveform, noise.to(waveform.device, waveform.dtype), alpha=amplitude)


def draw_band(
    generator: torch.Generator, n_fft: int = 400, max_mask_bins: int = 40
) -> Tuple[int, int]:
    """The masked band: width uniform in [0, max_mask_bins], start uniform
    in [0, max(n_bins - width, 1)), as JAX draws them (augment.py:97-98)."""
    n_bins = n_fft // 2 + 1
    width = int(torch.randint(0, max_mask_bins + 1, (), generator=generator))
    start = int(torch.randint(0, max(n_bins - width, 1), (), generator=generator))
    return width, start


def frequency_mask(
    waveform: torch.Tensor, width: int, start: int, n_fft: int = 400, hop: int = 200
) -> torch.Tensor:
    """STFT, bins [start, start + width) set to zero, inverse STFT, cut or
    zero-padded to the input length (JAX: augment.py:85-107)."""
    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).float()
    z = stft(x, n_fft, n_fft - hop)
    bins = torch.arange(z.shape[-2], device=z.device)
    band = (bins >= start) & (bins < start + width)
    z = torch.where(band[None, :, None], torch.zeros((), dtype=z.dtype, device=z.device), z)
    y = istft(z, n_fft, n_fft - hop)[..., : shape[-1]]
    if y.shape[-1] < shape[-1]:
        y = torch.nn.functional.pad(y, (0, shape[-1] - y.shape[-1]))
    return y.reshape(shape).to(waveform.dtype)


def naive_pitch_shift(waveform: np.ndarray, n_semitones: float) -> np.ndarray:
    """Resample-and-crop pitch shift on the host: pitch and tempo move
    together (JAX: augment.py:110-124)."""
    from voiceactivityprojection_tpu_torch.ops.audio import resample

    factor = 2.0 ** (n_semitones / 12.0)
    sr = 16_000
    y = resample(np.asarray(waveform), int(round(sr * factor)), sr)
    n = waveform.shape[-1]
    if y.shape[-1] < n:
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, n - y.shape[-1])])
    return y[..., :n]


def psola_pitch_shift(waveform: np.ndarray, n_semitones: float) -> np.ndarray:
    """Tempo-preserving pitch shift on the host, channel by channel, by
    TD-PSOLA (JAX: augment.py:127-140): F0 scales by 2^(semitones / 12);
    duration and the VAD frames stay aligned."""
    from voiceactivityprojection_tpu_torch.ops.prosody import shift_pitch

    factor = 2.0 ** (n_semitones / 12.0)
    wf = np.asarray(waveform, dtype=np.float32)
    flat = wf.reshape(-1, wf.shape[-1])
    return np.stack([shift_pitch(ch, factor) for ch in flat]).reshape(wf.shape)


class Augmentation:
    """With ``probability``, one of pitch shift, noise, frequency mask or all
    three (pitch -> mask -> noise), a quarter each (JAX: augment.py:144-240).
    """

    def __init__(
        self,
        noise_amplitude: float = 0.01,
        max_pitch_semitones: int = 2,
        probability: float = 0.5,
        seed: int = 0,
        pitch_mode: str = "vocoder",
    ):
        if pitch_mode not in ("vocoder", "resample", "psola"):
            raise ValueError(f"pitch_mode must be 'vocoder', 'resample' or 'psola', got {pitch_mode!r}")
        self.noise_amplitude = noise_amplitude
        self.max_pitch = max_pitch_semitones
        self.probability = probability
        self.pitch_mode = pitch_mode
        # the device pitch branches: 0 = off, then the semitone steps
        self.pitch_steps = (
            (0,) + tuple(range(1, max_pitch_semitones + 1)) + tuple(range(-1, -max_pitch_semitones - 1, -1))
        )
        self.np_rng = np.random.default_rng(seed)

    def plan(self) -> Tuple[Optional[float], int]:
        """This step's plan from the host generator: (host semitones or
        None, composite choice). ``effect = choice % 4`` in {0 none, 1
        noise, 2 frequency mask, 3 mask then noise}; ``choice // 4`` indexes
        ``pitch_steps`` (vocoder mode). In the resample and psola modes the
        pitch branch returns the semitones to shift on the host instead."""
        if self.np_rng.random() >= self.probability:
            return None, 0
        choice = int(self.np_rng.integers(0, 4))
        semis = None
        pitch_idx = 0
        if choice in (0, 3):
            steps = int(self.np_rng.integers(1, self.max_pitch + 1)) * (1 if self.np_rng.random() < 0.5 else -1)
            if self.pitch_mode == "vocoder":
                pitch_idx = self.pitch_steps.index(steps)
            else:
                semis = float(steps)
        return semis, choice + 4 * pitch_idx

    def apply_pitch_host(self, waveform: np.ndarray, n_semitones: float) -> np.ndarray:
        """The host pitch shift of the psola or resample mode (numpy in and
        out)."""
        shift = psola_pitch_shift if self.pitch_mode == "psola" else naive_pitch_shift
        return np.asarray(shift(np.asarray(waveform), n_semitones), dtype=np.float32)

    def __call__(self, batch: Dict, generator: torch.Generator) -> Dict:
        """One plan applied to ``batch`` outside the train step: the pitch
        branch, then noise and the frequency mask drawn from ``generator``."""
        semis, choice = self.plan()
        pitch_idx, effect = choice // 4, choice % 4
        out = dict(batch)
        w = torch.as_tensor(batch["waveform"])
        if semis is not None:
            w = torch.from_numpy(self.apply_pitch_host(w.cpu().numpy(), semis)).to(w.device)
        elif pitch_idx:
            w = pitch_shift_semitones(w, self.pitch_steps[pitch_idx])
        if effect in (2, 3):
            w = frequency_mask(w, *draw_band(generator))
        if effect in (1, 3):
            w = add_gaussian_noise(w, draw_noise(generator, w.shape, w.device), self.noise_amplitude)
        out["waveform"] = w
        return out


@dataclasses.dataclass
class AugmentDraws:
    """The draws of one step's device augmentation (None where unused)."""

    flip: Optional[torch.Tensor] = None  # (B,) bool
    mask: Optional[torch.Tensor] = None  # (B,) bool
    band: Optional[Tuple[int, int]] = None  # frequency mask (width, start)
    noise: Optional[torch.Tensor] = None  # waveform-shaped, standard normal

    def rows(self, rows: slice) -> "AugmentDraws":
        """The draws of the batch rows ``rows`` (one rank's share of a
        global batch)."""
        pick = lambda t: None if t is None else t[rows]
        return AugmentDraws(pick(self.flip), pick(self.mask), self.band, pick(self.noise))


def draw_augment(
    generator: torch.Generator,
    choice: int,
    waveform_shape: Sequence[int],
    *,
    do_flip: bool,
    flip_prob: float,
    do_mask: bool,
    mask_prob: float,
    noise_device: torch.device,
) -> AugmentDraws:
    """Everything ``augment_on_device`` needs for ``choice``, drawn from the
    step's CPU ``generator`` in a fixed order: flip bits, mask bits, the
    band, the noise (on ``noise_device``)."""
    B = int(waveform_shape[0])
    effect = choice % 4
    return AugmentDraws(
        flip=draw_bits(generator, flip_prob, B) if do_flip else None,
        mask=draw_bits(generator, mask_prob, B) if do_mask else None,
        band=draw_band(generator) if effect in (2, 3) else None,
        noise=draw_noise(generator, waveform_shape, noise_device) if effect in (1, 3) else None,
    )


def augment_on_device(
    batch: Batch,
    draws: AugmentDraws,
    choice: int,
    *,
    noise_amplitude: float,
    sample_rate: int,
    frame_hz: int,
    pitch_steps: Tuple[int, ...] = (),
) -> Batch:
    """Every device-side batch mutation of a train step, on the batch's
    device (JAX: augment.py:243-309): the channel flip, the VAD mask, then
    the composite ``choice``: the pitch shift by ``pitch_steps[choice //
    4]`` (0 none), then ``choice % 4`` in {0 none, 1 noise, 2 frequency
    mask, 3 mask then noise}."""
    if draws.flip is not None:
        batch = flip_channels(batch, draws.flip)
    if draws.mask is not None:
        batch = mask_vad_channels(batch, draws.mask, sample_rate=sample_rate, frame_hz=frame_hz)
    wf = batch["waveform"]
    if len(pitch_steps) > 1 and pitch_steps[choice // 4]:
        wf = pitch_shift_semitones(wf, pitch_steps[choice // 4], sample_rate)
    effect = choice % 4
    if effect in (2, 3):
        wf = frequency_mask(wf, *draws.band)
    if effect in (1, 3):
        wf = add_gaussian_noise(wf, draws.noise, noise_amplitude)
    out = dict(batch)
    out["waveform"] = wf
    return out

"""Audio files and DSP on the host (JAX: ops/audio.py:24-215).

* WAV read by the repo's native decoder (``utils/native.py``) where it is
  built, else by scipy (int16, int32, 24-bit and float PCM, any channel
  count), with a sample-exact ``[start_time, end_time)`` slice;
* polyphase resampling (``resample_poly``, kaiser-windowed sinc), native
  first, then scipy;
* a Whisper-style log-mel spectrogram, for analysis only.

These return numpy arrays, as the JAX package's do. ``load_waveform`` and
``resample`` fill a ``backends`` dict, when given one, with which decoder
and resampler ran (``"native"`` or ``"scipy"``).
"""

from __future__ import annotations

import math
import wave
from typing import Any, Dict, Optional, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.utils import native

SAMPLE_RATE = 16_000
N_MELS = 80
N_FFT = 400
HOP_LENGTH = 320


def get_audio_info(path: str) -> Dict[str, Any]:
    """Duration, rate, frame count, bit depth, channels and encoding."""
    info = native.wav_info(path) if native.available() else None
    if info is not None:
        sr, ch, n, bits = info
        return {"name": path, "duration": n / sr, "sample_rate": sr, "num_frames": n,
                "bits_per_sample": bits, "num_channels": ch, "encoding": "PCM"}
    try:
        with wave.open(path, "rb") as w:
            frames, sr = w.getnframes(), w.getframerate()
            return {"name": path, "duration": frames / sr, "sample_rate": sr, "num_frames": frames,
                    "bits_per_sample": w.getsampwidth() * 8, "num_channels": w.getnchannels(),
                    "encoding": "PCM"}
    except wave.Error:
        # the wave module rejects float WAVs (format tag 3); scipy reads them
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        return {"name": path, "duration": data.shape[0] / sr, "sample_rate": sr,
                "num_frames": int(data.shape[0]), "bits_per_sample": data.dtype.itemsize * 8,
                "num_channels": 1 if data.ndim == 1 else data.shape[1],
                "encoding": "PCM_FLOAT" if data.dtype.kind == "f" else "PCM"}


def _pcm_to_float(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.int16:
        return x.astype(np.float32) / 32768.0
    if x.dtype == np.int32:
        return x.astype(np.float32) / 2147483648.0
    if x.dtype == np.uint8:
        return (x.astype(np.float32) - 128.0) / 128.0
    return x.astype(np.float32)


def load_waveform(
    path: str,
    sample_rate: Optional[int] = 16_000,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    mono: bool = False,
    backends: Optional[Dict[str, Optional[str]]] = None,
) -> Tuple[np.ndarray, int]:
    """(channels, n) float32 in [-1, 1] at ``sample_rate`` (None keeps the
    file's), from ``[start_time, end_time)``, mixed down to one channel
    under ``mono``. Returns the samples and their rate."""
    x = None
    decoder = "scipy"
    info = native.wav_info(path) if native.available() else None
    if info is not None:
        src_sr = info[0]
        start = int(start_time * src_sr) if start_time is not None else 0
        end = int(end_time * src_sr) if end_time is not None else info[2]
        res = native.wav_read(path, start, max(end - start, 0))
        if res is not None:
            (x, sr), decoder = res, "native"
    if x is None:
        from scipy.io import wavfile

        try:
            sr, data = wavfile.read(path, mmap=True)
        except ValueError:
            # 24-bit PCM has a 3-byte container that scipy cannot map
            sr, data = wavfile.read(path)
        if data.ndim == 1:
            data = data[:, None]
        start = int(start_time * sr) if start_time is not None else 0
        end = int(end_time * sr) if end_time is not None else data.shape[0]
        x = _pcm_to_float(np.asarray(data[start:end])).T  # (C, n)

    if mono and x.shape[0] > 1:
        x = x.mean(axis=0, keepdims=True)

    resampler = None
    if sample_rate is not None and sr != sample_rate:
        used: Dict[str, Optional[str]] = {}
        x = resample(x, sr, sample_rate, backends=used)
        resampler = used["resampler"]
        sr = sample_rate
    if backends is not None:
        backends.update(decoder=decoder, resampler=resampler)
    return np.ascontiguousarray(x), sr


def resample(
    x: np.ndarray, orig_freq: int, new_freq: int, backends: Optional[Dict[str, Optional[str]]] = None
) -> np.ndarray:
    """Polyphase FIR resampling along the last axis: the native library
    where it is built, else scipy (the same kaiser(5.0) windowed-sinc
    design)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    up, down = new_freq // g, orig_freq // g
    if native.available():
        shape = x.shape
        y = native.resample_poly(np.asarray(x, dtype=np.float32).reshape(-1, shape[-1]), up, down)
        if y is not None:
            if backends is not None:
                backends["resampler"] = "native"
            return y.reshape(*shape[:-1], y.shape[-1])
    from scipy.signal import resample_poly

    if backends is not None:
        backends["resampler"] = "scipy"
    return resample_poly(x, up, down, axis=-1).astype(np.float32)


def _mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """HTK-style triangular mel filterbank, (n_mels, n_fft // 2 + 1)."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, n_freqs), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def log_mel_spectrogram(
    waveform: np.ndarray,
    n_mels: int = N_MELS,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Whisper-style normalised log-mel: log10 of the mel power clamped at
    1e-10, floored at its maximum - 8, then (x + 4) / 4."""
    x = np.asarray(waveform, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    xp = np.pad(x, [(0, 0), (pad, pad)], mode="reflect")
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = xp[:, idx] * win  # (C, T, n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    spec = spec / (win ** 2).sum()  # a window-normalised STFT
    mel = np.einsum("mf,ctf->cmt", _mel_filterbank(sample_rate, n_fft, n_mels), spec)
    logmel = np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 8.0)
    logmel = (logmel + 4.0) / 4.0
    return logmel[0] if squeeze else logmel


def mono_to_stereo(waveform: np.ndarray) -> np.ndarray:
    """One channel -> that channel and a silent one: (1, n) -> (2, n) and
    (B, 1, n) -> (B, 2, n); anything else comes back as it is."""
    if waveform.ndim == 2 and waveform.shape[0] == 1:
        return np.concatenate([waveform, np.zeros_like(waveform)], axis=0)
    if waveform.ndim == 3 and waveform.shape[1] == 1:
        return np.concatenate([waveform, np.zeros_like(waveform)], axis=1)
    return waveform

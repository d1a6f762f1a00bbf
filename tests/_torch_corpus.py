"""The training tests' corpus: 3 synthetic 7 s stereo dialogs of
alternating tone bursts with their VAD lists and a manifest, as the JAX
package's training tests make it (tests/test_train_loop.py). No JAX."""

import wave

import numpy as np

from voiceactivityprojection_tpu_torch.data.dataset import write_manifest
from voiceactivityprojection_tpu_torch.utils.io import write_json

SR = 16_000


def write_wav(path, data):
    """data: (2, n) float32 in [-1, 1] -> 16-bit stereo WAV."""
    pcm = (np.clip(data.T, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def dialog_corpus(root, n=3, dur=7.0, seed=0):
    """Writes the dialogs under ``root`` and returns the manifest's path."""
    rows = []
    rng = np.random.default_rng(seed)
    for i in range(n):
        samples = int(dur * SR)
        wav = np.zeros((2, samples), dtype=np.float32)
        vl = [[], []]
        t = 0.0
        ch = i % 2
        while t < dur - 1.0:
            end = min(t + rng.uniform(0.8, 2.0), dur)
            s0, s1 = int(t * SR), int(end * SR)
            wav[ch, s0:s1] = 0.1 * np.sin(2 * np.pi * rng.uniform(100, 300) * np.arange(s1 - s0) / SR)
            vl[ch].append([round(t, 2), round(end, 2)])
            t = end + rng.uniform(0.1, 0.6)
            ch = 1 - ch
        wav_path, vad_path = root / f"dialog{i}.wav", root / f"dialog{i}_vad.json"
        write_wav(wav_path, wav)
        write_json(vl, str(vad_path))
        rows.append({"audio_path": str(wav_path), "vad_path": str(vad_path)})
    manifest = root / "manifest.csv"
    write_manifest(rows, str(manifest))
    return str(manifest)

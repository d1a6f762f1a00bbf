"""Two-channel pseudo-dialog sessions stitched from the phrase corpus's TTS
WAVs, for training (JAX: examples/make_phrases_dialog_corpus.py).

    python -m voiceactivityprojection_tpu_torch.tools.make_phrases_dialog_corpus --out DIR
        [--ref ROOT/dataset_phrases] [--n_train 200] [--n_val 24] [--duration 24] [--seed 0]
        [--p_shift 0.55] [--p_overlap 0.25] [--noise_rms 0.003] [--isolate_f0] [--device cuda|cpu]

Each session interleaves whole phrases of two distinct voices on two
channels: a phrase ends at a real end of turn; after it the other speaker
follows (``p_shift``: after a 0.05-1.5 s gap, or in ``p_overlap`` of the
shifts up to 0.5 s before the phrase ends) or the same one continues after
a 0.2-1.2 s pause. Phrases are RMS-normalized and a little Gaussian channel
noise is added. The voices of ``VAL_VOICES`` make the ``val`` split, the
others ``train``; each split gets its WAVs (16-bit stereo at 16 kHz), VAD
lists and a ``<split>.csv`` manifest. ``--isolate_f0`` first neutralizes
every phrase's duration and intensity cues (``ops/prosody.py``
``duration_words_psola``, ``flatten_intensity``), leaving the F0 contour.

The corpus is written on the host with numpy, byte for byte as JAX's
generator writes it from the same seed; ``--device`` is resolved as every
entry point's (the card by default: without one it raises, ``--device
cpu`` runs it anywhere). ``make_corpus`` returns the splits' session
counts and manifests.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import wave
from ast import literal_eval
from typing import Dict, List, Optional

import numpy as np

from voiceactivityprojection_tpu_torch.data.phrases import DEFAULT_PHRASES_ROOT
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

SR = 16_000
VAL_VOICES = ("en-US-Wavenet-F", "en-US-Wavenet-D")  # 1 female, 1 male


def read_phrase_rows(root: str) -> List[Dict]:
    """The corpus CSV's rows (``root`` is its ``dataset_phrases`` folder):
    WAV path, voice, channel-0 VAD segments and word alignments."""
    rows = []
    with open(os.path.join(root, "phrases.csv")) as f:
        for row in csv.DictReader(f):
            path = row["audio_path"]
            rows.append({
                "audio_path": path if os.path.isabs(path) else os.path.join(os.path.dirname(root.rstrip("/")), path),
                "voice": row["tts"],
                "vad": literal_eval(row["vad_list"])[0],
                "starts": literal_eval(row["starts"]),
                "ends": literal_eval(row["ends"]),
            })
    return rows


def isolate_f0_cues(r: Dict) -> None:
    """Every word of the phrase stretched (pitch kept) to the mean word
    duration and the frame energy equalized, in place: the F0 contour is
    the pre-end cue that remains."""
    from voiceactivityprojection_tpu_torch.ops.prosody import duration_words_psola, flatten_intensity

    y, new_segs = duration_words_psola(r["x"], list(zip(r["starts"], r["ends"])), SR)
    r["x"] = flatten_intensity(y, SR)
    r["vad"] = [[round(s, 3), round(e, 3)] for s, e in new_segs]


def load_wav_mono(path: str) -> np.ndarray:
    from voiceactivityprojection_tpu_torch.ops.audio import load_waveform

    x, sr = load_waveform(path, sample_rate=SR)
    assert sr == SR
    return np.asarray(x[0], np.float32)


def make_session(rng, duration, by_voice, voices, target_rms=0.05, p_shift=0.55, p_overlap=0.25,
                 noise_rms=0.003):
    """One (2, n) session and its VAD lists, drawn from ``rng`` in JAX's
    order (examples/make_phrases_dialog_corpus.py:87-146)."""
    n = int(duration * SR)
    wav = np.zeros((2, n), dtype=np.float32)
    vl = [[], []]
    va, vb = rng.choice(len(voices), size=2, replace=False)
    chan_voice = (voices[va], voices[vb])
    t = float(rng.uniform(0.2, 0.6))
    ch = int(rng.random() < 0.5)
    while True:
        cands = by_voice[chan_voice[ch]]
        p = cands[rng.integers(len(cands))]
        x = p["x"]
        rms = float(np.sqrt((x ** 2).mean()) + 1e-8)
        x = x * (target_rms / rms)
        s0 = int(t * SR)
        s1 = s0 + len(x)
        if s1 >= n - int(0.5 * SR):
            break
        wav[ch, s0:s1] += x
        for a, b in p["vad"]:
            vl[ch].append([round(t + a, 3), round(t + b, 3)])
        end = s1 / SR
        if rng.random() < p_shift:  # the other speaker next
            gap = -float(rng.uniform(0.02, 0.5)) if rng.random() < p_overlap else float(rng.uniform(0.05, 1.5))
            ch = 1 - ch
        else:  # the same speaker after a pause
            gap = float(rng.uniform(0.2, 1.2))
        t = end + gap
    if noise_rms:
        wav += rng.normal(0.0, noise_rms, wav.shape).astype(np.float32)
    for c in range(2):
        vl[c].sort()
    return wav, vl


def write_wav(path: str, data: np.ndarray) -> None:
    pcm = (np.clip(data.T, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def make_corpus(ref: str, out: str, n_train: int = 200, n_val: int = 24, duration: float = 24.0, seed: int = 0,
                p_shift: float = 0.55, p_overlap: float = 0.25, noise_rms: float = 0.003,
                isolate_f0: bool = False) -> Dict:
    """Writes the corpus; returns each split's voices, session count and
    manifest path."""
    rows = read_phrase_rows(ref)
    by_voice: Dict[str, List[Dict]] = {}
    for i, r in enumerate(rows):
        r["x"] = load_wav_mono(r["audio_path"])
        if isolate_f0:
            isolate_f0_cues(r)
            if (i + 1) % 30 == 0:
                print(f"  isolate_f0: {i + 1}/{len(rows)} phrases", flush=True)
        by_voice.setdefault(r["voice"], []).append(r)
    all_voices = sorted(by_voice)
    val_voices = [v for v in all_voices if v in VAL_VOICES]
    train_voices = [v for v in all_voices if v not in VAL_VOICES]
    print(f"{len(rows)} phrases, {len(all_voices)} voices ({len(train_voices)} train / {len(val_voices)} val)")

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    report = {"phrases": len(rows)}
    for split, n_sessions, voices in (("train", n_train, train_voices), ("val", n_val, val_voices)):
        man_rows = []
        for i in range(n_sessions):
            wav, vl = make_session(rng, duration, by_voice, voices, p_shift=p_shift, p_overlap=p_overlap,
                                   noise_rms=noise_rms)
            wp = os.path.join(out, f"{split}_{i:04d}.wav")
            vp = os.path.join(out, f"{split}_{i:04d}_vad.json")
            write_wav(wp, wav)
            with open(vp, "w") as f:
                json.dump(vl, f)
            man_rows.append({"audio_path": wp, "vad_path": vp})
        man = os.path.join(out, f"{split}.csv")
        with open(man, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["audio_path", "vad_path"])
            w.writeheader()
            w.writerows(man_rows)
        print(f"{split}: {n_sessions} x {duration:.0f}s -> {man}")
        report[split] = {"voices": voices, "sessions": n_sessions, "manifest": man}
    return report


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="pseudo-dialog sessions from the phrase corpus (PyTorch port)")
    ap.add_argument("--ref", default=os.path.join(DEFAULT_PHRASES_ROOT, "dataset_phrases"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train", type=int, default=200)
    ap.add_argument("--n_val", type=int, default=24)
    ap.add_argument("--duration", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--p_shift", type=float, default=0.55)
    ap.add_argument("--p_overlap", type=float, default=0.25,
                    help="fraction of shifts that are immediate follow-ons (next speaker starts before the phrase ends)")
    ap.add_argument("--noise_rms", type=float, default=0.003, help="Gaussian channel-noise RMS (0: exact silence)")
    ap.add_argument("--isolate_f0", action="store_true",
                    help="neutralize duration and intensity pre-end cues in every phrase (F0 contour left intact)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    resolve_device(args.device)
    make_corpus(args.ref, args.out, args.n_train, args.n_val, args.duration, args.seed, args.p_shift,
                args.p_overlap, args.noise_rms, args.isolate_f0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A synthetic phrase corpus in the schema of the reference's
``dataset_phrases/phrases.csv``: each phrase a few words of voiced harmonic
tone with a gliding F0 (falling at the end of a turn), 16-bit mono WAVs at
22,050 Hz so that loading resamples them, word alignments, a VAD list and
the syntactic completion point. numpy and the standard library only (no
JAX): the port's tests and chip_smoke.py both write it."""

import csv
import os
import wave

import numpy as np

PHRASES = ("student", "psychology", "first_year", "basketball", "experiment", "live", "work", "bike", "drive")
WAV_SR = 22_050
COLUMNS = ("audio_path", "phrase", "long_short", "gender", "phrase_idx", "tts", "words", "starts", "ends",
           "vad_list", "scp", "phones", "phone_starts", "phone_ends")


def _word(f0: float, f1: float, dur: float, rng) -> np.ndarray:
    t = np.arange(int(dur * WAV_SR)) / WAV_SR
    phase = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * dur))
    x = sum(0.25 / k * np.sin(k * phase + rng.uniform(0, 2 * np.pi)) for k in range(1, 6))
    return x * np.hanning(len(t)) ** 0.3


def write_phrase_corpus(root, n: int = 6, seed: int = 0, words=(3, 6), onset: float = 0.2, voices=None) -> str:
    """Writes ``n`` phrases (short and long in turn, both genders) under
    ``root/dataset_phrases`` and returns ``root``. A short phrase has
    ``words[0]`` words, a long one ``words[1]``; each word lasts 0.25-0.45 s
    after a 0.03-0.1 s gap. Phrase i's ``tts`` voice is ``voices[i %
    len(voices)]``, by default ``en-US-Synth-{i % 3}``."""
    voices = voices or [f"en-US-Synth-{k}" for k in range(3)]
    rng = np.random.default_rng(seed)
    base = os.path.join(str(root), "dataset_phrases")
    os.makedirs(os.path.join(base, "audio"), exist_ok=True)
    rows = []
    for i in range(n):
        long_short = ("short", "long")[i % 2]
        gender = ("female", "male")[(i // 2) % 2]
        phrase = PHRASES[i % len(PHRASES)]
        top = 210.0 if gender == "female" else 130.0
        t, starts, ends, parts = onset, [], [], [np.zeros(int(onset * WAV_SR))]
        n_words = words[1] if long_short == "long" else words[0]
        for k in range(n_words):
            dur = float(rng.uniform(0.25, 0.45))
            fall = 0.75 if k == n_words - 1 else 0.95
            f0 = top * float(rng.uniform(0.9, 1.1))
            parts.append(_word(f0, f0 * fall, dur, rng))
            starts.append(round(t, 3))
            t += dur
            ends.append(round(t, 3))
            gap = float(rng.uniform(0.03, 0.1))
            parts.append(np.zeros(int(gap * WAV_SR)))
            t += gap
        audio = np.concatenate(parts) + 0.002 * rng.standard_normal(sum(len(p) for p in parts))
        name = f"{phrase}_{long_short}_{gender}_{i}.wav"
        with wave.open(os.path.join(base, "audio", name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(WAV_SR)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
        word_names = [f"w{k}" for k in range(n_words)]
        scp = ends[n_words // 2 - 1] if long_short == "long" else ends[-1]
        rows.append({
            "audio_path": f"dataset_phrases/audio/{name}", "phrase": phrase, "long_short": long_short,
            "gender": gender, "phrase_idx": i // 4, "tts": voices[i % len(voices)], "words": word_names,
            "starts": starts, "ends": ends, "vad_list": [[[starts[0], ends[-1]]], []], "scp": scp,
            "phones": word_names, "phone_starts": starts, "phone_ends": ends,
        })
    with open(os.path.join(base, "phrases.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        for r in rows:
            w.writerow({k: (repr(v) if isinstance(v, list) else v) for k, v in r.items()})
    return str(root)

"""The phrase corpus and the turn-shift probe (JAX: data/phrases.py).

The corpus (``dataset_phrases/phrases.csv`` under ``phrases_root``, with
its WAVs) holds short TTS phrases with word alignments, a VAD list and the
syntactic completion point (``scp``) of the long ones. Every sample is
padded to ONE corpus-wide length, the longest phrase's end plus 2 s of
silence, with a silent second channel (or, for the mono model, one
channel). The probe runs the corpus through a model and takes the mean
next-speaker shift probability in the hold, prediction and reaction
regions around the end of the turn (and around the SCP of long phrases).

The CSV is read by ``utils/io.read_csv`` (``csv`` and ``ast.literal_eval``
for the list columns), where the JAX package reads it with pandas: the
rows come in the file's order as plain dicts, a column of integers as
``int``, of numbers as ``float``, any other as ``str``, as pandas types
them. The model runs on its own device (the card unless it was given
another); the region means are taken on the host.

``make_phrase_probe`` decides as the JAX package's does:
``phrases_probe`` 0 is off, -1 builds the probe when the corpus CSV exists,
1 requires it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.ops.audio import load_waveform
from voiceactivityprojection_tpu_torch.ops.vad import get_activity_history, vad_list_to_onehot
from voiceactivityprojection_tpu_torch.utils.io import read_csv
from voiceactivityprojection_tpu_torch.utils.units import time_to_frames, time_to_samples

DEFAULT_PHRASES_ROOT = os.path.join(os.sep, "root", "reference")
PHRASE_CSV = "dataset_phrases/phrases.csv"
LIST_COLUMNS = ("starts", "ends", "vad_list", "phone_starts", "phone_ends", "words", "phones")

# phrase -> the word at its syntactic completion point
EXAMPLE_TO_SCP_WORD = {
    "student": "student",
    "psychology": "psychology",
    "first_year": "student",
    "basketball": "basketball",
    "experiment": "before",
    "live": "yourself",
    "work": "side",
    "bike": "bike",
    "drive": "here",
}


def load_phrase_dataframe(csv_path: str) -> List[Dict[str, Any]]:
    """The corpus CSV as a list of row dicts in the file's order, the list
    columns parsed (JAX: phrases.py:48-58)."""
    return read_csv(csv_path, literal=LIST_COLUMNS)


class PhraseDataset:
    """Phrase samples of one fixed shape: (2, n) waveforms (or (1, n) under
    ``audio_mono``) and (frames, 2) VAD, over ``rows`` (the CSV's row
    dicts)."""

    def __init__(
        self,
        root: str = DEFAULT_PHRASES_ROOT,
        csv_path: Optional[str] = None,
        sample_rate: int = 16_000,
        audio_mono: bool = False,
        silence: float = 2.0,
        vad_hz: int = 50,
        vad_horizon: float = 2.0,
        limit: int = 0,
    ):
        self.root = root
        self.rows = load_phrase_dataframe(csv_path or os.path.join(root, PHRASE_CSV))
        if limit:
            # a balanced subset: the first short rows, then the first long
            # ones, at least one of each even at limit=1, so that both
            # families of the validation scalars stay defined
            short = [r for r in self.rows if r["long_short"] == "short"][: max(1, (limit + 1) // 2)]
            long_ = [r for r in self.rows if r["long_short"] == "long"][: max(1, limit // 2)]
            self.rows = short + long_
        self.sample_rate = sample_rate
        self.audio_mono = audio_mono
        self.silence = silence
        self.vad_hz = vad_hz
        self.vad_hop_time = 1.0 / vad_hz
        self.vad_horizon = vad_horizon
        # decoded waveforms by path: the probe reads the whole corpus at
        # every validation
        self._wav_cache: Dict[str, np.ndarray] = {}
        self.max_time = float(max(r["ends"][-1] for r in self.rows) + silence)
        self.n_samples = time_to_samples(self.max_time, sample_rate)
        self.n_frames = time_to_frames(self.max_time, self.vad_hop_time)

    def __len__(self) -> int:
        return len(self.rows)

    def get_sample(self, phrase: str, long_short: str, gender: str, phrase_idx: int) -> Dict[str, Any]:
        row = next(r for r in self.rows if (r["phrase"], r["long_short"], r["gender"], r["phrase_idx"])
                   == (phrase, long_short, gender, phrase_idx))
        return self._to_output(row)

    def _to_output(self, row: Dict[str, Any]) -> Dict[str, Any]:
        audio_path = os.path.join(self.root, row["audio_path"])
        w = self._wav_cache.get(audio_path)
        if w is None:
            w = load_waveform(audio_path, sample_rate=self.sample_rate, mono=True)[0][0]
            self._wav_cache[audio_path] = w
        out = np.zeros(self.n_samples, dtype=np.float32)
        out[: min(len(w), self.n_samples)] = w[: self.n_samples]
        waveform = out[None] if self.audio_mono else np.stack([out, np.zeros_like(out)])
        return {
            "waveform": waveform,
            "vad": vad_list_to_onehot(row["vad_list"], duration=self.max_time, hop_time=self.vad_hop_time),
            "scp": time_to_frames(row["scp"], self.vad_hop_time),
            "end": time_to_frames(row["ends"][-1], self.vad_hop_time),
            "phrase": row["phrase"],
            "long_short": row["long_short"],
            "gender": row["gender"],
            "phrase_idx": int(row["phrase_idx"]),
            "audio_path": audio_path,
            "words": row["words"],
            "starts": row["starts"],
            "ends": row["ends"],
        }

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._to_output(self.rows[idx])

    def batches(self, batch_size: int = 10):
        """The corpus in order, in batches of one shape (the last may be
        smaller)."""
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, len(self)))]
            yield {
                "waveform": np.stack([it["waveform"] for it in items]),
                "vad": np.stack([it["vad"] for it in items]),
                "scp": [it["scp"] for it in items],
                "end": [it["end"] for it in items],
                "long_short": [it["long_short"] for it in items],
                "phrase": [it["phrase"] for it in items],
            }


def get_region_shift_probs(
    p: np.ndarray, end: int, region_frames: int, speaker: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hold, prediction, reaction) slices of speaker ``speaker``'s shift
    probability around frame ``end``: before ``end - region_frames``, the
    region up to ``end``, the region after it. p: (frames, 2)."""
    if p.ndim != 2:
        raise ValueError(f"expected (n_frames, 2), got {p.shape}")
    pred_start = end - region_frames
    react_end = end + region_frames
    return p[:pred_start, speaker], p[pred_start:end, speaker], p[end:react_end, speaker]


class PhraseProbe:
    """The turn-shift probe over the phrase corpus: ``extract_stats(model)``
    gives the (means, stds) of the shift probability by length, readout
    (now, future, tot) and region, and for long phrases around the SCP."""

    def __init__(
        self,
        root: str = DEFAULT_PHRASES_ROOT,
        region_time: float = 0.2,
        silence: float = 2.0,
        batch_size: int = 10,
        mono: bool = False,
        limit: int = 0,
        va_history_times: Tuple[float, ...] = (60.0, 30.0, 10.0, 5.0),
    ):
        self.dset = PhraseDataset(root=root, audio_mono=mono, silence=silence, limit=limit)
        self.region_frames = time_to_frames(region_time, self.dset.vad_hop_time)
        self.batch_size = batch_size
        # a mono model with the VAD history is probed with it, derived per
        # batch from each sample's own VAD (a phrase has no earlier context)
        self.va_history_frames = tuple(int(round(t * self.dset.vad_hz)) for t in va_history_times)

    def _probs(self, model, batch) -> Dict[str, np.ndarray]:
        """p_now, p_future and p_tot of one batch on the host."""
        from voiceactivityprojection_tpu_torch.ops.codebook import get_probs

        w = batch["waveform"]
        if self.dset.audio_mono:
            vah = None
            if bool(getattr(model.conf, "va_history", False)):
                vah = np.stack([get_activity_history(v, self.va_history_frames) for v in batch["vad"]])
            out = model.forward(w, batch["vad"], vah)
        else:
            out = model.forward(w)
        with torch.inference_mode():
            probs = get_probs(out["logits"])
            return {k: probs[k].cpu().numpy() for k in ("p_now", "p_future", "p_tot")}

    def extract_stats(self, model) -> Tuple[Dict[str, float], Dict[str, float]]:
        """``model``: a ``VapModel``, or a ``VapMonoModel`` for a mono probe."""
        buckets: Dict[str, List[np.ndarray]] = {}

        def add(name, arr):
            buckets.setdefault(name, []).append(np.atleast_1d(arr))

        for batch in self.dset.batches(self.batch_size):
            probs = self._probs(model, batch)
            for i, ls in enumerate(batch["long_short"]):
                for pp in ("p_now", "p_future", "p_tot"):
                    nm = pp.replace("p_", "")
                    h, p, r = get_region_shift_probs(probs[pp][i], batch["end"][i], self.region_frames)
                    add(f"{ls}_{nm}_hold", h)
                    add(f"{ls}_{nm}_pred", p)
                    add(f"{ls}_{nm}_react", r)
                    if ls == "long":
                        h, p, r = get_region_shift_probs(probs[pp][i], batch["scp"][i], self.region_frames)
                        add(f"long_scp_{nm}_hold", h)
                        add(f"long_scp_{nm}_pred", p)
                        add(f"long_scp_{nm}_react", r)
        means = {k: float(np.concatenate(v).mean()) for k, v in buckets.items()}
        stds = {k: float(np.concatenate(v).std()) for k, v in buckets.items()}
        return means, stds

    def val_log_stats(self, means: Dict[str, float]) -> Dict[str, float]:
        """The scalars logged at a validation."""
        return {
            "val_ps_hold": means["short_future_hold"],
            "val_ps_pred": means["short_future_pred"],
            "val_ps_react": means["short_now_react"],
            "val_pl_hold": means["long_future_hold"],
            "val_pl_pred": means["long_future_pred"],
            "val_pl_react": means["long_now_react"],
            "val_pls_hold": means["long_scp_future_hold"],
            "val_pls_pred": means["long_scp_future_pred"],
            "val_pls_react": means["long_scp_now_react"],
        }


def make_phrase_probe(data_conf, mono: bool = False) -> Optional[PhraseProbe]:
    """The probe of ``data_conf`` (for the mono model under ``mono``): None
    under ``phrases_probe=0`` or, at -1, without a corpus;
    ``FileNotFoundError`` under 1 without one."""
    mode = int(data_conf.phrases_probe)
    if mode == 0:
        return None
    csv_path = os.path.join(data_conf.phrases_root, PHRASE_CSV)
    if not os.path.isfile(csv_path):
        if mode == 1:
            raise FileNotFoundError(f"--data_phrases_probe 1 but no phrase corpus at {csv_path}")
        return None
    return PhraseProbe(
        root=data_conf.phrases_root,
        mono=mono,
        limit=int(data_conf.phrases_probe_limit),
        va_history_times=tuple(data_conf.va_history_times),
    )

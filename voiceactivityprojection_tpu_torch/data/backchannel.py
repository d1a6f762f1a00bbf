"""The Switchboard backchannel dataset (JAX: data/backchannel.py; reference
vap/backchannel/dataset.py).

* ``SWBReader`` parses the ms98 transcriptions (utterance and word level)
  and the dialog-act word CSVs into each session's utterance table, one
  row dict an utterance, its bounds snapped to its word alignments;
* ``build_backchannel_csv`` writes the flat backchannel CSV from
  ``utterance_is_backchannel.json``;
* ``BackchannelDataset`` cuts fixed windows (15 s before, 5 s after)
  around each backchannel, zero-padded at the session's edges so that the
  backchannel starts at 15 s in every window.

numpy and the standard library's ``csv``, where the JAX package uses
pandas: a table is a list of row dicts, read by ``utils/io.read_csv`` (a
column of integers as ``int``, of numbers as ``float``, any other as
``str``, as pandas types them), and the session table is ordered as pandas' ``sort_values``
orders it (numpy's quicksort of the start times). The written CSV has
pandas' layout: the columns in order of first appearance, a missing value
empty, lists as their Python text. The Switchboard audio is licensed and
not shipped; ``audio_root`` points at a local copy.
"""

from __future__ import annotations

import csv
import os
from glob import glob
from os.path import basename, exists, join
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.utils.io import read_csv, read_json, read_txt
from voiceactivityprojection_tpu_torch.utils.units import time_to_frames, time_to_samples

DEFAULT_SWB_ROOT = os.path.join(os.sep, "root", "reference", "dataset_swb")
Row = Dict[str, Any]


def _is_noise_only(text: str) -> bool:
    return all(t == "[noise]" for t in text.split())


class SWBReader:
    def __init__(self, root: str = DEFAULT_SWB_ROOT):
        self.root = root
        self.anno_path = join(root, "swb_ms98_transcriptions")
        self.da_path = join(root, "swb_dialog_acts_words")
        self.split_path = join(root, "splits")
        self.session_to_path = self._session_paths()
        rel = join(root, "relative_audio_path.json")
        self.audio_rel_paths = read_json(rel) if exists(rel) else {}

    def _session_paths(self) -> Dict[str, Dict]:
        files = sorted(glob(join(self.anno_path, "**/*A-ms98-a-trans.text"), recursive=True))
        paths: Dict[str, Dict] = {}
        for p in files:
            session = basename(p).split("-")[0][2:-1]  # swNNNNA -> NNNN
            paths[session] = {
                ch: {
                    "trans": p.replace("A-ms98-a-trans", f"{ch}-ms98-a-trans"),
                    "words": p.replace("A-ms98-a-trans", f"{ch}-ms98-a-word"),
                    "da_words": join(self.da_path, f"sw{session}{ch}-word-da.csv"),
                }
                for ch in ("A", "B")
            }
        return paths

    @property
    def sessions(self) -> List[str]:
        return list(self.session_to_path)

    def split_sessions(self, split: str) -> List[str]:
        return read_txt(join(self.split_path, f"{split}.txt"))

    def session_to_audio_path(self, session, audio_root: str) -> str:
        return join(audio_root, self.audio_rel_paths[str(session)] + ".wav")

    # -- parsing -----------------------------------------------------------
    def read_utter_trans(self, path: str) -> Dict[str, Dict]:
        """utt_idx -> {start, end, text}, silence and noise-only rows dropped."""
        out: Dict[str, Dict] = {}
        for row in read_txt(path):
            utt_idx, start, end, *text_parts = row.split(" ")
            text = " ".join(text_parts)
            if text == "[silence]" or _is_noise_only(text):
                continue
            out[utt_idx] = {"start": float(start), "end": float(end), "text": text}
        return out

    def read_word_trans(self, path: str) -> List[Dict]:
        out = []
        for row in read_txt(path):
            utt_idx, start, end, text = row.strip().split()
            if text in ("[silence]", "[noise]"):
                continue
            out.append({"utt_idx": utt_idx, "start": float(start), "end": float(end), "text": text})
        return out

    def read_da_words(self, path: str) -> List[Row]:
        """The dialog-act words of one channel: rows of utt_idx, start, end,
        word, boi, da, da_idx (the file has no header)."""
        return read_csv(path, fieldnames=["utt_idx", "start", "end", "word", "boi", "da", "da_idx"])

    def combine(self, speaker: str, words: List[Dict], utters: Dict, da_words: Optional[List[Row]]) -> List[Row]:
        """One channel's word-aligned utterance table: each utterance's
        bounds snapped to its first and last word, its dialog acts joined."""
        rows = []
        for utt_idx, utt in utters.items():
            w_list, starts, ends = [], [], []
            for w in words:
                if utt["end"] + 1 < w["start"]:
                    break
                if w["utt_idx"] == utt_idx:
                    w_list.append(w["text"])
                    starts.append(w["start"])
                    ends.append(w["end"])
            if not starts:  # an utterance with no aligned words
                continue
            row = dict(utt)
            row.update(utt_idx=utt_idx, speaker=speaker, start=starts[0], end=ends[-1], starts=starts, ends=ends,
                       words=w_list)
            if da_words is not None:
                das = [d for d in da_words if d["utt_idx"] == utt_idx]
                row["da"] = [d["da"] for d in das]
                row["da_boi"] = [d["boi"] for d in das]
            rows.append(row)
        return rows

    def get_session(self, session) -> Dict[str, List[Row]]:
        """{"A": rows, "B": rows, "dialog": both channels by start time}."""
        session = str(session)
        p = self.session_to_path[session]
        info = {}
        for ch in ("A", "B"):
            utters = self.read_utter_trans(p[ch]["trans"])
            words = self.read_word_trans(p[ch]["words"])
            da = self.read_da_words(p[ch]["da_words"]) if exists(p[ch]["da_words"]) else None
            info[ch] = self.combine(ch, words, utters, da)
        both = info["A"] + info["B"]
        order = np.argsort(np.array([r["start"] for r in both], dtype=np.float64), kind="quicksort")
        info["dialog"] = [both[i] for i in order]
        return info

    def iter_sessions(self) -> Iterator[Tuple[str, Dict]]:
        for session in self.sessions:
            yield session, self.get_session(session)


def _write_table(rows: List[Row], path: str) -> None:
    """``rows`` as a CSV: the columns in order of first appearance, a
    missing or None value empty, floats and lists as Python writes them."""
    columns: List[str] = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=columns, restval="", lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def build_backchannel_csv(bc_json_path: str, out_csv: str, root: str = DEFAULT_SWB_ROOT) -> None:
    """The backchannel CSV from ``utterance_is_backchannel.json``: every
    backchannel utterance found in its session's table, with its label
    (``bc_label``) and session."""
    reader = SWBReader(root)
    samples = [{"session": utt_idx.split("-")[0][2:-1], "utt_idx": utt_idx, "label": label}
               for utt_idx, label in read_json(bc_json_path).items() if label != "non-bc"]
    rows = []
    for session in dict.fromkeys(s["session"] for s in samples):
        if session not in reader.session_to_path:
            continue
        dialog = reader.get_session(session)["dialog"]
        # every row carries the session table's columns, a missing one as None
        columns = list(dict.fromkeys(k for r in dialog for k in r))
        for bc in (s for s in samples if s["session"] == session):
            hit = next((r for r in dialog if r["utt_idx"] == bc["utt_idx"]), None)
            if hit is None:
                continue
            rows.append(dict({c: hit.get(c) for c in columns}, bc_label=bc["label"], session=session))
    _write_table(rows, out_csv)


class BackchannelDataset:
    """Fixed windows around backchannels: ``pre_context`` + ``post_context``
    seconds, zero-padded at the session's edges."""

    SPLITS = ("train", "val", "test", "all")

    def __init__(
        self,
        bc_csv: str,
        audio_root: str,
        split: str = "train",
        pre_context: float = 15.0,
        post_context: float = 5.0,
        sample_rate: int = 16_000,
        frame_hz: int = 50,
        root: str = DEFAULT_SWB_ROOT,
    ):
        self.reader = SWBReader(root)
        rows = read_csv(bc_csv, literal=("starts", "ends", "words"))
        if split != "all":
            sessions = set(int(s) for s in self.reader.split_sessions(split))
            rows = [r for r in rows if int(r["session"]) in sessions]
        self.rows = rows
        self.audio_root = audio_root
        self.pre_context = pre_context
        self.post_context = post_context
        self.sample_rate = sample_rate
        self.frame_hz = frame_hz
        self.n_samples = time_to_samples(pre_context + post_context, sample_rate)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        from voiceactivityprojection_tpu_torch.ops.audio import get_audio_info, load_waveform, mono_to_stereo

        utt = self.rows[idx]
        audio_path = self.reader.session_to_audio_path(utt["session"], self.audio_root)
        duration = get_audio_info(audio_path)["duration"]
        start = float(utt["start"])
        start_time = max(round(start - self.pre_context, 2), 0.0)
        end_time = min(round(start + self.post_context, 2), duration)
        w, _ = load_waveform(audio_path, start_time=start_time, end_time=end_time, sample_rate=self.sample_rate)
        if w.shape[0] == 1:
            w = mono_to_stereo(w)

        # a window that starts before the session is padded on the left, so
        # that the backchannel sits at pre_context seconds in every window
        out = np.zeros((2, self.n_samples), dtype=np.float32)
        offset = time_to_samples(self.pre_context - (start - start_time), self.sample_rate)
        usable = min(w.shape[-1], self.n_samples - offset)
        out[:, offset: offset + usable] = w[:, :usable]

        # the reference's sample, with two of its slips mended as in the JAX
        # package: the end frame is named bc_end_frame, and the start time is
        # where the padded window puts the backchannel
        rel_bc_start = self.pre_context
        utt_end = float(utt["end"]) if "end" in utt else float(utt["ends"][-1])
        utt_duration = utt_end - start
        hop = 1.0 / self.frame_hz
        return {
            "waveform": out,
            "speaker": 0 if str(utt.get("speaker", "A")) == "A" else 1,
            "bc_start_time": rel_bc_start,
            "bc_start_frame": time_to_frames(rel_bc_start, hop),
            "bc_end_time": rel_bc_start + utt_duration,
            "bc_end_frame": time_to_frames(rel_bc_start + utt_duration, hop),
            "label": utt.get("bc_label", ""),
            "session": str(utt["session"]),
            "utt_idx": utt["utt_idx"],
        }

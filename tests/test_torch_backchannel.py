"""PyTorch port, the Switchboard backchannel reader and dataset
(``data/backchannel.py``, no pandas) against the JAX package (pandas) on a
synthetic ms98-format transcription tree written here: two sessions with
silence, noise and word-less utterances, dialog-act words for both
channels of one session and one channel of the other, splits, audio paths,
8 kHz stereo WAVs. Every table, the written CSV's bytes and every window
of the dataset exact."""

import json
import math
import os

import numpy as np
import pytest
from scipy.io import wavfile

from voiceactivityprojection_tpu.data import backchannel as jbc
from voiceactivityprojection_tpu_torch.data import backchannel as tbc

pytestmark = pytest.mark.data

SESSIONS = ("2001", "2002")


def _records(rows):
    """Rows (a DataFrame's or a list of dicts), the missing (NaN) cells left
    out: NaN equals nothing, not even itself."""
    rows = rows.to_dict("records") if hasattr(rows, "to_dict") else rows
    return [{k: v for k, v in r.items() if not (isinstance(v, float) and math.isnan(v))} for r in rows]


@pytest.fixture(scope="module")
def swb(tmp_path_factory):
    root = tmp_path_factory.mktemp("swb")
    rng = np.random.default_rng(0)
    bc = {}
    rel = {}
    for si, session in enumerate(SESSIONS):
        tdir = root / "swb_ms98_transcriptions" / session[:2] / session
        tdir.mkdir(parents=True)
        (root / "swb_dialog_acts_words").mkdir(exist_ok=True)
        for ch in ("A", "B"):
            utts, words, das = [], [], []
            t = 0.3 + 0.7 * (ch == "B")
            for u in range(7):
                idx = f"sw{session}{ch}-ms98-a-{u + 1:04d}"
                if u == 1:
                    utts.append(f"{idx} {t:.6f} {t + 0.5:.6f} [silence]")
                    t += 0.6
                    continue
                if u == 4:
                    utts.append(f"{idx} {t:.6f} {t + 0.4:.6f} [noise] [noise]")
                    t += 0.5
                    continue
                n_words = 1 if u in (2, 5) else 3
                start = t
                for w in range(n_words):
                    text = "uh-huh" if n_words == 1 else f"word{u}{w}"
                    dur = round(float(rng.uniform(0.15, 0.4)), 6)
                    if u != 6:  # utterance 7 has no aligned words
                        words.append(f"{idx} {t:.6f} {t + dur:.6f} {text}")
                        das.append(f"{idx},{t:.6f},{t + dur:.6f},{text},{'B' if w == 0 else 'I'},"
                                   f"{'b' if n_words == 1 else 'sd'},{u}")
                    if w == 0 and u == 3:
                        words.append(f"{idx} {t + dur:.6f} {t + dur + 0.1:.6f} [noise]")
                    t += dur + 0.05
                utts.append(f"{idx} {start:.6f} {t:.6f} {'uh-huh' if n_words == 1 else 'some words here'}")
                if n_words == 1 and u != 6:
                    bc[idx] = "bc" if u == 2 else "non-bc"
                t += float(rng.uniform(0.5, 1.5))
            (tdir / f"sw{session}{ch}-ms98-a-trans.text").write_text("\n".join(utts) + "\n")
            (tdir / f"sw{session}{ch}-ms98-a-word.text").write_text("\n".join(words) + "\n")
            if session == "2001" or ch == "A":
                (root / "swb_dialog_acts_words" / f"sw{session}{ch}-word-da.csv").write_text("\n".join(das) + "\n")
        rel[session] = f"{session[:2]}/sw0{session}"
        audio = root / "audio" / session[:2]
        audio.mkdir(parents=True, exist_ok=True)
        x = (0.2 * rng.standard_normal((8000 * (22 + si), 2))).clip(-1, 1)
        wavfile.write(audio / f"sw0{session}.wav", 8000, (x * 32767).astype(np.int16))
    bc["sw2001A-ms98-a-0006"] = "bc"
    bc["sw9999A-ms98-a-0001"] = "bc"  # a session the tree lacks
    (root / "relative_audio_path.json").write_text(json.dumps(rel))
    (root / "splits").mkdir()
    for split, sessions in (("train", ["2001"]), ("val", ["2002"]), ("test", [])):
        (root / "splits" / f"{split}.txt").write_text("\n".join(sessions))
    (root / "bc.json").write_text(json.dumps(bc))
    return root


def test_reader_tables_equal_jax(swb):
    t, j = tbc.SWBReader(str(swb)), jbc.SWBReader(str(swb))
    assert t.sessions == j.sessions == list(SESSIONS)
    assert t.session_to_path == j.session_to_path and t.audio_rel_paths == j.audio_rel_paths
    for split in ("train", "val", "test"):
        assert t.split_sessions(split) == j.split_sessions(split)
    assert t.session_to_audio_path(2001, "/a") == j.session_to_audio_path(2001, "/a")
    for session in SESSIONS:
        p = t.session_to_path[session]
        for ch in ("A", "B"):
            assert t.read_utter_trans(p[ch]["trans"]) == j.read_utter_trans(p[ch]["trans"])
            assert t.read_word_trans(p[ch]["words"]) == j.read_word_trans(p[ch]["words"])
            if os.path.exists(p[ch]["da_words"]):
                assert t.read_da_words(p[ch]["da_words"]) == j.read_da_words(p[ch]["da_words"]).to_dict("records")
        got, want = t.get_session(session), j.get_session(session)
        for key in ("A", "B", "dialog"):
            assert got[key] == _records(want[key]), (session, key)
        assert any("da" in r for r in got["dialog"])
    assert [s for s, _ in t.iter_sessions()] == list(SESSIONS)


def test_backchannel_csv_bytes_equal_jax(swb, tmp_path):
    tbc.build_backchannel_csv(str(swb / "bc.json"), str(tmp_path / "t.csv"), root=str(swb))
    jbc.build_backchannel_csv(str(swb / "bc.json"), str(tmp_path / "j.csv"), root=str(swb))
    got, want = (tmp_path / "t.csv").read_bytes(), (tmp_path / "j.csv").read_bytes()
    assert got.count(b"\n") == 1 + 5
    assert got == want


@pytest.mark.parametrize("split", ["all", "train", "val", "test"])
def test_dataset_windows_equal_jax(swb, tmp_path, split):
    csv_path = str(tmp_path / "bc.csv")
    jbc.build_backchannel_csv(str(swb / "bc.json"), csv_path, root=str(swb))
    t = tbc.BackchannelDataset(csv_path, str(swb / "audio"), split=split, root=str(swb))
    j = jbc.BackchannelDataset(csv_path, str(swb / "audio"), split=split, root=str(swb))
    assert len(t) == len(j) == {"all": 5, "train": 3, "val": 2, "test": 0}[split]
    assert _records(t.rows) == _records(j.df)
    assert [list(r) for r in t.rows] == [list(r) for r in j.df.to_dict("records")]
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a.pop("waveform"), b.pop("waveform"))
        assert a == b

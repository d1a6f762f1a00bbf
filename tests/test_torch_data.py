"""PyTorch port, the data pipeline (``data/dataset.py``) against the JAX
package on a corpus from ``examples/make_synthetic_corpus.py``: windows,
items (stereo, the mono mix-down, the VAD history, a ragged session tail,
rows without ``end``), batch order shuffled or not, ``drop_last`` both
ways, prefetch 0 and 2, and the manifest file, all exact; the prefetch
thread's early exit within a time limit."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from scipy.io import wavfile

from voiceactivityprojection_tpu.data import dataset as jds
from voiceactivityprojection_tpu_torch.data import dataset as tds

pytestmark = pytest.mark.data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 stereo sessions of 30 s (rows without start and end), one of them
    also as the row 15-55 s (windows 15-35 s and 35-55 s, 5 s and 25 s of
    them past the audio),
    and a 25 s mono WAV at 22,050 Hz with its VAD list."""
    out = tmp_path_factory.mktemp("corpus")
    subprocess.run([sys.executable, "examples/make_synthetic_corpus.py", "--out", str(out), "--n", "4",
                    "--duration", "30"], cwd=ROOT, check=True, capture_output=True, timeout=300)
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal(int(25 * 22050))).clip(-1, 1)
    wavfile.write(out / "mono.wav", 22050, (x * 32767).astype(np.int16))
    with open(out / "mono_vad.json", "w") as f:
        json.dump([[[0.5, 4.0], [6.0, 12.5], [20.0, 24.9]], [[3.8, 6.2], [13.0, 19.0]]], f)
    rows = [{"audio_path": str(out / f"s{i:03d}.wav"), "vad_path": str(out / f"s{i:03d}_vad.json")}
            for i in range(4)]
    rows.append({"audio_path": str(out / "s001.wav"), "vad_path": str(out / "s001_vad.json"),
                 "start": "15.0", "end": "55.0"})
    rows.append({"audio_path": str(out / "mono.wav"), "vad_path": str(out / "mono_vad.json"), "start": "1.5"})
    jds.write_manifest(rows, str(out / "all.csv"))
    return out


def _pair(csv, **kw):
    return tds.SlidingWindowDataset(str(csv), **kw), jds.SlidingWindowDataset(str(csv), **kw)


def _items_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_write_manifest_byte_for_byte(corpus, tmp_path):
    rows = [{"audio_path": "a.wav", "vad_path": "a.json"}, {"audio_path": "b,c.wav", "vad_path": "b.json",
                                                             "start": 1.5, "end": "9"}]
    tds.write_manifest(rows, str(tmp_path / "t.csv"))
    jds.write_manifest(rows, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    with open(corpus / "all.csv") as f:
        lines = f.read().splitlines()
    tds.write_manifest([dict(zip(lines[0].split(","), l.split(","))) for l in lines[1:]], str(tmp_path / "a.csv"))
    assert (tmp_path / "a.csv").read_bytes() == (corpus / "all.csv").read_bytes()


@pytest.mark.parametrize("kw", [{}, {"overlap": 7.5}, {"audio_duration": 10.0, "horizon": 1.0}])
def test_windows_equal_jax(corpus, kw):
    t, j = _pair(corpus / "all.csv", **kw)
    assert t.windows == j.windows and len(t) == len(j) > 0
    assert (t.n_samples, t.n_frames) == (j.n_samples, j.n_frames)
    # rows without end run to the end of their audio (30 s, 25 s)
    assert max(w["end"] for w in t.windows if w["audio_path"].endswith("s000.wav")) <= 30.0


@pytest.mark.parametrize("mode", ["stereo", "mono", "va_history"])
def test_items_equal_jax(corpus, mode):
    kw = {"mono": mode == "mono", "va_history": mode == "va_history",
          "va_history_times": (20.0, 10.0, 5.0, 2.0)}
    t, j = _pair(corpus / "all.csv", **kw)
    for i in range(len(t)):
        got, want = t[i], j[i]
        _items_equal(got, want)
        assert got["waveform"].shape == ((1,) if mode == "mono" else (2,)) + (t.n_samples,)
        assert got["vad"].shape == (t.n_frames, 2)
    assert ("vah" in t[0]) == (mode == "va_history")
    # the mono WAV's window has a silent second channel in stereo
    mono_idx = [i for i, w in enumerate(t.windows) if w["audio_path"].endswith("mono.wav")]
    if mode == "stereo":
        assert not t[mono_idx[0]]["waveform"][1].any()


def test_ragged_tail_is_padded_as_jax(corpus):
    t, j = _pair(corpus / "all.csv", va_history=True)
    idx = [i for i, w in enumerate(t.windows) if w["start"] == 35.0]
    assert len(idx) == 1  # 35-55 s of a 30 s session: all padding
    got = t[idx[0]]
    _items_equal(got, j[idx[0]])
    assert not got["waveform"].any() and not got["vad"].any()
    tail = [i for i, w in enumerate(t.windows) if w["start"] == 15.0 and w["audio_path"].endswith("s001.wav")]
    x = t[tail[0]]["waveform"]
    assert not x[:, -16000 * 5:].any() and x[:, : 16000 * 14].any()


def test_vad_cache(corpus):
    t, _ = _pair(corpus / "all.csv")
    tds.clear_vad_cache()
    t[0]
    assert tds._read_vad_list.cache_info().currsize == 1
    tds.clear_vad_cache()
    assert tds._read_vad_list.cache_info().currsize == 0


def _batches(loader):
    return [b for b in loader]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle, drop_last", [(False, False), (False, True), (True, False), (True, True)])
def test_loader_batches_equal_jax(corpus, prefetch, shuffle, drop_last):
    t, j = _pair(corpus / "all.csv", audio_duration=10.0, horizon=1.0, va_history=True,
                 va_history_times=(20.0, 10.0))
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=3, prefetch=prefetch, num_workers=2)
    tl, jl = tds.VapDataLoader(t, **kw), jds.VapDataLoader(j, **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):  # the shuffle order moves on each pass, as JAX's
        got, want = _batches(tl), _batches(jl)
        assert len(got) == len(want) == len(tl)
        for g, w in zip(got, want):
            _items_equal(g, w)
    sizes = [b["vad"].shape[0] for b in got]
    assert sizes[-1] == (3 if drop_last else len(t) % 3 or 3)


def test_loader_early_break_returns(corpus):
    """A consumer that stops after one batch returns at once, and the
    prefetch thread ends; with a slow dataset and a full queue."""
    t, _ = _pair(corpus / "all.csv")

    class Slow:
        def __len__(self):
            return len(t)

        def __getitem__(self, i):
            time.sleep(0.05)
            return t[i]

    before = threading.active_count()
    loader = tds.VapDataLoader(Slow(), batch_size=1, prefetch=1, num_workers=1)
    t0 = time.perf_counter()
    for _ in loader:
        break
    assert time.perf_counter() - t0 < 5.0
    deadline = time.perf_counter() + 5.0
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_loader_raises_a_decode_error(corpus, tmp_path):
    rows = [{"audio_path": str(corpus / "s000.wav"), "vad_path": str(tmp_path / "missing.json")}]
    tds.write_manifest(rows, str(tmp_path / "bad.csv"))
    loader = tds.VapDataLoader(tds.SlidingWindowDataset(str(tmp_path / "bad.csv")), batch_size=1)
    with pytest.raises(FileNotFoundError):
        _batches(loader)

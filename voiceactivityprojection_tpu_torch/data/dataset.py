"""Sliding-window data pipeline (JAX: data/dataset.py).

A CSV manifest with columns

    audio_path,vad_path[,start,end]

lists sessions: a WAV file and its vad_list JSON (``[[[s, e], ...] x 2]``
seconds per speaker); ``start`` / ``end`` crop the session, and a row
without ``end`` runs to the end of its audio. ``SlidingWindowDataset``
cuts each session into ``audio_duration`` windows with ``horizon`` more
seconds of VAD, the reference's batch contract:

    batch["waveform"]: (B, 2, audio_duration * sample_rate)   float32
    batch["vad"]:      (B, (audio_duration + horizon) * frame_hz, 2)

``VapDataLoader`` batches the windows in order or shuffled, decoding a
batch's windows on a thread pool (the native decoder and resampler release
the GIL) and keeping ``prefetch`` batches ready on a background thread.
Batches are numpy arrays, as the JAX package's are; the step moves them to
its device.
"""

from __future__ import annotations

import csv as _csv
import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.ops.audio import get_audio_info, load_waveform, mono_to_stereo
from voiceactivityprojection_tpu_torch.ops.vad import (
    get_activity_history,
    get_vad_list_subset,
    vad_list_to_onehot,
)
from voiceactivityprojection_tpu_torch.utils.io import read_json


@functools.lru_cache(maxsize=None)
def _read_vad_list(path: str):
    """A session's vad_list, parsed once for all its windows. Unbounded: a
    cache smaller than the corpus misses on every window under shuffled
    access, and a parsed vad_list is tens of KB an hour of dialogue;
    ``clear_vad_cache`` releases it."""
    return read_json(path)


def clear_vad_cache() -> None:
    _read_vad_list.cache_clear()


class SlidingWindowDataset:
    """Fixed-duration windows over the sessions of a CSV manifest."""

    def __init__(
        self,
        csv_path: str,
        audio_duration: float = 20.0,
        horizon: float = 2.0,
        sample_rate: int = 16_000,
        frame_hz: int = 50,
        overlap: float = 0.0,
        mono: bool = False,
        va_history: bool = False,
        va_history_times: tuple = (60.0, 30.0, 10.0, 5.0),
    ):
        step = audio_duration - overlap
        if step <= 0:
            raise ValueError("overlap must be smaller than audio_duration")
        self.audio_duration = audio_duration
        self.horizon = horizon
        self.sample_rate = sample_rate
        self.frame_hz = frame_hz
        self.mono = mono
        # the mono model's VAD-history feature, from the session's VAD so
        # that the longest window reaches back before the window's start
        self.va_history = va_history
        self.va_history_frames = tuple(int(round(t * frame_hz)) for t in va_history_times)
        self.n_samples = int(audio_duration * sample_rate)
        self.n_frames = int((audio_duration + horizon) * frame_hz)

        self.windows: List[Dict] = []
        with open(csv_path) as f:
            for row in _csv.DictReader(f):
                start = float(row.get("start") or 0.0)
                end = float(row["end"]) if row.get("end") else get_audio_info(row["audio_path"])["duration"]
                t = start
                while t + audio_duration <= end:
                    self.windows.append(
                        {"audio_path": row["audio_path"], "vad_path": row["vad_path"],
                         "start": t, "end": t + audio_duration}
                    )
                    t += step

    def __len__(self) -> int:
        return len(self.windows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        w = self.windows[idx]
        x, _ = load_waveform(
            w["audio_path"], sample_rate=self.sample_rate, start_time=w["start"], end_time=w["end"],
            mono=self.mono,  # the mono model's one channel: the mix-down
        )
        if x.shape[0] == 1 and not self.mono:
            x = mono_to_stereo(x)
        if x.shape[-1] < self.n_samples:  # a session's ragged tail: zeros
            x = np.pad(x, [(0, 0), (0, self.n_samples - x.shape[-1])])
        x = x[:, : self.n_samples]

        vad_list = _read_vad_list(w["vad_path"])
        sub = get_vad_list_subset(vad_list, w["start"], w["end"] + self.horizon)
        vad = vad_list_to_onehot(sub, duration=self.audio_duration + self.horizon, frame_hz=self.frame_hz)
        if vad.shape[0] < self.n_frames:
            vad = np.pad(vad, [(0, self.n_frames - vad.shape[0]), (0, 0)])
        vad = vad[: self.n_frames]

        item = {"waveform": x.astype(np.float32), "vad": vad.astype(np.float32), "session": w["audio_path"]}
        if self.va_history:
            # the context reaches back by the longest history window, so
            # the window's first frames see their real past
            ext_start = max(0.0, w["start"] - self.va_history_frames[0] / self.frame_hz)
            ext = get_vad_list_subset(vad_list, ext_start, w["end"] + self.horizon)
            ext_vad = vad_list_to_onehot(ext, duration=(w["end"] + self.horizon) - ext_start, frame_hz=self.frame_hz)
            hist = get_activity_history(ext_vad, self.va_history_frames)
            off = int(round((w["start"] - ext_start) * self.frame_hz))
            vah = hist[off : off + self.n_frames]
            if vah.shape[0] < self.n_frames:  # a session's ragged tail
                vah = np.pad(vah, [(0, self.n_frames - vah.shape[0]), (0, 0)], constant_values=0.5)
            item["vah"] = vah.astype(np.float32)
        return item


class VapDataLoader:
    """Batches of windows, shuffled from ``np.random.default_rng(seed)``
    (a new order every pass), the tail batch kept unless ``drop_last``,
    ``prefetch`` batches decoded ahead on a background thread (0: in the
    caller's thread).

    Over processes, ``shard = (rank, n_ranks)``: ``batch_size`` is the
    global batch, which every rank orders from the same seed, and rank r
    yields (and decodes) only its rows ``[r * B / W, (r + 1) * B / W)``; a
    batch the ranks do not divide raises. JAX's single-host ``--n_devices``
    feeds the same global batch to its mesh."""

    def __init__(
        self,
        dataset: SlidingWindowDataset,
        batch_size: int = 16,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 4,
        shard: Tuple[int, int] = (0, 1),
    ):
        rank, n_ranks = shard
        if not 0 <= rank < n_ranks or batch_size % n_ranks:
            raise ValueError(f"a batch of {batch_size} does not split over {n_ranks} ranks (rank {rank})")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)

        def load_batch(idxs, pool):
            items = list(pool.map(lambda j: self.dataset[int(j)], idxs))
            batch = {
                "waveform": np.stack([it["waveform"] for it in items]),
                "vad": np.stack([it["vad"] for it in items]),
            }
            if "vah" in items[0]:
                batch["vah"] = np.stack([it["vah"] for it in items])
            return batch

        with ThreadPoolExecutor(max_workers=max(self.num_workers, 1)) as pool:
            rank, n_ranks = self.shard
            for i in range(0, len(order), self.batch_size):
                idxs = order[i : i + self.batch_size]
                if self.drop_last and len(idxs) < self.batch_size:
                    break
                if len(idxs) % n_ranks:
                    raise ValueError(f"a batch of {len(idxs)} windows does not split over {n_ranks} ranks")
                b = len(idxs) // n_ranks
                yield load_batch(idxs[rank * b : (rank + 1) * b], pool)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a put that gives up once the consumer has gone: one that
            # breaks out early must not leave the worker blocked on a full
            # queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a worker in the middle of a put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)


def write_manifest(rows: List[Dict[str, str]], path: str) -> None:
    """An audio/vad manifest CSV of ``rows`` (missing columns empty)."""
    fields = ["audio_path", "vad_path", "start", "end"]
    with open(path, "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fields})

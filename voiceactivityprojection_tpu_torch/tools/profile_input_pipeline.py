"""Throughput of the input pipeline: what feeds the card, not what runs on
it (JAX: examples/profile_input_pipeline.py).

    python -m voiceactivityprojection_tpu_torch.tools.profile_input_pipeline --csv train.csv
        [--batch_size 16] [--audio_duration 20] [--n_batches 50] [--num_workers 4] [--device cuda|cpu]

1. the loader (``data/dataset.py``: decode, resample, VAD one-hot,
   batching) with no prefetch, in audio-seconds/s and ms a batch;
2. ``events/events.py`` ``TurnTakingEvents`` on a batch's VAD, ms a batch,
   as every validation epoch runs it on the host;
3. ``train/augment.py`` ``flip_channels`` on a batch on the device, ms a
   batch (the other augmentations run inside the train step).

The loader's ms a batch is set against the bare bf16 frozen train step's
(``STEP_MS``): prefetch hides the loader where it is the shorter. The
device is the card unless ``--device cpu`` (without a card the default
raises); ``--device`` takes the place of JAX's ``--platform``.
``profile_input_pipeline`` returns the three figures.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.utils.device import resolve_device

# the bare bf16 frozen train step at B=16 x 20 s on an NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py [train_throughput], PERF.md section 5)
STEP_MS = 47.2
EVENTS_S = 3.0  # seconds of repeated event extraction timed
FLIP_S = 2.0  # seconds of repeated flips timed


def profile_input_pipeline(csv: str, batch_size: int = 16, audio_duration: float = 20.0, n_batches: int = 50,
                           num_workers: int = 4, device="cuda") -> Dict[str, float]:
    from voiceactivityprojection_tpu_torch.config import EventConfig
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
    from voiceactivityprojection_tpu_torch.events.events import TurnTakingEvents
    from voiceactivityprojection_tpu_torch.train.augment import draw_bits, flip_channels

    dev = resolve_device(device)
    ds = SlidingWindowDataset(csv, audio_duration=audio_duration)
    loader = VapDataLoader(ds, batch_size=batch_size, shuffle=True, num_workers=num_workers,
                           prefetch=0)  # the raw production rate, not the overlap with a consumer
    n = min(n_batches, len(loader))
    audio_s_per_batch = batch_size * audio_duration

    # 1. the loader
    it = iter(loader)
    first = next(it)  # warm: VAD JSON cache, file handles
    t0 = time.perf_counter()
    batches, got = [], 0
    for b in it:
        got += 1
        if len(batches) < 8:
            batches.append(b)
        if got + 1 >= n:
            break
    dt = time.perf_counter() - t0
    got = max(got, 1)
    out = {"loader_ms_per_batch": 1e3 * dt / got, "loader_audio_s_per_s": got * audio_s_per_batch / dt,
           "batches": got}
    print(f"loader: {out['loader_ms_per_batch']:.1f} ms/batch  {out['loader_audio_s_per_s']:,.0f} audio-s/s "
          f"(B={batch_size}, {audio_duration}s windows, {num_workers} workers, {got} batches)")
    batches = batches or [first]

    # 2. event extraction (host work of every validation epoch)
    ev = TurnTakingEvents(EventConfig(), seed=0)
    ev(np.asarray(batches[0]["vad"]))  # warm
    t0, reps = time.perf_counter(), 0
    while time.perf_counter() - t0 < EVENTS_S:
        for b in batches:
            ev(np.asarray(b["vad"]))
            reps += 1
    out["events_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / reps
    print(f"events: {out['events_ms_per_batch']:.1f} ms/batch ({reps} reps)")

    # 3. the channel flip on the device (the other augmentations run in the step)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items() if k in ("waveform", "vad")}
    flip = lambda: flip_channels(tb, draw_bits(torch.Generator().manual_seed(0), 0.5, batch_size))["waveform"]
    flip()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0, reps = time.perf_counter(), 0
    while time.perf_counter() - t0 < FLIP_S:
        flip()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reps += 1
    out["flip_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / reps
    print(f"flip_channels: {out['flip_ms_per_batch']:.1f} ms/batch")

    hidden = out["loader_ms_per_batch"] < STEP_MS
    print(f"\nsummary: loader {out['loader_ms_per_batch']:.1f} ms/batch vs the bare train step {STEP_MS:.0f} ms "
          f"(H100) — {'HIDDEN by prefetch' if hidden else 'LOADER-BOUND'}; val-epoch events add "
          f"{out['events_ms_per_batch']:.1f} ms/batch on host", flush=True)
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="input-pipeline throughput (PyTorch port)")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--audio_duration", type=float, default=20.0)
    ap.add_argument("--n_batches", type=int, default=50)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    profile_input_pipeline(args.csv, args.batch_size, args.audio_duration, args.n_batches, args.num_workers,
                           args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

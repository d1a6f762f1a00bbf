"""The SDS loop at live pacing: 20 ms hops delivered every 20 ms against a
wall-clock target, with each hop's latency and deadline miss (JAX:
examples/soak_sds.py; reference sds/run_sds.py:222-263).

    python -m voiceactivityprojection_tpu_torch.tools.soak_sds [--seconds 60] [--mode window|kv]
        [--batched S] [--device cuda|cpu]

Per hop:

  latency   the step's wall time: encoder, transformer, probabilities and
            the fetch of p to the host
  lateness  its completion against the hop's deadline, start + 20 ms x
            (i + 1); above 0 the hop missed real time

The single-stream modes drive ``inference/sds.py`` ``TurnTakingSDS.step``
(``--mode window``: ``StreamingVap``, 14 attention launches a hop; ``kv``:
the KV-cache streamer); ``--batched S`` drives a ``BatchedKVStreamer`` of
S dialogs, each push advancing all of them one hop and fetching ``p_now``
to the host (a synchronize a hop). 50 hops warm the streamer first. The
audio is a seeded speech-like signal (harmonic bursts and pauses) on each
channel. The streamers compute in float32, so the weights are the port's
seed-0 draw in float32 where JAX's script soaks a bfloat16 model. Runs on
the card unless ``--device cpu`` (without a card the default raises).
``soak`` returns the percentiles, the misses and every hop's p.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np

SR = 16_000
HOP_S = 0.02
WARM_HOPS = 50


def synth_speech(seconds: float, sr: int, seed: int = 0) -> np.ndarray:
    """Speech-like mono test signal (harmonic bursts + silences)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = np.zeros(n, np.float32)
    t = 0.0
    while t < seconds - 1.0:
        dur = rng.uniform(0.5, 2.0)
        s0, s1 = int(t * sr), min(int((t + dur) * sr), n)
        tt = np.arange(s1 - s0) / sr
        f0 = rng.uniform(100, 250)
        sig = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 4))
        x[s0:s1] = 0.1 * sig * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt))
        t += dur + rng.uniform(0.1, 0.5)
    return x


def report(name: str, lat: np.ndarray, late: np.ndarray, hop_s: float = HOP_S) -> Dict:
    """Prints JAX's summary line; returns its numbers (ms)."""
    pct = lambda a, p: float(np.percentile(a, p)) * 1e3
    misses = int((late > 0).sum())
    rec = {"hops": len(lat), "latency_ms": {"p50": pct(lat, 50), "p90": pct(lat, 90), "p99": pct(lat, 99),
                                            "max": float(lat.max()) * 1e3},
           "misses": misses, "miss_pct": 100.0 * misses / len(lat), "jitter_p99_ms": pct(np.maximum(late, 0), 99)}
    l = rec["latency_ms"]
    print(f"{name}: hops={len(lat)} latency p50/p90/p99/max = {l['p50']:.2f}/{l['p90']:.2f}/{l['p99']:.2f}/"
          f"{l['max']:.2f} ms | deadline({hop_s * 1e3:.0f}ms) misses={misses} ({rec['miss_pct']:.2f}%) | "
          f"jitter(p99 lateness)={rec['jitter_p99_ms']:.2f} ms", flush=True)
    return rec


def soak(model, n_hops: int, mode: str = "window", batched: int = 0, paced: bool = True) -> Dict:
    """``n_hops`` hops after the warm-up, paced at 20 ms unless ``paced`` is
    off; the report of ``report`` plus ``p``: each hop's smoothed p (single
    stream) or stream 0's newest p_now of speaker A (batched), and
    ``p_in_range``."""
    hop = int(HOP_S * SR)
    seconds = n_hops * HOP_S  # the audio of JAX's --seconds: the warm-up and the hops, 1 s to spare
    stereo = np.stack([synth_speech(seconds + 2.0, SR, seed=0), synth_speech(seconds + 2.0, SR, seed=1)])
    chunk = lambda i: stereo[:, i * hop:(i + 1) * hop]

    if batched:
        from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer

        S = batched
        streamer = BatchedKVStreamer(model, streams=S, context_time=20.0)
        step_fn = lambda i: streamer.push(np.broadcast_to(chunk(i), (S, 2, hop)).copy())["p_now"].cpu().numpy()
        name = f"batched S={S} (kv pool)"
    else:
        from voiceactivityprojection_tpu_torch.config import SDSConfig
        from voiceactivityprojection_tpu_torch.inference.sds import TurnTakingSDS

        sds = TurnTakingSDS(model, SDSConfig(transformer_mode=mode))
        sds.stream.reset()
        step_fn = lambda i: sds.step(chunk(i))
        name = f"single-stream ({mode})"
    for i in range(WARM_HOPS):
        step_fn(i)
    lat, late, ps = np.zeros(n_hops), np.zeros(n_hops), []
    in_range = True
    start = time.perf_counter()
    for i in range(n_hops):
        target = start + i * HOP_S
        if paced:
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
        t0 = time.perf_counter()
        p = step_fn(WARM_HOPS + i)  # on the host: the fetch waits for the hop
        t1 = time.perf_counter()
        lat[i] = t1 - t0
        late[i] = t1 - (target + HOP_S)
        if batched:
            in_range &= bool(((p >= 0) & (p <= 1)).all())
            p = float(p[-1, 0, 0]) if len(p) else float("nan")
        else:
            in_range &= 0.0 <= p <= 1.0
        ps.append(p)
    rec = report(name + ("" if paced else ", unpaced"), lat, late)
    rec.update(mode="batched" if batched else mode, streams=batched or 1, paced=paced, p=ps, p_in_range=in_range)
    return rec


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the SDS loop at live 50 Hz pacing (PyTorch port)")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--batched", type=int, default=0)
    ap.add_argument("--mode", default="window", choices=["window", "kv"])
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    args = get_parser().parse_args(argv)
    model = VapModel(VapConfig(), device=args.device)
    rec = soak(model, int(args.seconds / HOP_S), args.mode, args.batched)
    if not rec["p_in_range"]:
        raise SystemExit("a probability left [0, 1]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

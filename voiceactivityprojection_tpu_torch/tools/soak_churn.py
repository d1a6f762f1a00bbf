"""Churn soak of the stream server over real ZMQ (JAX: examples/soak_churn.py;
reference sds/run_sds.py:222-263, the single-dialog loop the server
generalizes).

    python -m voiceactivityprojection_tpu_torch.tools.soak_churn [--streams 64] [--duration 600]
        [--hop_frames 2] [--pace 1.0] [--port 0] [--check_sessions 24] [--max_wait_ms 15]
        [--session_timeout 30] [--out TMPDIR/soak_churn.json] [--seed 0] [--device cuda|cpu]

Drives ``inference/server.py``'s ``VapStreamServer`` with up to
``--streams`` live sessions at live pacing for ``--duration`` seconds,
with churn: sessions keep joining (about 90 % of the slots busy), each
runs 8-30 s of audio and leaves, 70 % with a close, 30 % by vanishing
without one (idle eviction must reclaim the slot); a tenth of the pushes
send two chunks back to back (the slot's FIFO must take both, in order);
slots are recycled across dialogs all run long. Live sessions are joined
for up to 60 s after ``--duration``, so the wall time is about the
duration plus one session's life.

Contamination check: every session's audio is a fixed function of its
serial (``synth_dialog``). The sessions that closed cleanly with no
underrun (the close reply carries the slot's count), each with its outputs
kept (a third of them) and at least 16 hops, are replayed through a solo
``BatchedKVStreamer`` and compared hop for hop, up to
``--check_sessions``. Alignment, as JAX's: a slot opens recycled (every
open resets its rows), so its first push emits one more frame than a fresh
stream's first: server frame j is solo frame j - 1; the first 8 hops (the
conv tails' convergence) are skipped. Another dialog's state leaking in
shows as a difference of about 0.1; the bar is 0.05.

Latency: each push's round trip at the client, p50 / p90 / p99 / max, with
the server's tick, push, underrun and eviction counts. The server binds a
port the OS picks (``--port 0``) and the clients use the one bound. The
model runs on the card unless ``--device cpu`` (without a card the default
raises), with the port's seed-0 weights in float32 (the streamers compute
in float32; JAX's script serves a bfloat16 model). pyzmq is imported when
the soak starts. The exit code is 1 when a replayed session differs by the
bar or more, else 0, also when no session was eligible (the summary says
so: ``contamination_ok`` is None); ``churn_soak`` returns the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

SR = 16_000
SKIP_HOPS = 8
CONTAMINATION_BAR = 0.05


def synth_dialog(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Deterministic (2, n) stereo pseudo-dialog for session ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = np.zeros((2, n), np.float32)
    t, ch = 0.0, rng.integers(0, 2)
    while t < seconds - 0.5:
        dur = float(rng.uniform(0.4, 1.6))
        s0, s1 = int(t * sr), min(int((t + dur) * sr), n)
        tt = np.arange(s1 - s0) / sr
        f0 = float(rng.uniform(90, 260))
        sig = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 4))
        x[ch, s0:s1] = 0.08 * sig * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * tt))
        ch = int(rng.integers(0, 2)) if rng.random() < 0.6 else ch
        t += dur + float(rng.uniform(0.05, 0.4))
    return x


class SessionResult:
    def __init__(self, serial: int):
        self.serial = serial
        self.outcome = "running"  # closed | crashed | evicted | rejected | error
        self.underruns: Optional[int] = None
        self.latencies: List[float] = []  # each push's round trip, s
        self.outputs: List[Dict[str, np.ndarray]] = []  # each hop's p_now / p_future
        self.n_hops = 0
        self.error: Optional[str] = None


def run_session(serial: int, port: int, hop_samples: int, sr: int, life_s: float, crash: bool, pace_scale: float,
                rng_seed: int, keep_outputs: bool, zctx) -> SessionResult:
    """One client's dialog of ``life_s`` seconds at live pacing."""
    from voiceactivityprojection_tpu_torch.inference.server import VapStreamClient

    res = SessionResult(serial)
    rng = np.random.default_rng(rng_seed)
    try:
        c = VapStreamClient(port=port, timeout_s=120.0, ctx=zctx)
        c.open()
        audio = synth_dialog(life_s + 1.0, sr, seed=serial)
        hop_s = hop_samples / sr * pace_scale
        n_hops = int(life_s * sr) // hop_samples
        start = time.time()
        i = 0
        while i < n_hops:
            burst = 2 if (rng.random() < 0.10 and i + 1 < n_hops) else 1  # fills the slot's FIFO
            for _ in range(burst):
                t0 = time.time()
                out = c.push(audio[:, i * hop_samples:(i + 1) * hop_samples])
                res.latencies.append(time.time() - t0)
                if keep_outputs:
                    res.outputs.append({k: np.asarray(v) for k, v in out.items() if k in ("p_now", "p_future")})
                i += 1
            res.n_hops = i
            dt = start + (i + 1) * hop_s - time.time()  # live pacing on the session's clock
            if dt > 0:
                time.sleep(dt)
        if crash:
            res.outcome = "crashed"
            c.session = None  # vanish without a close: the eviction path
            c.sock.close(0)  # the shared context stays
        else:
            h = c.close()
            res.outcome = "closed"
            if h is not None:
                res.underruns = h.get("underruns")
    except Exception as e:  # noqa: BLE001 -- the soak keeps going and counts it
        if "not yours" in repr(e):
            res.outcome = "evicted"  # the idle timeout took the slot: a churn outcome
        elif "no free stream slots" in repr(e):
            res.outcome = "rejected"  # respawned before a slot freed: the server refuses, rightly
        else:
            res.outcome = "error"
            res.error = repr(e)
    return res


def prewarm(server) -> float:
    """Runs the tick path (a slot reset, a push, the packed fetch) twice
    before any client exists, then resets the server's state; returns the
    seconds it took."""
    t0 = time.time()
    server.sessions[0] = b"_prewarm"
    server._resets.add(0)
    for _ in range(2):
        server.pending[0] = [(None, np.zeros((2, server.hop_samples), np.float32))]
        server._tick()
    server.sessions.clear()
    server.pending.clear()
    server.slot_underruns.clear()
    server.stats.update(ticks=0, pushes=0, underruns=0, evictions=0)
    server.streamer.reset()
    return time.time() - t0


def replay_check(model, results: List[SessionResult], hop_samples: int, hop_frames: int,
                 check_sessions: int) -> Dict:
    """Each eligible session replayed solo and compared hop for hop."""
    import torch

    from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer

    candidates = [r for r in results
                  if r.outcome == "closed" and r.underruns == 0 and r.outputs and r.n_hops >= 16]
    print(f"contamination check: {len(candidates)} clean underrun-free sessions with recorded outputs "
          f"(checking {min(len(candidates), check_sessions)})", flush=True)
    solo = BatchedKVStreamer(model, streams=1, context_time=20.0, hop_frames=hop_frames)
    skip_f = SKIP_HOPS * hop_frames
    keys = ("p_now", "p_future")
    diffs = []
    for r in candidates[:check_sessions]:
        solo.reset()
        audio = synth_dialog(r.n_hops * hop_samples / SR + 2.0, SR, seed=r.serial)
        srv = {k: np.concatenate([rec[k] for rec in r.outputs], 0) for k in keys}
        refs = {k: [] for k in keys}
        for i in range(len(r.outputs)):
            ref = solo.push(audio[None, :, i * hop_samples:(i + 1) * hop_samples])
            for k in keys:
                refs[k].append(ref[k][:, 0])
        fetched = {k: torch.cat(refs[k], 0).cpu().numpy() for k in keys}  # one fetch a session
        worst = 0.0
        for k in keys:
            L = min(len(srv[k]) - 1 - skip_f, len(fetched[k]) - skip_f)
            if L <= 0:
                continue
            worst = max(worst, float(np.max(np.abs(srv[k][1 + skip_f:1 + skip_f + L]
                                                    - fetched[k][skip_f:skip_f + L]))))
        diffs.append({"serial": r.serial, "hops": len(r.outputs), "max_abs_diff": worst})
        print(f"  session {r.serial}: {len(r.outputs)} hops, max |Δp| = {worst:.2e}", flush=True)
    return {"checked": len(diffs), "skip_hops": SKIP_HOPS, "bar": CONTAMINATION_BAR,
            "max_abs_diff": max((d["max_abs_diff"] for d in diffs), default=None), "per_session": diffs}


def churn_soak(model, streams: int = 64, duration: float = 600.0, hop_frames: int = 2, pace: float = 1.0,
               port: int = 0, check_sessions: int = 24, max_wait_ms: float = 15.0, session_timeout: float = 30.0,
               seed: int = 0, session_s: Tuple[float, float] = (8.0, 30.0)) -> Dict:
    """The soak and its contamination check; returns the summary. Each
    session runs a length of audio drawn uniformly from ``session_s``
    (seconds; the CLI's 8-30 s)."""
    import zmq

    from voiceactivityprojection_tpu_torch.inference.server import VapStreamServer

    server = VapStreamServer(model, streams=streams, context_time=20.0, hop_frames=hop_frames,
                             session_timeout_s=session_timeout, max_wait_ms=max_wait_ms)
    print(f"prewarm: {prewarm(server):.1f}s", flush=True)
    server.start(port=port)
    hop_samples = server.hop_samples
    print(f"server up on port {server.port}: {streams} slots, hop={hop_samples} samples "
          f"({hop_samples / SR * 1e3:.0f} ms)", flush=True)

    # keep ~90 % of the slots busy, one thread a live session, a fresh
    # serial for each; one zmq context shared by every client
    zctx = zmq.Context(io_threads=2)
    rng = np.random.default_rng(seed)
    results: List[SessionResult] = []
    results_lock = threading.Lock()
    serial_ctr = {"n": 0}
    t_start = time.time()
    stop_at = t_start + duration
    target_live = max(1, int(streams * 0.9))
    live: List[threading.Thread] = []

    def spawn() -> threading.Thread:
        serial = serial_ctr["n"]
        serial_ctr["n"] += 1
        life = float(rng.uniform(*session_s))
        crash = bool(rng.random() < 0.3)
        keep = serial % 3 == 0  # a third keep their outputs (memory)

        def work():
            res = run_session(serial, server.port, hop_samples, SR, life, crash, pace, rng_seed=10_000 + serial,
                              keep_outputs=keep, zctx=zctx)
            with results_lock:
                results.append(res)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        return t

    try:
        t_report = time.time()
        while time.time() < stop_at:
            live = [t for t in live if t.is_alive()]
            while len(live) < target_live and time.time() < stop_at:
                live.append(spawn())
                time.sleep(0.05)  # staggered joins
            time.sleep(0.25)
            if time.time() - t_report > 30:
                with results_lock:
                    done = len(results)
                print(f"t={time.time() - t_start:6.0f}s live={len(live)} done={done} stats={server.stats}",
                      flush=True)
                t_report = time.time()
        for t in live:
            t.join(timeout=60)

        with results_lock:
            results = list(results)
        lats = [r.latencies for r in results if r.latencies]
        lat = np.concatenate(lats) if lats else np.zeros(1)
        pct = lambda p: float(np.percentile(lat, p) * 1e3)
        summary = {
            "streams": streams, "duration_s": duration, "hop_ms": hop_samples / SR * 1e3, "pace": pace,
            "port": server.port, "wall_s": time.time() - t_start,
            "sessions_total": len(results),
            "sessions_closed": sum(r.outcome == "closed" for r in results),
            "sessions_crashed": sum(r.outcome == "crashed" for r in results),
            "sessions_evicted": sum(r.outcome == "evicted" for r in results),
            "sessions_rejected": sum(r.outcome == "rejected" for r in results),
            "sessions_error": sum(r.outcome == "error" for r in results),
            "sessions_running": sum(t.is_alive() for t in live),
            "errors": [r.error for r in results if r.error][:10],
            "hops_total": int(sum(r.n_hops for r in results)),
            "latency_ms_p50": pct(50), "latency_ms_p90": pct(90), "latency_ms_p99": pct(99),
            "latency_ms_max": float(lat.max() * 1e3),
            "server_stats": dict(server.stats),
        }
        print(json.dumps(summary, indent=2), flush=True)
        summary["contamination"] = replay_check(model, results, hop_samples, hop_frames, check_sessions)
    finally:
        server.stop()
        if not any(t.is_alive() for t in live):  # a live client's socket would hold term() forever
            zctx.term()
    diffs = summary["contamination"]["per_session"]
    # a check that examined nothing makes no claim
    summary["contamination_ok"] = (None if not diffs and check_sessions > 0
                                   else all(d["max_abs_diff"] < CONTAMINATION_BAR for d in diffs))
    return summary


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="churn soak of the stream server over ZMQ (PyTorch port)")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--hop_frames", type=int, default=2, help="frames per hop (2 = 40 ms hops)")
    ap.add_argument("--pace", type=float, default=1.0, help="pacing scale (>1 = slower than real time)")
    ap.add_argument("--port", type=int, default=0, help="the server's port (0: one the OS picks)")
    ap.add_argument("--check_sessions", type=int, default=24, help="max clean underrun-free sessions to replay solo")
    ap.add_argument("--max_wait_ms", type=float, default=15.0,
                    help="cohort deadline before a tick advances missing slots with silence; for slowed pacing "
                         "(--pace > 1) set >= pace * hop so that cohort ticks wait for every client")
    ap.add_argument("--session_timeout", type=float, default=30.0, help="idle-eviction timeout, s")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "soak_churn.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    args = get_parser().parse_args(argv)
    model = VapModel(VapConfig(), device=args.device)
    summary = churn_soak(model, args.streams, args.duration, args.hop_frames, args.pace, args.port,
                         args.check_sessions, args.max_wait_ms, args.session_timeout, args.seed)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    ok = summary["contamination_ok"]
    print(f"-> {args.out}  contamination_ok={ok}", flush=True)
    if ok is None and args.check_sessions > 0:
        print("WARNING: contamination check had zero eligible sessions — no pass/fail claim made", flush=True)
    return 1 if ok is False else 0


if __name__ == "__main__":
    sys.exit(main())

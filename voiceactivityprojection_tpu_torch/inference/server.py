"""Serving over ZMQ: micro-batched one-shot requests and live dialog streams.

Counterpart of ``voiceactivityprojection_tpu/inference/server.py``, with
the same wire protocol byte for byte, so a client of either package talks
to a server of the other. Transport is ZMQ ROUTER/DEALER; a request or
reply is multipart [header JSON, float32 bytes].

* ``VapServer`` (batch mode) pads each request of up to ``chunk_time`` to
  that length, fills a (batch_size, 2, n) batch until it is full or
  ``max_wait_ms`` after its first request, and runs ``VapModel.probs`` on
  it (on the card the inference kernels: K1 x 5, K2, K4 x 14), in the
  model's compute dtype. Longer requests get an error reply.
* ``VapStreamServer`` (stream mode) holds up to ``streams`` live sessions
  on a ``BatchedKVStreamer`` (float32) and advances all of them one hop per
  tick. A tick fires when every session has a pending chunk, or
  ``max_wait_ms`` after the first one arrived; a session without a chunk
  is advanced with silence and counted (``stats["underruns"]``, and its
  slot's count in the close reply). Chunks wait in a FIFO per slot, so a
  client that pushes twice within one tick loses no audio.

Threads: each server receives on one thread and runs the model on another
(the tick thread). Every operation on a socket (poll, recv, send) goes
through that socket's one lock: libzmq aborts the process, rather than
raising, when two threads use one socket. The tick thread alone touches the
streamer: a slot opened by the receiver is queued in ``_resets`` and reset
by the next tick before its first chunk is consumed. The tick fetches its
outputs to the host once (``_to_host``: one ``torch.cat`` of the raveled
outputs, one ``.cpu()``).

``zmq`` is imported only inside the functions that open sockets, as in JAX
(:108). ``port=0`` binds a port the OS picks; ``self.port`` holds the port
bound.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _join_serve_thread(t: Optional[threading.Thread]) -> None:
    """Wait for a ``start()`` thread's socket and context teardown:
    returning from ``stop()`` while the thread is inside ``ctx.term()``
    aborts the process at interpreter exit."""
    if t is not None and t is not threading.current_thread() and t.is_alive():
        t.join(timeout=5)


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every output on the host as float32, in one device-to-host copy."""
    keys = list(out)
    packed = torch.cat([out[k].float().reshape(-1) for k in keys]).cpu().numpy()
    host, off = {}, 0
    for k in keys:
        size = out[k].numel()
        host[k] = packed[off:off + size].reshape(tuple(out[k].shape))
        off += size
    return host


def _bind(sock, port: int, ready_event: Optional[threading.Event], owner) -> int:
    """Bind a ROUTER socket; on failure record the error for ``start()``,
    release the socket's context and raise."""
    import zmq

    try:
        sock.bind(f"tcp://*:{port}")
    except Exception as e:
        # surface the failure to start(): a silently dead server leaves
        # clients talking to whatever owns the port
        owner._serve_error = e
        if ready_event is not None:
            ready_event.set()
        ctx = sock.context
        sock.close(0)  # before ctx.term(), which waits for every socket
        ctx.term()
        raise
    return int(sock.getsockopt_string(zmq.LAST_ENDPOINT).rsplit(":", 1)[1])


def _start(owner, port: int, what: str) -> threading.Thread:
    ready = threading.Event()
    owner._serve_error = None
    t = threading.Thread(target=owner.serve, args=(port, ready), daemon=True)
    owner._thread = t
    t.start()
    ok = ready.wait(timeout=30)
    if owner._serve_error is not None:
        raise RuntimeError(f"{what} failed to start on port {port}") from owner._serve_error
    if not ok:
        raise RuntimeError(f"{what} did not become ready on port {port} within 30s")
    return t


def _pack(res: Dict[str, np.ndarray]) -> bytes:
    return b"".join(np.ascontiguousarray(res[k], dtype=np.float32).tobytes() for k in res)


class _Request:
    __slots__ = ("ident", "req_id", "waveform", "n_frames")

    def __init__(self, ident, req_id, waveform, n_frames):
        self.ident = ident
        self.req_id = req_id
        self.waveform = waveform
        self.n_frames = n_frames


class VapServer:
    """Micro-batched one-shot requests (JAX: server.py:48-232)."""

    def __init__(
        self,
        model,
        batch_size: int = 16,
        chunk_time: float = 20.0,
        max_wait_ms: float = 25.0,
        outputs: tuple = ("p_now", "p_future", "vad", "H"),
    ):
        self.model = model
        self.batch_size = batch_size
        self.sample_rate = model.conf.sample_rate
        self.frame_hz = model.conf.frame_hz
        self.n_samples = int(chunk_time * self.sample_rate)
        self.max_wait_s = max_wait_ms / 1000.0
        self.outputs = outputs
        self.queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "batch_fill_sum": 0}
        self.port: Optional[int] = None

    def _run_batch(self, batch: List[_Request]) -> List[Dict[str, np.ndarray]]:
        stacked = np.zeros((self.batch_size, 2, self.n_samples), dtype=np.float32)
        for i, r in enumerate(batch):
            stacked[i] = r.waveform
        out = self.model.probs(torch.from_numpy(stacked))
        out = _to_host({k: v for k, v in out.items() if k in self.outputs})
        results = [{k: v[i, : r.n_frames] for k, v in out.items()} for i, r in enumerate(batch)]
        self.stats["batches"] += 1
        self.stats["batch_fill_sum"] += len(batch)
        return results

    def _collect_batch(self) -> List[_Request]:
        """Block for the first request, then fill until full or the deadline."""
        first = self.queue.get()
        if first is None:  # the shutdown sentinel
            return []
        batch = [first]
        deadline = time.time() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                nxt = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def serve(self, port: int = 5590, ready_event: Optional[threading.Event] = None):
        import zmq

        ctx = zmq.Context()
        sock = ctx.socket(zmq.ROUTER)
        self.port = _bind(sock, port, ready_event, self)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        sock_lock = threading.Lock()  # every operation on the socket
        if ready_event is not None:
            ready_event.set()

        def receiver():
            while not self._stop.is_set():
                try:
                    with sock_lock:
                        ready = dict(poller.poll(timeout=0))
                        frames = sock.recv_multipart() if ready else None
                    if frames is None:
                        time.sleep(0.002)  # poll outside the lock: replies interleave
                        continue
                except zmq.ZMQError:
                    return  # the socket closed during shutdown
                try:
                    # a malformed request (frame count, JSON, payload size)
                    # gets an error reply and leaves the receiver running
                    ident, header, payload = frames
                    h = json.loads(header)
                    wf = np.frombuffer(payload, dtype=np.float32).reshape(h["shape"])
                except Exception as e:
                    if frames:
                        reply = {"req_id": None, "error": f"malformed request: {e}"}
                        with sock_lock:
                            sock.send_multipart([frames[0], json.dumps(reply).encode(), b""])
                    continue
                if wf.ndim != 2 or wf.shape[0] != 2 or wf.shape[1] > self.n_samples:
                    reply = {"req_id": h.get("req_id"),
                             "error": f"expected (2, <= {self.n_samples}), got {list(wf.shape)}"}
                    with sock_lock:
                        sock.send_multipart([ident, json.dumps(reply).encode(), b""])
                    continue
                n_frames = int(wf.shape[1] / self.sample_rate * self.frame_hz)
                padded = np.zeros((2, self.n_samples), dtype=np.float32)
                padded[:, : wf.shape[1]] = wf
                self.queue.put(_Request(ident, h.get("req_id"), padded, n_frames))
                self.stats["requests"] += 1

        rt = threading.Thread(target=receiver, daemon=True)
        rt.start()
        try:
            while not self._stop.is_set():
                batch = self._collect_batch()
                if not batch:
                    continue
                for r, res in zip(batch, self._run_batch(batch)):
                    header = {"req_id": r.req_id, "keys": list(res),
                              "shapes": {k: list(v.shape) for k, v in res.items()}}
                    with sock_lock:
                        sock.send_multipart([r.ident, json.dumps(header).encode(), _pack(res)])
        finally:
            self._stop.set()
            rt.join(timeout=2)
            sock.close(0)
            ctx.term()

    def start(self, port: int = 5590) -> threading.Thread:
        return _start(self, port, "server")

    def stop(self):
        self._stop.set()
        self.queue.put(None)
        _join_serve_thread(getattr(self, "_thread", None))


class VapStreamServer:
    """Live dialog sessions on one device (JAX: server.py:235-543).

    Protocol (ROUTER, multipart [ident, header JSON, payload]):

      {"op": "open"}                 -> {"session": i, "hop_samples": n}
      {"op": "push", "session": i} + (2, hop_samples) float32 bytes
                                     -> {"keys", "shapes"} + the outputs of
                                        that session's NEW frames
      {"op": "close", "session": i}  -> {"closed": i, "underruns": u}

    A reopened slot restarts its encoder rows from zeros at the steady tail
    lengths (``ExactStreamingEncoder.reset_rows``), where a fresh stream
    primes from the symmetric padding and emits its first frame one push
    later: a recycled session's first ~0.12 s of features (one conv
    receptive field) differ from a solo run's, then agree. Its K/V state
    restarts exactly. A session silent for ``session_timeout_s`` is evicted.
    """

    def __init__(
        self,
        model,
        streams: int = 16,
        context_time: float = 20.0,
        hop_frames: int = 1,
        max_wait_ms: float = 15.0,
        outputs: tuple = ("p_now", "p_future", "vad", "H"),
        session_timeout_s: Optional[float] = 60.0,
    ):
        from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer

        self.model = model
        self.streams = streams
        self.streamer = BatchedKVStreamer(model, streams=streams, context_time=context_time, hop_frames=hop_frames)
        self.hop_samples = self.streamer.hop_samples
        self.max_wait_s = max_wait_ms / 1000.0
        self.outputs = outputs
        self.session_timeout_s = session_timeout_s
        self.sessions: Dict[int, bytes] = {}  # slot -> client ident
        # slot -> FIFO of (req_id, chunk): chunks beyond one a tick wait for
        # the next ticks, and every req_id gets its reply
        self.pending: Dict[int, List[tuple]] = {}
        self.last_seen: Dict[int, float] = {}  # slot -> time of its last open or push
        # slots to recycle, reset by the tick thread before it touches the
        # streamer (a reset from the receiver would race the tick)
        self._resets: set = set()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self.stats = {"ticks": 0, "pushes": 0, "underruns": 0, "evictions": 0}
        # slot -> silence advances while its session held it (close reply)
        self.slot_underruns: Dict[int, int] = {}
        self.port: Optional[int] = None

    def _tick(self) -> Dict[int, tuple]:
        """Advance every slot one hop; returns {slot: (req_id, owner,
        outputs)}, ``owner`` the client that held the slot when its chunk
        was taken: replies go to it, not to whoever holds the slot at send
        time."""
        with self._lock:
            resets = list(self._resets)
            self._resets.clear()
            todo = {}
            for slot, fifo in list(self.pending.items()):
                req_id, chunk = fifo.pop(0)
                todo[slot] = (req_id, self.sessions.get(slot), chunk)
                if not fifo:
                    del self.pending[slot]
            if self.pending:
                self._work.set()  # chunks remain queued: tick again
            active = dict(self.sessions)
        for slot in resets:
            self.streamer.reset_stream(slot)
        chunks = np.zeros((self.streams, 2, self.hop_samples), dtype=np.float32)
        for slot, (_, _, chunk) in todo.items():
            chunks[slot] = chunk
        missed = [slot for slot in active if slot not in todo]
        self.stats["underruns"] += len(missed)
        with self._lock:
            for slot in missed:
                self.slot_underruns[slot] = self.slot_underruns.get(slot, 0) + 1
        out = self.streamer.push(torch.from_numpy(chunks))
        out = _to_host({k: v for k, v in out.items() if k in self.outputs})
        self.stats["ticks"] += 1
        return {slot: (req_id, owner, {k: v[:, slot] for k, v in out.items()})
                for slot, (req_id, owner, _) in todo.items()}

    def _evict_idle(self) -> None:
        """Reclaim the slots of clients that stopped pushing without a close."""
        if self.session_timeout_s is None:
            return
        cutoff = time.time() - self.session_timeout_s
        with self._lock:
            for s in [s for s, t in self.last_seen.items() if t < cutoff]:
                self.sessions.pop(s, None)
                self.pending.pop(s, None)
                self.last_seen.pop(s, None)
                self.stats["evictions"] += 1

    def serve(self, port: int = 5595, ready_event: Optional[threading.Event] = None):
        import zmq

        self.streamer.reset()
        ctx = zmq.Context()
        sock = ctx.socket(zmq.ROUTER)
        self.port = _bind(sock, port, ready_event, self)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        sock_lock = threading.Lock()  # every operation on the socket
        if ready_event is not None:
            ready_event.set()

        def reply(ident, header: dict, payload: bytes = b""):
            with sock_lock:
                sock.send_multipart([ident, json.dumps(header).encode(), payload])

        def receiver():
            while not self._stop.is_set():
                try:
                    with sock_lock:
                        ready = dict(poller.poll(timeout=0))
                        frames = sock.recv_multipart() if ready else None
                    if frames is None:
                        time.sleep(0.002)  # poll outside the lock: replies interleave
                        continue
                    ident, header, payload = frames
                except (zmq.ZMQError, ValueError):
                    if self._stop.is_set():
                        return
                    continue
                try:
                    h = json.loads(header)
                    op = h.get("op")
                    if op == "open":
                        with self._lock:
                            free = [i for i in range(self.streams) if i not in self.sessions]
                            if not free:
                                reply(ident, {"req_id": h.get("req_id"), "error": "no free stream slots"})
                                continue
                            slot = free[0]
                            self.sessions[slot] = ident
                            self.last_seen[slot] = time.time()
                            self.slot_underruns[slot] = 0
                            self._resets.add(slot)  # reset by the tick thread
                        reply(ident, {"req_id": h.get("req_id"), "session": slot,
                                      "hop_samples": self.hop_samples})
                    elif op == "push":
                        slot = int(h["session"])
                        chunk = np.frombuffer(payload, dtype=np.float32).reshape(2, self.hop_samples)
                        with self._lock:
                            if self.sessions.get(slot) != ident:
                                reply(ident, {"req_id": h.get("req_id"), "error": f"session {slot} not yours"})
                                continue
                            self.pending.setdefault(slot, []).append((h.get("req_id"), chunk))
                            self.last_seen[slot] = time.time()
                        self.stats["pushes"] += 1
                        self._work.set()
                    elif op == "close":
                        slot = int(h["session"])
                        with self._lock:
                            self.sessions.pop(slot, None)
                            self.pending.pop(slot, None)
                            self.last_seen.pop(slot, None)
                            underruns = self.slot_underruns.pop(slot, 0)
                        reply(ident, {"req_id": h.get("req_id"), "closed": slot, "underruns": underruns})
                    else:
                        reply(ident, {"req_id": h.get("req_id"), "error": f"unknown op {op!r}"})
                except Exception as e:  # one bad packet must not stop the serving
                    reply(ident, {"req_id": None, "error": f"malformed: {e}"})

        rt = threading.Thread(target=receiver, daemon=True)
        rt.start()
        try:
            while not self._stop.is_set():
                self._evict_idle()
                if not self._work.wait(timeout=0.05):
                    continue
                # the deadline: let the rest of the cohort arrive
                deadline = time.time() + self.max_wait_s
                while time.time() < deadline:
                    with self._lock:
                        if self.sessions and len(self.pending) >= len(self.sessions):
                            break
                    time.sleep(0.001)
                self._work.clear()
                with self._lock:
                    if not self.pending:
                        continue  # a spurious wake: never tick on silence alone
                for slot, (req_id, owner, res) in self._tick().items():
                    header = {"req_id": req_id, "session": slot, "keys": list(res),
                              "shapes": {k: list(v.shape) for k, v in res.items()}}
                    # the owner when the chunk was taken; dropped if the slot
                    # changed hands (closed, evicted, reopened) since
                    with self._lock:
                        still_owns = self.sessions.get(slot) == owner
                    if owner is not None and still_owns:
                        reply(owner, header, _pack(res))
        finally:
            self._stop.set()
            rt.join(timeout=2)
            sock.close(0)
            ctx.term()

    def start(self, port: int = 5595) -> threading.Thread:
        return _start(self, port, "stream server")

    def stop(self):
        self._stop.set()
        self._work.set()
        _join_serve_thread(getattr(self, "_thread", None))


def _decode_payload(h: dict, payload: bytes) -> Dict[str, np.ndarray]:
    """A reply's packed float32 payload by its header's keys and shapes."""
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for k in h["keys"]:
        shape = h["shapes"][k]
        size = int(np.prod(shape))
        out[k] = np.frombuffer(payload, dtype=np.float32, count=size, offset=offset * 4).reshape(shape)
        offset += size
    return out


def _recv_matching(sock, req_id, stale_plausible: bool = False):
    """Receive until the reply to ``req_id``; replies to an earlier request
    that timed out are dropped. An error reply with req_id None (a
    malformed request) is dropped as stale only under ``stale_plausible``
    (a previous call on this socket timed out); otherwise it is this
    request's and raises ``ValueError``."""
    import logging

    while True:
        parts = sock.recv_multipart()
        h = json.loads(parts[0])
        got = h.get("req_id")
        if got is not None and req_id is not None and got != req_id:
            continue
        if "error" in h:
            if got is None and req_id is not None and stale_plausible:
                logging.getLogger(__name__).warning("discarding stale error reply: %s", h["error"])
                continue
            raise ValueError(h["error"])
        return h, (parts[1] if len(parts) > 1 else b"")


class _Client:
    """A DEALER socket with request ids; a receive that times out marks
    later stale replies as plausible."""

    def __init__(self, port: int, host: str, timeout_s: float, ctx=None):
        import zmq

        self._own_ctx = ctx is None
        self.ctx = ctx if ctx is not None else zmq.Context()
        self.sock = self.ctx.socket(zmq.DEALER)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.connect(f"tcp://{host}:{port}")
        self.sock.setsockopt(zmq.RCVTIMEO, int(timeout_s * 1000))
        self._next_id = 0
        self._had_timeout = False

    def _request(self, header: dict, payload: bytes = b""):
        """Send ``header`` with this request's id (in its ``req_id`` slot
        where it has one, else last: the JAX clients' key order) and
        ``payload``; returns the matching reply."""
        import zmq

        req_id = self._next_id
        self._next_id += 1
        header["req_id"] = req_id
        self.sock.send_multipart([json.dumps(header).encode(), payload])
        try:
            return _recv_matching(self.sock, req_id, stale_plausible=self._had_timeout)
        except zmq.Again:
            self._had_timeout = True  # its reply may still arrive
            raise

    def _close_socket(self) -> None:
        self.sock.close(0)
        if self._own_ctx:
            self.ctx.term()


class VapStreamClient(_Client):
    """Client of ``VapStreamServer``: open a session, push hops, read each
    hop's outputs for the new frames. ``ctx`` shares one ``zmq.Context``
    among many clients: a harness with many clients must share one (rapid
    creation and termination of contexts aborts inside libzmq)."""

    def __init__(self, port: int = 5595, host: str = "localhost", timeout_s: float = 60.0, ctx=None):
        super().__init__(port, host, timeout_s, ctx)
        self.session: Optional[int] = None
        self.hop_samples: Optional[int] = None

    def open(self) -> int:
        h, _ = self._request({"op": "open"}, b"")
        self.session = int(h["session"])
        self.hop_samples = int(h["hop_samples"])
        return self.session

    def push(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        chunk = np.ascontiguousarray(chunk, dtype=np.float32)
        h, payload = self._request({"op": "push", "session": self.session}, chunk.tobytes())
        return _decode_payload(h, payload)

    def close(self) -> Optional[dict]:
        """Close the session and the socket; returns the server's close
        reply (``underruns``: silence advances while the session held its
        slot), or None if the handshake failed."""
        import zmq

        reply_h = None
        if self.session is not None:
            try:
                reply_h, _ = self._request({"op": "close", "session": self.session}, b"")
            except (zmq.ZMQError, ValueError):  # a timeout or an error reply: the socket closes below
                pass
            self.session = None
        self._close_socket()
        return reply_h


class VapClient(_Client):
    """Client of ``VapServer``: one (2, n) float32 waveform a request."""

    def __init__(self, port: int = 5590, host: str = "localhost", timeout_s: float = 60.0, ctx=None):
        super().__init__(port, host, timeout_s, ctx)

    def infer(self, waveform: np.ndarray) -> Dict[str, np.ndarray]:
        waveform = np.ascontiguousarray(waveform, dtype=np.float32)
        h, payload = self._request({"req_id": None, "shape": list(waveform.shape)}, waveform.tobytes())
        return _decode_payload(h, payload)

    def close(self) -> None:
        self._close_socket()

"""Profiling, the program's spans and counters, and tensor statistics
(JAX: utils/profiling.py).

* ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
  (the CPU, and the card where there is one) that writes a Chrome-format
  trace (``*.pt.trace.json``) into ``log_dir``, which TensorBoard's
  profiler plugin and Perfetto load.
* ``span(name)``, ``count(name, n)``: the program's layer boundaries and
  counters. They record only while a ``torch.profiler`` session is active
  or ``recording()`` is open; otherwise a span is one flag check and a
  shared no-op context, and a count returns at once. A recorded span is a
  host operation in the profiler's trace, on its clock (so it names the
  trace's host gaps), and a record in a bounded list: its name, id, parent
  and root (the outermost span open on its thread), its host start and end,
  and on the card two CUDA events on the current stream, read as device
  time by ``spans()`` after a synchronize (on the CPU the device time is
  the host time). Counters are kept per root. ``spans()``, ``counters()``
  and ``clear()`` read and drop what was recorded. ``suspended()`` turns
  both off on its thread (a CUDA graph's capture records no event).
* ``tree_stats``, ``activation_stats``, ``gradient_stats``: mean, std,
  largest magnitude, share of zeros and a histogram of every weight,
  activation or gradient (the reference's layer-output and gradient hooks,
  analyzes/model_params_grad.py). Weights are keyed by the JAX package's
  ``/``-joined names (``ar/layers/0/mha/query/w``), which the port's
  module names follow one to one (``models/checkpoint.py``
  ``params_from_jax``); the ALiBi slopes ``m`` are buffers here and
  leaves there, and are counted with the weights.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block: ``with trace("dir"): run_step()``. The
    default directory is ``vap_trace`` in the temporary directory. On the
    card the device is synchronized before the profiler starts and again
    before it stops, so that the trace holds exactly the block's kernels,
    each finished and recorded before the profiler collects. A process that
    has already run many profiler sessions (about 16-20 of some 55,000
    events each on an H100) can lose kernel records in PyTorch's profiler
    itself, the synchronize notwithstanding (``tools/trace_sessions.py``):
    take a trace that must be whole in a fresh process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vap_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if cuda:
            torch.cuda.synchronize()


MAX_SPANS = 1 << 16  # records kept; the oldest go first
MAX_ROOTS = 1 << 14  # roots whose counters are kept

_recording = 0  # depth of open ``recording()`` blocks
_lock = threading.Lock()
_local = threading.local()  # .stack: the spans open on this thread, innermost last
_ids = itertools.count(1)
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[int, Dict[str, int]] = {}
_free_events: Dict[int, List[tuple]] = {}  # by card: pairs of timing events that ``clear()`` released


@dataclass(frozen=True)
class Span:
    """A closed span as ``spans()`` reads it. ``parent`` is None for a
    root; ``root`` is the id of the outermost span open on its thread (its
    own for a root). ``device_ms`` is the time between the span's two CUDA
    events on its stream (the host time where it recorded none)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    host_start_ns: int
    host_end_ns: int
    device_ms: float

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event_pair(device: int) -> tuple:
    """Two timing events on card ``device``, reused where ``clear()``
    released some: creating and destroying them costs more than recording."""
    try:
        return _free_events[device].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Record:
    """An open or closed span, the context manager ``span()`` returns."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "device", "stream", "events",
                 "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        self.thread = threading.get_ident()
        self.end_ns = None
        # not record_function: its user annotation is mirrored onto the
        # device timeline (``gpu_user_annotation``), where a reader of the
        # device's operations would take the span for a kernel
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            # both events go on the stream the span began on
            self.device = torch.cuda.current_device()
            self.stream = torch.cuda.current_stream(self.device)
            self.events = _event_pair(self.device)
            self.events[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        _records.append(self)

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


def _off() -> bool:
    return not (_recording or _autograd_profiler._is_profiler_enabled) or getattr(_local, "suspended", 0) > 0


def span(name: str):
    """A named layer boundary, ``with span("vap.encoder"): ...``: recorded
    only under a profiler or ``recording()``, outside ``suspended()``."""
    if not (_recording or _autograd_profiler._is_profiler_enabled) or getattr(_local, "suspended", 0):
        return _NO_SPAN
    return _Record(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the root span open on this thread
    (root 0 outside any span), under a profiler or ``recording()``, outside
    ``suspended()``."""
    if _off():
        return
    stack = _stack()
    root = stack[0].root if stack else 0
    with _lock:
        per_root = _counters.get(root)
        if per_root is None:
            if len(_counters) >= MAX_ROOTS:
                del _counters[next(iter(_counters))]
            per_root = _counters[root] = {}
        per_root[name] = per_root.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record spans and counters in the enclosed block without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


@contextlib.contextmanager
def suspended():
    """Record no span or counter on this thread in the enclosed block."""
    _local.suspended = getattr(_local, "suspended", 0) + 1
    try:
        yield
    finally:
        _local.suspended -= 1


def spans() -> List[Span]:
    """The closed spans recorded, in the order they opened; on the card
    each waits for its end event."""
    out = []
    for r in list(_records):
        if r.end_ns is None:
            continue
        ms = (r.end_ns - r.start_ns) * 1e-6
        if r.events is not None:
            start, end = r.events
            end.synchronize()
            ms = start.elapsed_time(end)
        out.append(Span(r.name, r.id, r.parent, r.root, r.thread, r.start_ns, r.end_ns, ms))
    return out


def counters() -> Dict[int, Dict[str, int]]:
    """{root id: {counter: total}}, root 0 for counts outside any span."""
    with _lock:
        return {root: dict(c) for root, c in _counters.items()}


def clear() -> None:
    """Drop every record and counter; the closed spans' events are kept
    for reuse. Spans still open on a thread keep their place on its stack."""
    with _lock:
        for r in _records:
            if r.end_ns is not None and r.events is not None:
                _free_events.setdefault(r.device, []).append(r.events)
        _records.clear()
        _counters.clear()


def count_h2d(x) -> None:
    """Count under ``h2d_bytes`` what moving ``x`` to the model's device
    reads out of host memory: a host array's or CPU tensor's bytes, none
    of a tensor already on a card. Call it where the program hands host
    data to the device; on a CPU device the same sites count the same
    bytes, though nothing moves."""
    if _off():
        return
    if isinstance(x, torch.Tensor):
        n = x.numel() * x.element_size() if x.device.type == "cpu" else 0
    else:
        n = int(getattr(x, "nbytes", 0))
    count("h2d_bytes", n)


def _leaf_stats(x, bins: int) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, dtype=np.float64).ravel()
    hist, edges = np.histogram(x, bins=bins)
    return {
        "mean": float(x.mean()),
        "std": float(x.std()),
        "absmax": float(np.abs(x).max()),
        "frac_zero": float((x == 0).mean()),
        "hist": hist.tolist(),
        "bin_edges": edges.tolist(),
    }


def _named(tree: Any, prefix: str = ""):
    """(name, tensor) pairs of a module (its weights and buffers), or of a
    nested dict / list of tensors or arrays, the names ``/``-joined."""
    if isinstance(tree, torch.nn.Module):
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            yield prefix + name.replace(".", "/"), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_stats(tree: Any, bins: int = 30, prefix: str = "") -> Dict[str, Dict]:
    """Statistics of every weight, activation or gradient of ``tree`` (a
    module, or a nested dict / list of tensors or arrays), by name."""
    return {name: _leaf_stats(t, bins) for name, t in _named(tree, prefix)}


def activation_stats(model, waveform, layer_outputs: bool = True, bins: int = 30) -> Dict[str, Dict]:
    """The stereo ``model``'s (a ``VapModel``) stages on ``waveform`` (B, 2,
    n), on its device: the encoder features of each channel, the channel
    GPT's outputs, the stereo GPT's output and the logits."""
    from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder
    from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo

    conf, net = model.conf, model.net
    with torch.inference_mode():
        w = model._input(waveform)
        B = w.shape[0]
        z = apply_encoder(net.encoder, w.reshape(B * 2, w.shape[-1])).reshape(B, 2, -1, conf.dim)
        x1, x2 = z[:, 0], z[:, 1]
        acts = {"encoder_x1": x1, "encoder_x2": x2}
        o1 = apply_gpt(net.ar_channel, x1, num_heads=conf.num_heads)["x"]
        o2 = apply_gpt(net.ar_channel, x2, num_heads=conf.num_heads)["x"]
        acts["ar_channel_x1"], acts["ar_channel_x2"] = o1, o2
        out = apply_gpt_stereo(net.ar, o1, o2, num_heads=conf.num_heads)
        acts["ar_x"] = out["x"]
        acts["logits"] = out["x"] @ net.vap_head.w.T + net.vap_head.b
        return {k: _leaf_stats(v, bins) for k, v in acts.items()}


def gradient_stats(model, batch: Dict[str, Any], bins: int = 30) -> Dict[str, Dict]:
    """Statistics of the multitask loss's gradient (``train/step.loss_fn``,
    no dropout) with respect to every weight of the stereo ``model``, keyed
    ``grad/<name>``; a weight that takes no gradient (the frozen encoder,
    the slopes) counts as zeros, as JAX's gradient of it is. The loss runs
    the training forward at rate 0: the inference forward's GRU +
    downsample kernel has no backward. The model's weights and gradients
    are left as they were."""
    import dataclasses

    from voiceactivityprojection_tpu_torch.train.step import loss_fn

    net = model.net
    tensors = {k: model._input(v) for k, v in batch.items()}
    saved = {n: p.grad for n, p in net.named_parameters()}
    try:
        for p in net.parameters():
            p.grad = None
        with torch.enable_grad():
            loss, _ = loss_fn(net, tensors, dataclasses.replace(model.conf, dropout=0.0), torch.Generator())
            loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in net.named_parameters()}
        grads.update({n: torch.zeros_like(b) for n, b in net.named_buffers()})
        return {"grad/" + n.replace(".", "/"): _leaf_stats(g, bins) for n, g in grads.items()}
    finally:
        for n, p in net.named_parameters():
            p.grad = saved[n]

"""The port's spans and counters (``utils/profiling.py`` ``span``,
``count``): nothing recorded and the outputs unchanged while off; under a
profiler the span tree of ``VapModel.probs``, the frozen train step, the
CPC step and ``BatchedKVStreamer.push``, one root a call; ``h2d_bytes``
against hand values; one parent stack a thread; the benchmark's span
metrics read from a traced ``harness.run_cell`` of each cell at a small
size; and on the card, the spans' device times inside their root's and
no span on the device's timeline."""

import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer
from voiceactivityprojection_tpu_torch.models.encoder import Encoder
from voiceactivityprojection_tpu_torch.models.vap import VapModel, VapNet
from voiceactivityprojection_tpu_torch.train import cpc_pretrain
from voiceactivityprojection_tpu_torch.train.step import make_optimizer, make_train_step
from voiceactivityprojection_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vapbench import harness  # noqa: E402
from vapbench.tests.conftest import TINY  # noqa: E402

pytestmark = pytest.mark.model

KW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
N_SAMPLES = 3200  # 10 frames at 50 Hz
FORWARD = ["vap.encoder", "vap.gpt_channel", "vap.gpt_cross", "vap.heads"]


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def model():
    return VapModel(VapConfig(**KW), device="cpu")


def _wave(B=2, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, 2, N_SAMPLES))).astype(np.float32)


def _profiled(fn, calls=2):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    return prof


def _tree(root_name):
    """[(name, parent's name)] under each root named ``root_name``, in
    order, checking that every span of a call carries the call's root."""
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert roots and all(r.name == root_name and r.root == r.id for r in roots)
    trees = []
    for r in roots:
        under = [s for s in spans if s.root == r.id and s is not r]
        for s in under:
            assert s.parent in by_id and by_id[s.parent].root == r.id
            assert s.host_start_ns >= r.host_start_ns and s.host_end_ns <= r.host_end_ns
        trees.append([(s.name, by_id[s.parent].name) for s in under])
    return trees


# ------------------------------------------------------------------- off --
def test_off_records_nothing_and_shares_one_context():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        profiling.count("h2d_bytes", 8)
    profiling.count_h2d(np.zeros(4, np.float32))
    assert profiling.spans() == [] and profiling.counters() == {}


def test_probs_are_bit_identical_with_and_without_recording(model):
    w = _wave()
    off = model.probs(w)
    assert profiling.spans() == []
    with profiling.recording():
        on = model.probs(w)
    assert profiling.spans()
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_recording_nests_and_ends():
    with profiling.recording():
        with profiling.recording():
            with profiling.span("inner"):
                pass
        with profiling.span("outer"):
            pass
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.spans()] == ["inner", "outer"]


# ------------------------------------------------------------- the trees --
def test_probs_span_tree(model):
    w = _wave()
    prof = _profiled(lambda: model.probs(w))
    trees = _tree("vap.probs")
    assert len(trees) == 2
    want = [(n, "vap.probs") for n in FORWARD + ["vap.probs_from_logits"]]
    assert all(t == want for t in trees)
    # each span is a host operation in the profiler's own events, not a user annotation
    events = [e for e in prof.events() if e.name.startswith("vap.")]
    assert Counter(e.name for e in events)["vap.probs"] == 2
    assert not any(e.is_user_annotation for e in events)
    # the waveform came from host memory, per call
    assert [c["h2d_bytes"] for c in profiling.counters().values()] == [w.nbytes, w.nbytes]


def test_frozen_train_step_span_tree():
    conf = VapConfig(**KW)
    net = VapNet(conf)
    opt = make_optimizer(OptConfig(), net, conf.freeze_encoder)
    step = make_train_step(conf, opt)
    rng = np.random.default_rng(1)
    batch = {"waveform": torch.from_numpy(_wave(seed=1)),
             "vad": torch.from_numpy((rng.random((2, 10 + conf.horizon_frames, 2)) < 0.5).astype(np.float32))}
    _profiled(lambda: step(net, batch, torch.Generator().manual_seed(0)))
    trees = _tree("train.step")
    want = ([("train.forward", "train.step")] + [(n, "train.forward") for n in FORWARD]
            + [("train.backward", "train.step"), ("train.optimizer", "train.step")])
    assert trees == [want, want]
    nbytes = sum(v.numel() * v.element_size() for v in batch.values())
    assert [c["h2d_bytes"] for c in profiling.counters().values()] == [nbytes, nbytes]


def _cpc_state(n_predicts=3, dim=16):
    enc = Encoder(dim)
    heads = cpc_pretrain.init_cpc_heads(torch.Generator().manual_seed(0), n_predicts, dim, dim)
    return cpc_pretrain.init_cpc_train_state(enc, heads, device="cpu")


def test_cpc_step_span_tree_and_negatives_bytes():
    K, N, B = 3, 5, 2
    state = _cpc_state(K)
    step = cpc_pretrain.make_cpc_train_step(K, N)
    wave = torch.from_numpy(_wave(B, seed=2)[:, 0].copy())
    _profiled(lambda: step(state, wave, torch.Generator().manual_seed(3)))
    trees = _tree("train.step")
    want = [(n, "train.step") for n in ("cpc.negatives", "cpc.encoder", "cpc.negatives_h2d", "cpc.loss",
                                        "train.backward", "train.optimizer")]
    assert trees == [want, want]
    T = cpc_pretrain.encoded_frames(N_SAMPLES)
    hand = B * (T - K) * N * 8  # int64 indices (B, Tc, N)
    assert hand == 1360
    assert [c["h2d_bytes"] for c in profiling.counters().values()] == [hand, hand]


@pytest.mark.parametrize("hop_frames", [1, 2])
def test_batched_push_span_tree_and_chunk_bytes(model, hop_frames):
    S = 3
    b = BatchedKVStreamer(model, streams=S, context_time=0.2, hop_frames=hop_frames)
    chunk = (0.1 * np.random.default_rng(4).standard_normal((S, 2, 320 * hop_frames))).astype(np.float32)
    b.push(chunk)  # the first push builds the state, outside the profile
    profiling.clear()
    _profiled(lambda: b.push(chunk))
    trees = _tree("kv.push")
    layers = model.conf.channel_layers + model.conf.cross_layers
    frame = [("kv.layer", "kv.push")] * layers + [("kv.heads", "kv.push")]
    want = [("kv.h2d", "kv.push"), ("kv.encoder", "kv.push")] + frame * hop_frames
    assert trees == [want, want]
    assert [c["h2d_bytes"] for c in profiling.counters().values()] == [S * 2 * 320 * hop_frames * 4] * 2


def test_single_stream_push_counts_its_chunk(model):
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap

    s = KVStreamingVap(model, context_time=0.2)
    chunk = np.zeros((2, 320), np.float32)
    s.push(chunk)
    with profiling.recording():
        s.push(chunk)
    names = [x.name for x in profiling.spans()]
    assert names[:3] == ["kv.push", "kv.h2d", "kv.encoder"]
    assert list(profiling.counters().values()) == [{"h2d_bytes": chunk.nbytes}]


def test_a_tensor_on_the_device_counts_no_bytes():
    with profiling.recording(), profiling.span("root"):
        profiling.count_h2d(torch.zeros(4, device="meta"))
        profiling.count_h2d(torch.zeros(4, dtype=torch.float64))
    assert list(profiling.counters().values()) == [{"h2d_bytes": 32}]


def test_counts_outside_a_span_go_to_root_0():
    with profiling.recording():
        profiling.count("n", 2)
        with profiling.span("a"):
            profiling.count("n", 5)
    (root,) = [s.id for s in profiling.spans()]
    assert profiling.counters() == {0: {"n": 2}, root: {"n": 5}}


def test_two_threads_keep_their_own_parents():
    ready = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"outer.{tag}"):
            ready.wait()
            with profiling.span(f"inner.{tag}"):
                ready.wait()
                profiling.count("n", 1)

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = {s.name: s for s in profiling.spans()}
    for tag in "ab":
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.id and inner.root == outer.id
        assert outer.thread == inner.thread
    assert spans["outer.a"].thread != spans["outer.b"].thread
    assert profiling.counters() == {spans["outer.a"].id: {"n": 1}, spans["outer.b"].id: {"n": 1}}


def test_counts_from_many_threads_are_not_lost():
    """Eight threads add to one counter (outside any span: root 0) and to
    their own roots, with the interpreter switching threads often."""
    per_thread, n_threads = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                profiling.count("n", 1)
            with profiling.span("own"):
                for _ in range(per_thread):
                    profiling.count("n", 1)

        with profiling.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.counters()
    assert got.pop(0) == {"n": per_thread * n_threads}
    assert len(got) == n_threads and all(c == {"n": per_thread} for c in got.values())


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_records", profiling.collections.deque(maxlen=4))
    with profiling.recording():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]


def test_cpu_device_time_is_the_host_time():
    with profiling.recording(), profiling.span("a"):
        pass
    (s,) = profiling.spans()
    assert s.device_ms == s.host_ms >= 0


# ------------------------------------------------------- the benchmark --
SPAN_METRICS = {
    "stereo_infer_b64_20s": ["encoder_span_ms.infer", "transformer_span_ms.infer", "heads_span_ms.infer"],
    "cpc_pretrain_b32_1s": ["cpc_loss_span_ms.train", "negatives_host_ms.train", "h2d_mb.train",
                            "backward_span_ms.train", "optimizer_span_ms.train"],
    "stereo_train_frozen_b16_20s": ["backward_span_ms.train", "optimizer_span_ms.train"],
    "stereo_stream_kv_s512": ["host_enqueue_ms.stream", "kv_layers_span_ms.stream", "encoder_span_ms.stream",
                              "h2d_mb.stream"],
}


def _hand_counter(cell):
    t, m = TINY[cell]["traffic"], TINY[cell]["model"]
    if cell == "cpc_pretrain_b32_1s":
        T = cpc_pretrain.encoded_frames(m["sizeWindow"])
        return {"h2d_mb.train": t["batch"] * (T - m["nPredicts"]) * m["negativeSamplingExt"] * 8 / 1e6}
    if cell == "stereo_stream_kv_s512":
        return {"h2d_mb.stream": t["streams"] * 2 * 320 * 4 / 1e6}
    return {}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_cell_reports_its_span_metrics(cell):
    bench = harness.benchmark()
    _, layer = harness.cell_metrics(bench, cell)
    assert set(SPAN_METRICS[cell]) <= {m["name"] for m in layer if m["source"].startswith("program_")}
    ctx = harness.make_context(cell, 2 ** 31 + 11, 0.2, True, "cpu", TINY[cell])
    out = harness.run_cell(ctx, setup_clock=lambda: 1.0)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SPAN_METRICS[cell]:
        assert name in got and got[name] > 0, name
    for name, want in _hand_counter(cell).items():
        assert got[name] == pytest.approx(want, rel=1e-12), name
    # the device pass's roots: as many as the traced calls
    roots = [s for s in profiling.spans() if s.parent is None]
    assert len(roots) == ctx.profile["calls"] + max(1, ctx.profile["calls"] // 3)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from vapbench import program_spans

    ctx = harness.make_context("stereo_stream_kv_s512", 1, 0.1, True, "cpu", TINY["stereo_stream_kv_s512"])
    ctx.profile = {"calls": 3}
    assert program_spans.span_ms(ctx, "kv.push", ("kv.layer",)) is None
    assert program_spans.counter(ctx, "kv.push", "h2d_bytes") is None
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.span_ms(ctx, "kv.push", ("kv.layer",)) is None


# -------------------------------------------------------------- the card --
@pytest.mark.cuda
def test_device_times_lie_inside_the_root_and_off_the_device_timeline():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels and CUDA events run only there")
    from torch.autograd import DeviceType

    m = VapModel(VapConfig(), device="cuda")
    w = torch.from_numpy(0.1 * np.random.default_rng(5).standard_normal((2, 2, 32000)).astype(np.float32)).cuda()
    m.probs(w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m.probs(w)
        torch.cuda.synchronize()
    names = {"vap.probs", "vap.probs_from_logits", *FORWARD}
    assert not [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and e.name in names]
    assert {e.name for e in prof.events()} >= names
    spans = profiling.spans()
    (root,) = [s for s in spans if s.parent is None]
    children = [s for s in spans if s.parent == root.id]
    assert len(children) == 5 and all(s.device_ms > 0 for s in children) and root.device_ms > 0
    assert sum(s.device_ms for s in children) <= root.device_ms * 1.001
    assert list(profiling.counters().values()) == [{"h2d_bytes": 0}]

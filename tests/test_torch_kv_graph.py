"""PyTorch port: the KV streamers' frame as CUDA graphs
(``inference/streaming_kv.py`` ``_Graphs``), with the write cursor, the
encoder's state and the codebook's weights on the device.

On the CPU: the device cursor (an int64 tensor) writes the rings and reads
the attention row exactly as a host int does, across a ring wrap; the
exact encoder's state written in place gives the features of the
functional state over prime and steady pushes and after ``reset_rows``,
at fixed addresses; the codebook's weights are built once a device and
dtype; nothing records under ``profiling.suspended()``.

On the card (marked ``cuda``; they skip without one): over 60 ticks with
the prime tick, a ring wrap, a ``reset_stream(i)`` and a ``reset()`` that
reuses the graphs, the graph route's outputs equal the eager route's bit
for bit (``BatchedKVStreamer`` at S = 4 and 512, ``KVStreamingVap`` at 1
and 2 frames a hop), a tick's outputs outlive the next tick, replays count
as launches, the profiler names the rows and K3 a replayed tick, and a
device cursor outside the ring makes the row NaN. This
file imports neither JAX nor the JAX package, so it also runs without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kv_graph.py
"""

import re

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference import streaming_kv
from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer, KVStreamingVap
from voiceactivityprojection_tpu_torch.models import encoder_streaming_exact as exact
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.ops import _build, codebook
from voiceactivityprojection_tpu_torch.ops import kv_attention as k12
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

pytestmark = pytest.mark.inference

CONTEXT_S = 0.5  # 25 frames at 50 Hz: the rings wrap after 25 ticks
TICKS = 60
KEYS = ("p_now", "p_future", "vad", "H", "logits")


# ---------------------------------------------------------------- the CPU --
def test_device_cursor_writes_and_reads_as_the_host_int():
    """60 frames into 25-slot rings: ``_write_ring`` at a (1,) int64 cursor
    and the row read at it equal the slice write and the row at the int."""
    S, H, T, Dh = 3, 2, 25, 8
    g = torch.Generator().manual_seed(1)
    k_int, v_int = torch.zeros(S, 2, H, T, Dh), torch.zeros(S, 2, H, T, Dh)
    k_dev, v_dev = k_int.clone(), v_int.clone()
    steps = torch.zeros(1, dtype=torch.int64)
    n = torch.zeros(S, dtype=torch.int32)
    slopes = alibi_slopes(H).float()
    for frame in range(60):
        if frame == 40:
            n[1] = 0  # a recycled stream
        q, k, v = (torch.randn(S, 2, H, Dh, generator=g) for _ in range(3))
        n = torch.clamp(n + 1, max=T)
        pos = frame % T
        k_int[:, :, :, pos] = k
        v_int[:, :, :, pos] = v
        cursor = torch.remainder(steps, T)
        streaming_kv._write_ring(k_dev, k, cursor)
        streaming_kv._write_ring(v_dev, v, cursor)
        assert torch.equal(k_dev, k_int) and torch.equal(v_dev, v_int)
        for swap in (False, True):
            want = k12.kv_attention_row(q, k_int, v_int, slopes, pos, n, H * Dh, swap=swap)
            for c in (cursor, cursor.to(torch.int32)):
                assert torch.equal(k12.kv_attention_row(q, k_dev, v_dev, slopes, c, n, H * Dh, swap=swap), want)
        assert torch.equal(k12.slot_ages(cursor, T, "cpu"), k12.slot_ages(pos, T, "cpu"))
        steps.add_(1)


def test_a_tensor_cursor_is_checked():
    q, k = torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 9, 8)
    slopes, n = alibi_slopes(2).float(), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        k12.kv_attention_row(q, k, k, slopes, torch.tensor([9]), n, 16)
    with pytest.raises(ValueError, match="one int32 or int64"):
        k12.kv_attention_row(q, k, k, slopes, torch.tensor([1.0]), n, 16)
    with pytest.raises(ValueError, match="one int32 or int64"):
        k12.kv_attention_row(q, k, k, slopes, torch.tensor([1, 2]), n, 16)


def _small_encoder():
    return VapModel(VapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1), device="cpu").net.encoder


def test_in_place_encoder_state_matches_the_functional_state():
    """Prime and steady pushes of 1 and 3 frames, then ``reset_rows``: the
    features of ``push`` (state copied into its tensors) equal those of
    ``_run_pipeline`` with its returned state, and the state keeps its
    addresses."""
    enc = _small_encoder()
    rng = np.random.default_rng(2)
    s = exact.ExactStreamingEncoder(enc, batch=3)
    ptrs = [t.data_ptr() for t in exact._tensors(s.state)]
    ref = exact.init_exact_state(enc, 3)
    with torch.inference_mode():
        for i, frames in enumerate((1, 1, 3, 1, 2, 1, 1)):
            if i == 4:
                s.reset_rows([1])
                ts = [t.clone() for t in exact._tensors(ref)]
                for t in ts:
                    t[1] = 0.0
                ref = exact.ExactStreamState(tuple(ts[:-2]), ts[-2], ts[-1])
            x = (0.1 * rng.standard_normal((3, 320 * frames))).astype(np.float32)
            got = s.push(x)
            want, ref = exact._run_pipeline(enc, torch.from_numpy(x)[..., None], ref, i == 0)
            assert torch.equal(got, want), i
            assert all(torch.equal(a, b) for a, b in zip(exact._tensors(s.state), exact._tensors(ref)))
        s.reset()
        assert all(not t.any() for t in exact._tensors(s.state)) and not s.primed
    assert [t.data_ptr() for t in exact._tensors(s.state)] == ptrs


def test_codebook_weights_copy_from_the_host_once(monkeypatch):
    monkeypatch.setattr(codebook, "_WEIGHTS", {})
    built = []
    real = codebook._aggregate_weights

    def counted(*a, **k):
        built.append(a)
        return real(*a, **k)

    monkeypatch.setattr(codebook, "_aggregate_weights", counted)
    probs = torch.softmax(torch.randn(2, 5, 256, generator=torch.Generator().manual_seed(3)), dim=-1)
    first = codebook.probs_next_speaker_aggregate(probs, 0, 1)
    second = codebook.probs_next_speaker_aggregate(probs, 0, 1)
    assert len(built) == 1 and torch.equal(first, second)
    w = torch.from_numpy(real(0, 1))
    p_all = probs @ w
    assert torch.equal(second, p_all / (p_all.sum(-1, keepdim=True) + 1e-5))
    codebook.probs_next_speaker_aggregate(probs, 2, 3)
    codebook.probs_next_speaker_aggregate(probs.double(), 2, 3)
    assert len(built) == 3  # one build a range and dtype


def test_suspended_records_nothing():
    """A capture runs its stages under ``suspended()``: no span, no count."""
    from voiceactivityprojection_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.recording():
        with profiling.span("kv.push"):
            with profiling.suspended():
                with profiling.span("kv.layer"):
                    profiling.count("h2d_bytes", 5)
            profiling.count("h2d_bytes", 7)
    names = [s.name for s in profiling.spans()]
    counts = list(profiling.counters().values())
    profiling.clear()
    assert names == ["kv.push"] and counts == [{"h2d_bytes": 7}]


# --------------------------------------------------------------- the card --
@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs and the kernels run only there")
    return VapModel(VapConfig(), device="cuda")


def _eager(streamer):
    """The same streamer with the eager route the CPU and the prime tick take."""
    streamer._graphs = streamer._staging = None
    return streamer


def _equal(got, want, what):
    for k in KEYS:
        assert torch.equal(got[k], want[k]), (what, k, float((got[k] - want[k]).abs().max()))


def _launches():
    launched = _build.launch_totals(_build.launch_counts())
    return launched["kv_attention"], launched["gru_recurrence"]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4, 512])
def test_batched_graph_route_equals_eager_bit_for_bit(model, S):
    conf = model.conf
    rows = conf.channel_layers + 2 * conf.cross_layers
    g = BatchedKVStreamer(model, streams=S, context_time=CONTEXT_S)
    e = _eager(BatchedKVStreamer(model, streams=S, context_time=CONTEXT_S))
    rng = np.random.default_rng(S)
    prev = None
    for t in range(TICKS):
        if t == 30:
            g.reset_stream(1)
            e.reset_stream(1)
        if t == 45:
            captures = g._graphs.captures
            g.reset()
            e.reset()
        x = (0.1 * rng.standard_normal((S, 2, 320))).astype(np.float32)
        before = _launches()
        out = g.push(x)
        # eager, captured or replayed, a tick counts the rows and one K3
        assert np.subtract(_launches(), before).tolist() == [rows, 1], t
        if prev is not None:
            _equal(prev[0], prev[1], f"tick {t - 1} after tick {t}")
        want = e.push(x)
        _equal(out, want, f"tick {t}")
        prev = (out, {k: v.clone() for k, v in out.items()})
    assert g._graphs.captures == captures == 2  # the encoder's and the frame's, once
    assert g._graphs.replays == 2 * (TICKS - 2) - 1  # every tick past the first two, the encoder's after a reset
    assert g.state["frames"] == TICKS - 45 and int(g.state["steps"]) == TICKS - 45


@pytest.mark.cuda
def test_the_benchmarks_reset_reuses_the_graphs(model):
    """Warm-up ticks, then the state and the encoder dropped and ``reset()``:
    the ticks after replay the graphs of the warm-up, with no capture."""
    S = 8
    g = BatchedKVStreamer(model, streams=S, context_time=CONTEXT_S)
    rng = np.random.default_rng(8)
    xs = [(0.1 * rng.standard_normal((S, 2, 320))).astype(np.float32) for _ in range(8)]
    for x in xs[:4]:
        g.push(x)
    g.state = None
    g._enc = None
    g.reset()
    captures = g._graphs.captures
    e = _eager(BatchedKVStreamer(model, streams=S, context_time=CONTEXT_S))
    for x in xs:
        _equal(g.push(x), e.push(x), "after the reset")
    assert g._graphs.captures == captures == 2


@pytest.mark.cuda
@pytest.mark.parametrize("hop_frames", [1, 2])
def test_single_dialog_graph_route_equals_eager_bit_for_bit(model, hop_frames):
    g = KVStreamingVap(model, context_time=CONTEXT_S, hop_frames=hop_frames)
    e = _eager(KVStreamingVap(model, context_time=CONTEXT_S, hop_frames=hop_frames))
    rng = np.random.default_rng(hop_frames)
    for t in range(TICKS // hop_frames):
        if t == 20:
            g.reset()
            e.reset()
        x = (0.1 * rng.standard_normal((2, 320 * hop_frames))).astype(np.float32)
        _equal(g.push(x), e.push(x), f"hop {t}")
    feats = torch.randn(2, 3, model.conf.dim, generator=torch.Generator().manual_seed(4)).cuda()
    _equal(g.push_features(feats), e.push_features(feats), "features")
    assert g._graphs.captures == 2 and g._graphs.replays > 0
    assert g.frames_seen == e.frames_seen


@pytest.mark.cuda
def test_a_device_cursor_reads_as_the_host_int_on_the_card(model):
    S, H, T, Dh = 3, 4, 37, 64
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(S, 2, H, Dh, generator=gen).cuda()
    k, v = (torch.randn(S, 2, H, T, Dh, generator=gen).cuda() for _ in range(2))
    n = torch.tensor([37, 5, 1], dtype=torch.int32).cuda()
    slopes = alibi_slopes(H).float().cuda()
    for pos in (0, 17, T - 1):
        for swap in (False, True):
            want = k12.kv_attention_row(q, k, v, slopes, pos, n, H * Dh, swap=swap)
            for dtype in (torch.int64, torch.int32):
                cursor = torch.tensor([pos], dtype=dtype).cuda()
                assert torch.equal(k12.kv_attention_row(q, k, v, slopes, cursor, n, H * Dh, swap=swap), want)
    for bad in (T, -1):
        out = k12.kv_attention_row(q, k, v, slopes, torch.tensor([bad]).cuda(), n, H * Dh)
        assert bool(out.isnan().all())


@pytest.mark.cuda
def test_replayed_ticks_run_the_rows_and_k3_on_the_card(model):
    """A replay adds its capture's launches to the counters; the profiler
    names what the card ran: a replayed tick, the rows and one K3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S, ticks = 4, 5
    rows = model.conf.channel_layers + 2 * model.conf.cross_layers
    g = BatchedKVStreamer(model, streams=S, context_time=CONTEXT_S)
    rng = np.random.default_rng(9)
    xs = [(0.1 * rng.standard_normal((S, 2, 320))).astype(np.float32) for _ in range(3 + ticks)]
    for x in xs[:3]:  # the prime tick, the capture, a replay
        g.push(x)
    torch.cuda.synchronize()
    replays = g._graphs.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in xs[3:]:
            g.push(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert g._graphs.replays - replays == 2 * ticks
    assert sum(bool(re.search(r"\bkv_row_kernel\b", n)) for n in names) == rows * ticks
    assert sum(bool(re.search(r"\bgru_(f32_)?(cluster_)?kernel\b", n)) for n in names) == ticks


@pytest.mark.cuda
def test_a_cpu_hop_in_a_dtype_numpy_lacks_is_taken(model):
    """The pinned staging takes a bfloat16 CPU tensor, as the eager route does."""
    x = 0.1 * torch.randn(2, 320, generator=torch.Generator().manual_seed(6))
    for dtype in (torch.bfloat16, torch.float64):
        g = KVStreamingVap(model, context_time=CONTEXT_S)
        e = _eager(KVStreamingVap(model, context_time=CONTEXT_S))
        for t in range(3):
            _equal(g.push(x.to(dtype)), e.push(x.to(dtype)), f"{dtype} hop {t}")

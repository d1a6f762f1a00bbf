"""PyTorch port, the streamers against the JAX package on the CPU.

``StreamingVap`` (window mode, both encoder modes), ``KVStreamingVap``
(past the context fill, and through ``push_features``) and
``BatchedKVStreamer`` (S=3) are each fed the same chunks (numpy, from a
seed) as the JAX class, with the weights of one JAX ``init_vap`` at dim 16,
1 + 1 layers, crossed over by ``params_from_jax``. Bars: ``p_now``,
``p_future`` and ``vad`` 2e-6, ``H`` 2e-5 (measured on this CPU: 3.0e-7
and 2.4e-6 at most). The KV streamer is also held against the port's batch
forward on the true prefix (2e-6, measured 6e-8; JAX's own test holds 2e-5
at :54), a recycled stream against a fresh one, and the streamers' float32
rule.
"""

import numpy as np
import pytest
import jax
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.inference.streaming import StreamingVap as JStreamingVap
from voiceactivityprojection_tpu.inference.streaming_kv import BatchedKVStreamer as JBatched
from voiceactivityprojection_tpu.inference.streaming_kv import KVStreamingVap as JKV
from voiceactivityprojection_tpu.models.vap import VapModel as JVapModel
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.streaming import StreamingVap, streaming_net
from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer, KVStreamingVap
from voiceactivityprojection_tpu_torch.models.vap import VapModel

pytestmark = pytest.mark.inference

KW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
CONTEXT_S = 1.0  # 50 frames
BARS = {"p_now": 2e-6, "p_future": 2e-6, "vad": 2e-6, "H": 2e-5}
KV_VS_BATCH = 2e-6


@pytest.fixture(scope="module")
def models():
    jm = JVapModel.init(jax.random.key(0), JVapConfig(**KW))
    pm = VapModel.from_jax_params(jax.tree.map(np.asarray, jm.params), VapConfig(**KW), device="cpu")
    return jm, pm


def _hops(seed, n, hop_frames, streams=None):
    rng = np.random.default_rng(seed)
    shape = (2, hop_frames * 320) if streams is None else (streams, 2, hop_frames * 320)
    return [(0.1 * rng.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _close(got, want, what, keys=BARS):
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=BARS[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("encoder_mode", ["exact", "causal"])
def test_window_streamer_matches_jax(models, encoder_mode):
    """Two contexts' worth of 2-frame hops: the window's outputs every hop."""
    jm, pm = models
    j = JStreamingVap(jm, context_time=CONTEXT_S, hop_frames=2, encoder_mode=encoder_mode)
    p = StreamingVap(pm, context_time=CONTEXT_S, hop_frames=2, encoder_mode=encoder_mode)
    j.reset()
    p.reset()
    for i, c in enumerate(_hops(1, 50, 2)):
        got, want = p.push(c), j.push(c)
        _close(got, want, f"hop {i}")
        assert got["p_now"].shape == (50, 2)
        assert p.frames_seen == j.frames_seen
        assert p.warmed_up == j.warmed_up
    assert p.warmed_up


@pytest.mark.parametrize("encoder_mode", ["exact", "causal"])
def test_kv_streamer_matches_jax(models, encoder_mode):
    """Past the fill of the 50-slot rings: one row per new frame."""
    jm, pm = models
    j = JKV(jm, context_time=CONTEXT_S, hop_frames=5, encoder_mode=encoder_mode)
    p = KVStreamingVap(pm, context_time=CONTEXT_S, hop_frames=5, encoder_mode=encoder_mode)
    j.reset()
    p.reset()
    for i, c in enumerate(_hops(2, 20, 5)):
        got, want = p.push(c), j.push(c)
        _close(got, want, f"hop {i}", keys=("p_now", "p_future", "vad", "H"))
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0, atol=2e-6)
    assert p.frames_seen == j.frames_seen == 100
    assert p.state["steps"] == 100 and int(p.state["n"][0]) == 50


def test_kv_push_features_matches_jax(models):
    """Uneven feature chunks, past the fill, the frame loop against the scan."""
    jm, pm = models
    feats = np.random.default_rng(3).standard_normal((2, 80, 16)).astype(np.float32)
    j, p = JKV(jm, context_time=CONTEXT_S), KVStreamingVap(pm, context_time=CONTEXT_S)
    j.reset()
    p.reset()
    for lo, hi in ((0, 7), (7, 8), (8, 8), (8, 41), (41, 80)):
        got, want = p.push_features(feats[:, lo:hi]), j.push_features(feats[:, lo:hi])
        _close(got, want, f"frames {lo}:{hi}")
        assert got["p_now"].shape == (hi - lo, 2)


def test_batched_streamer_matches_jax(models):
    jm, pm = models
    S = 3
    j, p = JBatched(jm, streams=S, context_time=CONTEXT_S), BatchedKVStreamer(pm, streams=S, context_time=CONTEXT_S)
    j.reset()
    p.reset()
    for i, c in enumerate(_hops(4, 30, 1, streams=S)):
        got, want = p.push(c), j.push(c)
        _close(got, want, f"tick {i}")
        assert got["p_now"].shape == (1, S, 2)
    feats = np.random.default_rng(5).standard_normal((S, 2, 30, 16)).astype(np.float32)
    _close(p.push_features(feats), j.push_features(feats), "features")


def test_reset_stream_mid_batch(models):
    """A recycled slot runs as a fresh stream, the others keep their context
    (JAX: tests/test_streaming_kv.py:115-172), and as JAX's after the same
    reset."""
    jm, pm = models
    S = 2
    rng = np.random.default_rng(6)
    a = rng.standard_normal((S, 2, 10, 16)).astype(np.float32)
    c = rng.standard_normal((S, 2, 12, 16)).astype(np.float32)
    b, jb = BatchedKVStreamer(pm, streams=S, context_time=CONTEXT_S), JBatched(jm, streams=S, context_time=CONTEXT_S)
    b.push_features(a)
    jb.push_features(a)
    b.reset_stream(1)
    jb.reset_stream(1)
    got, want = b.push_features(c), jb.push_features(c)
    _close(got, want, "after reset_stream")
    fresh = KVStreamingVap(pm, context_time=CONTEXT_S)
    np.testing.assert_allclose(got["p_now"][:, 1].numpy(), fresh.push_features(c[1])["p_now"].numpy(),
                               rtol=0, atol=1e-6)
    cont = KVStreamingVap(pm, context_time=CONTEXT_S)
    cont.push_features(a[0])
    np.testing.assert_allclose(got["p_now"][:, 0].numpy(), cont.push_features(c[0])["p_now"].numpy(),
                               rtol=0, atol=1e-6)


def test_reset_stream_clears_encoder_state(models):
    """A recycled slot's outputs do not depend on the previous dialog's audio."""
    _, pm = models
    S, hops = 2, 6
    rng = np.random.default_rng(7)
    hist_a = rng.standard_normal((hops, S, 2, 640)).astype(np.float32)
    hist_b = hist_a.copy()
    hist_b[:, 0] = rng.standard_normal((hops, 2, 640)).astype(np.float32)
    new = rng.standard_normal((hops, S, 2, 640)).astype(np.float32)
    outs = []
    for hist in (hist_a, hist_b):
        b = BatchedKVStreamer(pm, streams=S, context_time=CONTEXT_S, hop_frames=2)
        for h in hist:
            b.push(h)
        b.reset_stream(0)
        outs.append(np.concatenate([b.push(n)["p_now"][:, 0].numpy() for n in new]))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_kv_pipeline_matches_port_batch_forward(models):
    """Waveform in: the exact encoder and the K/V caches give the port's
    batch forward on a prefix shorter than the context."""
    _, pm = models
    w = (0.1 * np.random.default_rng(8).standard_normal((2, 30 * 320))).astype(np.float32)
    want = pm.probs(w[None])
    s = KVStreamingVap(pm, context_time=2.0, hop_frames=5)
    got = torch.cat([s.push(w[:, i * 1600:(i + 1) * 1600])["p_now"] for i in range(6)])
    n = got.shape[0]
    assert n >= 20
    np.testing.assert_allclose(got.numpy(), want["p_now"][0, :n].numpy(), rtol=0, atol=KV_VS_BATCH)


def test_streamers_compute_in_float32(models):
    """A bfloat16 model is refused: the streamers run on float32 weights, as
    JAX's run on its float32 params whatever the compute dtype."""
    _, pm = models
    assert streaming_net(pm) is pm.net
    m16 = VapModel(VapConfig(**KW, dtype="bfloat16"), device="cpu")
    for cls in (StreamingVap, KVStreamingVap):
        with pytest.raises(ValueError, match="float32"):
            cls(m16)
    with pytest.raises(ValueError, match="float32"):
        BatchedKVStreamer(m16, streams=2)
    with pytest.raises(ValueError, match="encoder_mode"):
        StreamingVap(pm, encoder_mode="lookahead")


def test_push_checks_the_chunk_shape(models):
    _, pm = models
    with pytest.raises(ValueError, match="expected"):
        StreamingVap(pm, context_time=CONTEXT_S).push(np.zeros((2, 640), np.float32))
    with pytest.raises(ValueError, match="expected"):
        BatchedKVStreamer(pm, streams=2, context_time=CONTEXT_S).push(np.zeros((3, 2, 320), np.float32))

"""PyTorch port, the real-time SDS loop and the servers, against the JAX
package on the CPU.

``TurnTakingSDS.step`` over a WAV in window and kv mode gives JAX's values
(2e-6); ``VapServer._run_batch`` gives JAX's outputs on the same requests
(2e-6, trimmed to each request's frames); the servers answer over sockets
on ports the OS picks, as JAX's tests have them answer (tests/test_server.py,
tests/test_stream_server.py); and a JAX client talks to a port server and a
port client to a JAX server, which shows that the wire format is shared.
Weights: one JAX ``init_vap`` at dim 16, 1 + 1 layers, crossed over by
``params_from_jax``. Every blocking call has its own limit (client
``timeout_s``, ``join(timeout=)``).
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import jax
from scipy.io import wavfile

from voiceactivityprojection_tpu.config import SDSConfig as JSDSConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.inference import sds as jsds
from voiceactivityprojection_tpu.inference import server as jserver
from voiceactivityprojection_tpu.models.vap import VapModel as JVapModel
from voiceactivityprojection_tpu_torch.config import SDSConfig, VapConfig
from voiceactivityprojection_tpu_torch.inference import sds as psds
from voiceactivityprojection_tpu_torch.inference import server as pserver
from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap
from voiceactivityprojection_tpu_torch.models.vap import VapModel

pytestmark = pytest.mark.inference

KW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
ATOL = 2e-6
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def models():
    jm = JVapModel.init(jax.random.key(0), JVapConfig(**KW))
    pm = VapModel.from_jax_params(jax.tree.map(np.asarray, jm.params), VapConfig(**KW), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("sds") / "dialog.wav"
    x = (0.2 * np.random.default_rng(0).standard_normal((3 * 16000 + 77, 2))).clip(-1, 1)
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))
    return str(path)


def _free_port() -> int:
    """A port the OS picks, for a JAX server (which takes a port number)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wave(seed, n):
    return (0.1 * np.random.default_rng(seed).standard_normal((2, n))).astype(np.float32)


# --------------------------------------------------------------------- SDS --
@pytest.mark.parametrize("mode", ["window", "kv"])
def test_sds_step_matches_jax(models, wav, mode):
    jm, pm = models
    kw = dict(context_time=1.0, chunk_time=0.1, zmq_port=0, transformer_mode=mode)
    j, p = jsds.TurnTakingSDS(jm, JSDSConfig(**kw)), psds.TurnTakingSDS(pm, SDSConfig(**kw))
    src = psds.WavSource(wav, chunk_samples=p.stream.hop_samples)
    jsrc = jsds.WavSource(wav, chunk_samples=j.stream.hop_samples)
    chunks = list(src.chunks())
    assert len(chunks) == 30
    for c, jc in zip(chunks, jsrc.chunks()):
        np.testing.assert_array_equal(c, jc)
    j.stream.reset()
    p.stream.reset()
    got = [p.step(c) for c in chunks]
    want = [j.step(c) for c in chunks]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert all(0.0 <= v <= 1.0 for v in got)


def test_sds_zero_smoothing_is_the_newest_frame(models):
    _, pm = models
    sds = psds.TurnTakingSDS(pm, SDSConfig(context_time=1.0, chunk_time=0.1, zmq_port=0, prob_smooth_time=0.0))
    assert sds.smooth_frames == 1
    chunk = _wave(1, 1600)
    sds.stream.reset()
    v = sds.step(chunk)
    s2 = psds.TurnTakingSDS(pm, SDSConfig(context_time=1.0, chunk_time=0.1, zmq_port=0))
    s2.stream.reset()
    out = s2.stream.push(chunk)
    assert v == pytest.approx(float(out["p_now"][-1, 0]), abs=0)


def test_sds_config_is_checked(models):
    _, pm = models
    with pytest.raises(ValueError, match="whole number"):
        psds.TurnTakingSDS(pm, SDSConfig(chunk_time=0.03, zmq_port=0))
    with pytest.raises(ValueError, match="transformer_mode"):
        psds.TurnTakingSDS(pm, SDSConfig(zmq_port=0, transformer_mode="nope"))
    assert set(SDSConfig.__dataclass_fields__) == set(JSDSConfig.__dataclass_fields__)
    assert SDSConfig() == SDSConfig(**{k: getattr(JSDSConfig(), k) for k in SDSConfig.__dataclass_fields__})


def test_sds_run_publishes_to_a_subscriber(models, wav):
    pytest.importorskip("zmq")
    _, pm = models
    pub = psds.ZmqPublisher(port=0)
    joined = threading.Event()
    got = []

    def listen():
        # the socket opens in this thread, on the generator's first next()
        sub = psds.zmq_subscriber(port=pub.port, timeout_s=TIMEOUT_S)
        for v in sub:
            joined.set()
            if v >= 0.0:  # not a probe sent while the subscription joins
                got.append(v)
                if len(got) == 5:
                    break
        sub.close()

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    deadline = time.time() + TIMEOUT_S
    while not joined.is_set() and time.time() < deadline:
        pub.send(-1.0)  # PUB drops what it sends before the subscription arrives
        time.sleep(0.01)
    assert joined.is_set()
    sds = psds.TurnTakingSDS(pm, SDSConfig(context_time=1.0, chunk_time=0.02, zmq_port=0), publisher=pub)
    sds.source = psds.WavSource(wav, chunk_samples=sds.stream.hop_samples)
    logged = []
    sds.run(max_chunks=20, log=logged.append)
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive() and len(logged) == 20
    values = [float(line.split("=")[1]) for line in logged]
    assert len(got) == 5 and all(abs(v - w) <= 5e-4 for v, w in zip(got, values))


def test_wav_recorder_writes_what_it_was_given(models, wav, tmp_path):
    _, pm = models
    out = tmp_path / "rec.wav"
    sds = psds.TurnTakingSDS(pm, SDSConfig(context_time=1.0, chunk_time=0.1, zmq_port=0, savefile=str(out)))
    src = psds.WavSource(wav, chunk_samples=sds.stream.hop_samples)
    sds.source = src
    sds.run(max_chunks=7, log=None)
    sr, data = wavfile.read(out)
    want = (np.clip(src.x[:, :7 * 1600].T, -1, 1) * 32767).astype(np.int16)
    assert sr == 16000 and data.shape == (7 * 1600, 2)
    np.testing.assert_array_equal(data, want)


# ------------------------------------------------------------ batch server --
def test_run_batch_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(2)
    lens = (32000, 16000, 20800)
    waves = [(0.1 * rng.standard_normal((2, n))).astype(np.float32) for n in lens]

    def requests(cls):
        out = []
        for i, w in enumerate(waves):
            padded = np.zeros((2, 32000), np.float32)
            padded[:, : w.shape[1]] = w
            out.append(cls(b"c%d" % i, i, padded, int(w.shape[1] / 16000 * 50)))
        return out

    got = pserver.VapServer(pm, batch_size=4, chunk_time=2.0)._run_batch(requests(pserver._Request))
    want = jserver.VapServer(jm, batch_size=4, chunk_time=2.0)._run_batch(requests(jserver._Request))
    for g, w, n in zip(got, want, lens):
        assert set(g) == set(w) == {"p_now", "p_future", "vad", "H"}
        for k in g:
            assert g[k].shape == w[k].shape and g[k].shape[0] == n // 320
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ATOL if k != "H" else 2e-5, err_msg=k)


@pytest.fixture(scope="module")
def batch_server(models):
    pytest.importorskip("zmq")
    _, pm = models
    server = pserver.VapServer(pm, batch_size=4, chunk_time=2.0, max_wait_ms=30)
    server.start(port=0)
    client = pserver.VapClient(port=server.port, timeout_s=TIMEOUT_S)
    yield server, client
    client.close()
    server.stop()


def test_batch_server_single_and_short_requests(batch_server, models):
    server, client = batch_server
    w = _wave(3, 32000)
    out = client.infer(w)
    assert set(out) == {"p_now", "p_future", "vad", "H"} and out["p_now"].shape == (100, 2)
    want = models[1].probs(w[None])
    np.testing.assert_allclose(out["p_now"], want["p_now"][0].numpy(), rtol=0, atol=ATOL)
    assert client.infer(_wave(4, 16000))["p_now"].shape == (50, 2)  # trimmed to the real 1 s


def test_batch_server_batches_concurrent_requests(batch_server):
    server, _ = batch_server
    before = server.stats["batches"]
    waves = [_wave(10 + i, 32000) for i in range(4)]
    results = [None] * 4

    def call(i):
        c = pserver.VapClient(port=server.port, timeout_s=TIMEOUT_S)
        try:
            results[i] = c.infer(waves[i])
        finally:
            c.close()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r["p_now"].shape == (100, 2) for r in results)
    assert server.stats["batches"] - before <= 3


def test_batch_server_refuses_oversized_and_survives_malformed(batch_server):
    import zmq

    server, client = batch_server
    with pytest.raises(ValueError, match="expected"):
        client.infer(np.zeros((2, 64000), np.float32))
    ctx = zmq.Context()
    raw = ctx.socket(zmq.DEALER)
    raw.setsockopt(zmq.LINGER, 0)
    raw.setsockopt(zmq.RCVTIMEO, int(TIMEOUT_S * 1000))
    raw.connect(f"tcp://localhost:{server.port}")
    try:
        raw.send_multipart([json.dumps({"req_id": 99, "shape": [2, 32000]}).encode(), b"\x00" * 64])
        assert "error" in json.loads(raw.recv_multipart()[0])
        raw.send_multipart([b"{not json", b""])
        assert "error" in json.loads(raw.recv_multipart()[0])
        raw.send_multipart([b"only-one-frame"])
        assert "error" in json.loads(raw.recv_multipart()[0])
    finally:
        raw.close(0)
        ctx.term()
    assert client.infer(_wave(5, 32000))["p_now"].shape == (100, 2)


# ----------------------------------------------------------- stream server --
def test_stream_sessions_match_single_streamer(models):
    pytest.importorskip("zmq")
    _, pm = models
    server = pserver.VapStreamServer(pm, streams=4, context_time=2.0, hop_frames=5, max_wait_ms=400)
    server.start(port=0)
    c1 = pserver.VapStreamClient(port=server.port, timeout_s=TIMEOUT_S)
    c2 = pserver.VapStreamClient(port=server.port, timeout_s=TIMEOUT_S)
    try:
        assert c1.open() != c2.open()
        hops = 4
        w1, w2 = _wave(20, hops * 1600), _wave(21, hops * 1600)
        got1, got2 = [], []
        for i in range(hops):
            sl = slice(i * 1600, (i + 1) * 1600)
            res = [None, None]
            threads = [threading.Thread(target=lambda: res.__setitem__(0, c1.push(w1[:, sl]))),
                       threading.Thread(target=lambda: res.__setitem__(1, c2.push(w2[:, sl])))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT_S)
            assert res[0] is not None and res[1] is not None
            got1.append(res[0])
            got2.append(res[1])
        for w, got in ((w1, got1), (w2, got2)):
            s = KVStreamingVap(pm, context_time=2.0, hop_frames=5)
            want = np.concatenate([s.push(w[:, i * 1600:(i + 1) * 1600])["p_now"].numpy() for i in range(hops)])
            p = np.concatenate([r["p_now"] for r in got])
            assert p.shape == want.shape
            np.testing.assert_allclose(p, want, rtol=0, atol=1e-6)
        assert server.stats["underruns"] == 0
        assert c1.close() == {"req_id": hops + 1, "closed": 0, "underruns": 0}
    finally:
        c1.close()
        c2.close()
        server.stop()


def test_stream_slot_exhaustion_and_recycle(models):
    pytest.importorskip("zmq")
    _, pm = models
    server = pserver.VapStreamServer(pm, streams=1, context_time=1.0, hop_frames=5)
    server.start(port=0)
    a = pserver.VapStreamClient(port=server.port, timeout_s=TIMEOUT_S)
    b = pserver.VapStreamClient(port=server.port, timeout_s=TIMEOUT_S)
    try:
        a.open()
        with pytest.raises(ValueError, match="no free stream slots"):
            b.open()
        a.close()
        assert b.open() == 0
    finally:
        b.close()
        server.stop()


def test_tick_fifo_resets_and_requeue(models):
    """Two chunks queued in one tick window go over two ticks; the reset of
    an opened slot is applied by the tick."""
    _, pm = models
    server = pserver.VapStreamServer(pm, streams=2, context_time=1.0, hop_frames=2)
    server.streamer.reset()
    server.sessions[0] = b"client"
    server._resets.add(0)
    c1 = np.full((2, server.hop_samples), 0.1, np.float32)
    server.pending[0] = [("r1", c1), ("r2", -c1)]
    replies = server._tick()
    assert set(replies) == {0} and replies[0][0] == "r1" and replies[0][1] == b"client"
    assert replies[0][2]["p_now"].shape == (2, 2)
    assert not server._resets
    assert server._work.is_set()
    assert server.pending[0][0][0] == "r2"
    replies = server._tick()
    assert replies[0][0] == "r2" and 0 not in server.pending
    assert server.stats["ticks"] == 2 and server.stats["underruns"] == 0


def test_idle_session_evicted(models):
    _, pm = models
    server = pserver.VapStreamServer(pm, streams=1, context_time=1.0, hop_frames=2, session_timeout_s=0.01)
    server.sessions[0] = b"gone"
    server.last_seen[0] = time.time() - 1.0
    server.pending[0] = [("r", np.zeros((2, server.hop_samples), np.float32))]
    server._evict_idle()
    assert server.sessions == {} and server.pending == {} and server.stats["evictions"] == 1


def test_recv_matching_discards_stale_replies():
    class FakeSock:
        def __init__(self, frames):
            self.frames = list(frames)

        def recv_multipart(self):
            return self.frames.pop(0)

    stale = [json.dumps({"req_id": 1, "keys": [], "shapes": {}}).encode(), b""]
    good = [json.dumps({"req_id": 2, "keys": [], "shapes": {}}).encode(), b"xy"]
    h, payload = pserver._recv_matching(FakeSock([stale, good]), 2)
    assert h["req_id"] == 2 and payload == b"xy"
    err = [json.dumps({"req_id": 3, "error": "boom"}).encode()]
    with pytest.raises(ValueError, match="boom"):
        pserver._recv_matching(FakeSock([stale, err]), 3)
    orphan = [json.dumps({"req_id": None, "error": "malformed"}).encode()]
    h, _ = pserver._recv_matching(FakeSock([orphan, good]), 2, stale_plausible=True)
    assert h["req_id"] == 2


# ------------------------------------------------------ one wire protocol --
def test_clients_and_servers_interoperate(models):
    """A port client against a JAX batch server, and JAX clients against the
    port's batch and stream servers."""
    pytest.importorskip("zmq")
    jm, pm = models
    w = _wave(30, 32000)
    want = pm.probs(w[None])
    jport = _free_port()
    jsrv = jserver.VapServer(jm, batch_size=2, chunk_time=2.0, max_wait_ms=10)
    jsrv.start(port=jport)
    try:
        c = pserver.VapClient(port=jport, timeout_s=TIMEOUT_S)
        try:
            out = c.infer(w)
        finally:
            c.close()
    finally:
        jsrv.stop()
    np.testing.assert_allclose(out["p_now"], want["p_now"][0].numpy(), rtol=0, atol=ATOL)

    psrv = pserver.VapServer(pm, batch_size=2, chunk_time=2.0, max_wait_ms=10)
    psrv.start(port=0)
    try:
        jc = jserver.VapClient(port=psrv.port, timeout_s=TIMEOUT_S)
        try:
            out = jc.infer(w)
        finally:
            jc.close()
    finally:
        psrv.stop()
    np.testing.assert_allclose(out["p_now"], want["p_now"][0].numpy(), rtol=0, atol=ATOL)

    ssrv = pserver.VapStreamServer(pm, streams=2, context_time=1.0, hop_frames=5)
    ssrv.start(port=0)
    jc = jserver.VapStreamClient(port=ssrv.port, timeout_s=TIMEOUT_S)
    try:
        assert jc.open() == 0 and jc.hop_samples == 1600
        got = np.concatenate([jc.push(w[:, i * 1600:(i + 1) * 1600])["p_now"] for i in range(3)])
        assert jc.close() == {"req_id": 4, "closed": 0, "underruns": 0}
    finally:
        ssrv.stop()
    s = KVStreamingVap(pm, context_time=1.0, hop_frames=5)
    single = np.concatenate([s.push(w[:, i * 1600:(i + 1) * 1600])["p_now"].numpy() for i in range(3)])
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-6)

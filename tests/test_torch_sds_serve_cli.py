"""PyTorch port, the ``run_sds`` and ``serve`` entry points on the CPU.

``python -m voiceactivityprojection_tpu_torch.run_sds --device cpu`` over a
WAV in both transformer modes gives the values of the same loop in this
process (seed-0 weights, dim 16, 1 + 1 layers); ``--vap_dtype bfloat16``
still streams in float32. ``... .serve --device cpu`` in batch and stream
mode, each in a subprocess on a port the OS picks, answers one client and
is then killed. Without ``--device cpu`` both entry points need the card
and raise. Every subprocess has its own time limit and is killed by its
PID in a ``finally``.
"""

import os
import queue
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from voiceactivityprojection_tpu_torch import run_sds, serve
from voiceactivityprojection_tpu_torch.config import SDSConfig, VapConfig
from voiceactivityprojection_tpu_torch.inference.sds import TurnTakingSDS, WavSource
from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap
from voiceactivityprojection_tpu_torch.models.vap import VapModel

pytestmark = pytest.mark.inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "dialog.wav"
    x = (0.2 * np.random.default_rng(0).standard_normal((2 * 16000, 2))).clip(-1, 1)
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module")
def model():
    return VapModel(VapConfig(**KW), device="cpu")  # the CLIs' weights without -sd: seed 0


def _run_sds(wav, *extra):
    r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.run_sds", "--device", "cpu",
                        "--wav", wav, "--max_chunks", "50", "--sds_zmq_port", "0", "--sds_context_time", "1.0",
                        *SMALL_ARGS, *extra], cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout, [line for line in r.stdout.splitlines() if line.startswith("p_now(A)=")]


@pytest.mark.parametrize("mode", ["window", "kv"])
def test_run_sds_cli_matches_the_loop_in_process(wav, model, mode):
    out, lines = _run_sds(wav, "--sds_transformer_mode", mode)
    assert len(lines) == 50 and '"hops": 50' in out.splitlines()[-1]
    sds = TurnTakingSDS(model, SDSConfig(context_time=1.0, zmq_port=0, transformer_mode=mode))
    sds.source = WavSource(wav, chunk_samples=sds.stream.hop_samples)
    logged = []
    sds.run(max_chunks=50, log=logged.append)
    assert lines == logged


def test_run_sds_cli_streams_in_float32(wav):
    out, lines = _run_sds(wav, "--sds_transformer_mode", "kv", "--vap_dtype", "bfloat16")
    assert "--vap_dtype bfloat16 ignored" in out
    assert lines == _run_sds(wav, "--sds_transformer_mode", "kv")[1]


def _start_server(*args):
    """A serve process on a port the OS picks: (process, port)."""
    proc = subprocess.Popen([sys.executable, "-m", "voiceactivityprojection_tpu_torch.serve", "--device", "cpu",
                             "--port", "0", "--chunk_time", "2.0", *SMALL_ARGS, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True).start()
    seen = []
    while True:
        try:
            line = lines.get(timeout=TIMEOUT_S)
        except queue.Empty:
            proc.kill()
            raise AssertionError(f"no 'Serving' line: {seen}")
        seen.append(line)
        m = re.search(r"Serving \(\w+\) on tcp://\*:(\d+)", line)
        if m:
            return proc, int(m.group(1))
        if proc.poll() is not None and lines.empty():
            raise AssertionError(f"serve exited {proc.returncode}: {seen}")


def test_serve_cli_batch_mode(model):
    pytest.importorskip("zmq")
    from voiceactivityprojection_tpu_torch.inference.server import VapClient

    proc, port = _start_server("--mode", "batch", "--batch_size", "2", "--max_wait_ms", "10")
    try:
        client = VapClient(port=port, timeout_s=TIMEOUT_S)
        try:
            w = (0.1 * np.random.default_rng(1).standard_normal((2, 32000))).astype(np.float32)
            out = client.infer(w)
        finally:
            client.close()
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
    np.testing.assert_allclose(out["p_now"], model.probs(w[None])["p_now"][0].numpy(), rtol=0, atol=2e-6)


def test_serve_cli_stream_mode(model):
    pytest.importorskip("zmq")
    from voiceactivityprojection_tpu_torch.inference.server import VapStreamClient

    proc, port = _start_server("--mode", "stream", "--streams", "2", "--context_time", "1.0", "--hop_frames", "5",
                               "--vap_dtype", "bfloat16")
    try:
        client = VapStreamClient(port=port, timeout_s=TIMEOUT_S)
        try:
            assert client.open() == 0 and client.hop_samples == 1600
            w = (0.1 * np.random.default_rng(2).standard_normal((2, 3 * 1600))).astype(np.float32)
            got = np.concatenate([client.push(w[:, i * 1600:(i + 1) * 1600])["p_now"] for i in range(3)])
        finally:
            client.close()
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
    s = KVStreamingVap(model, context_time=1.0, hop_frames=5)
    want = np.concatenate([s.push(w[:, i * 1600:(i + 1) * 1600])["p_now"].numpy() for i in range(3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_entry_points_need_the_card_by_default(wav, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sds.main(["--wav", wav, "--max_chunks", "1", "--sds_zmq_port", "0", *SMALL_ARGS])
    for mode in ("batch", "stream"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--mode", mode, "--port", "0", *SMALL_ARGS])

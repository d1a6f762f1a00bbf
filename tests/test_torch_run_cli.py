"""PyTorch port, the offline CLI (``python -m voiceactivityprojection_tpu_torch.run``)
against the JAX package's ``run.py`` on the same WAV and the same
reference-format state dict, both on the CPU in subprocesses: every output
key within 2e-5 (float32), single shot, chunked and with a VAD list; and the
port's default device, the card, refusing to run without one."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch
from scipy.io import wavfile

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import checkpoint as jckpt
from voiceactivityprojection_tpu.models import vap as jvap

pytestmark = pytest.mark.inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
ATOL = 2e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A reference-format ``.pt`` of JAX-initialised weights, a 6 s and a
    7 s stereo int16 WAV and a VAD list."""
    out = tmp_path_factory.mktemp("cli")
    tree = jvap.init_vap(jax.random.key(0), JVapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1))
    sd = jckpt.export_vap_state_dict(jax.tree.map(np.asarray, tree))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out / "w.pt")
    rng = np.random.default_rng(0)
    for seconds in (6, 7):
        x = (0.2 * rng.standard_normal((16000 * seconds + 131, 2))).clip(-1, 1)
        wavfile.write(out / f"a{seconds}.wav", 16000, (x * 32767).astype(np.int16))
    with open(out / "vad.json", "w") as f:
        json.dump([[[0.0, 1.3], [2.0, 4.1]], [[1.2, 2.2], [4.0, 6.5]]], f)
    return out


def _run(argv, env=None, timeout=300):
    return subprocess.run([sys.executable] + argv, cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, **(env or {})), timeout=timeout)


def _both(files, wav, extra, tag):
    outs = {}
    for side, argv, env in (
        ("jax", ["run.py"], {"VAP_PLATFORM": "cpu"}),
        ("port", ["-m", "voiceactivityprojection_tpu_torch.run", "--device", "cpu"], None),
    ):
        path = files / f"{tag}_{side}.json"
        r = _run(argv + ["-a", str(files / wav), "-sd", str(files / "w.pt"), "-o", str(path)] + SMALL_ARGS + extra,
                 env)
        assert r.returncode == 0, (side, r.stderr[-3000:] or r.stdout[-3000:])
        outs[side] = json.loads(path.read_text())
        outs[f"{side}_stdout"] = r.stdout
    return outs


def _assert_close(outs, keys):
    assert set(outs["port"]) == set(outs["jax"]) == set(keys)
    for k in keys:
        got, want = np.asarray(outs["port"][k]), np.asarray(outs["jax"][k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=k)


KEYS = {"probs", "vad", "p_now", "p_future", "H"}


def test_single_shot_matches_jax_cli(files):
    outs = _both(files, "a6.wav", [], "single")
    _assert_close(outs, KEYS)
    assert np.asarray(outs["port"]["p_now"]).shape == (1, 300, 2)
    assert "Single shot: 300 frames" in outs["port_stdout"]
    assert "Audio decoder: " in outs["port_stdout"]
    timings = json.loads(outs["port_stdout"].strip().splitlines()[-1])
    assert set(timings["timings"]) == {"load_weights_s", "load_audio_s", "extract_s", "write_json_s"}
    assert timings["device"] == "cpu"


def test_chunked_matches_jax_cli(files):
    outs = _both(files, "a7.wav", ["--chunk", "--chunk_time", "5", "--step_time", "1"], "chunk")
    _assert_close(outs, KEYS)
    assert np.asarray(outs["port"]["H"]).shape == (1, 350)
    assert "Chunked extraction: 350 frames" in outs["port_stdout"]


def test_vad_list_adds_loss(files):
    outs = _both(files, "a6.wav", ["--vad_list", str(files / "vad.json")], "vad")
    _assert_close(outs, KEYS | {"loss"})
    assert np.asarray(outs["port"]["loss"]).shape == (1, 300)


def test_context_parallel_on_the_cpu_is_the_single_shot(files):
    """One shard on the CPU: the same numbers as the single-shot run."""
    paths = [files / "cp.json", files / "ss.json"]
    for path, extra in zip(paths, (["--context_parallel"], [])):
        r = _run(["-m", "voiceactivityprojection_tpu_torch.run", "--device", "cpu", "-a", str(files / "a6.wav"),
                  "-sd", str(files / "w.pt"), "-o", str(path)] + SMALL_ARGS + extra)
        assert r.returncode == 0, r.stderr[-3000:]
    cp, ss = (json.loads(p.read_text()) for p in paths)
    assert set(cp) == set(ss)
    for k in ss:
        np.testing.assert_array_equal(np.asarray(cp[k]), np.asarray(ss[k]), err_msg=k)


def test_default_device_needs_a_card(files):
    r = _run(["-m", "voiceactivityprojection_tpu_torch.run", "-a", str(files / "a6.wav"),
              "-o", str(files / "none.json")] + SMALL_ARGS, env={"CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (files / "none.json").exists()

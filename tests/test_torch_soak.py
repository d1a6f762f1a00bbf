"""PyTorch port, the live-paced soaks against the JAX package's scripts
(loaded by path) and its SDS loop: ``synth_speech`` and ``synth_dialog``
equal to JAX's; 2 s of kv-mode hops at live pacing and of window-mode hops
whose smoothed p equals JAX's ``TurnTakingSDS.step`` over the same audio
within 2e-6 (window mode with a 1 s context, so that the CPU keeps up), a
batched soak's p equal to JAX's ``BatchedKVStreamer``'s; and the churn soak
over real ZMQ with three slots on a port the OS picks: no session in
error, at least one session replayed solo within the 0.05 contamination
bar. Every blocking call of the churn soak carries its own time limit (the
clients' 120 s receive, the 60 s joins, the server's 5 s stop)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import SDSConfig as JSDSConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.inference import sds as jsds
from voiceactivityprojection_tpu.inference.streaming_kv import BatchedKVStreamer as JBatched
from voiceactivityprojection_tpu.models.vap import VapModel as JVapModel
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.tools import soak_churn as tchurn
from voiceactivityprojection_tpu_torch.tools import soak_sds as tsoak

pytestmark = pytest.mark.inference

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
ATOL = 2e-6
HOPS = 100  # 2 s


def _jax_script(rel: str):
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    tree = random_params_tree(VapConfig(**KW), seed=0)
    return JVapModel(JVapConfig(**KW), jax.tree.map(jnp.asarray, tree)), VapModel.from_jax_params(
        tree, VapConfig(**KW), device="cpu")


def _audio(n_hops):
    """The soak's stereo audio for ``n_hops`` hops, and its hop size."""
    seconds = n_hops * tsoak.HOP_S + 2.0
    return np.stack([tsoak.synth_speech(seconds, 16_000, 0), tsoak.synth_speech(seconds, 16_000, 1)]), 320


def test_synth_signals_equal_jax():
    jsoak, jchurn = _jax_script("examples/soak_sds.py"), _jax_script("examples/soak_churn.py")
    for seed in (0, 1):
        np.testing.assert_array_equal(tsoak.synth_speech(4.3, 16_000, seed), jsoak.synth_speech(4.3, 16_000, seed))
    for seed in (0, 7):
        np.testing.assert_array_equal(tchurn.synth_dialog(3.1, 16_000, seed), jchurn.synth_dialog(3.1, 16_000, seed))


@pytest.mark.parametrize("mode", ["kv", "window"])
def test_soak_hops_match_jax_sds(models, mode, monkeypatch):
    jm, pm = models
    ctx = {} if mode == "kv" else {"context_time": 1.0}
    monkeypatch.setattr(tconfig, "SDSConfig", functools.partial(tconfig.SDSConfig, **ctx))
    rec = tsoak.soak(pm, HOPS, mode, paced=mode == "kv")
    assert rec["hops"] == len(rec["p"]) == HOPS and rec["p_in_range"] and rec["paced"] == (mode == "kv")
    assert set(rec["latency_ms"]) == {"p50", "p90", "p99", "max"} and rec["misses"] <= HOPS
    stereo, hop = _audio(HOPS)
    j = jsds.TurnTakingSDS(jm, JSDSConfig(transformer_mode=mode, **ctx))
    j.stream.reset()
    want = [j.step(stereo[:, i * hop:(i + 1) * hop]) for i in range(tsoak.WARM_HOPS + HOPS)]
    np.testing.assert_allclose(rec["p"], want[tsoak.WARM_HOPS:], rtol=0, atol=ATOL)


def test_batched_soak_matches_jax(models):
    jm, pm = models
    n, S = 20, 3
    rec = tsoak.soak(pm, n, batched=S, paced=False)
    assert rec["streams"] == S and rec["p_in_range"]
    stereo, hop = _audio(n)
    jb = JBatched(jm, streams=S, context_time=20.0)
    want = [float(np.asarray(jb.push(np.broadcast_to(stereo[:, i * hop:(i + 1) * hop], (S, 2, hop)).copy())
                             ["p_now"])[-1, 0, 0]) for i in range(tsoak.WARM_HOPS + n)]
    np.testing.assert_allclose(rec["p"], want[tsoak.WARM_HOPS:], rtol=0, atol=ATOL)


def test_churn_soak_over_zmq(models):
    pytest.importorskip("zmq")
    _, pm = models
    # seed 20: the first two sessions (14.2 and 10.7 s of audio) close cleanly;
    # at a tenth of real time and a 200 ms cohort wait they run without underruns
    s = tchurn.churn_soak(pm, streams=3, duration=1.0, hop_frames=2, pace=0.1, max_wait_ms=200.0,
                          session_timeout=3.0, seed=20)
    assert s["port"] not in (0, 5611) and s["sessions_total"] >= 2
    assert s["sessions_error"] == 0 and s["sessions_running"] == 0, s["errors"]
    assert s["latency_ms_p50"] > 0 and s["server_stats"]["pushes"] == s["hops_total"]
    c = s["contamination"]
    assert c["checked"] >= 1 and c["max_abs_diff"] < tchurn.CONTAMINATION_BAR and s["contamination_ok"] is True

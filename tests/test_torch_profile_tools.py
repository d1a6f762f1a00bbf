"""PyTorch port, the profile tools and the multi-process rehearsal on the
CPU at narrow widths: ``profile_stages`` prints and returns each of its
named stages (JAX's names, plus the fused GRU + downsample and the heads);
``profile_train_step`` (frozen and unfrozen, ``--deep``) at rate 0, where
the loss of every stage that computes one (the forward, its gradient, the
transformer section from the encoder's features, and their backward)
equals the port's full train step's within 1e-6; ``profile_input_pipeline``
over a synthetic corpus; and ``multihost_rehearsal`` with one process and
two over gloo, the two-process run's weights after its steps within 1e-6
of one process's."""

import os

import pytest
import torch

from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.tools import multihost_rehearsal as tmh
from voiceactivityprojection_tpu_torch.tools import profile_input_pipeline as tpip
from voiceactivityprojection_tpu_torch.tools import profile_stages as tps
from voiceactivityprojection_tpu_torch.tools import profile_train_step as tpts
from voiceactivityprojection_tpu_torch.train.step import make_optimizer, make_train_step

from _torch_corpus import dialog_corpus

pytestmark = pytest.mark.train

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
LOSS_TOL = 1e-6
WEIGHTS_TOL = 1e-6


def test_profile_stages_names_its_stages(capsys):
    out = tps.profile_stages(2, "cpu", VapConfig(**NARROW), n_samples=16_000, iters=2)
    jax_names = ["full forward+probs", "full forward", "conv stack (fused, R=2B)", "gru (R=2B)", "downsample (R=2B)",
                 "ar_channel GPT 1L (B)", "ar stereo GPT 3L (B)", "one attention pass (B)", "one attention pass (2B)",
                 "probs_from_logits"]
    assert set(jax_names) | {"gru+downsample (fused, R=2B)", "heads (B)"} == set(out)
    printed = capsys.readouterr().out
    for name, rec in out.items():
        assert rec["ms"] > 0 and rec["launches"] == {} and name in printed  # no kernel runs on the CPU
    assert out["conv stack (fused, R=2B)"]["gflop"] > 0 and "# B=2 total=" in printed


@pytest.mark.parametrize("frozen", [True, False])
def test_profile_train_step_stages_equal_the_step(frozen, capsys):
    conf = VapConfig(**NARROW, dropout=0.0, freeze_encoder=frozen)
    out = tpts.profile_train_step(2, deep=True, iters=1, device="cpu", conf=conf, n_samples=16_000, vad_frames=150)
    stages = out["stages"]
    want = {"aug", "fwd", "grad", "step", "enc_fwd", "labels", "tf_fwd", "tf_grad", "attn_site_fwd",
            "attn_site_grad", "opt"}
    if not frozen:
        want |= {"enc_grad", "conv_fwd", "conv_grad", "gru_fwd", "gru_grad"}
    assert set(stages) == want
    # the full step at rate 0 on the same weights and batch
    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=0), conf))
    batch = tpts._batch(2, 16_000, 150, torch.device("cpu"))
    loss = float(make_train_step(conf, make_optimizer(OptConfig(), net, frozen))(net, batch, torch.Generator())["loss"])
    for key in ("fwd", "grad", "tf_fwd", "tf_grad"):
        assert abs(stages[key]["value"] - loss) <= LOSS_TOL * abs(loss), (key, stages[key]["value"], loss)
    printed = capsys.readouterr().out
    assert "# deep summary (B=2)" in printed and ("enc_grad (fwd+bwd, cotangent)" in printed) != frozen
    assert out["summary"]["frozen"] == frozen and out["summary"]["attn_sites"] == 6


def test_profile_input_pipeline(tmp_path, monkeypatch):
    monkeypatch.setattr(tpip, "EVENTS_S", 0.2)
    monkeypatch.setattr(tpip, "FLIP_S", 0.1)
    manifest = dialog_corpus(tmp_path, n=3, dur=7.0)
    out = tpip.profile_input_pipeline(manifest, batch_size=2, audio_duration=2.0, n_batches=4, num_workers=2,
                                      device="cpu")
    assert out["batches"] >= 1 and out["loader_audio_s_per_s"] > 0
    assert out["events_ms_per_batch"] > 0 and out["flip_ms_per_batch"] > 0


def test_multihost_rehearsal_two_processes_as_one(monkeypatch):
    # the ranks (python -m) import the package from the repository's root
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    out = tmh.rehearse((1, 2), steps=2, device="cpu")
    one, two = out["rows"]
    assert (one["procs"], two["procs"]) == (1, 2) and len(two["losses"]) == 2
    assert two["weights_max_diff"] <= WEIGHTS_TOL and out["loss_spread"] <= 1e-6 * abs(one["losses"][0])
    assert one["step_ms"] > 0 and two["step_ms"] > 0

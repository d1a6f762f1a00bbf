"""PyTorch port, the phrase probe and the figures in the entry points:
``evaluate(phrase_probe=)`` against JAX's ``evaluate`` (the probe's
``test_*`` means within 2e-6) and the ``evaluate`` CLI with the corpus
found; the Trainer with ``phrases_probe=1`` against JAX's ``Trainer.fit``
(``val_ps_*``, ``val_pl_*``, ``val_pls_*`` within 2e-6, the rest as
``tests/_torch_fit.py`` holds it); a Trainer epoch in ``pitch_mode="psola"``;
``run --plot`` writing its PNG; the evaluation's ``curves_*.png``."""

import csv
import json
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.io import wavfile

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.data import phrases as jph
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.train import evaluation as jeval
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch import evaluate as tevaluate
from voiceactivityprojection_tpu_torch import run as trun
from voiceactivityprojection_tpu_torch.data import phrases as tph
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import (
    export_vap_state_dict,
    params_from_jax,
    random_params_tree,
)
from voiceactivityprojection_tpu_torch.train import evaluation as teval
from voiceactivityprojection_tpu_torch.train import loop as tloop

from _torch_corpus import dialog_corpus
from _torch_fit import EVENTS, NARROW, PROBE_KEYS, check_rows, fit_both
from _torch_phrases import write_phrase_corpus

pytestmark = pytest.mark.evaluation

torch.set_num_threads(2)
PROBE_TOL = 2e-6
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]


@pytest.fixture(scope="module")
def phrases(tmp_path_factory):
    return write_phrase_corpus(tmp_path_factory.mktemp("phrases"), n=4, seed=3)


@pytest.fixture(scope="module")
def dialogs(tmp_path_factory):
    return dialog_corpus(tmp_path_factory.mktemp("dialogs"))


def _models():
    conf = tconfig.VapConfig(**NARROW)
    tree = random_params_tree(conf, seed=4)
    return (jvap.VapModel(jconfig.VapConfig(**NARROW), jax.tree.map(jnp.asarray, tree)),
            tvap.VapModel.from_jax_params(tree, conf, device="cpu"), tree)


def test_evaluate_merges_the_probe_as_jax(phrases, tmp_path):
    jmodel, tmodel, _ = _models()
    kw = dict(phrases_probe=1, phrases_root=phrases)
    tprobe = tph.make_phrase_probe(tconfig.DataConfig(**kw))
    jprobe = jph.make_phrase_probe(jconfig.DataConfig(**kw))
    timings = {}
    got = teval.evaluate(tmodel, [], tconfig.EventConfig(), out_dir=str(tmp_path / "t"), threshold_search=False,
                         phrase_probe=tprobe, timings=timings)
    want = jeval.evaluate(jmodel, [], jconfig.EventConfig(), out_dir=str(tmp_path / "j"), threshold_search=False,
                          phrase_probe=jprobe)
    assert list(got) == list(want)
    probe_keys = [k for k in want if k.startswith(("test_short_", "test_long_"))]
    assert len(probe_keys) == 27 and timings["phrase_probe_s"] > 0
    for k in probe_keys:
        assert abs(got[k] - want[k]) <= PROBE_TOL, (k, got[k], want[k])
    with open(tmp_path / "t" / "metrics.csv") as f:
        header, values = list(csv.reader(f))
    assert header == list(got) and "test_long_scp_now_react" in header
    assert all(math.isnan(got[k]) for k in ("test_loss", "test_loss_va"))


def test_evaluate_cli_runs_the_probe(phrases, dialogs, tmp_path):
    _, tmodel, tree = _models()
    sd = export_vap_state_dict(params_from_jax(tree, tconfig.VapConfig(**NARROW)))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tmp_path / "w.pt")
    out = tmp_path / "eval"
    tevaluate.main(["--device", "cpu", "--data_test_path", dialogs, "--state_dict", str(tmp_path / "w.pt"),
                    "--out_dir", str(out), "--data_phrases_root", phrases, "--data_audio_duration", "4",
                    "--data_batch_size", "2", "--limit_batches", "1", "--event_min_context_time", "1.0",
                    "--event_max_time", "4.0"] + SMALL_ARGS)
    with open(out / "metrics.csv") as f:
        row = dict(zip(*csv.reader(f)))
    probe = tph.PhraseProbe(root=phrases)
    means, _ = probe.extract_stats(tmodel)
    for k, v in means.items():
        assert float(row[f"test_{k}"]) == v, k


def test_trainer_probe_matches_jax(phrases, dialogs, tmp_path, monkeypatch):
    """The Trainer comparison of ``tests/_torch_fit.py`` with the probe
    required at every validation: its nine scalars within 2e-6 of JAX's."""
    rows, pooled, _, _, _ = fit_both(dialogs, tmp_path, monkeypatch, epochs=2, phrases_probe=1,
                                     phrases_root=phrases)
    for side in ("jax", "port"):
        assert all(set(PROBE_KEYS) <= set(r) for r in rows[side]), side
    check_rows(rows, pooled, epochs=2)


def test_trainer_epoch_in_psola_mode(dialogs, tmp_path):
    """Every step's pitch branch shifted on the host by TD-PSOLA: the epoch
    runs and its loss is finite, and the branch was taken."""
    trainer = tloop.Trainer(
        model_conf=tconfig.VapConfig(**NARROW), opt_conf=tconfig.OptConfig(patience=50),
        data_conf=tconfig.DataConfig(phrases_probe=0, train_path=dialogs, val_path=dialogs, batch_size=2,
                                     audio_duration=4.0, pitch_mode="psola", augment_probability=1.0),
        event_conf=tconfig.EventConfig(**EVENTS), max_epochs=1, seed=1, out_dir=str(tmp_path), device="cpu")
    calls = []
    real = trainer.augment.apply_pitch_host
    trainer.augment.apply_pitch_host = lambda w, s: calls.append(s) or real(w, s)
    trainer.fit()
    row = json.loads(open(os.path.join(trainer.out_dir, "metrics.jsonl")).readline())
    assert math.isfinite(row["loss"]) and math.isfinite(row["val_loss"])
    assert calls and all(abs(s) in (1.0, 2.0) for s in calls)


def test_run_plot_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    x = (0.2 * np.random.default_rng(0).standard_normal((16000 * 3, 2))).clip(-1, 1)
    wavfile.write(tmp_path / "a.wav", 16000, (x * 32767).astype(np.int16))
    trun.main(["-a", str(tmp_path / "a.wav"), "-o", str(tmp_path / "a.json"), "--plot", "--device", "cpu"]
              + SMALL_ARGS)
    png = tmp_path / "a.png"
    assert png.exists() and png.stat().st_size > 1000
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_evaluation_writes_curve_pngs(dialogs, tmp_path):
    pytest.importorskip("matplotlib")
    _, tmodel, _ = _models()
    loader = VapDataLoader(SlidingWindowDataset(dialogs, audio_duration=4.0), batch_size=2, shuffle=False,
                           drop_last=False)
    teval.evaluate(tmodel, loader, tconfig.EventConfig(**EVENTS), out_dir=str(tmp_path))
    fams = sorted(json.loads((tmp_path / "thresholds.json").read_text()))
    assert fams and sorted(p.name for p in tmp_path.glob("curves_*.png")) == [f"curves_{f}.png" for f in fams]

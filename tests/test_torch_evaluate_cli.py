"""PyTorch port, test-split evaluation end to end on the CPU: the port's
``evaluate()`` over the sliding-window loader against the JAX package's
with the same weights (a narrow model: dim 16, encoder 16, 1 + 1 layers)
on a corpus of 4 x 30 s sessions from ``examples/make_synthetic_corpus.py``
(8 windows of 20 s in batches of 3, 3 and 2): regions, balance debt and
targets exact, pooled predictions and losses within 2e-6, metrics equal
apart from predictions within 2e-6 of a threshold (``tests/_torch_eval.py``);
then one ``python -m voiceactivityprojection_tpu_torch.evaluate --device
cpu`` process against one JAX ``evaluate.py`` process; and the CLI's
refusals: no weights, an orbax ``--checkpoint``, no card for the default
device; and the phrase probe's gate, with the probe run where JAX runs it."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.data import dataset as jds
from voiceactivityprojection_tpu.data import phrases as jphrases
from voiceactivityprojection_tpu.models import checkpoint as jckpt
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.train import evaluation as jeval
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch import evaluate as tcli
from voiceactivityprojection_tpu_torch.data import dataset as tds
from voiceactivityprojection_tpu_torch.data import phrases as tphrases
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.train import evaluation as teval

from _torch_eval import compare_evaluations, pooled, recording

pytestmark = pytest.mark.evaluation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
BAR = 2e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The corpus (each session as windows 0-20 s and 10-30 s), a
    reference ``.pt`` of JAX-initialised weights, and both packages'
    ``evaluate()`` over it with their collectors recorded."""
    out = tmp_path_factory.mktemp("eval")
    subprocess.run([sys.executable, "examples/make_synthetic_corpus.py", "--out", str(out), "--n", "4",
                    "--duration", "30"], cwd=ROOT, check=True, capture_output=True, timeout=300)
    rows = [{"audio_path": str(out / f"s{i:03d}.wav"), "vad_path": str(out / f"s{i:03d}_vad.json"),
             "start": str(start)} for i in range(4) for start in (0.0, 10.0)]
    tds.write_manifest(rows, str(out / "test.csv"))
    tree = jax.tree.map(np.asarray, jvap.init_vap(jax.random.key(0), jconfig.VapConfig(**SMALL)))
    sd = jckpt.export_vap_state_dict(tree)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out / "w.pt")

    res = {"dir": out}
    for side, mod, ds_mod in (("port", teval, tds), ("jax", jeval, jds)):
        if side == "port":
            model = VapModel.from_torch_state_dict(str(out / "w.pt"), tconfig.VapConfig(**SMALL), device="cpu")
            conf = tconfig.EventConfig()
        else:
            model = jvap.VapModel.from_torch_state_dict(str(out / "w.pt"), jconfig.VapConfig(**SMALL))
            conf = jconfig.EventConfig()
        loader = ds_mod.VapDataLoader(ds_mod.SlidingWindowDataset(str(out / "test.csv")), batch_size=3,
                                      shuffle=False, drop_last=False)
        kw = {"timings": {}} if side == "port" else {}
        with recording(mod) as seen:
            res[side] = mod.evaluate(model, loader, conf, out_dir=str(out / f"in_{side}"), **kw)
        res[side + "_collector"] = seen[0]
        res[side + "_timings"] = kw.get("timings")
    return res


def test_evaluate_matches_jax(run):
    t, j = run["port_collector"], run["jax_collector"]
    assert len(t.events) == len(j.events) == 3  # batches of 3, 3 and 2
    assert t.events == j.events and t.debts == j.debts
    assert sum(len(r) for ev in t.events for r in ev["shift"]) > 0
    assert len(t.vap_losses) == 3
    np.testing.assert_allclose(t.vap_losses, j.vap_losses, atol=BAR, rtol=0)
    np.testing.assert_allclose(t.vad_losses, j.vad_losses, atol=BAR, rtol=0)
    report = compare_evaluations(run["port"], run["jax"], pooled(t), pooled(j), BAR, BAR)
    assert not report["mismatches"], report
    assert set(run["port_timings"]) == {"loader_wait_s", "eval_step_s", "events_metrics_s", "threshold_search_s",
                                        "phrase_probe_s", "save_s"}
    d = run["dir"]
    # the same files as JAX's, the curve PNGs included where matplotlib imports
    assert {"curves.npz", "metrics.csv", "thresholds.json"} <= set(os.listdir(d / "in_port"))
    assert sorted(os.listdir(d / "in_port")) == sorted(os.listdir(d / "in_jax"))
    with open(d / "in_port" / "thresholds.json") as f, open(d / "in_jax" / "thresholds.json") as g:
        assert set(json.load(f)) == set(json.load(g))


def test_limit_batches_stops_early(run, tmp_path):
    model = VapModel.from_torch_state_dict(str(run["dir"] / "w.pt"), tconfig.VapConfig(**SMALL), device="cpu")
    loader = tds.VapDataLoader(tds.SlidingWindowDataset(str(run["dir"] / "test.csv")), batch_size=3)
    with recording(teval) as seen:
        teval.evaluate(model, loader, tconfig.EventConfig(), out_dir=str(tmp_path), limit_batches=1,
                       threshold_search=False)
    assert len(seen[0].events) == 1 and len(seen[0].vap_losses) == 1
    assert os.listdir(tmp_path) == ["metrics.csv"]


def _read_csv(path):
    with open(path) as f:
        header, values = list(csv.reader(f))
    return dict(zip(header, map(float, values)))


def test_cli_process_matches_jax_cli(run):
    """One port CLI process (``--device cpu``) and one JAX ``evaluate.py``
    process on the same manifest and ``.pt``: the same columns, losses
    within the bar, and each metric equal, or where a prediction lies within
    the bar of its threshold, each equal to its own package's in-process
    value, which the test above holds to the other's."""
    d = run["dir"]
    common = ["--data_test_path", str(d / "test.csv"), "--state_dict", str(d / "w.pt"), "--data_batch_size", "3",
              "--data_phrases_probe", "0"] + SMALL_ARGS
    outs = {}
    for side, argv, env in (("jax", ["evaluate.py"], {"VAP_PLATFORM": "cpu"}),
                            ("port", ["-m", "voiceactivityprojection_tpu_torch.evaluate", "--device", "cpu"], {})):
        r = subprocess.run([sys.executable] + argv + common + ["--out_dir", str(d / f"cli_{side}")], cwd=ROOT,
                           capture_output=True, text=True, env=dict(os.environ, **env), timeout=600)
        assert r.returncode == 0, (side, r.stderr[-3000:])
        outs[side] = _read_csv(d / f"cli_{side}" / "metrics.csv")
        if side == "port":
            line = json.loads(r.stdout.strip().splitlines()[-1])
            assert line["device"] == "cpu" and line["windows"] == 8
            assert {"load_weights_s", "eval_step_s", "events_metrics_s", "evaluate_s"} <= set(line["timings"])
    assert list(outs["port"]) == list(outs["jax"]) == list(run["port"])
    report = compare_evaluations(run["port"], run["jax"], pooled(run["port_collector"]),
                                 pooled(run["jax_collector"]), BAR, BAR)
    for key, got in outs["port"].items():
        want = outs["jax"][key]
        if key.startswith("test_loss"):
            assert abs(got - want) <= BAR, key
        elif got != want:
            assert report["near"][key] > 0, (key, got, want)
            assert got == run["port"][key] and want == run["jax"][key], key
    files = ["curves.npz", "metrics.csv", "thresholds.json"]
    assert set(files) <= set(os.listdir(d / "cli_port"))
    assert sorted(os.listdir(d / "cli_port")) == sorted(os.listdir(d / "cli_jax"))  # the curve PNGs too
    with np.load(d / "cli_port" / "curves.npz") as a, np.load(d / "cli_jax" / "curves.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_cli_refuses_random_init(run, tmp_path):
    r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.evaluate", "--device", "cpu",
                        "--data_test_path", str(run["dir"] / "test.csv"), "--out_dir", str(tmp_path / "o")]
                       + SMALL_ARGS, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "no weights given" in r.stderr
    assert not (tmp_path / "o").exists()


def test_cli_random_init_when_asked(run, tmp_path):
    tcli.main(["--device", "cpu", "--allow_random_init", "--data_test_path", str(run["dir"] / "test.csv"),
               "--out_dir", str(tmp_path), "--limit_batches", "1", "--no_threshold_search",
               "--data_phrases_probe", "0"] + SMALL_ARGS)
    assert os.listdir(tmp_path) == ["metrics.csv"]


def test_cli_checkpoint_raises_naming_orbax(run, tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        tcli.main(["--device", "cpu", "--checkpoint", str(tmp_path), "--data_test_path",
                   str(run["dir"] / "test.csv"), "--data_phrases_probe", "0"] + SMALL_ARGS)


def test_cli_default_device_needs_a_card(run, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--state_dict", str(run["dir"] / "w.pt"), "--data_test_path", str(run["dir"] / "test.csv"),
                   "--out_dir", str(tmp_path / "o"), "--data_phrases_probe", "0"] + SMALL_ARGS)
    assert not (tmp_path / "o").exists()


def test_phrase_probe_gate(run, tmp_path):
    """0 off and -1 without a corpus: None, as JAX; 1 without one:
    FileNotFoundError, as JAX; with a corpus, where JAX runs the probe (it
    raised here until the probe was ported): a probe, and from the CLI the
    probe's region means in metrics.csv."""
    from _torch_phrases import write_phrase_corpus

    empty = str(tmp_path / "none")
    for mode in (0, -1):
        conf = dict(phrases_probe=mode, phrases_root=empty)
        assert tphrases.make_phrase_probe(tconfig.DataConfig(**conf)) is None
        assert jphrases.make_phrase_probe(jconfig.DataConfig(**conf)) is None
    for mod, cfg in ((tphrases, tconfig), (jphrases, jconfig)):
        with pytest.raises(FileNotFoundError, match="no phrase corpus"):
            mod.make_phrase_probe(cfg.DataConfig(phrases_probe=1, phrases_root=empty))
    write_phrase_corpus(tmp_path / "ref", n=2)
    for mode in (-1, 1):
        probe = tphrases.make_phrase_probe(tconfig.DataConfig(phrases_probe=mode, phrases_root=str(tmp_path / "ref")))
        assert isinstance(probe, tphrases.PhraseProbe) and len(probe.dset) == 2
    tcli.main(["--device", "cpu", "--state_dict", str(run["dir"] / "w.pt"), "--data_test_path",
               str(run["dir"] / "test.csv"), "--data_phrases_root", str(tmp_path / "ref"), "--limit_batches", "1",
               "--out_dir", str(tmp_path / "o")] + SMALL_ARGS)
    with open(tmp_path / "o" / "metrics.csv") as f:
        header = next(csv.reader(f))
    assert {"test_short_future_pred", "test_long_scp_now_react"} <= set(header)

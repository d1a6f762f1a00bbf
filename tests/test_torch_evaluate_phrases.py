"""PyTorch port, the prosody-probing CLI (``python -m
voiceactivityprojection_tpu_torch.evaluate_phrases``) against the JAX
package's root ``evaluate_phrases.py``: the seven permutations of a phrase
(JAX's script loaded by path) at the same bytes; both CLIs on the CPU in
subprocesses over a synthetic corpus from one reference-format state dict,
their ``phrases_scores.csv`` and ``phrases_aggregate.json`` within 2e-5;
the permutation cache's hits and misses; ``--directionality``; and the
default device refusing to run without a card."""

import csv
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu_torch import evaluate_phrases as tep
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.data.phrases import PhraseDataset
from voiceactivityprojection_tpu_torch.models.checkpoint import (
    export_vap_state_dict,
    params_from_jax,
    random_params_tree,
)

from _torch_phrases import write_phrase_corpus

pytestmark = pytest.mark.evaluation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
ATOL = 2e-5


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_evaluate_phrases", os.path.join(ROOT, "evaluate_phrases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 4-phrase corpus and a reference ``.pt`` of seeded weights."""
    out = tmp_path_factory.mktemp("phrases_cli")
    write_phrase_corpus(out / "ref", n=4, seed=1)
    conf = VapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
    sd = export_vap_state_dict(params_from_jax(random_params_tree(conf, seed=2), conf))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out / "w.pt")
    return out


def _args(files, out_dir, extra=()):
    return ["--state_dict", str(files / "w.pt"), "--phrases_root", str(files / "ref"), "--out_dir", str(out_dir),
            *extra] + SMALL_ARGS


@pytest.mark.parametrize("perm", tep.PERMUTATIONS)
def test_permute_waveform_matches_jax(files, perm):
    jmod = _jax_script()
    assert tuple(jmod.PERMUTATIONS) == tep.PERMUTATIONS
    dset = PhraseDataset(root=str(files / "ref"))
    for i in (0, 1):
        sample = dset[i]
        x = sample["waveform"][0]
        got, want = tep.permute_waveform(perm, x.copy(), sample), jmod.permute_waveform(perm, x.copy(), sample)
        assert got.dtype == want.dtype and got.shape == want.shape == x.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown permutation"):
        tep.permute_waveform("other", x, sample)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_matches_jax_cli(files):
    outs = {}
    for side, argv, env in (
        ("jax", ["evaluate_phrases.py"], {"VAP_PLATFORM": "cpu"}),
        ("port", ["-m", "voiceactivityprojection_tpu_torch.evaluate_phrases", "--device", "cpu"], {}),
    ):
        out_dir = files / f"out_{side}"
        r = subprocess.run([sys.executable] + argv + _args(files, out_dir, ["--perm_cache", ""]), cwd=ROOT,
                           capture_output=True, text=True, env=dict(os.environ, **env), timeout=600)
        assert r.returncode == 0, (side, r.stderr[-3000:])
        outs[side] = (_read_csv(out_dir / "phrases_scores.csv"),
                      json.loads((out_dir / "phrases_aggregate.json").read_text()), r.stdout)
    (trows, tagg, tout), (jrows, jagg, _) = outs["port"], outs["jax"]
    assert len(trows) == len(jrows) == 4 * 7
    assert list(trows[0]) == list(jrows[0])
    for a, b in zip(trows, jrows):
        for k in b:
            if k in ("phrase", "long_short", "gender", "phrase_idx", "permutation"):
                assert a[k] == b[k], k
            elif b[k] == "":
                assert a[k] == "", k
            else:
                assert abs(float(a[k]) - float(b[k])) <= ATOL, (k, a[k], b[k])
    assert tagg.keys() == jagg.keys()
    for perm in jagg:
        assert tagg[perm].keys() == jagg[perm].keys()
        for ls in jagg[perm]:
            for k, v in jagg[perm][ls].items():
                assert abs(tagg[perm][ls][k] - v) <= ATOL, (perm, ls, k)
    timings = json.loads(tout.strip().splitlines()[-1])
    assert timings["device"] == "cpu" and timings["rows"] == 28
    assert set(timings["timings"]) == {"load_weights_s", "host_dsp_s", "model_s", "io_s"}


def test_perm_cache_hits_and_misses(files, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    perms = ["regular", "flat_f0", "flat_intensity"]
    extra = ["--device", "cpu", "--perm_cache", str(cache), "--limit", "2", "--permutations", *perms]
    tep.main(_args(files, tmp_path / "a", extra))
    entries = sorted(p.name for p in cache.rglob("*.npy"))
    assert len(entries) == 2 * 2 and all(n.split("__")[0] in perms[1:] for n in entries)
    assert not list(cache.rglob("*.tmp*"))

    calls = []
    real = tep.permute_waveform
    monkeypatch.setattr(tep, "permute_waveform", lambda *a: calls.append(a[0]) or real(*a))
    tep.main(_args(files, tmp_path / "b", extra))
    assert calls == ["regular", "regular"]  # every other permutation came from the cache
    # a cached file of another shape is a miss: recomputed and replaced
    stale = next(cache.rglob("flat_f0__*.npy"))
    np.save(stale, np.zeros(7, np.float32))
    tep.main(_args(files, tmp_path / "c", extra))
    assert calls.count("flat_f0") == 1 and np.load(stale).shape != (7,)
    assert (tmp_path / "a" / "phrases_scores.csv").read_text() == (tmp_path / "c" / "phrases_scores.csv").read_text()


def test_directionality_writes_its_report(files, tmp_path):
    tep.main(_args(files, tmp_path, ["--device", "cpu", "--perm_cache", "", "--limit", "2", "--permutations",
                                     "regular", "flat_intensity", "--directionality"]))
    report = json.loads((tmp_path / "directionality.json").read_text())
    assert "flat_intensity" in json.dumps(report)


def test_default_device_needs_the_card(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tep.main(_args(files, tmp_path, ["--limit", "1"]))

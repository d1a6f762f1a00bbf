"""PyTorch port, the figures (``utils/plot.py``) and the profiling helpers
(``utils/profiling.py``) against the JAX package: every plot function of
the JAX package's tests/test_plot.py and the rest of the module, each
figure's line, image, collection and text data equal to JAX's figure on
the same inputs (not the PNG bytes; skipped without matplotlib);
``tree_stats`` over imported weights with JAX's keys and values exactly;
``activation_stats`` and ``gradient_stats`` within 1e-5 relative, their
histograms apart by values within 1e-5 of a bin edge; and ``trace``
writing a trace that loads, with a ``span`` in it."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.utils import plot as jplot
from voiceactivityprojection_tpu.utils import profiling as jprof
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.utils import plot as tplot
from voiceactivityprojection_tpu_torch.utils import profiling as tprof

pytestmark = pytest.mark.evaluation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
REL = 1e-5


@pytest.fixture(scope="module")
def plt():
    pytest.importorskip("matplotlib")
    return tplot._plt()


def _inputs():
    rng = np.random.default_rng(0)
    T = 100
    p = rng.random((T, 2)).astype(np.float32)
    return {
        "w": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "p": p / p.sum(-1, keepdims=True),
        "vad": (rng.random((T, 2)) < 0.5).astype(np.float32),
        "p1": rng.random(T).astype(np.float32),
        "scores": {"f1_hold_shift": 0.87, "f1_predict_shift": 0.79, "f1_short_long": 0.78,
                   "f1_bc_prediction": 0.72, "shift": {"f1": 0.61}, "hold": {"f1": 0.92}, "loss": 1.74,
                   "threshold_pred_shift": 0.09, "threshold_pred_bc": 0.05, "threshold_short_long": 0.31},
        "sample": {"waveform": (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32), "phrase": "student",
                   "long_short": "long", "gender": "female", "words": ["are", "you", "a", "student"],
                   "starts": [0.0, 0.1, 0.3, 0.4], "end": 40, "scp": 35},
        "tone": (0.3 * np.sin(2 * np.pi * 160 * np.arange(16000) / 16000)).astype(np.float32),
        "curves": {"thresholds": np.linspace(0, 1, 11), "f1_weighted": rng.random(11),
                   "balanced_accuracy": rng.random(11), "precision": rng.random(11), "recall": rng.random(11)},
    }


def _axes(plt, n=1, ylim=None):
    fig, ax = plt.subplots(n, 1)
    axs = list(np.atleast_1d(ax))
    for a in axs:
        if ylim:
            a.set_ylim(ylim)
    return fig, axs


def _on_axes(fn, n=1, ylim=None):
    def run(m, plt, x):
        fig, ax = _axes(plt, n, ylim)
        fn(m, ax, x)
        return fig
    return run


FIGURES = {
    "plot_stereo": lambda m, plt, x: m.plot_stereo(x["w"], x["p"], x["p"], x["vad"])[0],
    "plot_vap": lambda m, plt, x: m.plot_vap(x["w"], x["p1"], p_fut=x["p1"][::-1].copy(), vad=x["vad"])[0],
    "plot_vap_now_only": lambda m, plt, x: m.plot_vap(x["w"], x["p"])[0],
    "plot_threshold_curves": lambda m, plt, x: m.plot_threshold_curves(x["curves"], title="hs")[0],
    "plot_evaluation_scores": lambda m, plt, x: m.plot_evaluation_scores(x["scores"])[0],
    "plot_phrases_sample": lambda m, plt, x: m.plot_phrases_sample(x["sample"], x["p"][:50], x["p"][:50])[0],
    "plot_event_and_words_time": _on_axes(lambda m, ax, x: (
        m.plot_event([(10, 30, 0), (50, 70, 1)], ax, frame_hz=50),
        m.plot_words_time(["hi", "there"], ax[0], starts=[0.1, 0.5], ends=[0.4, 0.9]),
        m.plot_words_time(["x"], ax[1], starts=[0.2])), n=2, ylim=[0, 80]),
    "plot_stereo_mel_spec": _on_axes(lambda m, ax, x: m.plot_stereo_mel_spec(x["w"][:, :16000], ax=ax,
                                                                             vad=x["vad"][:50]), n=2),
    "plot_mel_spec": _on_axes(lambda m, ax, x: m.plot_mel_spec(x["w"][0], ax=ax[0], vad=x["vad"][:, 0],
                                                               no_ticks=True)),
    "plot_next_speaker_probs_bc": _on_axes(lambda m, ax, x: m.plot_next_speaker_probs(
        x["p"], ax[0], p_bc=x["p"] * 0.3, vad=x["vad"], legend=True)),
    "plot_sample_panels": _on_axes(lambda m, ax, x: (
        m.plot_sample_waveform(x["w"][0], ax[0], words=["a", "b"], starts=[0.1, 0.5], ends=[0.4, 0.9]),
        m.plot_sample_mel_spec(x["w"][0], ax[1], words=["a", "b"], starts=[0.1, 0.5]),
        m.plot_sample_f0(x["tone"], ax[2])), n=3),
    "plot_small_panels": _on_axes(lambda m, ax, x: (
        m.plot_entropy(x["p1"] * 8, ax[0]), m.plot_waveform(x["w"][0], ax[1]),
        m.plot_probs(np.arange(100) / 50, x["p1"], ax[2]), m.plot_spectrogram(x["w"][:, :400], ax[3]),
        m.plot_words(["a", "b"], [0.1, 0.5], ax[4], word_ends=[0.4, 0.9]),
        m.plot_melspectrogram(x["w"][0], ax[5]), m.plot_vad(np.arange(100) / 50, x["vad"][:, 0], ax[5]),
        m.plot_f0(x["tone"], ax[6], hop_time=0.01)), n=7),
}


def _figure_data(fig):
    """Each axis's lines, images, collections, texts and limits."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [np.asarray(l.get_xydata(), dtype=np.float64) for l in ax.lines],
            "images": [np.asarray(im.get_array()) for im in ax.images],
            "collections": [[np.asarray(p.vertices) for p in c.get_paths()] for c in ax.collections],
            "patches": [np.asarray(p.get_verts()) for p in ax.patches],
            "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        })
    return out


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _equal(u, v, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_data_equals_jax(plt, name):
    x = _inputs()
    fig_t, fig_j = FIGURES[name](tplot, plt, x), FIGURES[name](jplot, plt, x)
    try:
        data = _figure_data(fig_t)
        assert any(d["lines"] or d["images"] or d["collections"] or d["patches"] for d in data)
        _equal(data, _figure_data(fig_j))
    finally:
        plt.close(fig_t)
        plt.close(fig_j)


def test_savepath_and_to_mono(plt, tmp_path):
    x = _inputs()
    tplot.plot_stereo(x["w"], x["p"], x["p"], x["vad"], savepath=str(tmp_path / "s.png"))
    assert (tmp_path / "s.png").stat().st_size > 1000
    w = np.ones((2, 100), np.float32)
    w[1] *= 3
    np.testing.assert_array_equal(tplot.to_mono(w), jplot.to_mono(w))
    assert tplot.to_mono(np.ones((4, 2, 100), np.float32)).shape == (4, 1, 100)
    with pytest.raises(NotImplementedError):
        tplot.to_mono(np.ones((3, 100)))


def test_import_leaves_matplotlib_out():
    code = ("import sys\nimport voiceactivityprojection_tpu_torch.utils.plot\n"
            "print('matplotlib' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr


# ---------------------------------------------------------------- profiling --
def _models(**kw):
    conf = dict(NARROW, **kw)
    tree = random_params_tree(VapConfig(**conf), seed=12)
    return (jvap.VapModel(JVapConfig(**conf), jax.tree.map(jnp.asarray, tree)),
            tvap.VapModel.from_jax_params(tree, VapConfig(**conf), device="cpu"), tree)


def test_tree_stats_equal_jax():
    jmodel, tmodel, tree = _models()
    got, want = tprof.tree_stats(tmodel.net), jprof.tree_stats(jmodel.params)
    assert got == want
    assert tprof.tree_stats(tree, prefix="p/") == jprof.tree_stats(jax.tree.map(jnp.asarray, tree), prefix="p/")
    # a flat state dict keeps its own names
    state = params_from_jax(tree, VapConfig(**NARROW))
    assert tprof.tree_stats(state) == {k.replace("/", "."): v for k, v in got.items()}


def _recording(module, monkeypatch):
    seen = {}
    base = module._leaf_stats

    def record(x, bins):
        out = base(x, bins)
        seen[len(seen)] = np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float64).ravel()
        return out

    monkeypatch.setattr(module, "_leaf_stats", record)
    return seen


def _stats_close(got, want, raw):
    assert list(got) == list(want) or set(got) == set(want)
    for i, k in enumerate(got):
        g, w = got[k], want[k]
        scale = max(abs(w["absmax"]), 1e-30)
        for f in ("mean", "std", "absmax"):
            assert abs(g[f] - w[f]) <= REL * scale, (k, f, g[f], w[f])
        edges = np.asarray(w["bin_edges"])
        np.testing.assert_allclose(g["bin_edges"], edges, rtol=0, atol=REL * scale, err_msg=k)
        values = raw[k]
        near = int((np.abs(values[:, None] - edges[None, :]) <= REL * scale).sum())
        moved = int(np.abs(np.asarray(g["hist"]) - np.asarray(w["hist"])).sum())
        assert moved <= 2 * near, (k, moved, near)


def test_activation_stats_match_jax(monkeypatch):
    jmodel, tmodel, _ = _models()
    wav = (np.random.default_rng(1).normal(size=(1, 2, 8000)) * 0.1).astype(np.float32)
    seen = _recording(tprof, monkeypatch)
    got = tprof.activation_stats(tmodel, wav)
    want = jprof.activation_stats(jmodel, wav)
    assert list(got) == list(want)
    _stats_close(got, want, dict(zip(got, seen.values())))


def test_gradient_stats_match_jax(monkeypatch):
    jmodel, tmodel, _ = _models(dropout=0.0)
    rng = np.random.default_rng(2)
    batch = {"waveform": (rng.normal(size=(1, 2, 8000)) * 0.1).astype(np.float32),
             "vad": (rng.random((1, 125, 2)) < 0.4).astype(np.float32)}
    seen = _recording(tprof, monkeypatch)
    got = tprof.gradient_stats(tmodel, batch)
    want = jprof.gradient_stats(jmodel, batch)
    assert set(got) == set(want) and all(k.startswith("grad/") for k in got)
    _stats_close(got, want, dict(zip(got, seen.values())))
    assert got["grad/vap_head/w"]["absmax"] > 0 and got["grad/encoder/gEncoder/0/conv/w"]["absmax"] == 0
    assert all(p.grad is None for p in tmodel.net.parameters())


def test_trace_holds_the_span(tmp_path):
    _, tmodel, _ = _models()
    wav = np.zeros((1, 2, 3200), np.float32)
    with tprof.trace(str(tmp_path)) as d:
        with tprof.span("probe_span"):
            tmodel.probs(wav)
    assert d == str(tmp_path)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "probe_span" for e in events)

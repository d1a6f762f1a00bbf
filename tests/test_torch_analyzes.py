"""PyTorch port, the analysis tools beside the package against the JAX
package's scripts (each loaded by path): the directionality report equal
to JAX's on the same score CSV under ``--voices all`` and ``heldout``; the
pseudo-dialog corpus's WAV bytes, VAD lists and manifests equal to JAX's
generator's on the same phrase corpus; the label counts equal to JAX's
exactly; the weight statistics within 2e-6, the activations' within 2e-5
and the gradients' within 1e-5 of each leaf's largest, with histogram
counts apart only by values within that bar of a bin edge; the
probabilities each stereo figure draws within 2e-6 of JAX's figure's, and
one PNG written per window; ``evaluate_phrases --directionality`` and the
held-out analysis run in a fresh interpreter without ``jax`` or ``pandas``,
the held-out keys read from the corpus CSV; and every tool of the slice
defaulting to the card and refusing to run without it."""

import csv
import importlib.util
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch.analyzes import interface_stereo as tis
from voiceactivityprojection_tpu_torch.analyzes import interface_stereo_phrases as tisp
from voiceactivityprojection_tpu_torch.analyzes import label_frequency as tlf
from voiceactivityprojection_tpu_torch.analyzes import model_params_grad as tmpg
from voiceactivityprojection_tpu_torch.analyzes import phrases_directionality as tpd
from voiceactivityprojection_tpu_torch.analyzes import plot_directionality as tplotd
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.data.phrases import PhraseDataset
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import (
    export_vap_state_dict,
    params_from_jax,
    random_params_tree,
)
from voiceactivityprojection_tpu_torch.tools import make_phrases_dialog_corpus as tmdc

from _torch_corpus import dialog_corpus
from _torch_native import same_native_backend
from _torch_phrases import write_phrase_corpus

pytestmark = pytest.mark.evaluation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
PROBS_TOL = 2e-6
STATS_TOL = {"params": 2e-6, "activations": 2e-5, "gradients": 1e-5}  # of each leaf's largest magnitude
# phrase i's voice: phrase_idx 0 two training voices, 1 and 2 the held-out pair
VOICES = ["en-US-Synth-0"] * 2 + ["en-US-Synth-1"] * 2 + (["en-US-Wavenet-F"] * 2 + ["en-US-Wavenet-D"] * 2) * 2
HELDOUT = {("female", "1"), ("male", "1"), ("female", "2"), ("male", "2")}


def _jax_script(rel: str):
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    mod.main()


@pytest.fixture(scope="module")
def phrases(tmp_path_factory):
    """12 phrases, the held-out voices at phrase_idx 1 and 2."""
    return write_phrase_corpus(tmp_path_factory.mktemp("phrases"), n=12, seed=4, voices=VOICES)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference ``.pt`` of seeded narrow weights, and their JAX tree."""
    tree = random_params_tree(VapConfig(**NARROW), seed=5)
    path = tmp_path_factory.mktemp("weights") / "w.pt"
    sd = export_vap_state_dict(params_from_jax(tree, VapConfig(**NARROW)))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path), tree


def _scores_csv(path, phrases_root):
    """Score rows for every sample of the corpus under four permutations:
    seeded values, a planted drop under flat_f0, an empty and a NaN cell."""
    rows, rng = [], np.random.default_rng(7)
    for s in PhraseDataset(root=phrases_root).rows:
        base = rng.uniform(0.2, 0.8, 4)
        for perm, shift in (("regular", 0.0), ("flat_f0", -0.05), ("shift_f0_up", 0.0), ("duration_avg", -0.01)):
            vals = base + shift + rng.normal(0, 0.01, 4)
            rows.append({"phrase": s["phrase"], "long_short": s["long_short"], "gender": s["gender"],
                         "phrase_idx": s["phrase_idx"], "permutation": perm, "now_pred": f"{vals[0]:.6f}",
                         "now_react": f"{vals[1]:.6f}", "future_pred": f"{vals[2]:.6f}",
                         "scp_now_pred": f"{vals[3]:.6f}" if s["long_short"] == "long" else ""})
    rows[5]["now_react"] = "nan"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


@pytest.mark.parametrize("voices", ["all", "heldout"])
def test_directionality_report_equals_jax(phrases, tmp_path, monkeypatch, voices):
    scores = _scores_csv(tmp_path / "scores.csv", phrases)
    jmod = _jax_script("analyzes/phrases_directionality.py")
    _jax_main(jmod, ["--scores", scores, "--out", str(tmp_path / "jax.json"), "--voices", voices,
                     "--phrases_root", phrases], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = tpd.run(scores, str(tmp_path / "port.json"), voices, phrases)
    assert json.loads((tmp_path / "port.json").read_text()) == want == json.loads(json.dumps(got))
    assert want["regions"]["flat_f0"]["now_pred"]["n"] == (12 if voices == "all" else 8)
    assert tpd.heldout_keys(phrases) == jmod.heldout_keys(phrases) == HELDOUT


def test_heldout_keys_fall_back_as_jax(tmp_path, capsys):
    assert tpd.heldout_keys(str(tmp_path)) == tpd.FALLBACK_HELDOUT  # no corpus there
    assert "heldout_keys fallback" in capsys.readouterr().out
    other = write_phrase_corpus(tmp_path / "other", n=4)  # no VAL_VOICES voice
    assert tpd.heldout_keys(other) == tpd.FALLBACK_HELDOUT


@pytest.mark.parametrize("isolate_f0", [False, True])
def test_dialog_corpus_equals_jax(phrases, tmp_path, monkeypatch, isolate_f0):
    same_native_backend(monkeypatch)
    jmod = _jax_script("examples/make_phrases_dialog_corpus.py")
    assert tmdc.VAL_VOICES == jmod.VAL_VOICES
    ref = os.path.join(phrases, "dataset_phrases")
    args = ["--n_train", "2", "--n_val", "2", "--duration", "6", "--seed", "3"] + (["--isolate_f0"] if isolate_f0
                                                                                 else [])
    _jax_main(jmod, ["--ref", ref, "--out", str(tmp_path / "jax")] + args, monkeypatch)
    assert tmdc.main(["--ref", ref, "--out", str(tmp_path / "port"), "--device", "cpu"] + args) == 0
    jfiles, tfiles = sorted(os.listdir(tmp_path / "jax")), sorted(os.listdir(tmp_path / "port"))
    assert jfiles == tfiles and len(jfiles) == 4 * 2 + 2
    for name in jfiles:
        a, b = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".csv"):
            a = a.replace(str(tmp_path / "port").encode(), b"DIR")
            b = b.replace(str(tmp_path / "jax").encode(), b"DIR")
        assert a == b, name


def test_label_frequency_equals_jax(tmp_path, monkeypatch):
    (tmp_path / "corpus").mkdir()
    manifest = dialog_corpus(tmp_path / "corpus")
    jmod = _jax_script("analyzes/label_frequency.py")
    _jax_main(jmod, ["--manifest", manifest, "--audio_duration", "2", "--out", str(tmp_path / "jax.json")],
              monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    assert tlf.main(["--manifest", manifest, "--audio_duration", "2", "--out", str(tmp_path / "port.json"),
                     "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert want["n_windows"] == 9 and want["total"] == sum(want["counts"])


def _recording(monkeypatch):
    """The raw values of every statistic the port computes, in order."""
    from voiceactivityprojection_tpu_torch.utils import profiling

    seen, base = [], profiling._leaf_stats

    def record(x, bins):
        seen.append(np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float64).ravel())
        return base(x, bins)

    monkeypatch.setattr(profiling, "_leaf_stats", record)
    return seen


def _stats_close(got, want, tol, raw):
    assert set(got) == set(want)
    for k, values in zip(got, raw):
        g, w = got[k], want[k]
        bar = tol * max(abs(w["absmax"]), 1e-30)
        for f in ("mean", "std", "absmax"):
            assert abs(g[f] - w[f]) <= bar, (k, f, g[f], w[f])
        edges = np.asarray(w["bin_edges"])
        np.testing.assert_allclose(g["bin_edges"], edges, rtol=0, atol=bar, err_msg=k)
        # a value within the bar of a bin edge may fall on either side of it
        near = int((np.abs(values[:, None] - edges[None, :]) <= bar).sum())
        moved = int(np.abs(np.asarray(g["hist"]) - np.asarray(w["hist"])).sum())
        assert moved <= 2 * near, (k, moved, near)


def test_model_params_grad_matches_jax(weights, tmp_path, monkeypatch):
    sd_path, _ = weights
    jmod = _jax_script("analyzes/model_params_grad.py")
    args = ["--state_dict", sd_path, "--seconds", "0.5"] + SMALL_ARGS
    _jax_main(jmod, args + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    raw = _recording(monkeypatch)
    assert tmpg.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu", "--plot"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert list(got) == ["params", "activations", "gradients"]
    assert got["params"] == want["params"]  # the same weights: the same statistics
    assert len(raw) == sum(len(got[part]) for part in got)
    offset = len(got["params"])
    for part in ("activations", "gradients"):
        _stats_close(got[part], want[part], STATS_TOL[part], raw[offset:offset + len(got[part])])
        offset += len(got[part])
    assert (tmp_path / "port.png").exists()


def _models(tree):
    jmodel = jvap.VapModel(JVapConfig(**NARROW), jax.tree.map(jnp.asarray, tree))
    return jmodel, tvap.VapModel.from_jax_params(tree, VapConfig(**NARROW), device="cpu")


def _drawn(fig):
    """The p_now and p_future lines' y data of a stereo figure."""
    return [np.asarray(line.get_ydata(), np.float64) for ax in fig.axes[2:4] for line in ax.lines]


def _same_lines(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=PROBS_TOL)


def test_interface_stereo_export_matches_jax(weights, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    sd_path, tree = weights
    (tmp_path / "corpus").mkdir()
    manifest = dialog_corpus(tmp_path / "corpus", n=1, dur=5.0)
    jmod = _jax_script("analyzes/interface_stereo.py")
    jmodel, tmodel = _models(tree)
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset

    item = SlidingWindowDataset(manifest, audio_duration=2.0)[1]
    (tfig, _), (jfig, _) = tis.sample_figure(tmodel, item), jmod.sample_figure(jmodel, item)
    _same_lines(_drawn(tfig), _drawn(jfig))
    assert tis.main(["--manifest", manifest, "--export", str(tmp_path / "png"), "--audio_duration", "2", "--limit",
                     "5", "--state_dict", sd_path, "--device", "cpu"] + SMALL_ARGS) == 0
    assert sorted(os.listdir(tmp_path / "png")) == [f"window_{i:04d}.png" for i in range(2)]


def test_interface_stereo_phrases_export_matches_jax(phrases, weights, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    same_native_backend(monkeypatch)
    sd_path, tree = weights
    jmod = _jax_script("analyzes/interface_stereo_phrases.py")
    assert tuple(jmod.PERMUTATIONS) == tuple(tisp.PERMUTATIONS)
    jmodel, tmodel = _models(tree)
    item = PhraseDataset(root=phrases)[1]
    for perm in ("regular", "flat_intensity"):
        _same_lines(_drawn(tisp.sample_figure(tmodel, item, perm)), _drawn(jmod.sample_figure(jmodel, item, perm)))
    args = ["--phrases_root", phrases, "--export", str(tmp_path / "png"), "--limit", "2", "--permutation",
            "flat_intensity", "--state_dict", sd_path, "--device", "cpu"] + SMALL_ARGS
    assert tisp.main(args) == 0
    names = sorted(os.listdir(tmp_path / "png"))
    assert len(names) == 2 and all(n.endswith("_flat_intensity.png") for n in names)


def test_streamlit_modes_need_streamlit(capsys):
    if importlib.util.find_spec("streamlit") is not None:
        pytest.skip("streamlit is installed: its browser would start")
    assert tis.main(["--manifest", "m.csv", "--device", "cpu"]) == 1
    assert tisp.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out.count("streamlit not installed") == 2


def test_plot_directionality_writes_the_forest(tmp_path, phrases):
    pytest.importorskip("matplotlib")
    scores = _scores_csv(tmp_path / "scores.csv", phrases)
    for voices, name in (("all", "directionality.json"), ("heldout", "directionality_heldout.json")):
        tpd.run(scores, str(tmp_path / name), voices, phrases)
    # the figure reads every permutation of its table: give the missing ones the planted one's numbers
    for name in ("directionality.json", "directionality_heldout.json"):
        report = json.loads((tmp_path / name).read_text())
        for perm, _ in tplotd.PERMS:
            report["regions"].setdefault(perm, report["regions"]["flat_f0"])
        (tmp_path / name).write_text(json.dumps(report))
    assert tplotd.main(["--dir", str(tmp_path), "--device", "cpu"]) == 0
    assert (tmp_path / "directionality_forest.png").stat().st_size > 10_000


def test_evaluate_phrases_directionality_needs_nothing_of_jax(phrases, weights, tmp_path):
    sd_path, _ = weights
    out = tmp_path / "eval"
    argv = ["--device", "cpu", "--directionality", "--state_dict", sd_path, "--phrases_root", phrases, "--out_dir",
            str(out), "--perm_cache", "", "--permutations", "regular", "flat_intensity"] + SMALL_ARGS
    code = (
        "import json, sys\n"
        "from voiceactivityprojection_tpu_torch import evaluate_phrases\n"
        "from voiceactivityprojection_tpu_torch.analyzes import phrases_directionality as pd\n"
        f"evaluate_phrases.main({argv!r})\n"
        f"keys = pd.heldout_keys({phrases!r})\n"
        f"pd.run({str(out / 'phrases_scores.csv')!r}, {str(out / 'heldout.json')!r}, 'heldout', {phrases!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pandas', "
        "'voiceactivityprojection_tpu'))\n"
        "print('RESULT', json.dumps({'bad': bad, 'keys': sorted(keys)}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "fallback" not in r.stdout
    result = json.loads(r.stdout.split("RESULT ", 1)[1])
    assert result["bad"] == [] and {tuple(k) for k in result["keys"]} == HELDOUT
    assert json.loads((out / "directionality.json").read_text())["regions"]["flat_intensity"]["now_pred"]["n"] == 12
    assert json.loads((out / "heldout.json").read_text())["regions"]["flat_intensity"]["now_pred"]["n"] == 8


TOOLS = {
    "analyzes.phrases_directionality": ["--scores", "s.csv"],
    "analyzes.plot_directionality": [],
    "analyzes.label_frequency": ["--manifest", "m.csv"],
    "analyzes.model_params_grad": [],
    "analyzes.interface_stereo": ["--manifest", "m.csv", "--export", "png"],
    "analyzes.interface_stereo_phrases": ["--export", "png"],
    "tools.make_phrases_dialog_corpus": ["--out", "corpus"],
    "tools.soak_sds": [],
    "tools.soak_churn": [],
    "tools.profile_stages": [],
    "tools.profile_train_step": [],
    "tools.profile_input_pipeline": ["--csv", "m.csv"],
    "tools.multihost_rehearsal": [],
    "tools.f32_route_turns": [],
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_defaults_to_the_card(name, monkeypatch, tmp_path):
    """``python -m <tool>`` runs on the card by default and raises without
    one, before it reads or writes any file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module = f"voiceactivityprojection_tpu_torch.{name}"
    monkeypatch.setattr(sys, "argv", [module] + TOOLS[name])
    monkeypatch.delitem(sys.modules, module, raising=False)  # run afresh, as python -m does
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    assert os.listdir(tmp_path) == []

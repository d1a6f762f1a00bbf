"""PyTorch port, the phrase corpus and the turn-shift probe
(``data/phrases.py``) against the JAX package on a synthetic corpus in the
reference's CSV schema (``tests/_torch_phrases.py``: WAVs at 22,050 Hz, so
that loading resamples): the rows (read without pandas) equal to JAX's
DataFrame rows, the dataset's items and batches exact, the ``limit``
subsets, the regions, the probe's means and stds within 2e-6 for the
stereo model and the mono model with its VAD history, the gate, and the
module with pandas blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.data import phrases as jph
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch.data import phrases as tph
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree

from _torch_native import same_native_backend
from _torch_phrases import write_phrase_corpus

pytestmark = pytest.mark.data

NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
PROBE_TOL = 2e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_audio_backend(monkeypatch):
    """Loading resamples the corpus's 22,050 Hz WAVs: both packages on one backend."""
    same_native_backend(monkeypatch)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_phrase_corpus(tmp_path_factory.mktemp("phrases"), n=6)


def test_rows_equal_jax_dataframe(corpus):
    csv_path = os.path.join(corpus, tph.PHRASE_CSV)
    rows = tph.load_phrase_dataframe(csv_path)
    want = jph.load_phrase_dataframe(csv_path).to_dict("records")
    assert rows == want
    assert [type(r["phrase_idx"]) for r in rows] == [int] * len(rows)
    assert [type(r["scp"]) for r in rows] == [float] * len(rows)
    assert isinstance(rows[0]["vad_list"], list) and isinstance(rows[0]["words"], list)
    assert tph.EXAMPLE_TO_SCP_WORD == jph.EXAMPLE_TO_SCP_WORD


@pytest.mark.parametrize("limit", [0, 1, 2, 3])
@pytest.mark.parametrize("mono", [False, True])
def test_dataset_items_and_batches_equal_jax(corpus, limit, mono):
    t = tph.PhraseDataset(root=corpus, limit=limit, audio_mono=mono)
    j = jph.PhraseDataset(root=corpus, limit=limit, audio_mono=mono)
    assert t.rows == j.df.to_dict("records")
    assert (len(t), t.max_time, t.n_samples, t.n_frames) == (len(j), j.max_time, j.n_samples, j.n_frames)
    if limit:
        assert {r["long_short"] for r in t.rows} == {"short", "long"}
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    for bt, bj in zip(t.batches(4), j.batches(4), strict=True):
        assert bt.keys() == bj.keys()
        for k in bt:
            if isinstance(bt[k], np.ndarray):
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
            else:
                assert bt[k] == bj[k], k


def test_get_sample_and_regions(corpus):
    t, j = tph.PhraseDataset(root=corpus), jph.PhraseDataset(root=corpus)
    r = t.rows[3]
    key = (r["phrase"], r["long_short"], r["gender"], r["phrase_idx"])
    a, b = t.get_sample(*key), j.get_sample(*key)
    assert (a["phrase"], a["long_short"], a["end"], a["scp"]) == (b["phrase"], b["long_short"], b["end"], b["scp"])
    np.testing.assert_array_equal(a["waveform"], b["waveform"])
    p = np.random.default_rng(0).random((t.n_frames, 2)).astype(np.float32)
    for end, frames in ((a["end"], 10), (a["scp"], 5), (t.n_frames - 3, 10)):
        for u, v in zip(tph.get_region_shift_probs(p, end, frames), jph.get_region_shift_probs(p, end, frames)):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="n_frames, 2"):
        tph.get_region_shift_probs(p[:, 0], 10, 5)


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= PROBE_TOL, (k, got[k], want[k])


def test_probe_stereo_matches_jax(corpus):
    conf = dict(NARROW)
    tree = random_params_tree(tconfig.VapConfig(**conf), seed=5)
    jmodel = jvap.VapModel(jconfig.VapConfig(**conf), jax.tree.map(jnp.asarray, tree))
    tmodel = tvap.VapModel.from_jax_params(tree, tconfig.VapConfig(**conf), device="cpu")
    tprobe, jprobe = tph.PhraseProbe(root=corpus, batch_size=4), jph.PhraseProbe(root=corpus, batch_size=4)
    (tm, ts), (jm, js) = tprobe.extract_stats(tmodel), jprobe.extract_stats(jmodel)
    _close(tm, jm)
    _close(ts, js)
    assert len(tm) == 3 * 3 * 3  # (short, long, long_scp) x (now, future, tot) x regions
    assert tprobe.val_log_stats(tm).keys() == jprobe.val_log_stats(jm).keys()
    _close(tprobe.val_log_stats(tm), jprobe.val_log_stats(jm))


@pytest.mark.parametrize("history", [True, False])
def test_probe_mono_matches_jax(corpus, history):
    conf = dict(NARROW, va_history=history)
    times = (2.0, 1.0, 0.5, 0.25)
    tree = random_params_tree(tconfig.VapMonoConfig(**conf), seed=6)
    jmodel = jvap.VapMonoModel(jconfig.VapMonoConfig(**conf), jax.tree.map(jnp.asarray, tree))
    tmodel = tvap.VapMonoModel.from_jax_params(tree, tconfig.VapMonoConfig(**conf), device="cpu")
    kw = dict(root=corpus, batch_size=4, mono=True, limit=4, va_history_times=times)
    tm, ts = tph.PhraseProbe(**kw).extract_stats(tmodel)
    jm, js = jph.PhraseProbe(**kw).extract_stats(jmodel)
    _close(tm, jm)
    _close(ts, js)
    if history:  # the history reaches the forward: without its head the means move
        tree2 = dict(tree)
        tree2.pop("va_cond_history")
        other = tvap.VapMonoModel.from_jax_params(tree2, tconfig.VapMonoConfig(**dict(conf, va_history=False)),
                                                  device="cpu")
        m2, _ = tph.PhraseProbe(**kw).extract_stats(other)
        assert any(abs(tm[k] - m2[k]) > 1e-9 for k in tm)


def test_make_phrase_probe_modes(corpus, tmp_path):
    empty = str(tmp_path / "none")
    for mod, cfg in ((tph, tconfig), (jph, jconfig)):
        assert mod.make_phrase_probe(cfg.DataConfig(phrases_probe=0, phrases_root=corpus)) is None
        assert mod.make_phrase_probe(cfg.DataConfig(phrases_probe=-1, phrases_root=empty)) is None
        with pytest.raises(FileNotFoundError, match="no phrase corpus"):
            mod.make_phrase_probe(cfg.DataConfig(phrases_probe=1, phrases_root=empty))
    for mode in (-1, 1):
        for mono in (False, True):
            kw = dict(phrases_probe=mode, phrases_root=corpus, phrases_probe_limit=2)
            t = tph.make_phrase_probe(tconfig.DataConfig(**kw), mono=mono)
            j = jph.make_phrase_probe(jconfig.DataConfig(**kw), mono=mono)
            assert isinstance(t, tph.PhraseProbe)
            assert t.dset.rows == j.dset.df.to_dict("records") and len(t.dset) == 2
            assert (t.dset.audio_mono, t.region_frames, t.va_history_frames) == \
                (j.dset.audio_mono, j.region_frames, j.va_history_frames)


def test_module_runs_without_pandas(corpus):
    """pandas is absent on the card's machine: block it, then read the
    corpus and build a probe."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "from voiceactivityprojection_tpu_torch.data import phrases\n"
        f"p = phrases.PhraseProbe(root={corpus!r}, limit=2)\n"
        "item = p.dset[0]\n"
        "print(len(p.dset), item['waveform'].shape, 'pandas' in sys.modules and sys.modules['pandas'] is not None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "2" and out.stdout.split()[-1] == "False"

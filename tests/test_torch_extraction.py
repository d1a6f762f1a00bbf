"""PyTorch port, offline extraction: ``VapExtractor`` (single shot and the
chunked, batched, stitched windows), its JSON and CSV files,
``VapModel.vad`` and ``VapModel.probs(vad=)`` for every objective
representation, against the JAX package on the same weights and inputs
(float32, CPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.inference.extraction import VapExtractor as JVapExtractor
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.extraction import MAX_SINGLE_SHOT_TIME, VapExtractor
from voiceactivityprojection_tpu_torch.models import vap as tvap

pytestmark = pytest.mark.inference

torch.set_num_threads(2)

SMALL = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
ATOL = 2e-5  # float32, port against JAX on the CPU
KEYS = ("p_now", "p_future", "H", "vad", "probs")


def _models(representation="discrete", seed=0):
    jconf = JVapConfig(representation=representation, **SMALL)
    conf = VapConfig(representation=representation, **SMALL)
    jmodel = jvap.VapModel.init(jax.random.key(seed), jconf)
    tmodel = tvap.VapModel.from_jax_params(jax.tree.map(np.asarray, jmodel.params), conf, device="cpu")
    return jmodel, tmodel


@pytest.fixture(scope="module")
def models():
    return _models()


def _wave(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _vad(frames, seed):
    return (np.random.default_rng(seed).random((1, frames, 2)) < 0.5).astype(np.float32)


def _close(got, want, keys=KEYS):
    assert set(got) == set(want)
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, err_msg=k)


def _pair(models, **kw):
    jmodel, tmodel = models
    return JVapExtractor(jmodel, **kw), VapExtractor(tmodel, **kw)


@pytest.mark.parametrize("shape, frames", [((2, 48_000), 150), ((1, 32_000), 100), ((1, 2, 128_123), 400)])
def test_extract_single_shot_matches_jax(models, shape, frames):
    """Up to 160 s one forward; a mono signal gets a silent channel; a
    length that is not whole frames keeps the floor."""
    jex, tex = _pair(models, context_time=4.0, step_time=1.0)
    w = _wave(shape, seed=frames)
    got, want = tex.extract(w), jex.extract(w)
    assert got["p_now"].shape == (1, frames, 2)
    _close(got, want)
    assert MAX_SINGLE_SHOT_TIME == 160.0


@pytest.mark.parametrize("seconds, extra", [(12.3, 0), (9.7, 77), (7.0, 5)])
def test_step_extraction_matches_jax(models, seconds, extra):
    """Windows of 5 s every 1 s, four to a model call (the last call
    padded): the stitched frames and their count. 9.7 s + 77 samples leaves
    a tail window and an odd sample count."""
    jex, tex = _pair(models, context_time=4.0, step_time=1.0, chunk_batch=4)
    n = int(16000 * seconds) + extra
    w = _wave((1, 2, n), seed=extra)
    got, want = tex.step_extraction(w), jex.step_extraction(w)
    assert got["p_now"].shape[1] == int(n / 16000 * 50) == want["p_now"].shape[1]
    _close(got, want)
    # the first window's frames are one direct pass of its samples
    direct = models[1].probs(w[:, :, : tex.chunk_samples])
    np.testing.assert_allclose(got["p_now"][0, : tex.chunk_frames], direct["p_now"][0].numpy(), atol=1e-6)


def test_step_extraction_with_vad_loss_matches_jax(models):
    jex, tex = _pair(models, context_time=4.0, step_time=1.0, chunk_batch=4)
    seconds = 11.0
    w = _wave((1, 2, int(16000 * seconds)), seed=2)
    vad = _vad(int(seconds * 50) + 100, seed=3)
    got, want = tex.step_extraction(w, vad=vad), jex.step_extraction(w, vad=vad)
    _close(got, want, KEYS + ("loss",))
    assert got["loss"].shape == (1, 550)


def test_step_extraction_shorter_than_a_window_matches_jax(models):
    jex, tex = _pair(models, context_time=4.0, step_time=1.0, chunk_batch=4)
    w = _wave((1, 2, 16000 * 3), seed=8)
    vad = _vad(250, seed=9)
    got, want = tex.step_extraction(w, vad=vad), jex.step_extraction(w, vad=vad)
    assert got["p_now"].shape == (1, 150, 2)
    _close(got, want, KEYS + ("loss",))


@pytest.mark.parametrize("representation", ["independent", "comparative"])
def test_stitched_loss_per_representation_matches_jax(representation):
    models = _models(representation, seed=1)
    jex, tex = _pair(models, context_time=4.0, step_time=1.0, chunk_batch=4)
    w = _wave((1, 2, int(16000 * 7.5)), seed=4)
    vad = _vad(int(7.5 * 50) + 100, seed=5)
    got, want = tex.step_extraction(w, vad=vad), jex.step_extraction(w, vad=vad)
    _close(got, want, KEYS + ("loss",))


def test_json_and_csv_files_match_jax(models, tmp_path):
    """The same outputs give the same files; the CSV keeps every frame and
    pads the shorter loss column with 0."""
    jex, tex = _pair(models, context_time=4.0, step_time=1.0)
    seconds = 6.0
    w = _wave((1, 2, int(16000 * seconds)), seed=6)
    out = tex.step_extraction(w, vad=_vad(int(seconds * 50), seed=7))
    assert out["loss"].shape[1] < out["p_now"].shape[1]
    for name, ex in (("port", tex), ("jax", jex)):
        ex.save_json(out, str(tmp_path / f"{name}.json"))
        ex.save_csv(out, str(tmp_path / f"{name}.csv"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert len(rows) == 1 + out["p_now"].shape[1]
    assert rows[0].split(",") == ["p_now", "p_future", "model_vad0", "model_vad1", "H", "loss"]
    assert float(rows[-1].split(",")[-1]) == 0.0
    # each side's own outputs: the same rows
    jout = jex.step_extraction(w, vad=_vad(int(seconds * 50), seed=7))
    jex.save_csv(jout, str(tmp_path / "jax_own.csv"))
    assert len((tmp_path / "jax_own.csv").read_text().splitlines()) == len(rows)


@pytest.mark.parametrize("fill, omit", [(0.02, 0.02), (0.1, 0.06), (0.0, 0.0)])
def test_model_vad_matches_jax(models, fill, omit):
    jmodel, tmodel = models
    w = _wave((2, 2, 48_000), seed=10)
    want = np.asarray(jmodel.vad(w, fill, omit, 0.5))
    got = tmodel.vad(w, fill, omit, 0.5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("representation", ["discrete", "independent", "comparative"])
def test_probs_with_vad_matches_jax(representation):
    """``probs(vad=)`` adds the per-frame loss against the labels of the
    given VAD, for every representation (the port once raised for the
    Bernoulli ones)."""
    jmodel, tmodel = _models(representation, seed=2)
    w = _wave((2, 2, 64_000), seed=11)
    vad = (np.random.default_rng(12).random((2, 300, 2)) < 0.5).astype(np.float32)
    want = jmodel.probs(w, vad=vad)
    got = {k: v.numpy() for k, v in tmodel.probs(w, vad=vad).items()}
    _close(got, {k: np.asarray(v) for k, v in want.items()}, KEYS + ("loss",))
    assert "loss" not in tmodel.probs(w)
    assert tmodel.horizon_time == jmodel.horizon_time == pytest.approx(2.0)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_objective_variants_match_jax(reduction):
    """Labels, losses and next-speaker probabilities of the independent and
    comparative representations against JAX's (float32 CPU bar 2e-6)."""
    from voiceactivityprojection_tpu.ops import objective_variants as jov
    from voiceactivityprojection_tpu_torch.ops import objective_variants as tov

    assert tov.HEAD_DIMS == jov.HEAD_DIMS
    rng = np.random.default_rng(13)
    va = (rng.random((2, 160, 2)) < 0.4).astype(np.float32)
    va[1, :, :] = 0.0  # all silent: the comparative label's 0.5
    bins = [10, 20, 30, 40]
    for t_lab, j_lab in ((tov.get_labels_independent, jov.get_labels_independent),
                         (tov.get_labels_comparative, jov.get_labels_comparative)):
        np.testing.assert_array_equal(t_lab(torch.from_numpy(va), bins).numpy(),
                                      np.asarray(j_lab(jnp.asarray(va), bins)))
    for width, t_loss, j_loss, t_lab, j_lab in (
        (8, tov.loss_vap_independent, jov.loss_vap_independent, tov.get_labels_independent, jov.get_labels_independent),
        (1, tov.loss_vap_comparative, jov.loss_vap_comparative, tov.get_labels_comparative, jov.get_labels_comparative),
    ):
        z = (3 * rng.standard_normal((2, 150, width))).astype(np.float32)
        got = t_loss(torch.from_numpy(z), t_lab(torch.from_numpy(va), bins), reduction)
        want = j_loss(jnp.asarray(z), j_lab(jnp.asarray(va), bins), reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    z8 = (3 * rng.standard_normal((2, 150, 8))).astype(np.float32)
    z1 = z8[..., :1]
    for got, want in ((tov.get_probs_independent(torch.from_numpy(z8), bins), jov.get_probs_independent(jnp.asarray(z8), bins)),
                      (tov.get_probs_comparative(torch.from_numpy(z1)), jov.get_probs_comparative(jnp.asarray(z1)))):
        assert set(got) == set(want) == {"p_now", "p_future", "p_tot"}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-6, err_msg=k)
    with pytest.raises(ValueError):
        tov.loss_vap_comparative(torch.zeros(1, 5, 1), torch.zeros(1, 5), "sum")


def test_io_helpers_match_jax(tmp_path):
    from voiceactivityprojection_tpu.utils import io as jio
    from voiceactivityprojection_tpu_torch.utils import io as tio

    x = np.arange(6, dtype=np.float32).reshape(1, 3, 2) / 7
    d = {"t": torch.from_numpy(x), "nested": {"a": torch.ones(2, dtype=torch.int64)}, "s": "text", "n": 3}
    got = tio.tensor_dict_to_json(d)
    assert got == jio.tensor_dict_to_json({"t": x, "nested": {"a": np.ones(2, np.int64)}, "s": "text", "n": 3})
    tio.write_json(got, str(tmp_path / "a.json"))
    assert tio.read_json(str(tmp_path / "a.json")) == jio.read_json(str(tmp_path / "a.json")) == got
    tio.write_txt(["one", "two "], str(tmp_path / "a.txt"))
    assert tio.read_txt(str(tmp_path / "a.txt")) == jio.read_txt(str(tmp_path / "a.txt")) == ["one", "two"]

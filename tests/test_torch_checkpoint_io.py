"""PyTorch port, reference state dicts: the import of a ``.pt`` state dict
and of a legacy Lightning ``.ckpt`` into the port's weights, and the export
back, against the JAX package's import and export on the same trees (CPU,
bit for bit)."""

import numpy as np
import pytest
import jax
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.config import VapMonoConfig as JVapMonoConfig
from voiceactivityprojection_tpu.models import checkpoint as jckpt
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch.config import VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.models import checkpoint as tckpt
from voiceactivityprojection_tpu_torch.models.vap import VapModel, VapMonoModel

pytestmark = pytest.mark.model

SMALL = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
# (name, JAX config, port config, JAX init, port model class)
CASES = {
    "discrete": (JVapConfig(**SMALL), VapConfig(**SMALL), jvap.init_vap, VapModel),
    "independent": (JVapConfig(representation="independent", **SMALL),
                    VapConfig(representation="independent", **SMALL), jvap.init_vap, VapModel),
    "comparative": (JVapConfig(representation="comparative", **SMALL),
                    VapConfig(representation="comparative", **SMALL), jvap.init_vap, VapModel),
    "mono_history": (JVapMonoConfig(va_history=True, **SMALL), VapMonoConfig(va_history=True, **SMALL),
                     jvap.init_vap_mono, VapMonoModel),
}


def _tree(name, seed=0):
    jconf, _, init, _ = CASES[name]
    return jax.tree.map(np.asarray, init(jax.random.key(seed), jconf))


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def _legacy(sd):
    """The reference's older Lightning layout: ``net.`` prefixes, the codebook
    stored, the head under ``projection_head``, hyperparameters beside."""
    out = {"net.VAP.codebook.emb.weight": torch.zeros(256, 8)}
    for k, v in sd.items():
        k = k.replace("vap_head", "vap_head.projection_head")
        out[f"net.{k}"] = torch.from_numpy(np.array(v))
    return {"state_dict": out, "hyper_parameters": {"conf": {"dim": 16}}, "epoch": 3}


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_from_torch_state_dict_matches_params_from_jax(name, tmp_path):
    """JAX ``export_vap_state_dict`` -> ``.pt`` -> the port's
    ``from_torch_state_dict``: the state of ``params_from_jax`` on the same
    tree, bit for bit (the mono conditioning weights included)."""
    _, conf, _, cls = CASES[name]
    tree = _tree(name)
    path = tmp_path / "w.pt"
    _save(jckpt.export_vap_state_dict(tree), path)
    model = cls.from_torch_state_dict(str(path), conf, device="cpu")
    _assert_state_equal(model.net.state_dict(), tckpt.params_from_jax(tree, conf))


@pytest.mark.parametrize("name", ["discrete", "independent", "comparative"])
def test_import_matches_jax_import(name, tmp_path):
    """The port's import of a ``.pt`` equals ``params_from_jax`` of the
    JAX package's own import of that file."""
    jconf, conf, _, _ = CASES[name]
    path = tmp_path / "w.pt"
    _save(jckpt.export_vap_state_dict(_tree(name, seed=1)), path)
    want = tckpt.params_from_jax(
        jax.tree.map(np.asarray, jckpt.import_vap_state_dict(jckpt.load_torch_state_dict(str(path)), jconf)), conf)
    got = tckpt.state_from_reference(tckpt.load_torch_state_dict(str(path)), conf)
    _assert_state_equal(got, want)


@pytest.mark.parametrize("name", ["discrete", "mono_history"])
def test_legacy_ckpt_imports_the_same_weights(name, tmp_path):
    _, conf, _, cls = CASES[name]
    tree = _tree(name, seed=2)
    sd = jckpt.export_vap_state_dict(tree)
    pt, ckpt = tmp_path / "w.pt", tmp_path / "w.ckpt"
    _save(sd, pt)
    torch.save(_legacy(sd), ckpt)
    got = tckpt.load_torch_state_dict(str(ckpt))
    want = tckpt.load_torch_state_dict(str(pt))
    assert set(got) == set(want) and not any("codebook" in k or "projection_head" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX package reads the legacy file to the same names
    assert set(jckpt.load_torch_state_dict(str(ckpt))) == set(want)
    _assert_state_equal(cls.from_torch_state_dict(str(ckpt), conf, device="cpu").net.state_dict(),
                        tckpt.params_from_jax(tree, conf))


@pytest.mark.parametrize("name", list(CASES))
def test_export_matches_jax_export(name):
    _, conf, _, _ = CASES[name]
    tree = _tree(name, seed=3)
    want = jckpt.export_vap_state_dict(tree)
    got = tckpt.export_vap_state_dict(tckpt.params_from_jax(tree, conf))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_export_of_a_net_round_trips(tmp_path):
    """A model's net exported and imported again gives its own weights."""
    _, conf, _, _ = CASES["discrete"]
    model = VapModel(conf, device="cpu")
    path = tmp_path / "w.pt"
    _save(tckpt.export_vap_state_dict(model.net), path)
    _assert_state_equal(VapModel.from_torch_state_dict(str(path), conf, device="cpu").net.state_dict(),
                        model.net.state_dict())


def test_mismatched_head_raises(tmp_path):
    path = tmp_path / "w.pt"
    _save(jckpt.export_vap_state_dict(_tree("discrete")), path)
    wrong_j = JVapConfig(representation="independent", **SMALL)
    wrong = VapConfig(representation="independent", **SMALL)
    with pytest.raises(ValueError, match="vap_head shape"):
        jckpt.import_vap_state_dict(jckpt.load_torch_state_dict(str(path)), wrong_j)
    with pytest.raises(ValueError, match="vap_head shape"):
        VapModel.from_torch_state_dict(str(path), wrong, device="cpu")
    with pytest.raises(ValueError, match="vap_head shape"):
        tckpt.import_vap_state_dict(tckpt.load_torch_state_dict(str(path)), VapConfig(**dict(SMALL, dim=32)))


def test_from_args_reads_flags_and_refuses_orbax(tmp_path):
    """The CLI's constructor: ``--vap_*`` flags and ``--state_dict``; without
    weights the seed-0 draw; an orbax ``--checkpoint`` raises, naming the
    format."""
    import argparse

    path = tmp_path / "w.pt"
    tree = _tree("independent", seed=4)
    _save(jckpt.export_vap_state_dict(tree), path)
    parser = VapConfig.add_argparse_args(argparse.ArgumentParser())
    parser.add_argument("--state_dict", default="")
    parser.add_argument("--checkpoint", default="")
    flags = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_cross_layers", "1",
             "--vap_representation", "independent"]
    model = VapModel.from_args(parser.parse_args(flags + ["--state_dict", str(path)]), device="cpu")
    assert model.conf == CASES["independent"][1]
    _assert_state_equal(model.net.state_dict(), tckpt.params_from_jax(tree, model.conf))
    seeded = VapModel.from_args(parser.parse_args(flags), device="cpu").net.state_dict()
    _assert_state_equal(seeded, tckpt.params_from_jax(tckpt.random_params_tree(model.conf, seed=0), model.conf))
    with pytest.raises(ValueError, match="orbax"):
        VapModel.from_args(parser.parse_args(flags + ["--checkpoint", str(tmp_path)]), device="cpu")

"""PyTorch port: the mono (VAD-conditioned) model, ``VapMonoConfig``,
``VapMonoNet`` / ``forward_mono`` / ``VapMonoModel`` and its
context-parallel forward, against the JAX package on the same numpy inputs
(CPU)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapMonoConfig as JVapMonoConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.parallel import context as jcp
from voiceactivityprojection_tpu.parallel.mesh import make_mesh as j_make_mesh
from voiceactivityprojection_tpu_torch import params_from_jax
from voiceactivityprojection_tpu_torch.config import VapMonoConfig
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.parallel import context as cp
from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.model

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_mono_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JVapMonoConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(VapMonoConfig)}
    assert tf == jf
    assert {"mono", "va_history", "va_history_bins"} <= set(tf)
    assert VapMonoConfig().n_classes == JVapMonoConfig().n_classes == 256


@pytest.mark.parametrize("history", [False, True])
def test_params_from_jax_covers_the_mono_tree(history):
    """Every leaf of the JAX ``init_vap_mono`` tree maps one to one, and the
    port's random tree has that structure."""
    jconf, tconf = JVapMonoConfig(va_history=history), VapMonoConfig(va_history=history)
    shapes = jax.eval_shape(lambda k: jvap.init_vap_mono(k, jconf), jax.random.key(0))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    state = params_from_jax(tree, tconf)
    flat = _flat(tree)
    assert set(state) == set(flat)
    assert ("va_cond_history.w" in state) == history
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), flat[name], err_msg=name)
    assert {k: np.shape(v) for k, v in _flat(random_params_tree(tconf, seed=1)).items()} == \
        {k: v.shape for k, v in flat.items()}
    with pytest.raises(ValueError, match="does not use"):  # a stereo config refuses the mono tree
        params_from_jax(tree)


def _inputs(B, t50, seed, bins=5):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((B, 1, t50 * 320))).astype(np.float32)
    va = (rng.random((B, t50 + 10, 2)) < 0.4).astype(np.float32)
    vah = rng.random((B, t50 + 10, bins)).astype(np.float32)
    return wave, va, vah


@pytest.mark.parametrize("history", [False, True])
def test_forward_mono_and_probs_match_jax(history):
    """f32, default widths, B=2 x 0.5 s with va longer than the audio (the
    ``n = min(...)`` crop): logits 2e-5, probabilities 2e-6, as the stereo
    slice (measured 8.3e-7 and 2.4e-7)."""
    jconf, tconf = JVapMonoConfig(va_history=history), VapMonoConfig(va_history=history)
    tree = random_params_tree(tconf, seed=31)
    wave, va, vah = _inputs(2, 25, seed=32)
    hist = vah if history else None
    jmodel = jvap.VapMonoModel(jconf, jax.tree.map(jnp.asarray, tree))
    jout = jmodel.forward(wave, va, hist)
    jprobs = jmodel.probs(wave, va, hist)
    model = tvap.VapMonoModel.from_jax_params(tree, tconf, device="cpu")
    out = model.forward(wave, va, hist)
    probs = model.probs(wave, va, hist)
    assert tuple(out["logits"].shape) == jout["logits"].shape == (2, 25, 256)
    assert out["logits"].dtype == torch.float32
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=2e-5)
    np.testing.assert_array_equal(out["vad"].numpy(), va)
    for key, atol in (("p_now", 2e-6), ("p_future", 2e-6), ("probs", 2e-6), ("H", 2e-5)):
        assert tuple(probs[key].shape) == jprobs[key].shape, key
        np.testing.assert_allclose(probs[key].numpy(), np.asarray(jprobs[key]), atol=atol, err_msg=key)
    if history:  # the history conditions the output
        assert float((model.forward(wave, va)["logits"] - out["logits"]).abs().max()) > 1e-6


def test_forward_mono_bfloat16_tracks_jax():
    """bf16 compute: the VAD conditioning in f32 joined in bf16; against JAX's
    bf16 forward at the stereo bf16 slice's bars (logits 5e-2, p 2e-3)."""
    jconf, tconf = JVapMonoConfig(dtype="bfloat16"), VapMonoConfig(dtype="bfloat16")
    tree = random_params_tree(tconf, seed=33)
    wave, va, _ = _inputs(2, 25, seed=34)
    jprobs = jvap.VapMonoModel(jconf, jax.tree.map(jnp.asarray, tree)).probs(wave, va)
    jout = jvap.VapMonoModel(jconf, jax.tree.map(jnp.asarray, tree)).forward(wave, va)
    model = tvap.VapMonoModel.from_jax_params(tree, tconf, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in model.net.state_dict().values())
    np.testing.assert_allclose(model.forward(wave, va)["logits"].numpy(), np.asarray(jout["logits"]), atol=5e-2)
    probs = model.probs(wave, va)
    for key in ("p_now", "p_future"):
        np.testing.assert_allclose(probs[key].numpy(), np.asarray(jprobs[key]), atol=2e-3, err_msg=key)


@pytest.fixture(scope="module")
def mono_cp():
    """Both configs' weights, inputs, and JAX's context-parallel outputs on
    the 8-device CPU mesh with and without the history."""
    out = {}
    for history in (False, True):
        jconf, tconf = JVapMonoConfig(va_history=history), VapMonoConfig(va_history=history)
        tree = random_params_tree(tconf, seed=41 + history)
        wave, va, vah = _inputs(1, 16, seed=43)
        params = jax.tree.map(jnp.asarray, tree)
        hist = jnp.asarray(vah) if history else None
        want = jcp.forward_mono_context_parallel(params, jnp.asarray(wave), jnp.asarray(va), jconf,
                                                 j_make_mesh(), va_history=hist)
        net = tvap.VapMonoNet(tconf)
        net.load_state_dict(params_from_jax(tree, tconf))
        out[history] = (net, tconf, wave, va, vah, np.asarray(want["logits"]))
    return out


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("history", [False, True])
def test_mono_context_parallel_matches_jax(mono_cp, D, history):
    """Against JAX ``forward_mono_context_parallel`` (2e-4 there; measured
    8.9e-7 at most) and the port's plain ``forward_mono``; with the history,
    the history changes the sharded output."""
    net, conf, wave, va, vah, want = mono_cp[history]
    hist = torch.from_numpy(vah) if history else None
    mesh = make_mesh(n_data=D, devices=[torch.device("cpu")] * D)
    got = cp.forward_mono_context_parallel(net, torch.from_numpy(wave), torch.from_numpy(va), conf, mesh,
                                           va_history=hist)
    assert tuple(got["logits"].shape) == want.shape == (1, 16, 256)
    np.testing.assert_allclose(got["logits"].numpy(), want, atol=2e-5)
    np.testing.assert_array_equal(got["vad"].numpy(), va[:, :16])
    with torch.no_grad():
        plain = tvap.forward_mono(net, torch.from_numpy(wave), torch.from_numpy(va), conf, va_history=hist)
    np.testing.assert_allclose(got["logits"].numpy(), plain["logits"][:, :16].numpy(), atol=2e-5)
    if history:
        without = cp.forward_mono_context_parallel(net, torch.from_numpy(wave), torch.from_numpy(va), conf, mesh)
        assert float((got["logits"] - without["logits"]).abs().max()) > 1e-6


def test_mono_context_parallel_single_shard(mono_cp):
    net, conf, wave, va, vah, want = mono_cp[True]
    got = cp.forward_mono_context_parallel(net, wave[0, 0], va[0], conf, make_mesh(1, devices=["cpu"]),
                                           va_history=torch.from_numpy(vah))
    np.testing.assert_allclose(got["logits"].numpy(), want, atol=2e-5)
    with pytest.raises(ValueError, match="va covers"):
        cp.forward_mono_context_parallel(net, torch.from_numpy(wave), torch.from_numpy(va[:, :8]), conf,
                                         make_mesh(2, devices=["cpu"] * 2))

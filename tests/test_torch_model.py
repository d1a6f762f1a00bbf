"""PyTorch port, the stereo inference slice as a whole: config, weights from
the JAX params tree, encoder, forward and probs against the JAX package on
the same numpy inputs (CPU)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.models.encoder import apply_encoder as j_apply_encoder
from voiceactivityprojection_tpu_torch import VapConfig, VapModel, params_from_jax
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder

pytestmark = pytest.mark.model

torch.set_num_threads(2)

NARROW = dict(encoder_dim=64, dim=64, channel_layers=1, cross_layers=1, num_heads=2)


def _confs(dtype="float32", **kw):
    return JVapConfig(dtype=dtype, **kw), VapConfig(dtype=dtype, **kw)


def _jax_tree(jconf, seed=0):
    """A tree with the structure and shapes of the JAX package's own
    ``init_vap`` (traced, not run), filled with numpy values from a seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jvap.init_vap(k, jconf), jax.random.key(0))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _run_jax(tree, wave, jconf):
    """JAX forward and VapModel.probs (both jitted, as users call them)."""
    model = jvap.VapModel(jconf, jax.tree.map(jnp.asarray, tree))
    return model.forward(wave), model.probs(wave)


def _wave(B, n, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, 2, n))).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.shape(tree)}


def test_config_fields_and_properties_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JVapConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(VapConfig)}
    assert tf == jf
    for kw in ({}, {"bin_times": (0.2, 0.4)}, {"representation": "independent"}):
        j, t = JVapConfig(**kw), VapConfig(**kw)
        for prop in ("bin_frames", "horizon_frames", "horizon_time", "n_classes", "head_dim"):
            assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("kw", [{}, NARROW])
def test_params_from_jax_uses_every_leaf(kw):
    jconf, tconf = _confs(**kw)
    tree = _jax_tree(jconf)
    state = params_from_jax(tree, tconf)
    flat = _flat(tree)
    assert set(state) == set(flat)
    for name, t in state.items():
        assert tuple(t.shape) == flat[name], name
        np.testing.assert_array_equal(t.numpy(), np.asarray(_lookup(tree, name)))
    # the random tree of the port has the JAX tree's structure and shapes
    assert _flat(random_params_tree(tconf, seed=1)) == flat


def _lookup(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def test_params_from_jax_raises_on_extra_missing_and_shape():
    jconf, tconf = _confs(**NARROW)
    tree = _jax_tree(jconf)
    extra = dict(tree, unused_head={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="does not use"):
        params_from_jax(extra, tconf)
    missing = dict(tree)
    missing["va_classifier"] = {"w": tree["va_classifier"]["w"]}
    with pytest.raises(ValueError, match="does not fill"):
        params_from_jax(missing, tconf)
    bad = dict(tree)
    bad["vap_head"] = {"w": tree["vap_head"]["w"][:, :-1], "b": tree["vap_head"]["b"]}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tconf)


def test_encoder_matches_jax():
    jconf, tconf = _confs(**NARROW)
    tree = random_params_tree(tconf, seed=2)
    wave = _wave(2, 16000)[:, 0]
    want = np.asarray(jax.jit(j_apply_encoder)(jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(wave)))
    model = VapModel.from_jax_params(tree, tconf, device="cpu")
    with torch.no_grad():  # the weights are trainable parameters
        got = apply_encoder(model.net.encoder, torch.from_numpy(wave), fused_auto=True).numpy()
    assert got.shape == want.shape == (2, 50, 64)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("width,n", [("narrow", 16000), ("default", 8000)])
def test_forward_and_probs_match_jax_f32(width, n):
    kw = NARROW if width == "narrow" else {}
    jconf, tconf = _confs(**kw)
    tree = random_params_tree(tconf, seed=3)
    B = 2 if width == "narrow" else 1
    wave = _wave(B, n, seed=4)
    jout, jprobs = _run_jax(tree, wave, jconf)

    model = VapModel.from_jax_params(tree, tconf, device="cpu")
    tout = model.forward(wave)
    tprobs = model.probs(wave)
    assert tout["logits"].dtype == torch.float32
    # measured: logits 1.1e-6, p_now / p_future 1.8e-7 (same math, other
    # summation order); the JAX package's own bars vs the reference are
    # 1e-3 / 2e-4
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=2e-5)
    np.testing.assert_allclose(tout["vad"].numpy(), np.asarray(jout["vad"]), atol=2e-5)
    for key, atol in (("p_now", 2e-6), ("p_future", 2e-6), ("vad", 1e-6), ("H", 2e-5), ("probs", 1e-6)):
        assert tprobs[key].shape == jprobs[key].shape, key
        np.testing.assert_allclose(tprobs[key].numpy(), np.asarray(jprobs[key]), atol=atol, err_msg=key)


def test_probs_match_jax_bf16():
    """bf16 compute: both frameworks round at other places (JAX's dense bf16
    attention stores scores in bf16; the port's GRU carry stays f32 as in
    the fused kernel), so the bound is looser: p_now / p_future within
    2e-3, logits within 5e-2 (measured 1.1e-4 and 1.5e-2 at default widths,
    6e-5 and 6e-3 here, with logits spanning about +-0.55)."""
    jconf, tconf = _confs("bfloat16", **NARROW)
    tree = random_params_tree(tconf, seed=5)
    wave = _wave(2, 16000, seed=6)
    jout, jprobs = _run_jax(tree, wave, jconf)
    model = VapModel.from_jax_params(tree, tconf, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in model.net.state_dict().values())
    tout = model.forward(wave)
    tprobs = model.probs(wave)
    assert tout["logits"].dtype == torch.float32
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=5e-2)
    for key in ("p_now", "p_future"):
        np.testing.assert_allclose(tprobs[key].numpy(), np.asarray(jprobs[key]), atol=2e-3, err_msg=key)


def test_compute_cast_rounds_slopes_through_bf16():
    conf = VapConfig(dtype="bfloat16", **NARROW)
    net = tvap.VapNet(conf)
    state = params_from_jax(random_params_tree(conf), conf)
    net.load_state_dict(state)
    want = np.asarray(jnp.asarray(state["ar.layers.0.mha.m"].numpy()).astype(jnp.bfloat16).astype(jnp.float32))
    # training: cast on the graph; inference: the model's weights cast once
    for m in (tvap._compute_params(net, conf)["ar.layers.0.mha.m"],
              VapModel(conf, state, device="cpu").net.ar.layers[0].mha.m):
        assert m.dtype == torch.bfloat16
        np.testing.assert_array_equal(m.float().numpy(), want)
    assert net.ar.layers[0].mha.m.dtype == torch.float32


def test_non_discrete_representations_not_ported_yet():
    """Once a fault (the port raised NotImplementedError for the
    independent and comparative representations), now ported:
    ``probs_from_logits`` with and without ground-truth VAD against JAX's
    within the float32 CPU bar (2e-6); an unknown representation raises."""
    rng = np.random.default_rng(7)
    vad_logits = (2 * rng.standard_normal((2, 140, 2))).astype(np.float32)
    vad = (rng.random((2, 150, 2)) < 0.5).astype(np.float32)
    for rep, width in (("independent", 8), ("comparative", 1)):
        logits = (3 * rng.standard_normal((2, 140, width))).astype(np.float32)
        jconf, tconf = _confs(representation=rep)
        for v in (None, vad):
            want = jvap.probs_from_logits(jnp.asarray(logits), jnp.asarray(vad_logits), jconf,
                                          vad=None if v is None else jnp.asarray(v))
            got = tvap.probs_from_logits(torch.from_numpy(logits), torch.from_numpy(vad_logits), tconf,
                                         vad=None if v is None else torch.from_numpy(v))
            assert set(got) == set(want)
            for key in want:
                assert tuple(got[key].shape) == want[key].shape, (rep, key)
                np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-6,
                                           err_msg=f"{rep} {key}")
    with pytest.raises(ValueError, match="unknown representation"):
        tvap.probs_from_logits(torch.zeros(1, 2, 8), torch.zeros(1, 2, 2),
                               dataclasses.replace(VapConfig(), representation="other"))

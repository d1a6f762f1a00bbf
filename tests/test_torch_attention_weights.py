"""PyTorch port, the attention weights of the stereo forward
(``VapModel.forward(waveform, attention=True)``) against the JAX package on
the same weights and waveform: ``self_attn``, ``cross_attn`` and
``cross_self_attn`` (B, 2, L, H, T, T) within 2e-6 and the logits within
2e-6 of the plain forward; causal rows that sum to 1; the weights in v's
dtype under bfloat16; and ``attn_impl="pallas"`` refusing to return
weights, as JAX's does."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree

pytestmark = pytest.mark.model

TOL = 2e-6
KEYS = ("self_attn", "cross_attn", "cross_self_attn")


def _models(layers=(2, 1), **kw):
    conf = dict(dim=16, encoder_dim=16, channel_layers=layers[0], cross_layers=layers[1], **kw)
    tree = random_params_tree(VapConfig(**conf), seed=9)
    jmodel = jvap.VapModel(JVapConfig(**conf), jax.tree.map(jnp.asarray, tree))
    return jmodel, tvap.VapModel.from_jax_params(tree, VapConfig(**conf), device="cpu")


def _wave(B=2, seconds=1.3, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, 2, int(16000 * seconds)))).astype(np.float32)


@pytest.mark.parametrize("layers", [(1, 1), (2, 1)])
def test_weights_match_jax(layers):
    jmodel, tmodel = _models(layers)
    w = _wave()
    got = tmodel.forward(w, attention=True)
    want = jmodel.forward(w, attention=True)
    T = got["logits"].shape[1]
    for k in KEYS:
        L = layers[0] if k == "self_attn" else layers[1]
        assert tuple(got[k].shape) == (2, 2, L, 4, T, T), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, err_msg=k)
    for k in ("logits", "vad"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), tmodel.forward(w)[k].numpy(), atol=TOL, err_msg=k)
    assert set(got) == set(want)


def test_rows_sum_to_one_and_are_causal():
    _, tmodel = _models()
    out = tmodel.forward(_wave(B=1), attention=True)
    for k in KEYS:
        a = out[k]
        np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5, err_msg=k)
        T = a.shape[-1]
        above = torch.triu(torch.ones(T, T, dtype=torch.bool), diagonal=1)
        assert float(a[..., above].abs().max()) == 0.0, k
        assert float(a.min()) >= 0.0


def test_bfloat16_weights_in_v_dtype():
    jmodel, tmodel = _models(dtype="bfloat16")
    w = _wave(B=1)
    got, want = tmodel.forward(w, attention=True), jmodel.forward(w, attention=True)
    for k in KEYS:
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16, k
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32), atol=2 ** -6, err_msg=k)
    assert got["logits"].dtype == torch.float32


def test_pallas_with_weights_raises_as_jax():
    jmodel, tmodel = _models(attn_impl="pallas")
    w = _wave(B=1, seconds=0.5)
    with pytest.raises(ValueError, match="cannot return attention weights"):
        tmodel.forward(w, attention=True)
    with pytest.raises(ValueError, match="cannot return attention weights"):
        jmodel.forward(w, attention=True)

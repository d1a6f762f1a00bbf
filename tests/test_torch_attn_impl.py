"""PyTorch port: the attention route, ``VapConfig.attn_impl`` and the head
widths the kernels take (``ops/attention.py`` ``use_kernels``), against the
JAX package's forward with the same ``attn_impl`` on the same numpy inputs
(CPU; JAX's ``"pallas"`` runs its kernels in interpret mode here, the
port's runs the kernels' plain versions)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.config import VapMonoConfig as JVapMonoConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu_torch import VapConfig, VapModel
from voiceactivityprojection_tpu_torch.config import VapMonoConfig
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.model

torch.set_num_threads(2)

NARROW = dict(encoder_dim=64, dim=64, channel_layers=1, cross_layers=1, num_heads=2)
IMPLS = ("auto", "xla", "pallas")


def _wave(B, n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, 2, n))).astype(np.float32)


def _both(kw, tree_seed, wave):
    """JAX's and the port's forward and probs of one config on one waveform."""
    jconf, tconf = JVapConfig(**kw), VapConfig(**kw)
    tree = random_params_tree(tconf, seed=tree_seed)
    jmodel = jvap.VapModel(jconf, jax.tree.map(jnp.asarray, tree))
    model = VapModel.from_jax_params(tree, tconf, device="cpu")
    return (jmodel.forward(wave), jmodel.probs(wave)), (model.forward(wave), model.probs(wave))


def _assert_f32_bars(jax_out, port_out):
    """The bars of ``test_forward_and_probs_match_jax_f32``: logits 2e-5,
    p_now / p_future 2e-6."""
    (jout, jprobs), (tout, tprobs) = jax_out, port_out
    assert tout["logits"].shape == jout["logits"].shape
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=2e-5)
    np.testing.assert_allclose(tout["vad"].numpy(), np.asarray(jout["vad"]), atol=2e-5)
    for key in ("p_now", "p_future"):
        np.testing.assert_allclose(tprobs[key].numpy(), np.asarray(jprobs[key]), atol=2e-6, err_msg=key)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_with_attn_impl_matches_jax(impl):
    """Narrow widths (Dh 32), B=2 x 1 s, f32: each route against JAX's."""
    jax_out, port_out = _both(dict(NARROW, attn_impl=impl), 41, _wave(2, 16000, seed=42))
    _assert_f32_bars(jax_out, port_out)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_eight_heads_forward_matches_jax(impl):
    """``VapConfig(num_heads=8)``: default widths with head width 32 (one
    of the kernels' ``KERNEL_HEAD_DIMS``), B=1 x 0.5 s."""
    jax_out, port_out = _both(dict(num_heads=8, attn_impl=impl), 43, _wave(1, 8000, seed=44))
    _assert_f32_bars(jax_out, port_out)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_two_heads_forward_matches_jax(impl):
    """``VapConfig(num_heads=2)``: default widths with head width 128, B=1
    x 0.5 s."""
    jax_out, port_out = _both(dict(num_heads=2, attn_impl=impl), 47, _wave(1, 8000, seed=48))
    _assert_f32_bars(jax_out, port_out)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_mono_with_attn_impl_matches_jax(impl):
    """``forward_mono`` threads ``attn_impl`` too: narrow widths, B=2 x 0.5 s."""
    kw = dict(NARROW, attn_impl=impl)
    jconf, tconf = JVapMonoConfig(**kw), VapMonoConfig(**kw)
    tree = random_params_tree(tconf, seed=45)
    rng = np.random.default_rng(46)
    wave = (0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    va = (rng.random((2, 30, 2)) < 0.4).astype(np.float32)
    want = jvap.VapMonoModel(jconf, jax.tree.map(jnp.asarray, tree)).forward(wave, va)
    got = tvap.VapMonoModel.from_jax_params(tree, tconf, device="cpu").forward(wave, va)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-5)


# the route for (impl, on the card, head width): True = the kernel wrappers,
# False = attention_dense, "raises" = ValueError. The kernels take head
# widths 32, 64 and 128; 16 stands for any other.
WIDTHS = (16, 32, 64, 128)
ROUTES = {
    **{("auto", False, d): False for d in WIDTHS},
    **{("auto", True, d): d != 16 or "raises" for d in WIDTHS},
    **{("xla", on_card, d): False for on_card in (False, True) for d in WIDTHS},
    **{("pallas", False, d): True for d in WIDTHS},
    **{("pallas", True, d): d != 16 or "raises" for d in WIDTHS},
}


@pytest.mark.parametrize("impl,on_card,head_dim", sorted(ROUTES))
def test_dispatch_rule_by_impl_and_head_width(impl, on_card, head_dim):
    want = ROUTES[(impl, on_card, head_dim)]
    assert tattn.KERNEL_HEAD_DIMS == (32, 64, 128)
    if want == "raises":
        with pytest.raises(ValueError, match=f"head width .*got {head_dim}; use impl='xla'"):
            tattn.use_kernels(impl, on_card, head_dim, return_weights=False)
    else:
        assert tattn.use_kernels(impl, on_card, head_dim, return_weights=False) is want
    # a request for the weights always takes the dense path, except under
    # "pallas", which cannot serve it
    if impl == "pallas":
        with pytest.raises(ValueError, match="cannot return attention weights"):
            tattn.use_kernels(impl, on_card, head_dim, return_weights=True)
    else:
        assert tattn.use_kernels(impl, on_card, head_dim, return_weights=True) is False


def _mha(D=32, H=2, seed=7):
    rng = np.random.default_rng(seed)
    mha = tattn.MHA(D, H).requires_grad_(False)
    for n in ("query", "key", "value", "proj"):
        getattr(mha, n).w.copy_(torch.from_numpy((0.3 * rng.standard_normal((D, D))).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 9, D)).astype(np.float32))
    return mha, x


def test_pallas_with_weights_and_unknown_impl_raise():
    mha, x = _mha()
    with pytest.raises(ValueError, match="cannot return attention weights"):
        tattn.attention(mha, x, x, 2, impl="pallas", return_weights=True)
    for bad in ("flash", "", "XLA"):
        with pytest.raises(ValueError, match="attn_impl must be one of"):
            tattn.attention(mha, x, x, 2, impl=bad)
    # the dense routes return the weights
    for impl in ("auto", "xla"):
        _, w = tattn.attention(mha, x, x, 2, impl=impl, return_weights=True)
        assert tuple(w.shape) == (2, 2, 9, 9)
    conf = VapConfig(attn_impl="flash", **NARROW)
    model = VapModel(conf, device="cpu")
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        model.forward(_wave(1, 3200, seed=8))


@pytest.mark.parametrize("impl", IMPLS)
def test_every_impl_gives_one_attention_on_the_cpu(impl):
    """On CPU tensors the three routes compute one function: the dense
    path and the kernels' plain versions agree at 1e-6, with a gradient
    (the training wrappers) and without."""
    mha, x = _mha()
    want, _ = tattn.attention_dense(mha, x, x, 2)
    got, none = tattn.attention(mha, x, x, 2, impl=impl)
    assert none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    xg = x.clone().requires_grad_()
    gw = torch.autograd.grad(tattn.attention_dense(mha, xg, xg, 2)[0].sum(), xg)[0]
    gg = torch.autograd.grad(tattn.attention(mha, xg, xg, 2, impl=impl)[0].sum(), xg)[0]
    np.testing.assert_allclose(gg.numpy(), gw.numpy(), atol=1e-5)

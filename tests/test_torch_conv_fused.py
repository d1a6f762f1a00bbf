"""PyTorch port: the conv0 + conv1 kernel's module (``ops/conv_fused.py``,
K11) and the encoder's implementation dispatch (``VAP_CONV_IMPL``,
``VAP_GRU_DS``), against the JAX package on the same numpy inputs (CPU).

On CPU tensors every kernel wrapper takes its plain version, so each
dispatch value computes the same function here: the tests also record
which wrappers the encoder called."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.models.encoder import _conv_stack as j_conv_stack
from voiceactivityprojection_tpu.models.encoder import init_encoder
from voiceactivityprojection_tpu.ops import conv_fused as jcf
from voiceactivityprojection_tpu.train import cpc_pretrain as jcpc
from voiceactivityprojection_tpu_torch import VapConfig, params_from_jax
from voiceactivityprojection_tpu_torch.models import encoder as tenc
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
from voiceactivityprojection_tpu_torch.train.cpc_pretrain import cpc_forward

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return random_params_tree(VapConfig(), seed=11)


def _layers(enc_tree):
    enc = encoder_from_jax(enc_tree)
    return enc, [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]


def _x(R, n, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((R, n))).astype(np.float32)


@pytest.mark.parametrize("n", [16000, 12345])
def test_plain_matches_jax_reference_unfused(tree, n):
    x = _x(2, n)
    want = np.asarray(jcf._reference_unfused(jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(x)))
    _, layers = _layers(tree["encoder"])
    with torch.no_grad():
        got = k11.fused_conv01(layers, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, k11.out_len(n), 256)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_plain_matches_jax_kernel_interpret(tree):
    """Against JAX's Pallas kernel in interpret mode (its test's 1e-4 bar)."""
    x = _x(2, 16000, seed=1)
    want = np.asarray(jcf.fused_conv01(jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(x)))
    _, layers = _layers(tree["encoder"])
    with torch.no_grad():
        got = k11.fused_conv01(layers, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gradients_match_jax_grad_of_the_kernel(tree):
    """Gradients through the port's ``fused_conv01`` (its plain version on
    the CPU, differentiated by autograd) against ``jax.grad`` of JAX's
    ``fused_conv01`` (interpret-mode forward, custom-VJP backward through
    ``_reference_unfused``): 1e-4 of each leaf's largest."""
    x = _x(1, 8000, seed=2)
    cot = np.random.default_rng(3).standard_normal((1, k11.out_len(8000), 256)).astype(np.float32)
    j_enc = jax.tree.map(jnp.asarray, tree["encoder"])

    def loss(enc, x):
        return (jcf.fused_conv01(enc, x) * cot).sum()

    j_genc, j_gx = jax.grad(loss, argnums=(0, 1))(j_enc, jnp.asarray(x))
    _, layers = _layers(tree["encoder"])
    xt = torch.from_numpy(x).requires_grad_()
    leaves = [xt, *layers[0], *layers[1]]
    got = torch.autograd.grad((k11.fused_conv01(layers, xt) * torch.from_numpy(cot)).sum(), leaves)
    want = [j_gx] + [j_genc["gEncoder"][i][g][p] for i in (0, 1)
                     for g, p in (("conv", "w"), ("conv", "b"), ("norm", "w"), ("norm", "b"))]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(float(np.abs(w).max()), 1e-6))


@pytest.mark.parametrize("dim", [256, 16])
def test_supported_matches_jax(dim):
    j = jax.eval_shape(lambda k: init_encoder(k, dim=dim), jax.random.key(0))
    enc = encoder_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), j))
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    assert k11.fused_conv01_supported(layers) == jcf.fused_conv01_supported(j) == (dim == 256)


def test_wrapper_refuses_what_it_does_not_take(tree):
    _, layers = _layers(tree["encoder"])
    with pytest.raises(ValueError, match="rows, samples"):
        k11.fused_conv01(layers, torch.zeros(2, 1, 3200))
    small = encoder_from_jax(random_params_tree(VapConfig(encoder_dim=16, dim=16), seed=0)["encoder"])
    with pytest.raises(ValueError, match="conv0 must be"):
        k11.fused_conv01([(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in small.gEncoder],
                         torch.zeros(2, 3200))


# ------------------------------------------------------------------ dispatch --
_SPIED = ("fused_conv_stack", "fused_conv01", "gru_downsample_fused")


@pytest.fixture
def calls(monkeypatch):
    """Counts the encoder's calls of each kernel wrapper."""
    counts = dict.fromkeys(_SPIED, 0)
    for name in _SPIED:
        real = getattr(tenc, name)

        def spy(*args, _real=real, _name=name):
            counts[_name] += 1
            return _real(*args)

        monkeypatch.setattr(tenc, name, spy)
    return counts


@pytest.fixture(scope="module")
def jax_forward(tree):
    """JAX ``forward`` (eager, the XLA convs) at default widths, 0.5 s."""
    wave = (0.1 * np.random.default_rng(4).standard_normal((1, 2, 8000))).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAP_CONV_IMPL", "xla")
        out = jvap.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(wave), JVapConfig())
    return wave, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("impl", [None, "xla", "fused", "fused_stack"])
@pytest.mark.parametrize("gru_ds", ["fused", "off"])
def test_forward_under_each_impl_matches_jax(tree, jax_forward, calls, monkeypatch, impl, gru_ds):
    """The port's forward under every ``VAP_CONV_IMPL`` / ``VAP_GRU_DS``
    value against JAX's XLA path: the stereo slice's f32 bar (2e-5 logits),
    and the wrappers the dispatch chose (inference: ``fused_auto`` on)."""
    if impl is not None:
        monkeypatch.setenv("VAP_CONV_IMPL", impl)
    monkeypatch.setenv("VAP_GRU_DS", gru_ds)
    wave, want = jax_forward
    conf = VapConfig()
    net = tvap.VapNet(conf)
    net.load_state_dict(params_from_jax(tree, conf))
    with torch.no_grad():
        got = tvap.forward(net, torch.from_numpy(wave), conf)
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], atol=2e-5)
    np.testing.assert_allclose(got["vad"].numpy(), want["vad"], atol=2e-5)
    stack = impl in (None, "fused_stack")
    assert calls == {"fused_conv_stack": int(stack), "fused_conv01": int(impl == "fused"),
                     "gru_downsample_fused": int(gru_ds == "fused")}


@pytest.mark.parametrize("impl", [None, "xla", "fused", "fused_stack"])
@pytest.mark.parametrize("fused_auto", [False, True])
def test_conv_stack_under_each_impl_matches_jax(tree, calls, monkeypatch, impl, fused_auto):
    """``_conv_stack`` against JAX's XLA convs (1e-5); ``fused_stack`` runs
    the conv stack kernel whatever ``fused_auto`` says, as JAX's does."""
    x = _x(2, 12800, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAP_CONV_IMPL", "xla")
        want = np.asarray(j_conv_stack(jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(x)[..., None]))
    if impl is not None:
        monkeypatch.setenv("VAP_CONV_IMPL", impl)
    enc, _ = _layers(tree["encoder"])
    with torch.no_grad():
        got = tenc._conv_stack(enc, torch.from_numpy(x), fused_auto=fused_auto).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    stack = impl == "fused_stack" or (impl is None and fused_auto)
    assert (calls["fused_conv_stack"], calls["fused_conv01"]) == (int(stack), int(impl == "fused"))


@pytest.mark.parametrize("value", ["fused_conv", "XLA", ""])
def test_unknown_conv_impl_raises(tree, monkeypatch, value):
    """JAX falls back to its XLA convs on an unknown value; the port raises,
    so a typo cannot hide a kernel."""
    monkeypatch.setenv("VAP_CONV_IMPL", value)
    enc, _ = _layers(tree["encoder"])
    with pytest.raises(ValueError, match="VAP_CONV_IMPL"):
        tenc.apply_encoder(enc, torch.zeros(1, 3200), fused_auto=True)


@pytest.mark.parametrize("impl", [None, "fused"])
def test_cpc_forward_matches_jax(tree, calls, monkeypatch, impl):
    """``cpc_forward`` goes through ``_conv_stack`` as JAX's does: under
    ``VAP_CONV_IMPL=fused`` it runs K11's wrapper; either way it matches
    JAX's ``cpc_forward`` on the XLA convs (1e-5)."""
    x = _x(2, 20480, seed=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAP_CONV_IMPL", "xla")
        jz, jc = jcpc.cpc_forward(jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(x))
    if impl is not None:
        monkeypatch.setenv("VAP_CONV_IMPL", impl)
    enc, _ = _layers(tree["encoder"])
    with torch.no_grad():
        z, c = cpc_forward(enc, torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    assert calls["fused_conv01"] == int(impl == "fused")

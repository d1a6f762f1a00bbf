"""PyTorch port: context parallelism (``parallel/context.py``,
``parallel/mesh.py``) and its attention kernel's module (K10,
``ops/flash_alibi.py`` ``flash_alibi_attention_offset``), against the JAX
package on the same numpy inputs (CPU).

The port's meshes repeat the CPU device (one controller runs every shard);
the JAX oracle runs on the 8-device CPU mesh that the repo's conftest
forces, and its single-device ``forward``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.ops import flash_alibi as jfa
from voiceactivityprojection_tpu.ops.attention import alibi_slopes as j_alibi_slopes
from voiceactivityprojection_tpu.parallel import context as jcp
from voiceactivityprojection_tpu.parallel.mesh import make_mesh as j_make_mesh
from voiceactivityprojection_tpu_torch import VapConfig, params_from_jax
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k10
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
from voiceactivityprojection_tpu_torch.parallel import context as cp
from voiceactivityprojection_tpu_torch.parallel.mesh import Mesh, make_mesh

from _torch_tol import bf16_tol

pytestmark = pytest.mark.parallel

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(D):
    return make_mesh(n_data=D, devices=[CPU] * D)


# ------------------------------------------------------------- K10, plain --
def _offset_attention_f64(q, k, v, slopes, scale, off):
    """Dense float64 offset attention of the numpy inputs: the yardstick
    both float32 sides are held to before they are held to each other."""
    s = np.einsum("bhid,bhjd->bhij", q.astype(np.float64), k.astype(np.float64)) * scale
    i = off + np.arange(q.shape[2])[:, None]
    j = np.arange(k.shape[2])[None, :]
    s = s + np.asarray(slopes, np.float64)[None, :, None, None] * (j - i)
    s = np.where(j <= i, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)


OFFSET_CASES = [(384, 128, 0), (384, 128, 128), (384, 128, 256), (300, 100, 37)]


def _offset_inputs(T, Tq, off):
    rng = np.random.default_rng(T + off)
    q = rng.standard_normal((1, 4, Tq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4, T, 64)).astype(np.float32) for _ in range(2))
    return q, k, v, 1.0 / np.sqrt(4 * 64)


def _offset_side(side, q, k, v, scale, off):
    """One float32 side of the offset attention on the numpy inputs: the
    port's plain version or JAX's Pallas kernel in interpret mode."""
    if side == "port":
        return k10.flash_alibi_attention_offset(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), alibi_slopes(4), scale, off).numpy()
    return np.asarray(jfa.flash_alibi_attention_offset(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_alibi_slopes(4), scale, jnp.int32(off)))


@pytest.mark.parametrize("T,Tq,off", OFFSET_CASES)
@pytest.mark.parametrize("side", ["port", "jax"])
def test_offset_attention_side_matches_float64(side, T, Tq, off):
    """Each float32 side (``side``: the port's plain version, or JAX
    ``flash_alibi_attention_offset`` in interpret mode) against a float64
    dense reference of the same numpy inputs, at the JAX test's 1e-5 bar.
    One case a side, so the failing test's name says which side moved."""
    q, k, v, scale = _offset_inputs(T, Tq, off)
    got = _offset_side(side, q, k, v, scale, off)
    ref = _offset_attention_f64(q, k, v, np.asarray(j_alibi_slopes(4)), scale, off)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,Tq,off", OFFSET_CASES)
def test_offset_attention_plain_matches_jax_interpret(T, Tq, off):
    """The plain version against JAX ``flash_alibi_attention_offset`` (the
    Pallas kernel in interpret mode), at the JAX test's 1e-5 bar; the ragged
    case (Tq=100 at offset 37 of 300 keys) crosses tiles off their edges.
    Each side's own check against float64 is
    ``test_offset_attention_side_matches_float64``."""
    q, k, v, scale = _offset_inputs(T, Tq, off)
    want = _offset_side("jax", q, k, v, scale, off)
    got = _offset_side("port", q, k, v, scale, off)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # at offset 0 over its own rows it is the causal kernel's plain version
    full = k10.dense_reference(*(torch.from_numpy(t) for t in (q, k[:, :, :Tq], v[:, :, :Tq])),
                               alibi_slopes(4), scale)
    np.testing.assert_array_equal(
        k10.flash_alibi_attention_offset(*(torch.from_numpy(t) for t in (q, k[:, :, :Tq], v[:, :, :Tq])),
                                         alibi_slopes(4), scale, 0).numpy(), full.numpy())


@pytest.mark.parametrize("off", [0, 37])
def test_offset_attention_plain_matches_jax_interpret_bf16(off):
    """bfloat16, the precision contract of the tensor-core kernel: the plain
    version (f32 scores and sums, p rounded before the value product)
    against JAX's Pallas kernel in interpret mode on the same bf16 inputs,
    Tq=128 rows at offsets 0 and 37 of a ragged 300-key timeline, within two
    bf16 roundings (p and the output)."""
    rng = np.random.default_rng(300 + off)
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4, 300, 64)).astype(np.float32) for _ in range(2))
    scale = 1.0 / np.sqrt(4 * 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_alibi_attention_offset(jq, jk, jv, j_alibi_slopes(4), scale, jnp.int32(off))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = k10.flash_alibi_attention_offset(tq, tk, tv, alibi_slopes(4), scale, off)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=bf16_tol(want, 2))


def test_offset_attention_refuses_bad_offsets_and_shapes():
    """The port raises where JAX would give rows past Tk zero-padded keys."""
    q, k = torch.zeros(1, 4, 100, 64), torch.zeros(1, 4, 300, 64)
    s = alibi_slopes(4)
    for off in (-1, 201, 300):
        with pytest.raises(ValueError, match="must lie in"):
            k10.flash_alibi_attention_offset(q, k, k, s, 0.1, off)
    with pytest.raises(ValueError, match="one \\(B, H, Tk, Dh\\)"):
        k10.flash_alibi_attention_offset(q, k, k[:, :, :200], s, 0.1, 0)
    with pytest.raises(ValueError, match="slopes"):
        k10.flash_alibi_attention_offset(q, k, k, alibi_slopes(2), 0.1, 0)


# --------------------------------------------------------------------- mesh --
def test_make_mesh(monkeypatch):
    mesh = make_mesh(n_data=4, devices=[CPU] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 4} and mesh.devices == (CPU,) * 4
    assert make_mesh(devices=["cpu", "cpu"]).shape["data"] == 2
    # a "model" axis spans processes: refused until a process group exists
    # (tests/test_torch_parallel.py builds one)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(n_data=2, n_model=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="n_data=3"):
        make_mesh(n_data=3, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


def test_pad_waveform_for_mesh():
    wav = torch.ones(1, 2, 1000)
    out = cp.pad_waveform_for_mesh(wav, 8)
    assert out.shape[-1] % (320 * 8) == 0
    torch.testing.assert_close(out[..., :1000], wav, rtol=0, atol=0)
    assert float(out[..., 1000:].abs().sum()) == 0
    wav2 = torch.ones(2, 320 * 8 * 3)
    assert cp.pad_waveform_for_mesh(wav2, 8) is wav2


# ----------------------------------------------------------- stereo forward --
@pytest.fixture(scope="module")
def setup():
    conf = VapConfig()
    tree = random_params_tree(conf, seed=21)
    net = tvap.VapNet(conf)
    net.load_state_dict(params_from_jax(tree, conf))
    net.requires_grad_(False)
    return tree, net


def _wave(t50, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((1, 2, t50 * 320))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(setup):
    """JAX ``forward_context_parallel`` on the 8-device CPU mesh and JAX
    ``forward``, per t50, float32."""
    tree, _ = setup
    params = jax.tree.map(jnp.asarray, tree)
    jconf = JVapConfig()
    out = {}
    for t50 in (16, 24):
        wav = jnp.asarray(_wave(t50, t50))
        cpo = jcp.forward_context_parallel(params, wav, jconf, j_make_mesh())
        fwd = jvap.forward(params, wav, jconf)
        out[t50] = {k: (np.asarray(cpo[k]), np.asarray(fwd[k])) for k in ("logits", "vad")}
    return out


# measured on the CPU: logits and vad within 1.3e-6 of JAX's context-parallel
# forward and of its plain forward at every D and t50 (the JAX bar is 2e-4)
CP_TOL = 2e-5


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("t50", [16, 24])
def test_context_parallel_matches_jax(setup, jax_outputs, D, t50):
    _, net = setup
    got = cp.forward_context_parallel(net, torch.from_numpy(_wave(t50, t50)), VapConfig(), _mesh(D))
    for key in ("logits", "vad"):
        want_cp, want_fwd = jax_outputs[t50][key]
        assert tuple(got[key].shape) == want_fwd.shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want_cp, atol=CP_TOL, err_msg=f"{key} vs JAX CP")
        np.testing.assert_allclose(got[key].numpy(), want_fwd, atol=CP_TOL, err_msg=f"{key} vs JAX forward")


def test_context_parallel_probs_match_jax(setup):
    tree, net = setup
    wav = (0.1 * np.random.default_rng(1).standard_normal((2, 16 * 320))).astype(np.float32)
    jconf = JVapConfig()
    out = jvap.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(wav)[None], jconf)
    want = jvap.probs_from_logits(out["logits"], out["vad"], jconf)
    got = cp.probs_context_parallel(net, torch.from_numpy(wav), VapConfig(), _mesh(4))
    for key in ("p_now", "p_future", "H"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, err_msg=key)


def test_context_parallel_single_shard_is_the_plain_forward(setup, jax_outputs):
    _, net = setup
    wav = torch.from_numpy(_wave(16, 16))
    got = cp.forward_context_parallel(net, wav, VapConfig(), _mesh(1))
    with torch.no_grad():
        plain = tvap.forward(net, wav, VapConfig())
    for key in ("logits", "vad"):
        torch.testing.assert_close(got[key], plain[key], rtol=0, atol=0)
        np.testing.assert_allclose(got[key].numpy(), jax_outputs[16][key][1], atol=CP_TOL)


def test_context_parallel_with_the_conv01_kernel(setup, jax_outputs, monkeypatch):
    """``VAP_CONV_IMPL=fused``: each shard's conv stage goes through K11's
    wrapper (its plain version here); the result still matches JAX."""
    from voiceactivityprojection_tpu_torch.models import encoder as tenc

    calls = []
    real = tenc.fused_conv01
    monkeypatch.setattr(tenc, "fused_conv01", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("VAP_CONV_IMPL", "fused")
    _, net = setup
    got = cp.forward_context_parallel(net, torch.from_numpy(_wave(24, 24)), VapConfig(), _mesh(4))
    assert len(calls) == 4
    np.testing.assert_allclose(got["logits"].numpy(), jax_outputs[24]["logits"][1], atol=CP_TOL)


def test_context_parallel_bfloat16(setup):
    """bf16 compute against JAX's bf16 forward at the JAX test's bar (rtol
    0.1, atol 0.05; the port's GRU carries in f32 on the card, its CPU loop
    in bf16 as JAX's scan), and against the port's own bf16 forward."""
    tree, net = setup
    wav = _wave(16, 4)
    want = jvap.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(wav), JVapConfig(dtype="bfloat16"))
    conf = VapConfig(dtype="bfloat16")
    got = cp.forward_context_parallel(net, torch.from_numpy(wav), conf, _mesh(4))
    with torch.no_grad():
        plain = tvap.forward(net, torch.from_numpy(wav), conf)
    for key in ("logits", "vad"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0.1, atol=0.05)
        np.testing.assert_allclose(got[key].numpy(), plain[key].numpy(), rtol=0.1, atol=0.05)


def test_context_parallel_refuses_what_it_cannot_split(setup):
    _, net = setup
    with pytest.raises(ValueError, match="multiple of 1280"):
        cp.forward_context_parallel(net, torch.zeros(2, 16 * 320 + 1), VapConfig(), _mesh(4))
    with pytest.raises(ValueError, match="chunks too small"):
        cp.forward_context_parallel(net, torch.zeros(2, 8 * 320), VapConfig(), _mesh(8))
    with pytest.raises(ValueError, match="stereo"):
        cp.forward_context_parallel(net, torch.zeros(1, 1, 16 * 320), VapConfig(), _mesh(2))

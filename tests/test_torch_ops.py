"""PyTorch port, tensor ops: each function against its JAX counterpart on
the same numpy inputs (CPU, float32)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.ops import attention as jattn
from voiceactivityprojection_tpu.ops import codebook as jcb
from voiceactivityprojection_tpu.ops import conv as jconv
from voiceactivityprojection_tpu.ops import gru as jgru
from voiceactivityprojection_tpu_torch.ops import attention as tattn
from voiceactivityprojection_tpu_torch.ops import codebook as tcb
from voiceactivityprojection_tpu_torch.ops import conv as tconv
from voiceactivityprojection_tpu_torch.ops import gru as tgru

pytestmark = pytest.mark.objective

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize(
    "k,s,pad,dil",
    [(10, 5, (3, 3), 1), (8, 4, (2, 2), 1), (4, 2, (1, 1), 1), (5, 2, (4, 0), 1), (3, 1, (2, 2), 2)],
)
def test_conv1d_matches_jax(k, s, pad, dil):
    rng = np.random.default_rng(0)
    c_in = 1 if k == 10 else 16
    x, w, b = _rand(rng, 2, 97, c_in), _rand(rng, k, c_in, 24), _rand(rng, 24)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s, pad, dil))
    got = tconv.conv1d(_t(x), _t(w), _t(b), stride=s, padding=pad, dilation=dil).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 33, 16), _rand(rng, 5, 16, 16), _rand(rng, 16)
    want = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2))
    got = tconv.causal_conv1d(_t(x), _t(w), _t(b), stride=2).numpy()
    assert got.shape == want.shape == (2, 17, 16)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("name", ["channel_norm", "layer_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(name, dtype):
    rng = np.random.default_rng(2)
    x, g, b = _rand(rng, 3, 11, 64, scale=3.0), _rand(rng, 64), _rand(rng, 64)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(getattr(jconv, name)(jx, jnp.asarray(g), jnp.asarray(b)).astype(jnp.float32))
    tx = _t(x).to(getattr(torch, dtype))
    got = getattr(tconv, name)(tx, _t(g), _t(b))
    assert got.dtype == tx.dtype
    # bf16: both round one f32 result to bf16; ties may land one ulp apart
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_channel_norm_is_unbiased():
    x = torch.tensor([[[1.0, 3.0]]])
    y = tconv.channel_norm(x, torch.ones(2), torch.zeros(2), eps=0.0)
    # unbiased variance of (1, 3) is 2: (x - 2) / sqrt(2)
    np.testing.assert_allclose(y.numpy().ravel(), [-1 / np.sqrt(2), 1 / np.sqrt(2)], rtol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_matches_jax(with_h0):
    rng = np.random.default_rng(3)
    C, H, B, T = 24, 32, 3, 17
    p = {
        "w_ih": _rand(rng, C, 3 * H, scale=0.2), "w_hh": _rand(rng, H, 3 * H, scale=0.2),
        "b_ih": _rand(rng, 3 * H, scale=0.2), "b_hh": _rand(rng, 3 * H, scale=0.2),
    }
    x = _rand(rng, B, T, C)
    h0 = _rand(rng, B, H) if with_h0 else None
    ys_j, h_j = jgru.gru(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0), impl="scan",
    )
    ys_t, h_t = tgru.gru(
        _t(x), _t(p["w_ih"]), _t(p["w_hh"]), _t(p["b_ih"]), _t(p["b_hh"]),
        None if h0 is None else _t(h0),
    )
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)


@pytest.mark.parametrize("num_heads", [1, 2, 4, 6, 8, 12])
def test_alibi_slopes_match_jax(num_heads):
    np.testing.assert_array_equal(
        tattn.alibi_slopes(num_heads).numpy(), np.asarray(jattn.alibi_slopes(num_heads))
    )


@pytest.mark.parametrize("cross", [False, True])
def test_attention_dense_matches_jax(cross):
    rng = np.random.default_rng(4)
    B, T, D, H = 2, 37, 32, 4
    w = {n: _rand(rng, D, D, scale=0.3) for n in ("query", "key", "value", "proj")}
    q_in = _rand(rng, B, T, D)
    kv_in = _rand(rng, B, T, D) if cross else q_in
    jp = {n: {"w": jnp.asarray(v)} for n, v in w.items()}
    jp["m"] = jattn.alibi_slopes(H)
    want, want_w = jattn.attention_dense(jp, jnp.asarray(q_in), jnp.asarray(kv_in), H, return_weights=True)

    mha = tattn.MHA(D, H)
    for n, v in w.items():
        getattr(mha, n).w.data.copy_(_t(v))
    mha.requires_grad_(False)
    got, got_w = tattn.attention_dense(mha, _t(q_in), _t(kv_in), H, return_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    # CPU tensors take the dense path through the dispatcher too
    disp, none = tattn.attention(mha, _t(q_in), _t(kv_in), H)
    assert none is None
    np.testing.assert_allclose(disp.numpy(), got.numpy(), atol=0)


def test_codebook_matrix_and_weights_match_jax():
    np.testing.assert_array_equal(tcb.codebook_matrix(4), jcb.codebook_matrix(4))
    for fb, tb in [(0, 1), (2, 3), (0, 3)]:
        np.testing.assert_array_equal(
            tcb._aggregate_weights(fb, tb), jcb._aggregate_weights(fb, tb)
        )
    np.testing.assert_array_equal(
        tcb._aggregate_weights(0, 3, bin_frames=[10, 20, 30, 40], scale_with_bins=True),
        jcb._aggregate_weights(0, 3, bin_frames=[10, 20, 30, 40], scale_with_bins=True),
    )


def test_next_speaker_and_entropy_match_jax():
    rng = np.random.default_rng(5)
    logits = _rand(rng, 2, 9, 256, scale=3.0)
    probs = np.asarray(torch.softmax(_t(logits), -1))
    probs[0, 0] = 0.0
    probs[0, 0, 7] = 1.0  # one exact zero-entropy row: 0 * log2(0) := 0
    for fb, tb in [(0, 1), (2, 3)]:
        want = np.asarray(jcb.probs_next_speaker_aggregate(jnp.asarray(probs), fb, tb))
        got = tcb.probs_next_speaker_aggregate(_t(probs), fb, tb).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    want_h = np.asarray(jcb.entropy_bits(jnp.asarray(probs)))
    got_h = tcb.entropy_bits(_t(probs)).numpy()
    np.testing.assert_allclose(got_h, want_h, atol=1e-5)
    assert got_h[0, 0] == 0.0

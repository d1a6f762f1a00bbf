"""PyTorch port, the streaming encoders against the JAX package on the CPU.

The causal ``apply_encoder_streaming`` and the exact
``ExactStreamingEncoder`` are fed the same chunks (numpy, from a seed) as
their JAX counterparts, hop by hop at 1, 2 and 5 frames, with the weights
of one JAX ``init_encoder`` (dim 16) crossed over by ``encoder_from_jax``. The
port's exact frames are also held against its own batch ``apply_encoder``
(the symmetric-pad lookahead taken as latency), across chunk sizes, and
through ``reset`` and ``reset_rows``.

Measured on this CPU: the causal and the exact encoder within 1.4e-6 of
JAX (bar 5e-6), the exact frames within 5.4e-7 of the port's batch
encoder (bar 5e-6; JAX's own test holds 1e-5).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.models import encoder as jenc
from voiceactivityprojection_tpu.models.encoder_streaming_exact import ExactStreamingEncoder as JExact
from voiceactivityprojection_tpu_torch.models import encoder as penc
from voiceactivityprojection_tpu_torch.models import encoder_streaming_exact as pexact
from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax

pytestmark = pytest.mark.inference

VS_JAX = 5e-6
VS_BATCH = 5e-6
MARGIN = 2  # trailing frames where the batch forward sees its end padding


@pytest.fixture(scope="module")
def models():
    jp = jenc.init_encoder(jax.random.key(0), dim=16)
    return jp, encoder_from_jax(jax.tree.map(np.asarray, jp)).requires_grad_(False)


def _wave(seed, rows, frames):
    return (0.1 * np.random.default_rng(seed).standard_normal((rows, frames * 320))).astype(np.float32)


def _chunks(w, hop_frames):
    hop = hop_frames * 320
    return [w[:, i:i + hop] for i in range(0, w.shape[1], hop)]


def test_tail_table_matches_jax():
    from voiceactivityprojection_tpu.models import encoder_streaming_exact as jx

    assert pexact._CONV_TAILS == jx._CONV_TAILS == [(8, 3), (5, 2), (2, 1), (2, 1), (2, 1)]
    assert (pexact._DOWN_PRIME, pexact._DOWN_STEADY) == (jx._DOWN_PRIME, jx._DOWN_STEADY) == (4, 3)


@pytest.mark.parametrize("hop_frames", [1, 2, 5])
def test_causal_streaming_matches_jax(models, hop_frames):
    jp, enc = models
    w = _wave(hop_frames, 2, 30)
    js = jenc.init_encoder_state(jp, 2)
    ps = penc.init_encoder_state(enc, 2)
    step = jax.jit(jenc.apply_encoder_streaming)
    for c in _chunks(w, hop_frames):
        want, js = step(jp, jnp.asarray(c), js)
        with torch.inference_mode():
            got, ps = penc.apply_encoder_streaming(enc, torch.from_numpy(c), ps)
        assert got.shape == want.shape == (2, hop_frames, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=VS_JAX)
    for p_t, j_t in zip(ps.conv_tails, js.conv_tails):
        np.testing.assert_allclose(p_t.numpy(), np.asarray(j_t), rtol=0, atol=VS_JAX)
    np.testing.assert_allclose(ps.gru_h.numpy(), np.asarray(js.gru_h), rtol=0, atol=VS_JAX)


@pytest.mark.parametrize("hop_frames", [1, 2, 5])
def test_exact_streaming_matches_jax(models, hop_frames):
    """The prime push and every steady push, frame for frame."""
    jp, enc = models
    w = _wave(10 + hop_frames, 2, 30)
    je, pe = JExact(jp, batch=2), pexact.ExactStreamingEncoder(enc, batch=2)
    for i, c in enumerate(_chunks(w, hop_frames)):
        want, got = np.asarray(je.push(c)), pe.push(c).numpy()
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=0, atol=VS_JAX, err_msg=f"push {i}")
    assert pe.frames_emitted == je.frames_emitted


@pytest.mark.parametrize("hop_frames", [1, 5, 16])
def test_exact_streaming_matches_port_batch(models, hop_frames):
    _, enc = models
    w = _wave(20 + hop_frames, 1, 48)
    with torch.inference_mode():
        batch = penc.apply_encoder(enc, torch.from_numpy(w)).numpy()
    s = pexact.ExactStreamingEncoder(enc, batch=1)
    stream = np.concatenate([s.push(c).numpy() for c in _chunks(w, hop_frames)], axis=1)
    n = min(stream.shape[1], batch.shape[1]) - MARGIN
    assert n >= 40
    np.testing.assert_allclose(stream[0, :n], batch[0, :n], rtol=0, atol=VS_BATCH)


def test_exact_streaming_chunk_invariance(models):
    _, enc = models
    w = _wave(30, 1, 30)

    def run(hop_frames):
        s = pexact.ExactStreamingEncoder(enc, batch=1)
        return np.concatenate([s.push(c).numpy() for c in _chunks(w, hop_frames)], axis=1)

    a, b = run(1), run(5)
    n = min(a.shape[1], b.shape[1])
    np.testing.assert_allclose(a[0, :n], b[0, :n], rtol=0, atol=VS_BATCH)


def test_reset_is_exact(models):
    _, enc = models
    w = _wave(31, 2, 10)
    s = pexact.ExactStreamingEncoder(enc, batch=2)
    a = s.push(w).numpy()
    s.push(w)
    s.reset()
    assert not s.primed and s.frames_emitted == 0
    np.testing.assert_array_equal(s.push(w).numpy(), a)
    # the causal encoder from a fresh state: the same frames again
    st = penc.init_encoder_state(enc, 2)
    with torch.inference_mode():
        c1, _ = penc.apply_encoder_streaming(enc, torch.from_numpy(w), st)
        c2, _ = penc.apply_encoder_streaming(enc, torch.from_numpy(w), penc.init_encoder_state(enc, 2))
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())


def test_reset_rows_zeroes_only_its_rows(models):
    """The rows reset go to zeros and the others keep their state; the
    stream then goes on as JAX's does after the same reset."""
    jp, enc = models
    w = _wave(32, 3, 12)
    je, pe = JExact(jp, batch=3), pexact.ExactStreamingEncoder(enc, batch=3)
    for c in _chunks(w[:, :6 * 320], 2):
        je.push(c)
        pe.push(c)
    before = [t.clone() for t in (*pe.state.conv_tails, pe.state.gru_h, pe.state.down_tail)]
    je.reset_rows([1])
    pe.reset_rows([1])
    after = (*pe.state.conv_tails, pe.state.gru_h, pe.state.down_tail)
    for b, a in zip(before, after):
        assert float(a[1].abs().max()) == 0.0
        np.testing.assert_array_equal(a[[0, 2]].numpy(), b[[0, 2]].numpy())
    assert float(before[5][1].abs().max()) > 0  # the GRU hidden was not zero before
    for c in _chunks(w[:, 6 * 320:], 2):
        np.testing.assert_allclose(pe.push(c).numpy(), np.asarray(je.push(c)), rtol=0, atol=VS_JAX)


def test_push_rejects_a_ragged_chunk(models):
    _, enc = models
    with pytest.raises(ValueError, match="chunk must be"):
        pexact.ExactStreamingEncoder(enc, batch=1).push(np.zeros((1, 100), np.float32))

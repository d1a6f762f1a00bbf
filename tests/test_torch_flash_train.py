"""PyTorch port, the kernels of the training slice on the CPU: the attention
dropout hash, the plain flash-train forward and backward (the CPU side of
the K6 and K7/K8 kernels), and the plain GRU recurrence (the CPU side of
K3), each against the JAX package on the same numpy inputs. The JAX
flash-train kernels run in interpret mode, as the JAX package's own tests
run them. The CUDA kernels are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.ops import flash_alibi_train as jft
from voiceactivityprojection_tpu.ops.attention import alibi_slopes as jalibi
from voiceactivityprojection_tpu.ops.gru import gru as jgru
from voiceactivityprojection_tpu_torch.models.encoder import Encoder
from voiceactivityprojection_tpu_torch.ops import attention as tattn
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

pytestmark = pytest.mark.transformer

torch.set_num_threads(2)

B, H, T, DH = 1, 2, 160, 32
SCALE = 1.0 / np.sqrt(H * DH)  # the full model dim, as the model calls it


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return [(0.3 * rng.standard_normal((B, H, T, DH))).astype(np.float32) for _ in range(4)]


# ---------------------------------------------------------------- the hash --
@pytest.mark.parametrize("seed", [0, 1, 1234, 2**31 - 2])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_matches_jax_bit_for_bit(seed, rate):
    for bh in (0, 1, 7, 63):
        want = np.asarray(jft.dropout_mask_reference(jnp.asarray(seed, jnp.int32), bh, T, rate))
        got = ft.dropout_mask_reference(seed, bh, T, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_rate_threshold_and_keep_mask_layout():
    for rate in (0.0, 0.1, 0.5, 0.999999):
        assert ft.rate_threshold(rate) == int(jft._rate_threshold(rate))
    keep = ft.keep_mask(2, 3, 20, 5, 0.1)
    for b in range(2):
        for h in range(3):
            np.testing.assert_array_equal(
                keep[b, h].numpy(), ft.dropout_mask_reference(5, b * 3 + h, 20, 0.1).numpy())
    assert abs(float(ft.keep_mask(2, 2, 160, 3, 0.25).float().mean()) - 0.75) < 0.01


# ------------------------------------------------------------ K6 and K7/K8 --
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_train_forward_plain_matches_jax(qkv, rate):
    q, k, v, _ = qkv
    seed = 1234
    args = [jnp.asarray(a) for a in (q, k, v)] + [jalibi(H), jnp.asarray(seed, jnp.int32)]
    want = np.asarray(jft.flash_alibi_attention_train(*args, SCALE, rate))
    _, want_lse = jft._flash_train_forward(*args, SCALE, rate)
    out, lse = ft.flash_train_forward(_t(q), _t(k), _t(v), alibi_slopes(H), seed, SCALE, rate)
    assert lse.shape == (B * H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=3e-5)


def test_train_backward_plain_matches_jax(qkv):
    q, k, v, cot = qkv
    seed, rate = 77, 0.1
    slopes, jseed = jalibi(H), jnp.asarray(seed, jnp.int32)

    def loss(q, k, v):
        return jnp.sum(jft.flash_alibi_attention_train(q, k, v, slopes, jseed, SCALE, rate) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ft.flash_alibi_attention_train(*leaves, alibi_slopes(H), seed, SCALE, rate)
    got = torch.autograd.grad(out, leaves, _t(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_train_backward_plain_is_the_gradient_of_the_plain_forward(qkv, rate):
    """The backward written from the identities equals autograd through the
    masked dense forward (float64, so only the algebra is compared)."""
    q, k, v, cot = (torch.from_numpy(a).double() for a in qkv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = ft.train_forward_reference(*leaves, alibi_slopes(H).double(), 9, SCALE, rate)
    want = torch.autograd.grad(out, leaves, cot)
    got = ft.flash_train_backward(q, k, v, alibi_slopes(H).double(), 9, out.detach(), lse.detach(),
                                  cot, SCALE, rate)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


def test_dense_dropout_uses_the_kernel_mask(qkv):
    """On the CPU the dense attention path drops weights by the same hash
    mask as the kernels: for one seed it matches the flash-train path."""
    rng = np.random.default_rng(1)
    D = H * DH
    mha = tattn.MHA(D, H).requires_grad_(False)
    for n in ("query", "key", "value", "proj"):
        getattr(mha, n).w.copy_(_t(0.2 * rng.standard_normal((D, D))))
    x = _t(rng.standard_normal((B, T, D)))
    dense, _ = tattn.attention_dense(mha, x, x, H, dropout_rate=0.2,
                                     generator=torch.Generator().manual_seed(3))
    seed = tattn._dropout_seed(torch.Generator().manual_seed(3))
    q, k, v = (tattn._split_heads(x @ getattr(mha, n).w.T, H) for n in ("query", "key", "value"))
    flash = ft.flash_alibi_attention_train(q, k, v, mha.m, seed, 1 / np.sqrt(D), 0.2)
    np.testing.assert_allclose(dense.numpy(), (tattn._merge_heads(flash) @ mha.proj.w.T).numpy(),
                               atol=1e-5)
    none, _ = tattn.attention_dense(mha, x, x, H)
    assert not torch.allclose(dense, none)


def test_attention_dispatch_draws_one_seed_per_dropout_call():
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    mha = tattn.MHA(16, 2).requires_grad_(False)
    torch.nn.init.normal_(mha.query.w)
    x = torch.randn(1, 5, 16)
    tattn.attention(mha, x, x, 2, dropout_rate=0.0, generator=gen)
    assert torch.equal(gen.get_state(), before)
    tattn.attention(mha, x, x, 2, dropout_rate=0.1, generator=gen)
    assert not torch.equal(gen.get_state(), before)


# ---------------------------------------------------------------- K3 --------
def _gru_inputs(Hd, T, R=2, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.2: (sc * rng.standard_normal(s)).astype(np.float32)
    return {"z": r(R, T, Hd, sc=1.0), "w_ih": r(Hd, 3 * Hd), "b_ih": r(3 * Hd),
            "w_hh": r(Hd, 3 * Hd), "b_hh": r(3 * Hd), "h0": r(R, Hd)}


@pytest.mark.parametrize("T", [48, 33])
def test_gru_recurrence_plain_matches_jax(T):
    p = _gru_inputs(128, T)
    g = {k: jnp.asarray(p[k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    ys_j, h_j = jgru(g, jnp.asarray(p["z"]), jnp.asarray(p["h0"]), impl="scan")
    x_proj = _t(p["z"]) @ _t(p["w_ih"]) + _t(p["b_ih"])
    ys, h_last = k3.gru_recurrence(x_proj, _t(p["w_hh"]), _t(p["b_hh"]), _t(p["h0"]))
    assert ys.shape == (2, T, 128) and h_last.shape == (2, 128)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_j), atol=1e-5)


def test_gru_recurrence_keeps_an_f32_carry_in_bf16():
    p = _gru_inputs(32, 20)
    x_proj = (_t(p["z"]) @ _t(p["w_ih"]) + _t(p["b_ih"])).bfloat16()
    args = [x_proj, _t(p["w_hh"]).bfloat16(), _t(p["b_hh"]).bfloat16(), _t(p["h0"]).bfloat16()]
    ys, h_last = k3.gru_recurrence(*args)
    want, _ = k3.gru_recurrence(*(a.float() for a in args))
    assert ys.dtype == torch.bfloat16 and torch.equal(h_last, ys[:, -1])
    # f32 carry, one rounding of the output: within one bf16 step of f32
    np.testing.assert_allclose(ys.float().numpy(), want.numpy(), atol=2 ** -8)


@pytest.mark.slow
def test_gru_recurrence_plain_matches_jax_kernel():
    """Against the JAX Pallas kernel itself, in interpret mode."""
    from voiceactivityprojection_tpu.ops.gru_pallas import gru_recurrence_pallas

    p = _gru_inputs(128, 48, seed=1)
    x_proj = p["z"] @ p["w_ih"] + p["b_ih"]
    args = [x_proj, p["w_hh"], p["b_hh"], p["h0"]]
    ys_j, h_j = gru_recurrence_pallas(*map(jnp.asarray, args))
    ys, h_last = k3.gru_recurrence(*map(_t, args))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_j), atol=1e-5)


# ---------------------------------------------------------------- wrappers --
def test_cpu_paths_carry_gradients_and_count_no_launches():
    """Every kernel wrapper's CPU path is plain PyTorch, so autograd runs
    through it; none of them counts a launch."""
    counters = (k1.fused_conv_stack, k2.gru_downsample_fused, k3.gru_recurrence,
                ft.flash_train_forward, ft.flash_train_backward, k4.flash_alibi_attention)
    before = [c.launches for c in counters]
    enc = Encoder(32)
    for t in enc.parameters():
        torch.nn.init.normal_(t, std=0.1)
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    (g,) = torch.autograd.grad(k1.fused_conv_stack(layers, torch.randn(1, 1600)).sum(), layers[1][0])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    d = enc.downsample
    out = k2.gru_downsample_fused(torch.randn(1, 6, 96), enc.gAR.w_hh, enc.gAR.b_hh, torch.zeros(1, 32),
                                  d.conv.w, d.conv.b, d.ln.w, d.ln.b)
    (g,) = torch.autograd.grad(out.sum(), d.conv.w)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    p = _gru_inputs(32, 6)
    w_hh = _t(p["w_hh"]).requires_grad_()
    ys, _ = k3.gru_recurrence(_t(p["z"]) @ _t(p["w_ih"]), w_hh, _t(p["b_hh"]), _t(p["h0"]))
    (g,) = torch.autograd.grad(ys.sum(), w_hh)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    out = ft.flash_alibi_attention_train(q, q, q, alibi_slopes(2), 5, 0.1, 0.1)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    (g4,) = torch.autograd.grad(k4.flash_alibi_attention(q, q, q, alibi_slopes(2), 0.1).sum(), q)
    (gd,) = torch.autograd.grad(k4.dense_reference(q, q, q, alibi_slopes(2), 0.1).sum(), q)
    torch.testing.assert_close(g4, gd, atol=0, rtol=0)
    assert [c.launches for c in counters] == before


def test_train_wrappers_check_shapes_and_refuse_other_devices():
    with pytest.raises(ValueError, match="share one"):
        ft.flash_train_forward(torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 9, 64),
                               torch.zeros(1, 2, 8, 64), alibi_slopes(2), 0, 0.1, 0.1)
    with pytest.raises(ValueError, match="h0"):
        k3.gru_recurrence(torch.zeros(2, 4, 96), torch.zeros(32, 96), torch.zeros(96), torch.zeros(1, 32))
    meta = torch.device("meta")
    q = torch.empty(1, 2, 8, 64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ft.flash_train_forward(q, q, q, torch.empty(2, device=meta), 0, 0.1, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        k3.gru_recurrence(torch.empty(1, 4, 96, device=meta), torch.empty(32, 96, device=meta),
                          torch.empty(96, device=meta), torch.empty(1, 32, device=meta))
    with pytest.raises(ValueError, match="dropout rate"):
        ft._dropout_args(0, 1.0)

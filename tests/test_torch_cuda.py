"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the model on the card against the same
model on the CPU. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu_torch import VapConfig, VapModel, params_from_jax
from voiceactivityprojection_tpu_torch.config import OptConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
from voiceactivityprojection_tpu_torch.train import step as tstep
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels compile and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state():
    conf = VapConfig()
    return params_from_jax(random_params_tree(conf, seed=0), conf)


def _layers(state, device, dtype=torch.float32):
    return [
        tuple(state[f"encoder.gEncoder.{i}.{p}"].to(device, dtype)
              for p in ("conv.w", "conv.b", "norm.w", "norm.b"))
        for i in range(5)
    ]


@pytest.mark.parametrize("n", [16000, 12345, 161])
def test_conv_stack_kernel_matches_plain(cuda, state, n):
    layers = _layers(state, cuda)
    x = 0.1 * torch.randn(4, n, device=cuda)
    want = k1.reference_stack(layers, x)
    got = k1.fused_conv_stack(layers, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _gru_args(state, R, T, device, dtype=torch.float32):
    g = {k: state[f"encoder.gAR.{k}"] for k in ("w_hh", "b_hh")}
    d = {k: state[f"encoder.downsample.{k}"] for k in ("conv.w", "conv.b", "ln.w", "ln.b")}
    x_proj = 0.5 * torch.randn(R, T, 768)
    args = [x_proj, g["w_hh"], g["b_hh"], torch.zeros(R, 256), d["conv.w"], d["conv.b"],
            d["ln.w"], d["ln.b"]]
    return [a.to(device, dtype).contiguous() for a in args]


@pytest.mark.parametrize("T", [1, 48, 33, 2000])
def test_gru_downsample_kernel_matches_plain(cuda, state, T):
    args = _gru_args(state, 3, T, cuda)
    got = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k2.gru_downsample_reference(*args), atol=5e-5, rtol=0)


@pytest.mark.parametrize("T", [1000, 3000, 77, 1])
def test_attention_kernel_matches_plain(cuda, T):
    q, k, v = (torch.randn(2, 4, T, 64, device=cuda) for _ in range(3))
    s = alibi_slopes(4).to(cuda)
    got = k4.flash_alibi_attention(q, k, v, s, 1 / 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k4.dense_reference(q, k, v, s, 1 / 16), atol=5e-6, rtol=0)


def test_kernels_refuse_what_they_do_not_take(cuda, state):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        k4.flash_alibi_attention(q, q, q, alibi_slopes(2).to(cuda), 0.1)
    with pytest.raises(ValueError, match="float16"):
        q16 = torch.randn(1, 2, 8, 64, device=cuda).half()
        k4.flash_alibi_attention(q16, q16, q16, alibi_slopes(2).to(cuda), 0.1)
    x = torch.randn(2, 3200, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_conv_stack(_layers(state, cuda), x[:, ::2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_card_matches_cpu(cuda, state, dtype):
    conf = VapConfig(dtype=dtype)
    wave = (0.1 * np.random.default_rng(0).standard_normal((2, 2, 16000))).astype(np.float32)
    counters = (k1.fused_conv_stack, k2.gru_downsample_fused, k4.flash_alibi_attention)
    for c in counters:
        c.launches = 0
    got = VapModel(conf, state, device="cuda").probs(wave)
    assert [c.launches for c in counters] == [5, 1, 14]
    want = VapModel(VapConfig(), state, device="cpu").probs(wave)
    # float32: the JAX package's bar; bfloat16 vs float32: the bf16 slice bound
    atol = 2e-4 if dtype == "float32" else 2e-3
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=atol, rtol=0)
    assert math.isfinite(float(got["H"].sum()))


@pytest.mark.parametrize("T", [1, 33, 2000])
def test_gru_recurrence_kernel_matches_plain(cuda, state, T):
    args = _gru_args(state, 3, T, cuda)
    args = [args[0], args[1], args[2], 0.1 * torch.randn(3, 256, device=cuda)]
    ys, h_last = k3.gru_recurrence(*args)
    torch.cuda.synchronize()
    want, _ = k3.gru_recurrence_reference(*args)
    torch.testing.assert_close(ys, want, atol=5e-6, rtol=0)
    assert torch.equal(h_last, ys[:, -1])


@pytest.mark.parametrize("T", [1000, 3000, 77, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_train_attention_kernels_match_plain(cuda, T, rate):
    q, k, v, do = (torch.randn(2, 4, T, 64, device=cuda) for _ in range(4))
    s = alibi_slopes(4).to(cuda)
    out, lse = ft.flash_train_forward(q, k, v, s, 99, 1 / 16, rate)
    torch.cuda.synchronize()
    want, want_lse = ft.train_forward_reference(q, k, v, s, 99, 1 / 16, rate)
    torch.testing.assert_close(out, want, atol=5e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=5e-6, rtol=0)
    got = ft.flash_train_backward(q, k, v, s, 99, out, lse, do, 1 / 16, rate)
    torch.cuda.synchronize()
    # against autograd through the masked dense forward
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = ft.train_forward_reference(*leaves, s, 99, 1 / 16, rate)
    for g, w in zip(got, torch.autograd.grad(ref, leaves, do)):
        torch.testing.assert_close(g, w, atol=2e-5 * max(float(w.abs().max()), 1.0), rtol=0)


def test_inference_attention_backward_matches_dense(cuda):
    leaves = [torch.randn(2, 4, 300, 64, device=cuda, requires_grad=True) for _ in range(3)]
    s = alibi_slopes(4).to(cuda)
    cot = torch.randn(2, 4, 300, 64, device=cuda)
    got = torch.autograd.grad(k4.flash_alibi_attention(*leaves, s, 1 / 16), leaves, cot)
    want = torch.autograd.grad(k4.dense_reference(*leaves, s, 1 / 16), leaves, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_kernels_without_backward_raise_on_grad(cuda, state):
    """K2 alone has no backward (nor has JAX's ``gru_downsample_fused``): it
    raises on a grad-requiring input. K1 and K3 are autograd functions."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)]
    assert k1.fused_conv_stack(layers, torch.randn(2, 3200, device=cuda)).grad_fn is not None
    args = _gru_args(state, 2, 8, cuda)
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        k2.gru_downsample_fused(*args)
    ys, h_last = k3.gru_recurrence(*args[:4])
    assert ys.grad_fn is not None and h_last.grad_fn is not None
    with torch.no_grad():  # no grad requested: the kernel runs
        k2.gru_downsample_fused(*args)


def test_conv_stack_backward_matches_autograd_of_plain(cuda, state):
    """K1's backward (autograd through ``reference_stack`` on the saved
    inputs, as JAX ``_vjp_bwd``) against autograd through the plain stack."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)]
    x = (0.1 * torch.randn(2, 16000, device=cuda)).requires_grad_()
    leaves = [x, *(t for l in layers for t in l)]
    cot = torch.randn(2, 100, 256, device=cuda)
    k1.fused_conv_stack.launches = 0
    got = torch.autograd.grad(k1.fused_conv_stack(layers, x), leaves, cot)
    assert k1.fused_conv_stack.launches == 5
    want = torch.autograd.grad(k1.reference_stack(layers, x), leaves, cot)
    for g, w in zip(got, want):
        # the backward is the same computation; only the forward's tile sums differ
        torch.testing.assert_close(g, w, atol=1e-4 * max(float(w.abs().max()), 1.0), rtol=0)


def _gru_bwd_args(state, R, T, device, dtype):
    gen = torch.Generator().manual_seed(R * 10000 + T)
    x_proj = 0.5 * torch.randn(R, T, 768, generator=gen)
    h0 = 0.1 * torch.randn(R, 256, generator=gen)
    dys = torch.randn(R, T, 256, generator=gen)
    args = [x_proj, state["encoder.gAR.w_hh"], state["encoder.gAR.b_hh"], h0]
    return [a.to(device, dtype).contiguous() for a in args], dys.to(device, dtype)


def _bf16_tol(want, steps=2):
    """``steps`` bf16 roundings at the largest magnitude (the kernel and its
    plain version sum in f32 in other orders, then round the same way)."""
    top = max(float(want.float().abs().max()), 1.0)
    return steps * 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("R,T", [(32, 2000), (3, 1999), (32, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_backward_kernel_matches_plain(cuda, state, R, T, dtype):
    args, dys = _gru_bwd_args(state, R, T, cuda, dtype)
    ys, _ = k3.gru_recurrence(*args)
    k3.gru_backward.launches = 0
    got = k3.gru_backward(*args, ys, dys)
    torch.cuda.synchronize()
    assert k3.gru_backward.launches == 1
    want = k3.gru_backward_reference(*args, ys, dys)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        # float32: 1e-5 of the largest gradient (sums in another order)
        tol = 1e-5 * max(float(w.abs().max()), 1.0) if dtype == torch.float32 else _bf16_tol(w)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


def test_gru_backward_kernel_matches_autograd_of_plain_forward(cuda, state):
    """float32: K3 + K9 through ``gru_recurrence`` against autograd through
    the plain forward loop, with a cotangent on ys and one on h_last."""
    args, dys = _gru_bwd_args(state, 3, 500, cuda, torch.float32)
    dh = torch.randn(3, 256, device=cuda)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, h_last = k3.gru_recurrence(*leaves)
    got = torch.autograd.grad((ys * dys).sum() + (h_last * dh).sum(), leaves)
    ys_p, h_p = k3.gru_recurrence_reference(*leaves)
    want = torch.autograd.grad((ys_p * dys).sum() + (h_p * dh).sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5 * max(float(w.abs().max()), 1.0), rtol=0)


def _train_step_on_both(state, dropout):
    conf = VapConfig(dropout=dropout)
    rng = np.random.default_rng(2)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    nets = {}
    for device in ("cpu", "cuda"):
        net = VapNet(conf)
        net.load_state_dict(state)
        net.to(device)
        ft.flash_train_forward.launches = ft.flash_train_backward.launches = 0
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net))
        metrics = step(net, batch, torch.Generator().manual_seed(0))
        nets[device] = (net, {k: float(v) for k, v in metrics.items()})
    # the card step's attention ran the training kernels, with or without dropout
    assert (ft.flash_train_forward.launches, ft.flash_train_backward.launches) == (14, 14)
    return nets


def test_train_step_on_card_matches_cpu(cuda, state):
    """One frozen-encoder step at dropout 0, float32, B=1 x 1 s."""
    nets = _train_step_on_both(state, 0.0)
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-4, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_dropout_train_step_on_card_matches_cpu(cuda, state, monkeypatch):
    """One frozen-encoder step at dropout 0.1, float32, B=1 x 1 s. The
    attention masks are the kernels' coordinate hash on either device; the
    elementwise masks are drawn on the CPU from the seed of the step's masks
    generator on both sides (on the CPU these are the port's own masks)."""
    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    def dropout(self, x, rate):
        if not hasattr(self, "cpu_masks"):
            self.cpu_masks = torch.Generator().manual_seed(self.masks.initial_seed())
        keep = (torch.rand(x.shape, generator=self.cpu_masks) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    monkeypatch.setattr(DropoutRng, "dropout", dropout)
    nets = _train_step_on_both(state, 0.1)
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-4, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_unfrozen_train_step_on_card_matches_cpu(cuda, state):
    """One unfrozen step at dropout 0, float32, B=1 x 1 s: the plain conv
    stack, K3 forward and K9 backward, the training attention kernels."""
    conf = VapConfig(dropout=0.0, freeze_encoder=False)
    rng = np.random.default_rng(3)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    nets = {}
    for device in ("cpu", "cuda"):
        net = VapNet(conf)
        net.load_state_dict(state)
        net.to(device)
        for c in (k1.fused_conv_stack, k3.gru_recurrence, k3.gru_backward, ft.flash_train_forward):
            c.launches = 0
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, freeze_encoder=False))
        metrics = step(net, batch, torch.Generator().manual_seed(0))
        nets[device] = (net, {k: float(v) for k, v in metrics.items()})
    assert (k1.fused_conv_stack.launches, k3.gru_recurrence.launches, k3.gru_backward.launches,
            ft.flash_train_forward.launches) == (0, 1, 1, 14)
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-5, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert p.grad is not None and q.grad is not None, name
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_cpc_step_on_card_matches_cpu(cuda, state):
    """One CPC step, float32, B=2 x 0.32 s, the same negatives (drawn from
    the step's CPU generator on both devices): metrics and gradients."""
    from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain as cpc

    tree = random_params_tree(VapConfig(), seed=0)["encoder"]
    wave = (0.1 * np.random.default_rng(4).standard_normal((2, 5120))).astype(np.float32)
    res = {}
    for device in ("cpu", "cuda"):
        heads = cpc.init_cpc_heads(torch.Generator().manual_seed(0), 12, 256, 256)
        st = cpc.init_cpc_train_state(encoder_from_jax(tree), heads, device=device)
        k3.gru_backward.launches = 0
        m = cpc.make_cpc_train_step(12, 128)(st, wave, torch.Generator().manual_seed(1))
        res[device] = (st, {k: float(v) for k, v in m.items()})
    assert k3.gru_backward.launches == 1
    (cpu, m_cpu), (card, m_card) = res["cpu"], res["cuda"]
    assert abs(m_cpu["cpc_loss"] - m_card["cpc_loss"]) < 1e-5
    pairs = [*zip(cpu.encoder.named_parameters(), card.encoder.parameters()),
             (("heads.W", cpu.heads.W), card.heads.W)]
    for (name, p), q in pairs:
        if p.grad is None:
            assert q.grad is None and name.startswith("downsample."), name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


@pytest.mark.parametrize("Tq,Tk,off", [(1500, 6000, 0), (1500, 6000, 1500), (1500, 6000, 4500),
                                       (1000, 3337, 2337), (100, 300, 37), (1, 1, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_attention_kernel_matches_plain(cuda, Tq, Tk, off, dtype):
    """K10 at the context-parallel shapes (and ragged ones) against its plain
    version: float32 to the K4 bar, bfloat16 to two roundings (p and out)."""
    gen = torch.Generator().manual_seed(Tq + Tk + off)
    q = torch.randn(1, 4, Tq, 64, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(1, 4, Tk, 64, generator=gen).to(cuda, dtype) for _ in range(2))
    s = alibi_slopes(4).to(cuda)
    k4.flash_alibi_attention_offset.launches = 0
    got = k4.flash_alibi_attention_offset(q, k, v, s, 1 / 16, off)
    torch.cuda.synchronize()
    assert k4.flash_alibi_attention_offset.launches == 1
    want = k4.dense_offset_reference(q, k, v, s, 1 / 16, off)
    tol = 5e-6 if dtype == torch.float32 else _bf16_tol(want)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_offset_attention_refuses_bad_offsets_and_grad(cuda):
    q = torch.randn(1, 4, 100, 64, device=cuda)
    k = torch.randn(1, 4, 300, 64, device=cuda)
    s = alibi_slopes(4).to(cuda)
    for off in (-1, 201):
        with pytest.raises(ValueError, match="must lie in"):
            k4.flash_alibi_attention_offset(q, k, k, s, 1 / 16, off)
    with pytest.raises(RuntimeError, match="no backward"):
        k4.flash_alibi_attention_offset(q.requires_grad_(), k, k, s, 1 / 16, 0)


@pytest.mark.parametrize("R,n", [(8, 320000), (4, 12345), (4, 16000), (3, 161)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv01_kernel_matches_plain(cuda, state, R, n, dtype):
    """K11 against the plain stack's first two layers: float32 to the conv
    stack's bar; bfloat16 to four roundings (each layer's output and, in
    the plain version, each conv sum, a step moving the next statistics)."""
    layers = _layers(state, cuda, dtype)
    x = (0.1 * torch.randn(R, n, generator=torch.Generator().manual_seed(n))).to(cuda, dtype)
    k11.fused_conv01.launches = 0
    got = k11.fused_conv01(layers, x)
    torch.cuda.synchronize()
    assert k11.fused_conv01.launches == 1
    want = k11.reference_unfused(layers, x)
    assert got.shape == want.shape == (R, k11.out_len(n), 256)
    tol = 1e-4 if dtype == torch.float32 else _bf16_tol(want, 4)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_conv01_backward_matches_autograd_of_plain(cuda, state):
    """K11's backward (autograd through ``reference_unfused`` on the saved
    inputs, as JAX ``_vjp_bwd``) against autograd through the plain layers."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)[:2]]
    x = (0.1 * torch.randn(2, 16000, device=cuda)).requires_grad_()
    leaves = [x, *(t for l in layers for t in l)]
    cot = torch.randn(2, 800, 256, device=cuda)
    got = torch.autograd.grad(k11.fused_conv01(layers, x), leaves, cot)
    want = torch.autograd.grad(k11.reference_unfused(layers, x), leaves, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4 * max(float(w.abs().max()), 1.0), rtol=0)


def _counters():
    return {"k1": k1.fused_conv_stack, "k2": k2.gru_downsample_fused, "k3": k3.gru_recurrence,
            "k4": k4.flash_alibi_attention, "k10": k4.flash_alibi_attention_offset,
            "k11": k11.fused_conv01}


@pytest.mark.parametrize("impl", [None, "fused"])
def test_context_parallel_on_card_matches_single_device(cuda, state, impl, monkeypatch):
    """60 s of stereo over a 4-shard mesh on one card, float32: K10 at every
    attention site of every shard, K3 once per shard (and K11 once per
    shard under ``VAP_CONV_IMPL=fused``); logits and vad within 2e-4 of the
    single-device forward on the card."""
    from voiceactivityprojection_tpu_torch.models.vap import forward
    from voiceactivityprojection_tpu_torch.parallel.context import forward_context_parallel
    from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh

    conf = VapConfig()
    net = VapNet(conf)
    net.load_state_dict(state)
    net.to(cuda).requires_grad_(False)
    wave = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((1, 2, 60 * 16000)))
                            .astype(np.float32)).to(cuda)
    want = forward(net, wave, conf)
    if impl is not None:
        monkeypatch.setenv("VAP_CONV_IMPL", impl)
    for c in _counters().values():
        c.launches = 0
    got = forward_context_parallel(net, wave, conf, make_mesh(n_data=4, devices=[cuda] * 4))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in _counters().items()}
    assert launches == {"k1": 0, "k2": 0, "k3": 4, "k4": 0, "k10": 56, "k11": 4 if impl else 0}
    for key in ("logits", "vad"):
        assert got[key].shape == want[key].shape
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=0)


def test_conv_impl_fused_runs_k11_in_inference(cuda, state, monkeypatch):
    """``VAP_CONV_IMPL=fused``: stereo inference runs K11 once per request
    and not K1; p_now / p_future within the float32 bar of the default."""
    monkeypatch.setenv("VAP_CONV_IMPL", "fused")
    wave = (0.1 * np.random.default_rng(6).standard_normal((2, 2, 32000))).astype(np.float32)
    model = VapModel(VapConfig(), state, device="cuda")
    for c in _counters().values():
        c.launches = 0
    got = model.probs(wave)
    assert (k11.fused_conv01.launches, k1.fused_conv_stack.launches) == (1, 0)
    monkeypatch.delenv("VAP_CONV_IMPL")
    want = model.probs(wave)
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=0)


def test_mono_model_on_card_matches_cpu(cuda):
    """The mono model with history conditioning, float32, B=2 x 1 s."""
    from voiceactivityprojection_tpu_torch.config import VapMonoConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapMonoModel

    conf = VapMonoConfig(va_history=True)
    mstate = params_from_jax(random_params_tree(conf, seed=1), conf)
    rng = np.random.default_rng(7)
    wave = (0.1 * rng.standard_normal((2, 1, 16000))).astype(np.float32)
    va = (rng.random((2, 60, 2)) < 0.4).astype(np.float32)
    vah = rng.random((2, 60, 5)).astype(np.float32)
    got = VapMonoModel(conf, mstate, device="cuda").probs(wave, va, vah)
    want = VapMonoModel(conf, mstate, device="cpu").probs(wave, va, vah)
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=2e-4, rtol=0)

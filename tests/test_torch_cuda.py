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
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
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

"""The CPC encoder's conv0 + conv1 (each with ChannelNorm + ReLU) on the card,
conv0's output kept on chip.

Replaces the TPU kernel ``_fused_kernel`` of
``voiceactivityprojection_tpu/ops/conv_fused.py`` (entry point
``fused_conv01``, :288): conv0 (k=10, s=5, pad 3, 1 -> 256 channels) and
conv1 (k=8, s=4, pad 2, 256 -> 256), each followed by ChannelNorm
(unbiased variance, eps 1e-5) and ReLU. (R, n) samples -> (R, n1, 256)
with n0 = (n + 6 - 10) // 5 + 1 and n1 = (n0 + 4 - 8) // 4 + 1. The
encoder runs it under ``VAP_CONV_IMPL=fused`` (``models/encoder.py``
``_conv_stack``), then the plain layers 2-4.

CUDA kernel: ``csrc/conv_fused.cu`` ``conv01_kernel``. One block per (row,
32 conv1 outputs) computes the 132 conv0 positions those read (10-tap
products from the raw samples, ChannelNorm, ReLU, literal zeros outside
[0, n0), which is conv1's padding) into shared memory in the I/O dtype, then
conv1 as a (32 x 2048) x (2048 x 256) product from there, with W1 streamed
through shared memory, and ChannelNorm + ReLU in the epilogue. conv0's
(R, n0, 256) output (4.2 GB in bf16 at R=128 x 20 s) never reaches device
memory, where K1 (``ops/conv_stack_fused.py``) writes it and reads it back.

Bound on the card: operations (conv1's 2048-deep contraction; about 1,000
FLOP per byte of samples read and features written). This first version
multiplies on the CUDA cores in f32; tensor-core tiles are the later step.

``reference_unfused`` is the plain PyTorch version (counterpart of
``_reference_unfused``, conv_fused.py:276: the first two layers of the
plain stack); the wrapper takes it only for CPU tensors. On the card the
wrapper is an autograd function whose backward runs autograd through
``reference_unfused`` on the saved inputs, as the JAX custom VJP does
(``_vjp_bwd``, conv_fused.py:296-299).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import LayerWeights, reference_stack

K0, S0, P0 = 10, 5, 3
K1, S1, P1 = 8, 4, 2
C = 256


def fused_conv01_supported(layers: Sequence[LayerWeights]) -> bool:
    """Whether the first two layers have the kernel's shapes (JAX:
    conv_fused.py:305-312)."""
    return (
        len(layers) >= 2
        and tuple(layers[0][0].shape) == (K0, 1, C)
        and tuple(layers[1][0].shape) == (K1, C, C)
    )


def out_len(n: int) -> int:
    """conv1 outputs for n samples."""
    n0 = (n + 2 * P0 - K0) // S0 + 1
    return (n0 + 2 * P1 - K1) // S1 + 1


def reference_unfused(layers: Sequence[LayerWeights], x: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, n) samples -> (R, n1, C), the plain stack's first
    two layers."""
    return reference_stack(layers[:2], x)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_fused")
    fn = lib.vap_conv01
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, flat: Sequence[torch.Tensor]) -> torch.Tensor:
    R, n = x.shape
    n1 = out_len(n)
    if not 0 < R <= 65535 or n1 < 1:
        raise ValueError(f"fused_conv01: unsupported input of {R} rows x {n} samples")
    _build.check_cuda_tensor(x, "fused_conv01 x", x.dtype)
    names = ("w0", "b0", "norm0 w", "norm0 b", "w1", "b1", "norm1 w", "norm1 b")
    for t, what in zip(flat, names):
        _build.check_cuda_tensor(t, f"fused_conv01 {what}", x.dtype)
    out = torch.empty(R, n1, C, dtype=x.dtype, device=x.device)
    rc = _lib().vap_conv01(
        x.data_ptr(), *(t.data_ptr() for t in flat), out.data_ptr(), R, n, n1,
        _build.dtype_code(x.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "fused_conv01")
    fused_conv01.launches += 1
    return out


class _FusedConv01(torch.autograd.Function):
    """The kernel forward; the backward recomputes ``reference_unfused``
    under autograd on the saved inputs (JAX ``_vjp_bwd``). Takes x and the
    two layers' eight weights flat."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return _launch(x, flat)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, flat = leaves[0], leaves[1:]
            layers = [tuple(flat[:4]), tuple(flat[4:])]
            return torch.autograd.grad(reference_unfused(layers, x), leaves, g)


def fused_conv01(layers: Sequence[LayerWeights], x: torch.Tensor) -> torch.Tensor:
    """x: (R, n) samples -> (R, n1, 256) features after conv1, from the first
    two of ``layers``. Differentiable in x and the eight weights on either
    device."""
    if not fused_conv01_supported(layers):
        raise ValueError("fused_conv01: conv0 must be (10, 1, 256) and conv1 (8, 256, 256)")
    if x.ndim != 2:
        raise ValueError(f"expected (rows, samples), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return reference_unfused(layers, x)
    if not x.is_cuda:
        raise ValueError(f"fused_conv01: unsupported device {x.device}")
    return _FusedConv01.apply(x, *layers[0], *layers[1])


fused_conv01.launches = 0

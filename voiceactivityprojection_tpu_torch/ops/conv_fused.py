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

The route is by dtype alone (``route``), as ``ops/gru_cluster.py``'s:

- bfloat16: ``csrc/conv01_wgmma.cuh`` ``conv01_wgmma_kernel``. One CTA per
  (row, 128 conv1 outputs) computes the 516 conv0 positions those read on
  the tensor cores (``wgmma`` with the 10 taps padded to 16 by zero rows of
  w0): first their ChannelNorm statistics, then, for each 64-channel group
  of conv1's contraction, that group's conv0 channels, normalised and
  stored in bf16, polyphase, in shared memory, from where ``ldmatrix``
  loads conv1's A operand into registers; conv1 is a (128 x 2048) x
  (2048 x 256) ``wgmma`` product with W1 streamed by TMA into a 7-stage
  mbarrier ring; ChannelNorm + ReLU in the epilogue. Each CTA loads all of
  W1 (no thread-block cluster: multicasting W1 to 2 or 4 CTAs was slower on
  the H100).
- float32: ``csrc/conv01_tf32x3.cuh`` ``conv01_tf32x3_kernel``, the same
  tile of 128 conv1 outputs: conv0 in exact f32 FFMA (its statistics over
  all 256 channels first, then one group of 32 input channels at a time,
  normalised, into polyphase planes in shared memory: the 516 positions x
  256 channels of f32 would be 528 KB), conv1 in 3xTF32 on ``wgmma`` (A
  read from the planes and split into tf32 hi and lo in registers, B W1's
  hi and lo halves pre-split K-major by K1's ``split_tf32_kmajor_kernel``,
  one launch a call counted as ``"split tf32"``, on a two-stage cp.async
  ring). Its accumulation truncates as K1's conv1 does: a third to a half
  of the float32 bar of 1e-4 (emulated in ``tests/test_torch_conv_tf32x3.py``).

A launch the kernel refuses raises; nothing falls back to the other kernel
or to the plain version. conv0's (R, n0, 256) output (4.2 GB in bf16 at
R=128 x 20 s) never reaches device memory, where K1
(``ops/conv_stack_fused.py``) writes it and reads it back.

Bound on the card: operations (conv1's 2048-deep contraction; about 1,000
FLOP per byte of samples read and features written).

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

from voiceactivityprojection_tpu_torch.ops import _build, conv_stack_fused
from voiceactivityprojection_tpu_torch.ops.conv_stack_fused import LayerWeights, reference_stack

K0, S0, P0 = 10, 5, 3
K1, S1, P1 = 8, 4, 2
C = 256
# the kernel of each dtype (``route``), and the float32 route's W1 split
_build.declare_kernels("conv01", ("wgmma bfloat16", "wgmma 3xtf32"), ("split tf32",))

# the bfloat16 kernel (csrc/conv01_wgmma.cuh, csrc/conv_fused.cu)
TILE = 128         # conv1 outputs a CTA
STAGES = 7         # W1 ring stages
STAGE_ROWS = 32    # W1 rows a stage
TAPS0 = 16         # conv0's taps padded to one k-step
SAMPLE_BUF = 2592  # samples a CTA keeps (2,585 read, zeros after)
MAX_SMEM = 232_448  # H100: a CTA's shared memory

# the float32 kernel (csrc/conv01_tf32x3.cuh)
F32_GROUP = 32         # input channels of conv0 a group in shared memory
F32_STAGES = 2         # W1 ring stages (a tap x 32 input channels, hi and lo)
F32_SAMPLE_BUF = 2588  # samples a CTA keeps (2,585 read, zeros after)

DESIGN = {
    "bfloat16": "wgmma: conv0 (taps padded to 16) and conv1 on the tensor cores; conv0's statistics and "
                "channels 0-63, then per 64-channel group conv0 recomputed into polyphase planes in shared "
                f"memory, read by ldmatrix as conv1's A; W1 by TMA into a {STAGES}-stage mbarrier ring "
                f"(no cluster: each CTA loads all of W1); {TILE} conv1 outputs a CTA of 256 threads "
                "(csrc/conv01_wgmma.cuh)",
    "float32": "wgmma 3xTF32: conv0 in f32 FFMA (statistics over 256 channels, then per 32-channel group "
               "recomputed into polyphase f32 planes in shared memory), conv1 on the tensor cores in 3xTF32 (A "
               "from the planes split into tf32 hi and lo in registers, B W1's pre-split hi and lo, K-major, "
               f"on a {F32_STAGES}-stage cp.async ring); {TILE} conv1 outputs a CTA of 256 threads "
               "(csrc/conv01_tf32x3.cuh)",
}


def route(dtype: torch.dtype) -> str:
    """The kernel a launch of ``dtype`` takes: "wgmma bfloat16" or "wgmma
    3xtf32" (float32)."""
    if dtype == torch.bfloat16:
        return "wgmma bfloat16"
    if dtype == torch.float32:
        return "wgmma 3xtf32"
    raise ValueError(f"fused_conv01: takes float32 or bfloat16, got {dtype}")


def conv0_positions() -> int:
    """conv0 positions the TILE conv1 outputs of a CTA read: 516."""
    return S1 * (TILE - 1) + K1


def smem_regions() -> dict:
    """Dynamic shared bytes of one bfloat16 CTA by region, as
    ``conv01_wgmma.cuh`` lays them out."""
    conv0_tiles = -(-conv0_positions() // 64)
    return {
        "w1_ring": STAGES * STAGE_ROWS * C * 2,          # stages of 32 x 256 bf16
        "w0_padded": TAPS0 * C * 2,                      # 16 taps x 256, bf16
        "conv0_im2col": conv0_tiles * 64 * TAPS0 * 2,    # 9 tiles of 64 positions x 16 taps
        "conv0_planes": conv0_positions() * 64 * 2,      # 516 positions x one 64-channel group, bf16
        "samples": SAMPLE_BUF * 2,
        "norm_params": 6 * C * 4,                        # bias, gamma, beta of both layers, f32
        "conv0_stats": conv0_tiles * 64 * 8,             # (mean, inv) a position, f32
        "mbarriers": STAGES * (8 + 4),                   # a full barrier and a release count a stage
        "alignment_slack": 1024,
    }


def smem_bytes() -> int:
    return sum(smem_regions().values())


def f32_smem_regions() -> dict:
    """Dynamic shared bytes of one float32 CTA by region, as
    ``conv01_tf32x3.cuh`` lays them out."""
    return {
        "w1_ring": F32_STAGES * 2 * C * F32_GROUP * 4,           # stages of 256 x 32 f32, hi and lo
        "conv0_planes": conv0_positions() * F32_GROUP * 4,     # 516 positions x one 32-channel group, f32
        "samples": F32_SAMPLE_BUF * 4,
        "conv0_stats": conv0_positions() * 8,                  # (mean, 1 / std) a position, f32
        "alignment_slack": 1024,
    }


def f32_smem_bytes() -> int:
    return sum(f32_smem_regions().values())


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


_NAMES = ("w0", "b0", "norm0 w", "norm0 b", "w1", "b1", "norm1 w", "norm1 b")


def _checked(x: torch.Tensor, flat: Sequence[torch.Tensor]) -> torch.Tensor:
    """Checks the launch's inputs and returns its output buffer."""
    R, n = x.shape
    n1 = out_len(n)
    if not 0 < R <= 65535 or n1 < 1:
        raise ValueError(f"fused_conv01: unsupported input of {R} rows x {n} samples")
    route(x.dtype)
    _build.check_cuda_tensor(x, "fused_conv01 x", x.dtype)
    for t, what in zip(flat, _NAMES):
        _build.check_cuda_tensor(t, f"fused_conv01 {what}", x.dtype)
    if x.dtype == torch.bfloat16:  # TMA reads w1, 16-byte loads w0
        _build.check_aligned(flat[0], "fused_conv01 w0")
        _build.check_aligned(flat[4], "fused_conv01 w1")
    return torch.empty(R, n1, C, dtype=x.dtype, device=x.device)


def _split_w1(w1: torch.Tensor) -> torch.Tensor:
    """W1's tf32 hi and lo halves, K-major (2, 8, 256 out, 256 in), by K1's
    split kernel (``csrc/conv_stack.cu`` ``vap_conv_split_tf32``)."""
    w_split = torch.empty(2, K1, C, C, dtype=torch.float32, device=w1.device)
    rc = conv_stack_fused._lib().vap_conv_split_tf32(w1.data_ptr(), w_split.data_ptr(), K1,
                                                     _build.stream_handle(w1))
    _build.check_launch(rc, "conv01", "split tf32")
    return w_split


def _launch(x: torch.Tensor, flat: Sequence[torch.Tensor]) -> torch.Tensor:
    out = _checked(x, flat)
    R, n = x.shape
    kernel = route(x.dtype)
    w1 = _split_w1(flat[4]) if x.dtype == torch.float32 else flat[4]
    ptrs = [t.data_ptr() for t in flat]
    ptrs[4] = w1.data_ptr()
    rc = _lib().vap_conv01(
        x.data_ptr(), *ptrs, out.data_ptr(), R, n, out.shape[1],
        _build.dtype_code(x.dtype), _build.stream_handle(x),
    )
    _build.check_launch(rc, "conv01", kernel)
    return out


def kernel_launches() -> dict:
    """The launches the library has taken by kernel since it was loaded (its
    own host-side counts): which route ran."""
    fn = _lib().vap_conv01_kernel_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    fn.restype = None
    bf16, f32 = ctypes.c_longlong(0), ctypes.c_longlong(0)
    fn(ctypes.byref(bf16), ctypes.byref(f32))
    return {"wgmma bfloat16": bf16.value, "wgmma 3xtf32": f32.value}


def kernel_info(dtype: torch.dtype) -> dict:
    """The kernel of ``dtype``'s own figures from the built library: shared
    bytes a CTA, conv1 outputs a CTA."""
    fn = getattr(_lib(), "vap_conv01_wgmma_info" if dtype == torch.bfloat16 else "vap_conv01_tf32x3_info")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, tile = ctypes.c_int(0), ctypes.c_int(0)
    fn(ctypes.byref(smem), ctypes.byref(tile))
    return {"smem": smem.value, "tile": tile.value}


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


"""The CPC conv stack (five convs, each with ChannelNorm + ReLU) on the card.

Replaces the TPU kernel ``_kernel`` of
``voiceactivityprojection_tpu/ops/conv_stack_fused.py`` (entry point
``fused_conv_stack``, :457): five Conv1d layers k=10,8,4,4,4 /
s=5,4,2,2,2 / symmetric pad 3,2,1,1,1 on raw samples, each followed by
ChannelNorm (unbiased variance, eps 1e-5) and ReLU. (R, n) samples ->
(R, n/160, 256) features.

CUDA kernels: ``csrc/conv_stack.cu``, launched once per layer. Each
launch is an implicit GEMM (im2col computed on the fly from the
feature-last input, never stored) of a tile of positions x all 256
channels with the conv bias, ChannelNorm and ReLU applied to the f32
accumulators before the one write of the tile. conv1-conv4 (Cin = 256) run
on the tensor cores (``wgmma``, ``csrc/wgmma.cuh``): in bfloat16
``conv_cn_relu_wgmma_kernel`` (the weights read in place as the MN-major
operand, x's rows and w's tiles through a two-stage ``cp.async`` ring); in
float32 ``conv_cn_relu_tf32x3_kernel``, 3xTF32 (x and w split into tf32
hi and lo halves, x_hi w_hi + x_hi w_lo + x_lo w_hi in the f32
accumulators: one-pass TF32 would break the float32 bar; the tensor cores'
truncating accumulation leaves the stack 4.4-4.9e-5 from its plain
version, about half of the 1e-4 bar), 128 positions a block, after
``split_tf32_kmajor_kernel`` has written w's hi and lo as K-major copies
(tf32 ``wgmma`` reads its operands K-major only): two launches a layer,
the split counted as ``"split tf32"``. conv0 (Cin = 1, a 10-deep contraction)
runs ``conv_cn_relu_kernel`` on the CUDA cores in both dtypes.
The launch ledger (``ops/_build.py``) counts each kernel's launches
under ``"conv_stack"``.

Bound on the card: operations (conv1's 2048-deep contraction holds most of
the stack's 48.9 GFLOP per stereo 20 s chunk). What the stack leaves in
device memory is each layer's output, read once by the next layer
(conv0's (R, n/5, 256) output is the largest: 4.2 GB in bf16 at R=128,
n=320000); keeping conv0 on chip, as K11 and the TPU kernel do, is the
next step. In float32 each product is three TF32 ones: 3 x 3.13 TFLOP a
B = 64 request over 495 TFLOP/s is 19 ms, under the 46.7 ms that the f32
FFMA rate (67 TFLOP/s) allows the CUDA-core kernel.

``reference_stack`` is the plain PyTorch version (counterpart of
``_reference_stack``, conv_stack_fused.py:444); the wrapper takes it only
for CPU tensors. On the card the wrapper is an autograd function whose
backward runs autograd through ``reference_stack`` on the saved inputs, as
the JAX custom VJP does (``_vjp_bwd``, conv_stack_fused.py:467-470). The
model's trained encoder does not take it: it runs the plain stack, as the
JAX encoder does when ``fused_auto`` is off.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, conv1d

# (kernel, stride, pad) per conv layer, fixed by the pretrained CPC
# architecture (JAX: models/encoder.py:46-52)
CPC_CONV_SPECS: Tuple[Tuple[int, int, int], ...] = (
    (10, 5, 3),
    (8, 4, 2),
    (4, 2, 1),
    (4, 2, 1),
    (4, 2, 1),
)
COUT = 256  # the kernel's tile holds every output channel of a position
# a layer's kernels (``kernel_for``), and the split of w before each 3xTF32 launch
_build.declare_kernels("conv_stack", ("cuda cores", "wgmma bfloat16", "wgmma 3xtf32"), ("split tf32",))

# per layer: conv w (K, Cin, Cout), conv b (Cout,), norm w (Cout,), norm b (Cout,)
LayerWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _out_len(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def plain_layers(
    layers: Sequence[LayerWeights], z: torch.Tensor, specs: Sequence[Tuple[int, int, int]]
) -> torch.Tensor:
    """conv + ChannelNorm + ReLU for each layer and its (kernel, stride, pad)
    spec, plain PyTorch: (R, n, Cin) -> (R, n', C)."""
    for (w, b, nw, nb), (_, s, p) in zip(layers, specs):
        z = conv1d(z, w, b, stride=s, padding=(p, p))
        z = torch.relu(channel_norm(z, nw, nb))
    return z


def reference_stack(layers: Sequence[LayerWeights], x: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, n) samples -> (R, n4, C) features; with fewer
    layers, the stack's prefix."""
    return plain_layers(layers, x[..., None], CPC_CONV_SPECS)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_stack")
    fn = lib.vap_conv_cn_relu
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.vap_conv_split_tf32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.vap_conv_cn_relu_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kernel_for(dtype: torch.dtype, c_in: int) -> str:
    """The kernel a layer takes on the card, by dtype and input channels."""
    if c_in != COUT:
        return "cuda cores"
    return "wgmma bfloat16" if dtype == torch.bfloat16 else "wgmma 3xtf32"


def conv_cn_relu(
    x: torch.Tensor, layer: LayerWeights, stride: int, pad: int
) -> torch.Tensor:
    """One launch: conv + ChannelNorm + ReLU. x: (R, n) for conv0 or
    (R, n, Cin); returns (R, n_out, 256) in x's dtype."""
    w, b, nw, nb = layer
    k, c_in, c_out = w.shape
    R, n_in = x.shape[:2]
    x_cin = 1 if x.ndim == 2 else x.shape[2]
    if c_out != COUT or x_cin != c_in:
        raise ValueError(
            f"conv_cn_relu: takes Cout={COUT} and input channels == w's Cin; "
            f"got w {tuple(w.shape)} for input {tuple(x.shape)}"
        )
    if not 0 < R <= 65535:
        raise ValueError(f"conv_cn_relu: rows must be in 1..65535, got {R}")
    for t, what in ((x, "x"), (w, "w"), (b, "b"), (nw, "norm w"), (nb, "norm b")):
        _build.check_cuda_tensor(t, f"conv_cn_relu {what}", x.dtype)
    kernel = kernel_for(x.dtype, c_in)
    if kernel != "cuda cores":  # the tensor-core kernels copy 16-byte pieces
        for t, what in ((x, "x"), (w, "w")):
            _build.check_aligned(t, f"conv_cn_relu {what}")
    n_out = _out_len(n_in, k, stride, pad)
    if n_out <= 0:
        raise ValueError(f"conv_cn_relu: input of {n_in} frames is shorter than the kernel")
    out = torch.empty(R, n_out, c_out, dtype=x.dtype, device=x.device)
    if kernel == "wgmma 3xtf32":
        # w's tf32 hi and lo halves, K-major (tap, out, in), for this call
        w_split = torch.empty(2, k, c_out, c_in, dtype=torch.float32, device=x.device)
        rc = _lib().vap_conv_split_tf32(w.data_ptr(), w_split.data_ptr(), k, _build.stream_handle(w))
        _build.check_launch(rc, "conv_stack", "split tf32")
        rc = _lib().vap_conv_cn_relu_tf32x3(
            x.data_ptr(), w_split.data_ptr(), b.data_ptr(), nw.data_ptr(), nb.data_ptr(),
            out.data_ptr(), R, n_in, n_out, k, stride, pad, _build.stream_handle(x),
        )
    else:
        rc = _lib().vap_conv_cn_relu(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), nw.data_ptr(), nb.data_ptr(),
            out.data_ptr(), R, n_in, n_out, c_in, k, stride, pad,
            _build.dtype_code(x.dtype), _build.stream_handle(x),
        )
    _build.check_launch(rc, "conv_stack", kernel)
    return out


class _FusedConvStack(torch.autograd.Function):
    """The kernel launches forward; the backward recomputes the plain stack
    under autograd on the saved inputs (JAX ``_vjp_bwd``,
    conv_stack_fused.py:467-470). Takes x and the 20 weights flat."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        z = x
        for i, (_, s, p) in enumerate(CPC_CONV_SPECS):
            z = conv_cn_relu(z, tuple(flat[4 * i:4 * i + 4]), s, p)
        return z

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, flat = leaves[0], leaves[1:]
            layers = [tuple(flat[4 * i:4 * i + 4]) for i in range(len(CPC_CONV_SPECS))]
            return torch.autograd.grad(reference_stack(layers, x), leaves, g)


def fused_conv_stack(layers: Sequence[LayerWeights], x: torch.Tensor) -> torch.Tensor:
    """x: (R, n) samples -> (R, n/160, 256) features (100 Hz).
    Differentiable in x and every weight on either device."""
    if len(layers) != len(CPC_CONV_SPECS):
        raise ValueError(f"expected {len(CPC_CONV_SPECS)} conv layers, got {len(layers)}")
    if x.ndim != 2:
        raise ValueError(f"expected (rows, samples), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return reference_stack(layers, x)
    if not x.is_cuda:
        raise ValueError(f"fused_conv_stack: unsupported device {x.device}")
    return _FusedConvStack.apply(x, *(t for layer in layers for t in layer))


"""Causal ALiBi attention on the card: one blocked online-softmax kernel.

Replaces two TPU kernels of ``voiceactivityprojection_tpu/ops/flash_alibi.py``
that compute the same function (entry point ``flash_alibi_attention``,
:731): ``_single_block_kernel`` (:122, T <= 1024, with its TPU schedule
variants ``_v2`` .. ``_v5`` and ``_tri``) and ``_flash_kernel`` (:54,
T > 1024). Scores ``q k^T * scale + slope_h * (j - i)`` for j <= i, f32
softmax, the probabilities cast to v's dtype before the value product,
f32 accumulation, output in q's dtype.

CUDA kernel: ``csrc/flash_alibi.cu`` ``flash_alibi_kernel``. One block per
(batch*head, 64-query tile) walks the 64-key tiles up to the diagonal
with the online-softmax recurrence (running max, sum and accumulator in
registers), so no (T, T) array exists; the heaviest (last) query tiles are
scheduled first.

Bound on the card: at T=1000 the roofline sits just on the memory side
(4 x T x Dh elements of I/O per head against 2 x 2 x Dh x T(T+1)/2
operations: 250 FLOP per byte in bf16), but this first version is bound
by its own arithmetic: it multiplies on the CUDA cores in f32 from shared
memory. ``mma``/``wgmma`` tiles are the later step.

``dense_reference`` is the plain PyTorch version (counterpart of
``_dense_reference``, flash_alibi.py:718, with the kernel's precision:
f32 scores, p cast to v's dtype); the wrapper takes it only for CPU
tensors. On the card the wrapper is an autograd function whose backward
recomputes ``dense_reference``, as the JAX custom VJP does. The model does
not take it: ``ops/attention.py`` sends every call that asks for a
gradient to the training kernels (``ops/flash_alibi_train.py``), at rate 0
when dropout is off.
"""

from __future__ import annotations

import ctypes

import torch

from voiceactivityprojection_tpu_torch.ops import _build

HEAD_DIM = 64  # the head width the kernel is instantiated for (256 / 4 heads)


def dense_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain version. q, k, v: (B, H, T, Dh); slopes: (H,)."""
    T = q.shape[2]
    sdt = torch.promote_types(q.dtype, torch.float32)
    s = (q.to(sdt) @ k.to(sdt).transpose(-1, -2)) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    s = s + slopes.to(sdt)[None, :, None, None] * (j - i)
    s = s.masked_fill(j > i, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v.dtype).to(sdt) @ v.to(sdt)
    return (pv / l).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_alibi")
    fn = lib.vap_flash_alibi
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor, scale: float
) -> torch.Tensor:
    B, H, T, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"flash_alibi_attention: head dim must be {HEAD_DIM}, got {Dh}")
    if not 0 < B * H <= 65535 or T < 1:
        raise ValueError(f"flash_alibi_attention: unsupported B*H={B * H}, T={T}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_cuda_tensor(t, f"flash_alibi_attention {what}", q.dtype)
    slopes32 = slopes.to(torch.float32).contiguous()
    _build.check_cuda_tensor(slopes32, "flash_alibi_attention slopes", torch.float32)
    out = torch.empty_like(q)
    rc = _lib().vap_flash_alibi(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes32.data_ptr(), out.data_ptr(),
        B * H, H, T, Dh, float(scale), _build.dtype_code(q.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "flash_alibi_attention")
    flash_alibi_attention.launches += 1
    return out


class _FlashAlibi(torch.autograd.Function):
    """The kernel forward; the backward recomputes ``dense_reference`` under
    autograd, as the JAX ``_bwd`` does (flash_alibi.py:739-742). The slopes
    get no gradient (non-trainable in JAX too)."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, scale):
        ctx.save_for_backward(q, k, v, slopes)
        ctx.scale = scale
        return _launch(q, k, v, slopes, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, slopes = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = dense_reference(*leaves, slopes.detach(), ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_alibi_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor, scale: float
) -> torch.Tensor:
    """q, k, v: (B, H, T, Dh); slopes: (H,) -> (B, H, T, Dh) in q's dtype.
    Differentiable in q, k and v on either device."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_alibi_attention: q, k, v must share one (B, H, T, Dh) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    H = q.shape[1]
    if tuple(slopes.shape) != (H,):
        raise ValueError(f"flash_alibi_attention: slopes must be ({H},), got {tuple(slopes.shape)}")
    if q.device.type == "cpu":
        return dense_reference(q, k, v, slopes, scale)
    return _FlashAlibi.apply(q, k, v, slopes, scale)


flash_alibi_attention.launches = 0

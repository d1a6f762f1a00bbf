"""Causal ALiBi attention on the card: one blocked online-softmax kernel.

Replaces three TPU kernels of ``voiceactivityprojection_tpu/ops/flash_alibi.py``
that compute the same function: ``_single_block_kernel`` (:122, T <= 1024,
with its TPU schedule variants ``_v2`` .. ``_v5`` and ``_tri``) and
``_flash_kernel`` (:54, T > 1024) behind ``flash_alibi_attention`` (:731),
and ``_flash_offset_kernel`` (:590) behind ``flash_alibi_attention_offset``
(:660), where the Tq query rows sit at a global offset ``off`` of a longer
Tk-key timeline (context parallelism, ``parallel/context.py``). Scores
``q k^T * scale + slope_h * (j - (off + i))`` for j <= off + i, f32
softmax, the probabilities cast to v's dtype before the value product,
f32 accumulation, output in q's dtype.

CUDA kernel: ``csrc/flash_alibi.cu`` ``flash_alibi_kernel``, one kernel
for both entry points (``off = 0``, Tq = Tk for the first). One block per
(batch*head, 64-query tile) walks the 64-key tiles up to the one that holds
the tile's last query row, in global row indices, with the online-softmax
recurrence (running max, sum and accumulator in registers), so no (Tq, Tk)
array exists; the heaviest (last) query tiles are scheduled first.

Bound on the card: at T=1000 the roofline sits just on the memory side
(4 x T x Dh elements of I/O per head against 2 x 2 x Dh x T(T+1)/2
operations: 250 FLOP per byte in bf16), and a context-parallel shard of
long audio (7500 query rows over 30000 keys) is far on the operations
side; this first version is bound by its own arithmetic: it multiplies on
the CUDA cores in f32 from shared memory. ``mma``/``wgmma`` tiles are the
later step.

``dense_reference`` and ``dense_offset_reference`` are the plain PyTorch
versions (counterparts of ``_dense_reference``, flash_alibi.py:718, and of
the dense branch of ``parallel/context.py`` ``_attn_ctx``, with the
kernel's precision: f32 scores, p cast to v's dtype); the wrappers take
them only for CPU tensors. On the card ``flash_alibi_attention`` is an
autograd function whose backward recomputes ``dense_reference``, as the JAX
custom VJP does. The model does not take it: ``ops/attention.py`` sends
every call that asks for a gradient to the training kernels
(``ops/flash_alibi_train.py``), at rate 0 when dropout is off.
``flash_alibi_attention_offset`` is inference only, as JAX's is (no VJP):
on a CUDA input that requires grad, with grad enabled, it raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from voiceactivityprojection_tpu_torch.ops import _build

HEAD_DIM = 64  # the head width the kernel is instantiated for (256 / 4 heads)


def dense_offset_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    scale: float,
    q_offset: int,
) -> torch.Tensor:
    """Plain version of the offset kernel. q: (B, H, Tq, Dh) at global rows
    ``q_offset ..``; k, v: (B, H, Tk, Dh); slopes: (H,)."""
    sdt = torch.promote_types(q.dtype, torch.float32)
    s = (q.to(sdt) @ k.to(sdt).transpose(-1, -2)) * scale
    i = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s + slopes.to(sdt)[None, :, None, None] * (j - i)
    s = s.masked_fill(j > i, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v.dtype).to(sdt) @ v.to(sdt)
    return (pv / l).to(q.dtype)


def dense_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain version. q, k, v: (B, H, T, Dh); slopes: (H,)."""
    return dense_offset_reference(q, k, v, slopes, scale, 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_alibi")
    fn = lib.vap_flash_alibi
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.vap_flash_alibi_offset
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    scale: float,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """K4's entry without ``q_offset``, K10's with it."""
    what = "flash_alibi_attention" if q_offset is None else "flash_alibi_attention_offset"
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    if Dh != HEAD_DIM:
        raise ValueError(f"{what}: head dim must be {HEAD_DIM}, got {Dh}")
    if not 0 < B * H <= 65535 or Tq < 1:
        raise ValueError(f"{what}: unsupported B*H={B * H}, T={Tq}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_cuda_tensor(t, f"{what} {name}", q.dtype)
    slopes32 = slopes.to(torch.float32).contiguous()
    _build.check_cuda_tensor(slopes32, f"{what} slopes", torch.float32)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes32.data_ptr(), out.data_ptr())
    tail = (float(scale), _build.dtype_code(q.dtype), _build.stream_handle())
    if q_offset is None:
        rc = _lib().vap_flash_alibi(*ptrs, B * H, H, Tq, Dh, *tail)
        _build.check_launch(rc, what)
        flash_alibi_attention.launches += 1
    else:
        rc = _lib().vap_flash_alibi_offset(*ptrs, B * H, H, Tq, Tk, q_offset, Dh, *tail)
        _build.check_launch(rc, what)
        flash_alibi_attention_offset.launches += 1
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


def flash_alibi_attention_offset(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    scale: float,
    q_offset: int,
) -> torch.Tensor:
    """q: (B, H, Tq, Dh) query rows at global rows ``q_offset ..`` of the
    (B, H, Tk, Dh) key/value timeline; slopes: (H,) -> (B, H, Tq, Dh) in q's
    dtype. Causal and ALiBi in global indices. Needs ``0 <= q_offset`` and
    ``q_offset + Tq <= Tk`` (the JAX kernel gives rows past Tk zero-padded
    keys instead). Inference only."""
    same_bhd = q.ndim == k.ndim == 4 and k.shape[:2] == q.shape[:2] and k.shape[3] == q.shape[3]
    if not same_bhd or v.shape != k.shape:
        raise ValueError(
            f"flash_alibi_attention_offset: q must be (B, H, Tq, Dh) and k, v one (B, H, Tk, Dh), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    H, Tq = q.shape[1], q.shape[2]
    if tuple(slopes.shape) != (H,):
        raise ValueError(f"flash_alibi_attention_offset: slopes must be ({H},), got {tuple(slopes.shape)}")
    q_offset = int(q_offset)
    Tk = k.shape[2]
    if q_offset < 0 or q_offset + Tq > Tk:
        raise ValueError(
            f"flash_alibi_attention_offset: query rows [{q_offset}, {q_offset + Tq}) must lie in "
            f"the {Tk} keys"
        )
    if q.device.type == "cpu":
        return dense_offset_reference(q, k, v, slopes, scale, q_offset)
    if _build.grad_requested(q, k, v):
        raise RuntimeError(
            "flash_alibi_attention_offset: the kernel has no backward (nor has the JAX "
            "kernel): context-parallel attention is inference only"
        )
    return _launch(q, k, v, slopes, scale, q_offset)


flash_alibi_attention.launches = 0
flash_alibi_attention_offset.launches = 0

"""Causal ALiBi attention with in-kernel attention dropout, for training:
a flash forward that keeps the per-row logsumexp and a flash backward that
recomputes the scores.

Counterpart of ``voiceactivityprojection_tpu/ops/flash_alibi_train.py``.
Replaces its three TPU kernels, which compute two functions:

* ``_fwd_kernel`` (:122, entry ``_flash_train_forward`` :184): scores
  ``q k^T * scale + slope_h * (j - i)`` for j <= i, the online softmax with
  the denominator ``l`` summed over every visible key, then the keep mask
  applied to the unnormalised p, p cast to v's dtype before ``p v``, the
  output ``acc / (1 - rate) / l`` and ``lse = m + log l`` (f32);
* ``_bwd_fused_kernel`` (:366, one block pair) and ``_bwd_dq_kernel`` (:242)
  + ``_bwd_dkv_kernel`` (:297, split): dQ, dK, dV from the identities
  (W = softmax(S), Y = mask . W / (1 - rate), out = Y V)

      dV = Y^T dO;  dP = dO V^T;  dW = mask . dP / (1 - rate)
      dS = W . (dW - delta), delta = rowsum(dO . out)
      dQ = scale . dS K;  dK = scale . dS^T Q

  with Y rounded to dO's dtype before dV and dS to k's / q's dtype before
  dQ / dK, f32 sums, outputs in the input dtype. The fused and the split
  kernels are two TPU schedules of one function; one CUDA backward serves
  both.

The keep mask is the lowbias32 hash of the global (batch*head, query, key)
coordinates and a per-call int32 seed, kept where ``hash >= rate * 2^32``
(``hash_keep``, ``rate_threshold``): a coordinate hash, so the mask is the
same bit for bit in the JAX package, the CUDA kernels and the plain
versions here, and the backward regenerates it under any blocking.

CUDA kernels: ``csrc/flash_alibi_train.cu``. ``flash_train_fwd_kernel`` is
the inference kernel's (``csrc/flash_alibi.cu``) blocked online softmax plus
the mask and ``lse``. The backward is FlashAttention-2 style in two kernels
with no atomics, so it is deterministic: ``flash_train_dkv_kernel``, one
block per (batch*head, 64-key tile) walking the query tiles from the
diagonal down, and ``flash_train_dq_kernel``, one block per (batch*head,
64-query tile) walking the key tiles up to the diagonal. ``delta`` is a
PyTorch reduction outside the kernels, as in the JAX package (:439-441).

Bound on the card: at T=1000 the work sits near the ridge (4 x T x Dh
inputs against 2 x 2 x Dh x T(T+1)/2 products per head and pass), but
these first versions multiply on the CUDA cores in f32 from shared memory,
so they are bound by their own arithmetic. Tensor-core tiles come later.

``train_forward_reference`` and ``train_backward_reference`` are the plain
versions, with the kernels' precision; the wrappers take them only for CPU
tensors. ``flash_alibi_attention_train`` is the autograd function around
the pair (JAX: the custom VJP at :572).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.flash_alibi import HEAD_DIM

_M32 = 0xFFFFFFFF


def rate_threshold(rate: float) -> int:
    """uint32 threshold with P(hash < threshold) = rate (JAX :102)."""
    return min(int(round(rate * 2.0**32)), 2**32 - 1)


def hash_keep(bh, q, k, seed, threshold: int) -> torch.Tensor:
    """lowbias32 hash of the coordinates -> keep mask (JAX ``_hash_keep`` :81).

    ``bh``, ``q``, ``k``: integer tensors (broadcast together) or ints;
    ``seed`` an int. The uint32 arithmetic runs in int64, masked to the low
    32 bits after every multiply and add (int64 products wrap mod 2^64, so
    the low 32 bits stay right), and shifts only masked, non-negative
    values."""
    as64 = lambda t: torch.as_tensor(t, dtype=torch.int64)
    x = (as64(bh) * 0x9E3779B1) & _M32
    x = (x + ((as64(q) * 0x85EBCA6B) & _M32)) & _M32
    x = (x + ((as64(k) * 0xC2B2AE35) & _M32)) & _M32
    x = (x + (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x >= threshold


def dropout_mask_reference(seed: int, bh_index: int, T: int, rate: float) -> torch.Tensor:
    """(T, T) keep mask of one batch*head slice (JAX :107)."""
    i = torch.arange(T)
    return hash_keep(bh_index, i[:, None], i[None, :], seed, rate_threshold(rate))


def keep_mask(B: int, H: int, T: int, seed: int, rate: float, device=None) -> torch.Tensor:
    """(B, H, T, T) keep mask; batch*head index b * H + h, as the kernels
    flatten (B, H)."""
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    i = torch.arange(T, device=device)
    return hash_keep(bh, i[:, None], i[None, :], seed, rate_threshold(rate))


def _scores(q, k, slopes, scale) -> torch.Tensor:
    """f32 (at least) scores with the ALiBi bias, -inf above the diagonal."""
    T = q.shape[2]
    sdt = torch.promote_types(q.dtype, torch.float32)
    s = (q.to(sdt) @ k.to(sdt).transpose(-1, -2)) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    s = s + slopes.to(sdt)[None, :, None, None] * (j - i)
    return s.masked_fill(j > i, float("-inf"))


def train_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor,
    seed: int, scale: float, rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (out (B, H, T, Dh) in q's dtype, lse (B*H, T) f32)."""
    B, H, T, _ = q.shape
    s = _scores(q, k, slopes, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = torch.where(keep_mask(B, H, T, seed, rate, q.device), p, 0.0)
    pv = p.to(v.dtype).to(s.dtype) @ v.to(s.dtype)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    out = (pv * inv / l).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B * H, T)


def train_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, slopes: torch.Tensor,
    seed: int, scale: float, rate: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward from ``lse`` and ``delta`` (both (B*H, T) f32) ->
    (dq, dk, dv) in the inputs' dtypes."""
    B, H, T, _ = q.shape
    s = _scores(q, k, slopes, scale)
    f = lambda t: t.to(s.dtype)
    w = torch.exp(s - lse.reshape(B, H, T, 1))
    dp = f(do) @ f(v).transpose(-1, -2)
    if rate > 0.0:
        keep = keep_mask(B, H, T, seed, rate, q.device)
        inv = 1.0 / (1.0 - rate)
        y = torch.where(keep, w * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        y = w
    dv = f(y.to(do.dtype)).transpose(-1, -2) @ f(do)
    ds = w * (dp - delta.reshape(B, H, T, 1))
    dq = scale * (f(ds.to(k.dtype)) @ f(k))
    dk = scale * (f(ds.to(q.dtype)).transpose(-1, -2) @ f(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dropout_args(seed: int, rate: float) -> Tuple[int, int, float, int]:
    """The kernels' dropout arguments: threshold, seed (as uint32), the
    output scale 1 / (1 - rate), and whether the mask is on."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    on = rate > 0.0
    return rate_threshold(rate), int(seed) & _M32, 1.0 / (1.0 - rate) if on else 1.0, int(on)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_alibi_train")
    common = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.vap_flash_train_fwd.argtypes = [ctypes.c_void_p] * 6 + common
    lib.vap_flash_train_bwd.argtypes = [ctypes.c_void_p] * 10 + common
    lib.vap_flash_train_fwd.restype = ctypes.c_int
    lib.vap_flash_train_bwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, slopes, what) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{what}: q, k, v must share one (B, H, T, Dh) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if tuple(slopes.shape) != (q.shape[1],):
        raise ValueError(f"{what}: slopes must be ({q.shape[1]},), got {tuple(slopes.shape)}")


def _check_cuda(what, q, tensors) -> None:
    B, H, T, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"{what}: head dim must be {HEAD_DIM}, got {Dh}")
    if not 0 < B * H <= 65535 or T < 1:
        raise ValueError(f"{what}: unsupported B*H={B * H}, T={T}")
    for name, t, dtype in tensors:
        _build.check_cuda_tensor(t, f"{what} {name}", dtype)


def flash_train_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor,
    seed: int, scale: float, rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (B, H, T, Dh) -> (out (B, H, T, Dh), lse (B*H, T) f32)."""
    _check(q, k, v, slopes, "flash_train_forward")
    if q.device.type == "cpu":
        return train_forward_reference(q, k, v, slopes, seed, scale, rate)
    slopes32 = slopes.detach().to(torch.float32).contiguous()
    _check_cuda("flash_train_forward", q, [("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype),
                                           ("slopes", slopes32, torch.float32)])
    drop = _dropout_args(seed, rate)
    B, H, T, Dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, T, dtype=torch.float32, device=q.device)
    rc = _lib().vap_flash_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes32.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B * H, H, T, Dh, float(scale), *drop, _build.dtype_code(q.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "flash_train_forward")
    flash_train_forward.launches += 1
    return out, lse


def flash_train_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor, seed: int,
    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, scale: float, rate: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``out`` = the forward's output at cotangent ``do`` ->
    (dq, dk, dv). One call launches the dK/dV and the dQ kernel."""
    _check(q, k, v, slopes, "flash_train_backward")
    B, H, T, Dh = q.shape
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B * H, T):
        raise ValueError("flash_train_backward: out and do must match q, lse must be (B*H, T)")
    sdt = torch.promote_types(q.dtype, torch.float32)
    delta = (do.to(sdt) * out.to(sdt)).sum(-1).reshape(B * H, T)
    if q.device.type == "cpu":
        return train_backward_reference(q, k, v, do, lse, delta, slopes, seed, scale, rate)
    slopes32 = slopes.detach().to(torch.float32).contiguous()
    do = do.contiguous()
    _check_cuda("flash_train_backward", q, [
        ("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype), ("do", do, q.dtype),
        ("lse", lse, torch.float32), ("slopes", slopes32, torch.float32),
    ])
    drop = _dropout_args(seed, rate)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _lib().vap_flash_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        slopes32.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, H, T, Dh, float(scale), *drop, _build.dtype_code(q.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "flash_train_backward")
    flash_train_backward.launches += 1
    return dq, dk, dv


flash_train_forward.launches = 0
flash_train_backward.launches = 0


class _FlashAlibiTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, slopes, seed, scale, rate):
        out, lse = flash_train_forward(q, k, v, slopes, seed, scale, rate)
        ctx.save_for_backward(q, k, v, slopes, out, lse)
        ctx.args = (seed, scale, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, slopes, out, lse = ctx.saved_tensors
        seed, scale, rate = ctx.args
        dq, dk, dv = flash_train_backward(q, k, v, slopes, seed, out, lse, g, scale, rate)
        return dq, dk, dv, None, None, None, None


def flash_alibi_attention_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor,
    seed: int, scale: float, rate: float,
) -> torch.Tensor:
    """Causal ALiBi attention with attention dropout at ``rate`` from the
    per-call ``seed`` (an int in [0, 2^31 - 1)). q, k, v: (B, H, T, Dh);
    slopes (H,) get no gradient. The kernels on CUDA tensors, the plain
    pair on CPU tensors."""
    return _FlashAlibiTrain.apply(q, k, v, slopes, seed, scale, rate)

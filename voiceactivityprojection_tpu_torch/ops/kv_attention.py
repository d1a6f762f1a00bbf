"""The KV streamers' attention row on the card: one pass over the K/V rings.

``inference/streaming_kv.py`` computes, for every frame and attention
site, one attention row per (stream, channel, head) over that site's K/V
rings: scores with the full-dim scale, the ALiBi bias ``-slope * age`` of a
slot, the mask of slots older than the stream's valid count, the softmax
and the value sum. The JAX package leaves that row to two XLA einsums
(``voiceactivityprojection_tpu/inference/streaming_kv.py:147, :156``), so
this kernel replaces no TPU kernel: it replaces the two ``torch.einsum``s
(cuBLAS gemv) and the elementwise passes around them.

CUDA kernel: ``csrc/kv_attention.cu`` ``kv_row_kernel``, one CTA per row,
streaming the row's contiguous K and V blocks once as 16-byte loads with an
online softmax, in float32 FFMA; the age and the mask come from the write
cursor ``pos`` and the per-stream ``n_valid``, and only valid slots are
read. The kernel reads the cursor from device memory, so a launch holds
no host value of it and a CUDA graph replays it as the cursor moves
(``inference/streaming_kv.py``): a one-element integer tensor on the card
as the streamers pass it, or a host int that the wrapper checks and fills
into one; the kernel checks the cursor against the T slots itself and
writes NaN rows for one outside. ``swap`` (the cross rows) reads ring
channel 1 - c for query channel c by index. Bound on the card: bytes (about 0.5 FLOP a byte), so
the design aims at HBM bandwidth; its time beside its bound: PERF.md (K12).
One launch a call at every S.

``attn_row_reference`` is the plain version, two ``torch.einsum``s; the
wrapper takes it only for CPU tensors (the cross rows through ``flip`` of
the query and of the result), so the streamers on the CPU compute the row
exactly as the einsums do.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from voiceactivityprojection_tpu_torch.ops import _build

# the head widths the kernel is instantiated for (the model's 256 over 8, 4
# and 2 heads), as every attention kernel of the port
HEAD_DIMS = (32, 64, 128)
_build.declare_kernels("kv_attention", ("row float32",))


def attn_row_reference(
    q: torch.Tensor,       # (S, 2, H, Dh)
    k_ring: torch.Tensor,  # (S, 2, H, T, Dh)
    v_ring: torch.Tensor,
    slopes: torch.Tensor,  # (H,)
    dist: torch.Tensor,    # (T,) age of a slot: 0 = just written
    n_valid: torch.Tensor,  # (S,) valid frames a stream, the newest included
    full_dim: int,
) -> torch.Tensor:
    """One attention row per stream, channel and head: (S, 2, H * Dh)
    (JAX: streaming_kv.py:127-157)."""
    scale = 1.0 / math.sqrt(full_dim)  # the full-dim scale of the reference
    scores = torch.einsum("schd,schtd->scht", q, k_ring) * scale
    # the relative position j - i of a slot of age d is -d
    scores = scores - slopes.float()[:, None] * dist[None, :]
    valid = dist[None, :] < n_valid[:, None]  # (S, T)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v_ring.dtype)
    out = torch.einsum("scht,schtd->schd", w, v_ring)
    return out.reshape(*out.shape[:-2], -1)


def slot_ages(pos, T: int, device) -> torch.Tensor:
    """(T,) float32: the age of slot j after the write at ``pos`` (an int or
    a one-element integer tensor), (pos - j) mod T."""
    return torch.remainder(pos - torch.arange(T, device=device), T).float()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_attention")
    fn = lib.vap_kv_attention_row
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kv_attention_row(
    q: torch.Tensor,
    k_ring: torch.Tensor,
    v_ring: torch.Tensor,
    slopes: torch.Tensor,
    pos,
    n_valid: torch.Tensor,
    full_dim: int,
    swap: bool = False,
) -> torch.Tensor:
    """q (S, 2, H, Dh); the rings (S, 2, H, T, Dh), slot ``pos`` just
    written; slopes (H,); n_valid (S,) -> (S, 2, H * Dh). ``pos`` is an int
    or a one-element int32 / int64 tensor on q's device (on the card read
    there, never by the host). With ``swap`` query channel c reads ring
    channel 1 - c (the cross rows). The kernel on CUDA tensors,
    ``attn_row_reference`` on CPU tensors. Inference only."""
    S, two, H, Dh = q.shape
    T = k_ring.shape[3]
    if two != 2 or tuple(k_ring.shape) != (S, 2, H, T, Dh) or v_ring.shape != k_ring.shape:
        raise ValueError(f"kv_attention_row: q must be (S, 2, H, Dh) and the rings (S, 2, H, T, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k_ring.shape)}, {tuple(v_ring.shape)}")
    if tuple(slopes.shape) != (H,) or tuple(n_valid.shape) != (S,):
        raise ValueError(f"kv_attention_row: slopes must be ({H},) and n_valid ({S},), got "
                         f"{tuple(slopes.shape)}, {tuple(n_valid.shape)}")
    at = isinstance(pos, torch.Tensor)
    if at and (pos.numel() != 1 or pos.dtype not in (torch.int32, torch.int64) or pos.device != q.device):
        raise ValueError(f"kv_attention_row: a tensor pos must be one int32 or int64 on {q.device}, got "
                         f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
    if not at:
        pos = int(pos)
    if (not at or q.device.type == "cpu") and not 0 <= int(pos) < T:  # the kernel checks a device cursor
        raise ValueError(f"kv_attention_row: pos {int(pos)} outside the {T} slots")
    if q.device.type == "cpu":
        dist = slot_ages(pos, T, q.device)
        if swap:  # the other channel's ring: swap the query's channels, then the result's
            return attn_row_reference(q.flip(1), k_ring, v_ring, slopes, dist, n_valid, full_dim).flip(1)
        return attn_row_reference(q, k_ring, v_ring, slopes, dist, n_valid, full_dim)
    if Dh not in HEAD_DIMS:
        raise ValueError(f"kv_attention_row: head dim must be one of {HEAD_DIMS}, got {Dh}")
    for name, t in (("q", q), ("k_ring", k_ring), ("v_ring", v_ring)):
        _build.check_cuda_tensor(t, f"kv_attention_row {name}", torch.float32)
        _build.check_aligned(t, f"kv_attention_row {name}")  # the kernel reads 16-byte pieces
    _build.check_cuda_tensor(n_valid, "kv_attention_row n_valid", torch.int32)
    if _build.grad_requested(q, k_ring, v_ring):
        raise RuntimeError("kv_attention_row: the kernel has no backward; the streamers run it for inference")
    slopes32 = slopes.to(torch.float32).contiguous()
    _build.check_cuda_tensor(slopes32, "kv_attention_row slopes", torch.float32)
    out = torch.empty(S, 2, H * Dh, dtype=torch.float32, device=q.device)
    if at:
        cursor = pos.reshape(1).to(torch.int64)  # no copy for the streamers' int64 cursor
    else:
        cursor = torch.full((1,), pos, dtype=torch.int64, device=q.device)  # a fill, no sync
    rc = _lib().vap_kv_attention_row(
        q.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(), slopes32.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), S, H, T, Dh, cursor.data_ptr(), 1.0 / math.sqrt(full_dim), int(bool(swap)),
        _build.stream_handle(q),
    )
    _build.check_launch(rc, "kv_attention", "row float32")
    return out

"""GRU recurrence over precomputed input projections on the card.

Replaces the TPU kernel ``_gru_kernel`` of
``voiceactivityprojection_tpu/ops/gru_pallas.py`` (entry point
``gru_recurrence_pallas``, :255): given ``x_proj = x @ W_ih + b_ih``, the
recurrence in gate order r, z, n with ``b_hn`` inside ``r * (.)``; gate math
and the carry in f32. (R, T, 3H) -> ``(ys (R, T, H), h_last (R, H))`` in
x_proj's dtype, ``h_last`` being ``ys[:, -1]`` (gru_pallas.py:297).

CUDA kernel: ``csrc/gru_recurrence.cu`` ``gru_kernel``, the GRU + downsample
kernel's design without its epilogue: one block of 3H threads per sequence,
thread j owning gate column j of ``h @ W_hh`` and reading ``W_hh[:, j]``
from L2 every step, the hidden state in shared memory, ``ys[:, t]`` written
each step.

Bound on the card: neither bytes nor operations but the T dependent steps.
W_hh (768 KB f32, 384 KB bf16 at H=256) fits no SM's shared memory, so a
step's time is what one SM needs to stream it from L2.

``gru_recurrence_reference`` is the plain PyTorch version (counterpart of
``_scan_recurrence``, gru_pallas.py:239, with the kernel's f32 carry); the
wrapper takes it only for CPU tensors. The kernel has no backward yet: the
GRU backward (K9, ``_gru_bwd_kernel``, gru_pallas.py:300) is queued with the
unfrozen encoder, so on a CUDA input that requires grad, with grad enabled,
the wrapper raises instead of returning a detached result.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.gru import gru_gates

MAX_HIDDEN = 256  # 3H threads per block, at most 768


def gru_recurrence_reference(
    x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence with an f32 carry, outputs in x_proj's
    dtype."""
    f = lambda t: t.to(torch.promote_types(t.dtype, torch.float32))
    xp, whh, bhh, h = f(x_proj), f(w_hh), f(b_hh), f(h0)
    ys = []
    for t in range(xp.shape[1]):
        h = gru_gates(xp[:, t], h, whh, bhh)
        ys.append(h)
    out = torch.stack(ys, dim=1).to(x_proj.dtype)
    return out, out[:, -1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_recurrence")
    fn = lib.vap_gru_recurrence
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gru_recurrence(
    x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_proj: (R, T, 3H) -> (ys (R, T, H), h_last (R, H))."""
    R, T, three_h = x_proj.shape
    H = three_h // 3
    for what, t, shape in (("w_hh", w_hh, (H, three_h)), ("b_hh", b_hh, (three_h,)),
                           ("h0", h0, (R, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_recurrence: {what} must be {shape}, got {tuple(t.shape)}")
    if x_proj.device.type == "cpu":
        return gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    if _build.grad_requested(x_proj, w_hh, b_hh, h0):
        raise NotImplementedError(
            "gru_recurrence: the GRU backward kernel (K9, ops/gru_pallas.py "
            "_gru_bwd_kernel) is not ported yet; it is queued with the unfrozen "
            "encoder. Train with freeze_encoder=True on the card."
        )
    if three_h != 3 * H or H % 32 or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"gru_recurrence: hidden must be a multiple of 32 up to {MAX_HIDDEN}, got {H}")
    if T < 1:
        raise ValueError("gru_recurrence: empty sequence")
    for what, t in (("x_proj", x_proj), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)):
        _build.check_cuda_tensor(t, f"gru_recurrence {what}", x_proj.dtype)
    ys = torch.empty(R, T, H, dtype=x_proj.dtype, device=x_proj.device)
    rc = _lib().vap_gru_recurrence(
        x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        R, T, H, _build.dtype_code(x_proj.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "gru_recurrence")
    gru_recurrence.launches += 1
    return ys, ys[:, -1]


gru_recurrence.launches = 0

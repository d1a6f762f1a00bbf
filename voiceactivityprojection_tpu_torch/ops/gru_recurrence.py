"""GRU recurrence over precomputed input projections on the card, and its
backward.

Replaces two TPU kernels of ``voiceactivityprojection_tpu/ops/gru_pallas.py``
behind the custom VJP ``gru_recurrence_pallas`` (:255):

- ``_gru_kernel`` (:49, K3), the forward: given ``x_proj = x @ W_ih + b_ih``,
  the recurrence in gate order r, z, n with ``b_hn`` inside ``r * (.)``;
  gate math and the carry in f32. (R, T, 3H) -> ``ys`` (R, T, H) in
  x_proj's dtype; ``h_last`` is ``ys[:, -1]`` (gru_pallas.py:297).
- ``_gru_bwd_kernel`` (:300, K9), the backward: the reverse recurrence
  with the gates recomputed from ``x_proj`` and ``h_{t-1}`` (read from
  ``ys`` in the I/O dtype), ``dx_proj`` in x_proj's dtype, ``dW_hh``,
  ``db_hh`` and ``dh0`` accumulated in f32 and cast as ``_backward_pallas``
  casts them (:430-436).

CUDA kernels: ``csrc/gru_recurrence.cu`` ``gru_kernel`` (K3: one block of
3H threads per sequence, thread j owning gate column j of ``h @ W_hh`` and
reading ``W_hh[:, j]`` from L2 every step, the hidden state in shared
memory) and ``csrc/gru_backward.cu`` (K9: the same block shape walking
time backwards, with the f32 gate gradients to a scratch, then a tiled
reduction of ``dW_hh`` / ``db_hh`` over rows and steps in a fixed order).
Bound on the card: neither bytes nor operations but the T dependent steps;
W_hh (768 KB f32, 384 KB bf16 at H=256) fits no SM's shared memory, so a
step's time is what one SM needs to stream it from L2 (twice a step in
the backward).

``gru_recurrence`` is the autograd function ``GruRecurrence`` on every
device: K3 forward and K9 backward on CUDA tensors, the plain versions
``gru_recurrence_reference`` (counterpart of ``_scan_recurrence``,
gru_pallas.py:239, with the kernel's f32 carry) and
``gru_backward_reference`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops.gru import gru_gates

MAX_HIDDEN = 256  # 3H threads per block, at most 768
_SMS = 132  # H100 SXM streaming multiprocessors: K9's weight reduction aims at 2 blocks each


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def gru_recurrence_reference(
    x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence with an f32 carry, outputs in x_proj's
    dtype."""
    xp, whh, bhh, h = _f32(x_proj), _f32(w_hh), _f32(b_hh), _f32(h0)
    ys = []
    for t in range(xp.shape[1]):
        h = gru_gates(xp[:, t], h, whh, bhh)
        ys.append(h)
    out = torch.stack(ys, dim=1).to(x_proj.dtype)
    return out, out[:, -1]


def gru_backward_reference(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    h0: torch.Tensor,
    ys: torch.Tensor,
    dys: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K9: ``(dx_proj, dw_hh, db_hh, dh0)``, the reverse
    recurrence of ``_gru_bwd_kernel`` (gru_pallas.py:334-373) with the gates
    recomputed in f32 from ``x_proj`` and ``h_{t-1} = [h0, ys[:, :-1]]`` in
    the I/O dtype; ``dh_last`` folded into the last step's ``dys`` (:385)."""
    R, T, three_h = x_proj.shape
    H = three_h // 3
    dys = _fold_dh_last(dys, dh_last)
    xp, w, b = _f32(x_proj), _f32(w_hh), _f32(b_hh)
    hprev = _f32(torch.cat([h0[:, None].to(ys.dtype), ys[:, :-1]], dim=1))
    dt = xp.dtype
    dh = torch.zeros(R, H, dtype=dt, device=xp.device)
    dxp = torch.empty(R, T, three_h, dtype=dt, device=xp.device)
    dgates = torch.empty(R, T, three_h, dtype=dt, device=xp.device)
    for t in range(T - 1, -1, -1):
        h = hprev[:, t]
        g = dh + dys[:, t].to(dt)
        hp = h @ w + b
        r = torch.sigmoid(xp[:, t, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, t, H:2 * H] + hp[:, H:2 * H])
        hn = hp[:, 2 * H:]
        n = torch.tanh(xp[:, t, 2 * H:] + r * hn)
        dn = g * (1.0 - z) * (1.0 - n * n)
        dz = g * (h - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dxp[:, t] = torch.cat([dr, dz, dn], dim=-1)
        dg = torch.cat([dr, dz, dn * r], dim=-1)
        dgates[:, t] = dg
        dh = g * z + dg @ w.T
    dw = hprev.reshape(R * T, H).T @ dgates.reshape(R * T, three_h)
    db = dgates.sum(dim=(0, 1))
    return dxp.to(x_proj.dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype), dh.to(h0.dtype)


def _fold_dh_last(dys: torch.Tensor, dh_last: Optional[torch.Tensor]) -> torch.Tensor:
    """``dys`` with the ``h_last`` cotangent added to its last step, in dys's
    dtype (JAX: ``dys.at[:, T - 1].add(dh_last)``, outside the kernel)."""
    if dh_last is None:
        return dys
    dys = dys.clone()
    dys[:, -1] += dh_last.to(dys.dtype)
    return dys


def _check_kernel_shapes(R: int, T: int, three_h: int, what: str) -> None:
    H = three_h // 3
    if three_h != 3 * H or H % 32 or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"{what}: hidden must be a multiple of 32 up to {MAX_HIDDEN}, got {three_h}/3")
    if T < 1 or R < 1:
        raise ValueError(f"{what}: empty input ({R} rows, {T} steps)")


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_recurrence")
    fn = lib.vap_gru_recurrence
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _backward_lib() -> ctypes.CDLL:
    lib = _build.load("gru_backward")
    fn = lib.vap_gru_backward
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _forward(
    x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> torch.Tensor:
    """ys: K3 on CUDA tensors, the plain loop on CPU tensors."""
    if x_proj.device.type == "cpu":
        return gru_recurrence_reference(x_proj, w_hh, b_hh, h0)[0]
    R, T, three_h = x_proj.shape
    _check_kernel_shapes(R, T, three_h, "gru_recurrence")
    for what, t in (("x_proj", x_proj), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)):
        _build.check_cuda_tensor(t, f"gru_recurrence {what}", x_proj.dtype)
    ys = torch.empty(R, T, three_h // 3, dtype=x_proj.dtype, device=x_proj.device)
    rc = _lib().vap_gru_recurrence(
        x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        R, T, three_h // 3, _build.dtype_code(x_proj.dtype), _build.stream_handle(),
    )
    _build.check_launch(rc, "gru_recurrence")
    gru_recurrence.launches += 1
    return ys


def weight_splits(rows: int, hidden: int) -> int:
    """Slices of the R*T rows in K9's dW_hh / db_hh reduction: enough
    (64 x 64 tile, slice) blocks for two per SM, at least 32 rows a slice."""
    tiles = -(-hidden // 64) * -(-3 * hidden // 64)
    return max(1, min(-(-2 * _SMS // tiles), -(-rows // 32)))


def gru_backward(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    h0: torch.Tensor,
    ys: torch.Tensor,
    dys: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9: ``(dx_proj, dw_hh, db_hh, dh0)`` for ``ys = gru_recurrence(x_proj,
    w_hh, b_hh, h0)`` and the output cotangents ``dys`` (and ``dh_last``)."""
    if x_proj.device.type == "cpu":
        return gru_backward_reference(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    R, T, three_h = x_proj.shape
    H = three_h // 3
    _check_kernel_shapes(R, T, three_h, "gru_backward")
    dys = _fold_dh_last(dys, dh_last)
    for what, t in (("x_proj", x_proj), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0),
                    ("ys", ys), ("dys", dys)):
        _build.check_cuda_tensor(t, f"gru_backward {what}", x_proj.dtype)
    if tuple(ys.shape) != (R, T, H) or dys.shape != ys.shape:
        raise ValueError(f"gru_backward: ys and dys must be {(R, T, H)}, got "
                         f"{tuple(ys.shape)}, {tuple(dys.shape)}")
    f32 = dict(dtype=torch.float32, device=x_proj.device)
    w_hh_t = w_hh.t().contiguous()  # (3H, H): dgates @ W_hh^T reads it row by row
    dxp = torch.empty_like(x_proj)
    dgates = torch.empty(R, T, three_h, **f32)
    dh0 = torch.empty(R, H, **f32)
    splits = weight_splits(R * T, H)
    partial = torch.empty(splits, H + 1, three_h, **f32)
    dwb = torch.empty(H + 1, three_h, **f32)
    rc = _backward_lib().vap_gru_backward(
        x_proj.data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
        partial.data_ptr(), dwb.data_ptr(), R, T, H, splits, _build.dtype_code(x_proj.dtype),
        _build.stream_handle(),
    )
    _build.check_launch(rc, "gru_backward")
    gru_backward.launches += 1
    return dxp, dwb[:H].to(w_hh.dtype), dwb[H].to(b_hh.dtype), dh0.to(h0.dtype)


class GruRecurrence(torch.autograd.Function):
    """``ys`` from K3 (the plain loop on the CPU); the backward is K9 (its
    plain version on the CPU), as JAX's custom VJP pairs ``_forward_pallas``
    with ``_backward_pallas`` (gru_pallas.py:439-458). The caller takes
    ``h_last = ys[:, -1]`` outside, so autograd folds its cotangent into
    ``dys``."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        ys = _forward(x_proj, w_hh, b_hh, h0)
        ctx.save_for_backward(x_proj, w_hh, b_hh, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, w_hh, b_hh, h0, ys = ctx.saved_tensors
        return gru_backward(x_proj, w_hh, b_hh, h0, ys, dys.contiguous())


def gru_recurrence(
    x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_proj: (R, T, 3H) -> (ys (R, T, H), h_last (R, H)), differentiable
    in every input on either device."""
    R, T, three_h = x_proj.shape
    H = three_h // 3
    for what, t, shape in (("w_hh", w_hh, (H, three_h)), ("b_hh", b_hh, (three_h,)),
                           ("h0", h0, (R, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_recurrence: {what} must be {shape}, got {tuple(t.shape)}")
    ys = GruRecurrence.apply(x_proj, w_hh, b_hh, h0)
    return ys, ys[:, -1]


gru_recurrence.launches = 0
gru_backward.launches = 0

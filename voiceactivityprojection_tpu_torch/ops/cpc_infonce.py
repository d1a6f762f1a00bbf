"""The CPC loss's InfoNCE scoring on the card: one kernel pair (K14).

``train/cpc_pretrain.py`` ``cpc_loss`` scores, for every context row
(b, t) and prediction step k, the prediction ``preds[k - 1, b, t]`` against
the true future encoding ``z[b, t + k]`` (slot 0) and N negatives
``z[idx[b, t, n]]`` drawn from the batch's encodings; the loss is the
softmax cross entropy with the positive in slot 0, averaged over the steps
and rows, and the accuracies count the rows whose positive scores at least
as high as every negative (``argmax``'s first index). The JAX package leaves
this to XLA einsums, so the kernel replaces no TPU kernel: it replaces the
plain version, which gathers a (B, Tc, N, C) tensor (486 MB at the CPC
cell's shape) and loops over the K heads with a batched gemv each, and
whose backward writes a gradient of that tensor a head and scatters it
into z.

CUDA kernels: ``csrc/cpc_infonce.cu``. The forward (one CTA a context row)
streams the row's K positives and N negatives from z, which stays in L2,
with 16-byte ``cp.async`` loads, scores each against the K predictions in
float32 FFMA, and keeps an online log-sum-exp a head; a one-CTA kernel sums
the rows' losses and hits in a fixed order, so the loss is the same bit for
bit from run to run. The positive is scored by the same instructions as a
negative, so a negative that is the positive's row ties it exactly and
counts as a hit, as ``argmax`` does. The backward recomputes the scores and
writes the predictions' gradient whole (one CTA a row, a fixed order) and
adds the encodings' gradient into z's with 16-byte atomic adds, whose order
changes from run to run: dz is not bit-reproducible on the card, within
float32 rounding of a fixed order. An index outside [0, B * T) makes the
loss NaN (checked on the card: the wrapper makes no host sync). Bound:
operations, 2.9 GFLOP forward at the CPC cell's shape; in practice each
pass streams its 520 MB of gathered rows from L2. Its time beside its
bound: PERF.md (K14).

Routes, by what the tensors show: CUDA float32 tensors with C = 256 (the
kernels' width, the configs' ``hiddenEncoder``) and K <= 16 take the
kernels, any B, Tc and N >= 1; everything else (CPU tensors, other dtypes,
other C or K) takes ``infonce_reference``, the plain version, so the CPU
computes the loss as before. The launch ledger counts the kernels under
``"cpc_infonce"``: one forward and one backward a training step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.ops import _build

KERNEL_WIDTH = 256  # C, a template constant of the kernels
MAX_HEADS = 16
_build.declare_kernels("cpc_infonce", ("forward float32", "backward float32"))

Metrics = Dict[str, torch.Tensor]


def infonce_reference(z: torch.Tensor, preds: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """The plain version: z (B, T, C) encodings, preds (K, B, Tc, C) the
    heads' predictions, idx (B, Tc, N) negatives into the flattened (B*T)
    encodings (JAX: cpc_pretrain.py:50-87)."""
    B, T, C = z.shape
    n_predicts, _, Tc, _ = preds.shape
    negs = z.reshape(B * T, C)[idx]  # (B, Tc, N, C)
    losses, accs = [], []
    for k in range(1, n_predicts + 1):
        pos = z[:, k:Tc + k]
        p_k = preds[k - 1]
        pos_score = (p_k * pos).sum(-1)
        neg_score = torch.einsum("btc,btnc->btn", p_k, negs)
        logits = torch.cat([pos_score[..., None], neg_score], dim=-1)
        losses.append(-F.log_softmax(logits, dim=-1)[..., 0].mean())
        accs.append((logits.argmax(-1) == 0).float().mean())
    loss = torch.stack(losses).mean()
    return loss, {
        "cpc_loss": loss,
        "cpc_acc": torch.stack(accs).mean(),
        "cpc_acc_k1": accs[0],
        "cpc_acc_k12": accs[-1],
    }


def kernel_takes(device_type: str, z_dtype: torch.dtype, preds_dtype: torch.dtype, width: int,
                 n_predicts: int) -> bool:
    """Whether z and preds on ``device_type`` of ``z_dtype`` and
    ``preds_dtype``, C = ``width`` and K = ``n_predicts`` take the kernels
    (else ``infonce_reference``)."""
    return (device_type == "cuda" and z_dtype == preds_dtype == torch.float32 and width == KERNEL_WIDTH
            and n_predicts <= MAX_HEADS)


def check_shapes(z: torch.Tensor, preds: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise unless z is (B, T, C), preds (K, B, Tc, C) with Tc + K <= T and
    idx (B, Tc, N) integer with N >= 1."""
    if z.ndim != 3 or preds.ndim != 4:
        raise ValueError(f"infonce: z must be (B, T, C) and preds (K, B, Tc, C), got {tuple(z.shape)}, "
                         f"{tuple(preds.shape)}")
    B, T, C = z.shape
    K, Bp, Tc, Cp = preds.shape
    if (Bp, Cp) != (B, C) or K < 1 or Tc < 1 or Tc + K > T:
        raise ValueError(f"infonce: preds must be (K, {B}, Tc, {C}) with K >= 1, Tc >= 1 and Tc + K <= {T}, "
                         f"got {tuple(preds.shape)}")
    if idx.ndim != 3 or tuple(idx.shape[:2]) != (B, Tc) or idx.shape[2] < 1:
        raise ValueError(f"infonce: idx must be ({B}, {Tc}, N) with N >= 1, got {tuple(idx.shape)}")
    if idx.dtype.is_floating_point or idx.dtype.is_complex or idx.dtype == torch.bool:
        raise ValueError(f"infonce: idx must be an integer tensor, got {idx.dtype}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cpc_infonce")
    for fn in (lib.vap_cpc_infonce_forward, lib.vap_cpc_infonce_backward):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _dims(z2: torch.Tensor, preds: torch.Tensor, idx: torch.Tensor, T: int):
    K, B, Tc, _ = preds.shape
    return (B, T, Tc, idx.shape[2], K, *preds.stride()[:3], _build.stream_handle(z2))


class _InfoNCE(torch.autograd.Function):
    """The forward kernel pair; the backward kernel."""

    @staticmethod
    def forward(ctx, z2, preds, idx, T):
        K, B, Tc, _ = preds.shape
        rows = B * Tc
        lse = torch.empty(K, rows, dtype=torch.float32, device=z2.device)
        part = torch.empty(rows, 2, -(-K // 4) * 4, dtype=torch.float32, device=z2.device)
        loss = torch.empty((), dtype=torch.float32, device=z2.device)
        stats = torch.empty(1 + K, dtype=torch.float32, device=z2.device)
        rc = _lib().vap_cpc_infonce_forward(z2.data_ptr(), preds.data_ptr(), idx.data_ptr(), lse.data_ptr(),
                                            part.data_ptr(), loss.data_ptr(), stats.data_ptr(),
                                            *_dims(z2, preds, idx, T))
        _build.check_launch(rc, "cpc_infonce", "forward float32")
        ctx.save_for_backward(z2, preds, idx, lse)
        ctx.T = T
        ctx.mark_non_differentiable(stats)
        return loss, stats

    @staticmethod
    def backward(ctx, g, _):
        z2, preds, idx, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dz = torch.zeros_like(z2)
        dpreds = torch.empty_strided(preds.shape, preds.stride(), dtype=torch.float32, device=z2.device)
        rc = _lib().vap_cpc_infonce_backward(z2.data_ptr(), preds.data_ptr(), idx.data_ptr(), lse.data_ptr(),
                                             g.data_ptr(), dz.data_ptr(), dpreds.data_ptr(),
                                             *_dims(z2, preds, idx, ctx.T))
        _build.check_launch(rc, "cpc_infonce", "backward float32")
        return (dz if ctx.needs_input_grad[0] else None, dpreds if ctx.needs_input_grad[1] else None, None, None)


def _kernel_preds(preds: torch.Tensor) -> torch.Tensor:
    """preds as the kernels read it: rows of C contiguous, every row on a
    16-byte boundary (the einsum's (B, Tc, K, C) layout as it lies)."""
    if preds.stride(3) == 1 and all(s % 4 == 0 for s in preds.stride()[:3]) and preds.data_ptr() % 16 == 0:
        return preds
    return preds.contiguous()


def infonce(z: torch.Tensor, preds: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """The InfoNCE loss and its metrics (``cpc_loss``, ``cpc_acc``,
    ``cpc_acc_k1``, ``cpc_acc_k12``: the first and the last head's
    accuracy) of z (B, T, C), preds (K, B, Tc, C) and idx (B, Tc, N) on z's
    device. The kernels where ``kernel_takes``, else ``infonce_reference``.
    Differentiable in z and preds."""
    check_shapes(z, preds, idx)
    B, T, C = z.shape
    K = preds.shape[0]
    if not kernel_takes(z.device.type, z.dtype, preds.dtype, C, K):
        return infonce_reference(z, preds, idx)
    if idx.device != z.device:
        raise ValueError(f"infonce: idx must be on {z.device}, got {idx.device}")
    z2 = z.reshape(B * T, C).contiguous()
    idx = idx.to(torch.int64).contiguous()
    preds = _kernel_preds(preds)
    _build.check_aligned(z2, "infonce z")
    loss, stats = _InfoNCE.apply(z2, preds, idx, T)
    return loss, {"cpc_loss": loss, "cpc_acc": stats[0], "cpc_acc_k1": stats[1], "cpc_acc_k12": stats[K]}

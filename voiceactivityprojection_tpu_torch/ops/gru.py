"""GRU: one hoisted input projection plus a per-step recurrence.

Counterpart of ``voiceactivityprojection_tpu/ops/gru.py:45-92``. Layouts
are the JAX package's: ``w_ih`` (C, 3H), ``w_hh`` (H, 3H). Gate order
r, z, n with ``b_hn`` inside ``r * (.)``:

    r = sigmoid(x_r + h W_hr + b_hr);  z = sigmoid(x_z + h W_hz + b_hz)
    n = tanh(x_n + r * (h W_hn + b_hn));  h' = (1 - z) n + z h

The step loop keeps the carry in the input dtype, as the JAX scan does;
on the card ``gru`` runs the recurrence kernel (K3, f32 carry) with its
backward kernel (K9), as the JAX package runs its Pallas kernels and their
custom VJP off the CPU. Inference does not come here: it runs the
recurrence fused with the downsample (``ops/gru_downsample.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gru_gates(
    x_proj: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One step given the precomputed input projection (B, 3H)."""
    h_proj = h @ w_hh + b_hh
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru(
    x: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b_ih: torch.Tensor,
    b_hh: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, C) -> (outputs (B, T, H), final carry (B, H)).

    CUDA tensors go to the recurrence kernel (``ops/gru_recurrence.py``,
    f32 carry), which autograd differentiates with the backward kernel;
    CPU tensors run the step loop under autograd (JAX: ops/gru.py:58-92,
    where ``impl="auto"`` picks the Pallas kernel off the CPU)."""
    B, T, _ = x.shape
    hidden = w_hh.shape[0]
    h = torch.zeros(B, hidden, dtype=x.dtype, device=x.device) if h0 is None else h0
    x_proj = x @ w_ih + b_ih  # (B, T, 3H), the hoisted matmul
    if x.is_cuda:
        from voiceactivityprojection_tpu_torch.ops.gru_recurrence import gru_recurrence

        return gru_recurrence(x_proj, w_hh, b_hh, h)
    ys = []
    for t in range(T):
        h = gru_gates(x_proj[:, t], h, w_hh, b_hh)
        ys.append(h)
    return torch.stack(ys, dim=1), h

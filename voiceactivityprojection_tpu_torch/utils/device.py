"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device: the
default is ``cuda``, and asking for it without a usable CUDA device raises
instead of carrying on elsewhere. ``device="cpu"`` selects the plain
PyTorch path (what the tests use).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

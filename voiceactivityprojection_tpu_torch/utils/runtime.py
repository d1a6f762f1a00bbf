"""Seeding of a run's host and torch generators.

Counterpart of ``voiceactivityprojection_tpu/utils/runtime.py``. Only
``everything_deterministic`` has a torch counterpart: the JAX module's
``setup_runtime`` pins the JAX platform and XLA's compilation cache, which
an eager PyTorch program does not have. The port's device randomness flows
through explicit ``torch.Generator``s (``train/step.py``
``step_generators``); this seeds the global ones besides.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def everything_deterministic(seed: int = 0) -> None:
    """Seed ``random``, numpy's global generator and torch's (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

"""Parameter containers whose names follow the JAX params pytree.

The JAX package keeps parameters as nested dicts (``{"conv": {"w", "b"}}``).
``ParamGroup`` is the leaf dict of that tree as an ``nn.Module``: one
trainable ``nn.Parameter`` per named leaf, so ``state_dict()`` keys are the
pytree paths joined by dots and weights map one to one
(``models/checkpoint.py`` ``params_from_jax``). Inference runs under
``torch.inference_mode()``; what training freezes is chosen by the model's
forward and the optimizer (``train/step.py``), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class ParamGroup(nn.Module):
    """Named parameters of the given shapes, allocated uninitialised."""

    def __init__(self, **shapes: Tuple[int, ...]):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(*shape)))

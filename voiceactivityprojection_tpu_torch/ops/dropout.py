"""Elementwise dropout and the randomness of one training forward.

Counterpart of the JAX package's ``_dropout`` (models/transformer.py:34-38)
and of the PRNG keys that its training forward splits: here the keys are
``torch.Generator``s, drawn in a fixed order. ``DropoutRng`` holds the two
streams of one forward: ``seeds``, the step's CPU generator, from which the
attention sites draw their per-call mask seeds (no device sync), and
``masks``, from which the elementwise sites draw their keep masks on the
activations' device: a generator there, seeded once from the step's. So
the attention seeds are the same on every device for one step generator;
CPU and CUDA generators give different elementwise masks.
"""

from __future__ import annotations

import torch


class DropoutRng:
    def __init__(self, generator: torch.Generator, device: torch.device):
        if generator.device.type != "cpu":
            raise ValueError(f"expected a CPU generator, got one on {generator.device}")
        self.seeds = generator
        self.masks = torch.Generator(device=device)
        self.masks.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Zero each element with probability ``rate``, scale the rest by
        1 / (1 - rate)."""
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.masks, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

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

Over several processes (``parallel/mesh.py``) every rank holds the same
step generator, and ``DropoutShard`` says where the rank's rows sit in the
global batch. The attention mask of a rank whose first global row is
``row0`` is the one process's mask of those rows: the kernels' hash adds
``bh * 0x9E3779B1`` with ``bh = b * H + h``, so shifting the seed by
``row0 * H * 0x9E3779B1`` moves the local rows onto the global ones. Under
tensor parallelism (a module's ``ModelShard``, ``parallel/tp.py``) a rank
holds ``H / n_model`` heads, whose local index is no offset of the global
one: the model rank is folded into the seed instead (masks that differ
from one process's). The elementwise masks fold in the data rank, so they
too differ from one process's; the model ranks of one row block draw the
same masks, as their replicated activations need, and the FFN hidden, which
each model rank holds a column block of, is masked by its block of the
full-width mask: with one data rank the elementwise masks are the one
process's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_BH_MUL = 0x9E3779B1  # the hash's multiplier of the batch*head index
_MODEL_FOLD = 0x632BE5AB
_DATA_FOLD = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class DropoutShard:
    """A rank's place in the global batch: its first global row and its
    data rank."""

    row0: int = 0
    data_rank: int = 0

    def attention_seed(self, seed: int, heads: int, tp=None) -> int:
        """The seed that gives this rank's ``heads`` heads of its rows the
        global batch's mask, or, under a ``ModelShard`` ``tp`` of several
        ranks, a seed folded with the model rank."""
        if tp is not None and tp.size > 1:
            return (seed + tp.rank * _MODEL_FOLD + self.row0 * _BH_MUL) & _M32
        return (seed + self.row0 * heads * _BH_MUL) & _M32


class DropoutRng:
    def __init__(self, generator: torch.Generator, device: torch.device, shard: Optional[DropoutShard] = None):
        if generator.device.type != "cpu":
            raise ValueError(f"expected a CPU generator, got one on {generator.device}")
        self.seeds = generator
        self.shard = shard
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        if shard is not None and shard.data_rank:
            seed = (seed + shard.data_rank * _DATA_FOLD) % 2**62
        self.masks = torch.Generator(device=device)
        self.masks.manual_seed(seed)

    def dropout(self, x: torch.Tensor, rate: float, tp=None) -> torch.Tensor:
        """Zero each element with probability ``rate``, scale the rest by
        1 / (1 - rate). Under a ``ModelShard`` ``tp`` of several ranks ``x``
        is model rank ``tp.rank``'s block of the last dimension: the mask is
        drawn at the full width and the rank keeps its block."""
        if rate <= 0.0:
            return x
        if tp is not None and tp.size > 1:
            w = x.shape[-1]
            draw = torch.rand((*x.shape[:-1], w * tp.size), generator=self.masks, device=x.device)
            keep = draw[..., tp.rank * w: (tp.rank + 1) * w] >= rate
        else:
            keep = torch.rand(x.shape, generator=self.masks, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

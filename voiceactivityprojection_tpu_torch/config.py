"""Model configuration of the PyTorch port.

Counterpart of ``voiceactivityprojection_tpu/config.py:71-135``
(``VapConfig``): the same fields with the same defaults, so a config built
for the JAX package describes the same model here. The other configs
(mono, optimizer, data, events, SDS) join with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from voiceactivityprojection_tpu_torch.utils.units import bin_times_to_frames

BIN_TIMES: Tuple[float, ...] = (0.2, 0.4, 0.6, 0.8)


@dataclass(frozen=True)
class VapConfig:
    """Stereo VAP model config (JAX: config.py:71-135)."""

    sample_rate: int = 16_000
    frame_hz: int = 50
    bin_times: Tuple[float, ...] = BIN_TIMES

    # Encoder
    freeze_encoder: bool = True
    load_pretrained: bool = True

    # GPT
    dim: int = 256
    channel_layers: int = 1
    cross_layers: int = 3
    num_heads: int = 4
    dropout: float = 0.1

    # compute dtype of the whole model ("float32" | "bfloat16"); attn_impl
    # is kept for config parity: the port dispatches on the tensor's device
    dtype: str = "float32"
    attn_impl: str = "auto"

    # objective representation: "discrete" | "independent" | "comparative"
    representation: str = "discrete"

    encoder_dim: int = 256

    def __post_init__(self):
        if isinstance(self.bin_times, list):
            object.__setattr__(self, "bin_times", tuple(self.bin_times))

    @property
    def bin_frames(self) -> List[int]:
        return bin_times_to_frames(list(self.bin_times), self.frame_hz)

    @property
    def horizon_frames(self) -> int:
        return sum(self.bin_frames)

    @property
    def horizon_time(self) -> float:
        return sum(self.bin_times)

    @property
    def n_classes(self) -> int:
        return 2 ** (2 * len(self.bin_times))

    @property
    def head_dim(self) -> int:
        n_bins = len(self.bin_times)
        return {
            "discrete": self.n_classes,
            "independent": 2 * n_bins,
            "comparative": 1,
        }[self.representation]

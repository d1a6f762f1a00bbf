"""Model configuration of the PyTorch port.

Counterpart of ``voiceactivityprojection_tpu/config.py:71-172``
(``VapConfig``, ``VapMonoConfig``, ``OptConfig``): the same fields with the
same defaults, so a config built for the JAX package describes the same
model and optimizer here. The other configs (data, events, SDS) join with
the slices that use them.
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


@dataclass(frozen=True)
class VapMonoConfig(VapConfig):
    """Mono (VAD-conditioned) VAP model config (JAX: config.py:138-146)."""

    mono: bool = True
    va_history: bool = False
    va_history_bins: int = 5


@dataclass(frozen=True)
class OptConfig:
    """Optimizer / schedule config (JAX: config.py:150-172)."""

    learning_rate: float = 3.63e-4
    find_learning_rate: bool = False
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.001
    lr_scheduler_interval: str = "step"
    lr_scheduler_freq: int = 100
    lr_scheduler_tmax: int = 2500
    lr_scheduler_patience: int = 2
    lr_scheduler_factor: float = 0.5

    # early stopping
    early_stopping: bool = True
    patience: int = 10
    monitor: str = "val_loss"
    mode: str = "min"

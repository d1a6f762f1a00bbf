"""Model configuration of the PyTorch port.

Counterpart of ``voiceactivityprojection_tpu/config.py:21-280``
(``ArgparseMixin``, ``VapConfig``, ``VapMonoConfig``, ``OptConfig``,
``DataConfig``, ``EventConfig``, ``SDSConfig``): the same fields with the
same defaults, so a config built for the JAX package describes the same
model, optimizer, data pipeline, event extraction and real-time loop here,
and the same command-line flags,
``--<PREFIX>_<field>`` for every field (a bool as an int flag, a tuple as
``nargs="+"``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import List, Tuple

from voiceactivityprojection_tpu_torch.utils.units import bin_times_to_frames

BIN_TIMES: Tuple[float, ...] = (0.2, 0.4, 0.6, 0.8)


class ArgparseMixin:
    """``--<PREFIX>_<field>`` flags for every field of a dataclass config
    (JAX: config.py:21-68). ``PREFIX`` is a class attribute, not a field."""

    PREFIX = ""

    @classmethod
    def add_argparse_args(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        for name, f in cls.__dataclass_fields__.items():
            arg = f"--{cls.PREFIX}_{name}"
            default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
            if isinstance(default, (tuple, list)):
                elem_t = type(default[0]) if len(default) else float
                parser.add_argument(arg, nargs="+", type=elem_t, default=list(default))
            elif isinstance(default, bool):
                parser.add_argument(arg, type=int, default=int(default))
            else:
                parser.add_argument(arg, type=type(default), default=default)
        return parser

    @classmethod
    def args_to_conf(cls, args: argparse.Namespace):
        """The config from the parsed flags: lists back to tuples, int flags
        of bool fields back to bools, fields without a flag at their
        default."""
        fields = cls.__dataclass_fields__
        p = cls.PREFIX + "_"
        kwargs = {}
        for k, v in vars(args).items():
            if not k.startswith(p) or k[len(p):] not in fields:
                continue
            name = k[len(p):]
            if isinstance(v, list):
                v = tuple(v)
            elif isinstance(fields[name].default, bool):
                v = bool(v)
            kwargs[name] = v
        return cls(**kwargs)


@dataclass(frozen=True)
class VapConfig(ArgparseMixin):
    """Stereo VAP model config (JAX: config.py:71-135)."""

    PREFIX = "vap"

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

    # compute dtype of the whole model ("float32" | "bfloat16"); attention
    # route ("auto" | "xla" | "pallas", ops/attention.py use_kernels)
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

    PREFIX = "vap"

    mono: bool = True
    va_history: bool = False
    va_history_bins: int = 5


@dataclass(frozen=True)
class OptConfig(ArgparseMixin):
    """Optimizer / schedule config (JAX: config.py:150-172)."""

    PREFIX = "opt"

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


@dataclass(frozen=True)
class DataConfig(ArgparseMixin):
    """Data pipeline config (JAX: config.py:173-228). A batch is
    ``waveform`` (B, 2, audio_duration * sample_rate) and ``vad``
    (B, (audio_duration + horizon_time) * frame_hz, 2)."""

    PREFIX = "data"

    train_path: str = ""
    val_path: str = ""
    test_path: str = ""
    flip_channels: bool = True
    flip_probability: float = 0.5
    mask_vad: bool = False
    mask_vad_probability: float = 0.4
    # pitch-shift augmentation: "vocoder" | "psola" | "resample" (read by
    # the training slice)
    pitch_mode: str = "vocoder"
    # the mono model's VAD-history windows (ops/vad.py get_activity_history);
    # len(times) + 1 must equal VapMonoConfig.va_history_bins
    va_history_times: Tuple[float, ...] = (60.0, 30.0, 10.0, 5.0)
    # phrase probe (data/phrases.py make_phrase_probe): -1 auto (on when the
    # corpus CSV exists under phrases_root), 0 off, 1 required. The root is
    # the JAX package's default mount of the reference checkout.
    phrases_probe: int = -1
    phrases_root: str = os.path.join(os.sep, "root", "reference")
    phrases_probe_limit: int = 0  # 0 = the full corpus
    # per-sample probability of waveform augmentation (training slice)
    augment_probability: float = 0.5
    batch_size: int = 16
    num_workers: int = 2

    # derived contract values
    audio_duration: float = 20.0
    sample_rate: int = 16_000
    frame_hz: int = 50
    horizon_time: float = 2.0


@dataclass(frozen=True)
class EventConfig(ArgparseMixin):
    """Turn-taking event extraction config (JAX: config.py:231-256)."""

    PREFIX = "event"

    min_context_time: float = 3.0
    metric_time: float = 0.2
    metric_pad_time: float = 0.05
    max_time: float = 20.0
    frame_hz: int = 50
    equal_hold_shift: bool = True
    prediction_region_time: float = 0.5

    # Shift/Hold
    sh_pre_cond_time: float = 1.0
    sh_post_cond_time: float = 1.0
    sh_prediction_region_on_active: bool = True

    # Backchannel
    bc_pre_cond_time: float = 1.0
    bc_post_cond_time: float = 1.0
    bc_max_duration: float = 1.0
    bc_negative_pad_left_time: float = 1.0
    bc_negative_pad_right_time: float = 2.0

    # Long/Short
    long_onset_region_time: float = 0.2
    long_onset_condition_time: float = 1.0


@dataclass(frozen=True)
class SDSConfig(ArgparseMixin):
    """Real-time spoken-dialogue-system config (JAX: config.py:262-280;
    reference: sds/run_sds.py:31-47)."""

    PREFIX = "sds"

    sample_rate: int = 16_000
    frame_hz: int = 50
    context_time: float = 20.0
    chunk_time: float = 0.02
    zmq_port: int = 5578
    zmq_topic: str = "tt_probs"
    prob_smooth_time: float = 0.5
    audio_device: int = -1
    savefile: str = ""
    # "window": re-run the transformer over the context window per hop
    # (StreamingVap); "kv": per-layer K/V caches, constant transformer work
    # per frame (KVStreamingVap: exact vs the batch forward until the
    # context fills, then per-layer sliding-window attention)
    transformer_mode: str = "window"

"""Time / sample / frame unit conversions (JAX: utils/units.py:14-38).

Truncating ``int()`` conversions, as the reference does: ``int(t * sr)``,
``int(t / hop)`` or ``int(t * hz)``.
"""

from __future__ import annotations

from typing import List, Sequence


def time_to_samples(t: float, sample_rate: int) -> int:
    return int(t * sample_rate)


def time_to_frames(t: float, hop_time_or_hz: float, *, is_hz: bool = False) -> int:
    """Seconds to frames: ``int(t / hop_time)``, or ``int(t * frame_hz)``
    with ``is_hz=True``."""
    if is_hz:
        return int(t * hop_time_or_hz)
    return int(t / hop_time_or_hz)


def sample_to_time(n_samples: int, sample_rate: int) -> float:
    return n_samples / sample_rate


def bin_times_to_frames(bin_times: Sequence[float], frame_hz: int) -> List[int]:
    return [int(bt * frame_hz) for bt in bin_times]

"""Time / frame unit conversions (JAX: utils/units.py:36-38).

Truncating ``int()`` conversions, as the reference objective does.
"""

from __future__ import annotations

from typing import List, Sequence


def bin_times_to_frames(bin_times: Sequence[float], frame_hz: int) -> List[int]:
    return [int(bt * frame_hz) for bt in bin_times]

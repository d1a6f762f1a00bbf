"""Shared settings of the benchmark's own tests: each cell shrunk to a size
the CPU runs in a second or two (the port's plain versions stand in for
its kernels there)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_VAP = {"dim": 16, "encoder_dim": 16}
TINY = {
    "stereo_infer_b64_20s": {"traffic": {"batch": 2, "chunk_seconds": 1.0, "pool": 2}, "model": SMALL_VAP},
    "cpc_pretrain_b32_1s": {"traffic": {"batch": 2, "pool": 4},
                            "model": {"hiddenEncoder": 16, "hiddenGar": 16, "sizeWindow": 3200, "nPredicts": 3,
                                      "negativeSamplingExt": 5}},
    "stereo_train_frozen_b16_20s": {"traffic": {"batch": 2, "chunk_seconds": 1.0, "pool": 4}, "model": SMALL_VAP},
    "stereo_stream_kv_s512": {"traffic": {"streams": 3, "context_seconds": 0.2, "pool_ticks": 8, "warmup_ticks": 2,
                                           "check_streams": 2}, "model": SMALL_VAP},
}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels and the cells' sizes run only there")
    return torch.device("cuda")

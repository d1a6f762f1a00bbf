"""On the card: each cell's comparison holds the program at a size a test
run can hold (the widths as the cell has them, fewer rows, dialogs or
seconds) and fails the control, the plain reference computed in TF32 in
the program's place. Skips without a card; imports no JAX.

    python -m pytest --noconftest -m cuda vapbench/tests/test_vapbench_card.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vapbench import harness  # noqa: E402

pytestmark = pytest.mark.cuda

SMALLER = {
    "stereo_infer_b64_20s": {"traffic": {"batch": 8, "pool": 2}},
    "cpc_pretrain_b32_1s": {"traffic": {"batch": 8, "pool": 4}},
    "stereo_train_frozen_b16_20s": {"traffic": {"batch": 4, "pool": 4}},
    "stereo_stream_kv_s512": {"traffic": {"streams": 64, "check_streams": 2}},
}


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only there")
    from voiceactivityprojection_tpu_torch.ops import _build

    _build.build()
    return torch.device("cuda:0")


@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_the_program_passes_and_the_control_fails(cell, card):
    seconds = 3.0
    for control, want in ((False, True), (True, False)):
        ctx = harness.make_context(cell, 2 ** 31 + 101, seconds, False, card, SMALLER[cell])
        harness.apply_precision(ctx.config)
        out = harness.run_cell(ctx, control=control, setup_clock=lambda: 0.0)
        assert out["correct"] is want, (control, out["checks"])

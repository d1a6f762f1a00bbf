"""The launch ledger of ``ops/_build.py``: every C entry call of the kernel
wrappers counted by op and kernel, through ``check_launch``.

CPU only: the ledger is plain Python, and a CUDA graph's capture is
stood in for by a graph that records nothing, so the take-back and the
replays run the streamers' own ``_Captured``.
"""

from __future__ import annotations

import importlib
import re

import pytest
import torch

from voiceactivityprojection_tpu_torch.inference import streaming_kv
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.tools.stage_timer import time_stage

# the ops the tests and chip_smoke.py expect, as they name them
OPS = {"conv_stack", "gru_downsample", "flash_alibi", "gru_recurrence", "flash_train_forward",
       "flash_train_backward", "gru_backward", "flash_alibi_offset", "conv01", "kv_attention", "linear"}
# the ops/ modules that call a C entry
WRAPPERS = sorted(p.stem for p in (_build.PKG_DIR / "ops").glob("*.py")
                  if p.stem != "_build" and "_build.check_launch(" in p.read_text())
LAUNCH = re.compile(r'_build\.check_launch\(rc, "(\w+)", ("[^"]+"|[^)]+)\)')


@pytest.fixture
def ledger(monkeypatch):
    """A ledger of two toy ops in place of the port's (every module that
    declares into the port's is imported above)."""
    monkeypatch.setattr(_build, "_LEDGER", {})
    monkeypatch.setattr(_build, "_AUXILIARY", {})
    monkeypatch.setattr(_build, "_ALL_DECLARED", True)
    _build.declare_kernels("toy", ("a", "b"), ("split",))
    _build.declare_kernels("other", ("x",))
    return _build


@pytest.mark.parametrize("op, kernel", [("nope", "a"), ("toy", "nope"), ("other", "a"), ("toy", "")])
def test_an_undeclared_op_or_kernel_raises(ledger, op, kernel):
    before = ledger.launch_counts()
    with pytest.raises(ValueError, match="launch ledger"):
        ledger.check_launch(0, op, kernel)
    with pytest.raises(ValueError, match="launch ledger"):
        ledger.add_launches({op: {kernel: 1}})
    assert ledger.launch_counts() == before


def test_a_failed_launch_raises_and_is_not_counted(ledger):
    before = ledger.launch_counts()
    with pytest.raises(RuntimeError, match="toy: CUDA error 700 at launch of 'a'"):
        ledger.check_launch(700, "toy", "a")
    assert ledger.launch_counts() == before


def test_declaring_again_keeps_the_counts_and_other_names_raise(ledger):
    ledger.check_launch(0, "toy", "b")
    ledger.declare_kernels("toy", ("a", "b"), ("split",))
    assert ledger.launch_counts()["toy"] == {"a": 0, "b": 1, "split": 0}
    with pytest.raises(ValueError, match="declared as"):
        ledger.declare_kernels("toy", ("a",), ("split",))


def test_the_snapshot_difference_counts_only_what_ran(ledger):
    ledger.check_launch(0, "toy", "a")
    before = ledger.launch_counts()
    for kernel in ("a", "a", "split", "b"):
        ledger.check_launch(0, "toy", kernel)
    assert ledger.launches_since(before) == {"toy": {"a": 2, "b": 1, "split": 1}, "other": {"x": 0}}
    assert ledger.launch_counts()["toy"] == {"a": 3, "b": 1, "split": 1}
    before["toy"]["a"] = 99  # a snapshot is a copy
    assert ledger.launch_counts()["toy"]["a"] == 3


def test_an_op_declared_after_the_snapshot_counts_from_zero(ledger):
    before = ledger.launch_counts()
    ledger.declare_kernels("late", ("k",))
    ledger.check_launch(0, "late", "k")
    assert ledger.launches_since(before)["late"] == {"k": 1}


def test_the_total_leaves_out_the_auxiliary_kernels(ledger):
    before = ledger.launch_counts()
    for kernel in ("a", "b", "split", "split", "split"):
        ledger.check_launch(0, "toy", kernel)
    ledger.check_launch(0, "other", "x")
    assert ledger.launch_totals(ledger.launches_since(before)) == {"toy": 2, "other": 1}


def test_a_capture_taken_back_and_replayed_reproduces_the_counts(ledger):
    """As a CUDA graph's capture: what it launched is taken back, and each
    replay adds it again."""
    before = ledger.launch_counts()
    for kernel in ("a", "split"):
        ledger.check_launch(0, "toy", kernel)
    ledger.check_launch(0, "other", "x")
    added = ledger.launches_since(before)
    ledger.add_launches(added, -1)
    assert ledger.launch_counts() == before
    for _ in range(3):
        ledger.add_launches(added)
    assert ledger.launches_since(before) == {"toy": {"a": 3, "b": 0, "split": 3}, "other": {"x": 3}}


class _RecordsNothing:
    """A CUDA graph on the CPU: its capture runs the stage, a replay
    launches nothing."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_the_streamers_graphs_count_each_replay_of_every_kernel(ledger, monkeypatch):
    """``_Captured`` takes each stage's launches back from the ledger and
    adds them at every replay, whatever the op."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordsNothing)

    def stage(*kernels):
        def run(x):
            for op, kernel in kernels:
                ledger.check_launch(0, op, kernel)
            return x
        return run

    x = torch.zeros(3)
    before = ledger.launch_counts()
    stages = [(None, stage(("toy", "a"), ("toy", "split"))), ("kv.test", stage(("other", "x")))]
    graphs = streaming_kv._Captured(stages, x, pool=None)
    assert ledger.launch_counts() == before
    for _ in range(2):
        graphs.replay(x)
    assert ledger.launches_since(before) == {"toy": {"a": 2, "b": 0, "split": 2}, "other": {"x": 2}}


def test_stage_timer_reads_the_launches_a_call(ledger):
    def call():
        ledger.check_launch(0, "toy", "a")
        ledger.check_launch(0, "toy", "split")

    rec = time_stage("toy", call, torch.device("cpu"), iters=4, warmup=1)
    assert rec["launches"] == {"toy": 1.0}


def test_the_port_declares_every_op_the_counts_name():
    counts = _build.launch_counts()
    assert set(counts) == OPS
    assert counts["linear"].keys() == {"gemm 3xtf32", "split tf32", "slice sum"}
    assert all(k in counts[op] for op in ("conv_stack", "conv01") for k in ("wgmma 3xtf32", "split tf32"))
    zero = {op: dict.fromkeys(row, 0) for op, row in counts.items()}
    assert _build.launch_totals(zero) == dict.fromkeys(OPS, 0)


@pytest.mark.parametrize("module", WRAPPERS)
def test_each_wrapper_module_declares_the_kernels_it_launches(module):
    """Every ``check_launch`` of an ``ops/`` module names a declared op, and
    a kernel named in the call itself is declared for it."""
    importlib.import_module(f"voiceactivityprojection_tpu_torch.ops.{module}")
    src = (_build.PKG_DIR / "ops" / f"{module}.py").read_text()
    calls = LAUNCH.findall(src)
    assert calls and len(calls) == src.count("_build.check_launch("), module
    counts = _build.launch_counts()
    for op, kernel in calls:
        assert op in counts, (module, op)
        if kernel.startswith('"'):
            assert kernel.strip('"') in counts[op], (module, op, kernel)


def test_wrappers_are_the_modules_that_launch():
    assert set(WRAPPERS) == {"conv_stack_fused", "conv_fused", "gru_downsample", "gru_recurrence", "flash_alibi",
                             "flash_alibi_train", "kv_attention", "linear"}

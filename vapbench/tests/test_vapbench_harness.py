"""The benchmark's harness on the CPU: names found by files, each cell's
set-up, window, trace and comparison at a small size, the comparison
failing on the faults the cells can have, the counts against hand values,
and ``run.py`` refusing to run without a card."""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys

import pytest
import torch

from vapbench import harness, traffic
from vapbench.counts import flops, peaks
from vapbench.tests.conftest import ROOT, TINY

CELLS = sorted(TINY)


def _run(cell, trace=False, seed=2 ** 31 + 7, seconds=0.3, control=False):
    ctx = harness.make_context(cell, seed, seconds, trace, "cpu", TINY[cell])
    return harness.run_cell(ctx, control=control, setup_clock=lambda: 1.0)


# ------------------------------------------------------------------ names --
def test_every_cell_of_the_benchmark_resolves():
    bench = harness.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        workload = harness.load_json("workloads", w["name"])
        assert workload["config"] == w["config"] and workload["chips"] == w["chips"]
        assert configs[w["config"]]["file"] == f"vapbench/configs/{w['config']}.json"
        harness.find("entries", workload["entry"])
        e2e, layer = harness.cell_metrics(bench, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in layer:
            assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind", ["configs", "workloads", "entries", "metrics"])
def test_an_unknown_name_is_refused(kind):
    with pytest.raises(harness.UnknownName):
        harness.find(kind, "no_such_name")
    with pytest.raises(harness.UnknownName):
        harness.find(kind, "../harness")


def test_a_new_cell_config_entry_and_metric_are_new_files(tmp_path):
    """A copy of the benchmark takes a dummy configuration, cell, entry and
    per-layer metric as added files, with no file of it edited."""
    shutil.copytree(ROOT / "vapbench", tmp_path / "vapbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    bench["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                             "file": "vapbench/configs/dummy_cfg.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_cell", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["dummy_cell"]})
    bench["per_layer"].append({"name": "dummy_layer_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "entry", "moves": "dummy_per_s", "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "vapbench"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps({"dtype": "float32", "model": {"n": 8}}))
    (b / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "dummy_cfg", "chips": 1, "entry": "dummy_entry", "traffic": {"size": 4}, "trace_calls": 2,
         "checks": {"sum_gap": 0.0}}))
    (b / "entries" / "dummy_entry.py").write_text(
        "import torch\n"
        "def setup(ctx):\n    return {'x': torch.ones(ctx.traffic['size']), 'n': 0}\n"
        "def call(st):\n    st['n'] += 1\n"
        "def finish(st):\n    pass\n"
        "def end_to_end(st, window):\n    return {'dummy_per_s': window['calls'] / window['elapsed_s']}\n"
        "def counts(st):\n    return {}\n"
        "def stages(st):\n    return {'sum': lambda: st['x'].sum()}\n"
        "def release(st):\n    pass\n"
        "def check(st, control=False):\n    return [('sum_gap', abs(float(st['x'].sum()) - 4.0), 0.0)]\n")
    (b / "metrics" / "dummy_layer_ms.py").write_text("def read(ctx):\n    return ctx.stage_ms.get('sum')\n")
    spec = importlib.util.spec_from_file_location("vapbench_copy_harness", b / "harness.py")
    copy = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = copy
    spec.loader.exec_module(copy)
    for trace in (False, True):
        ctx = copy.make_context("dummy_cell", 5, 0.05, trace, "cpu")
        out = copy.run_cell(ctx, setup_clock=lambda: 0.5)
        assert out["correct"] and out["attempted"] > 0
        want = {"dummy_layer_ms"} if trace else {"dummy_per_s", "setup_s"}
        assert set(out["metrics"]) == want
    with pytest.raises(copy.UnknownName):
        copy.make_context("stereo_infer_b64_20s_typo", 5, 0.05, False, "cpu")


# -------------------------------------------------------------- the cells --
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_cell_runs_and_agrees_with_the_reference(cell):
    """Set-up, window and comparison at a small size: the port's plain
    versions agree with the plain reference to float32 rounding."""
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] < 1e-4 for c in out["checks"].values()), out["checks"]
    assert list(out)[-1] == "checks"
    e2e, _ = harness.cell_metrics(harness.benchmark(), cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", ["stereo_infer_b64_20s", "cpc_pretrain_b32_1s"])
def test_a_traced_small_cell_reads_its_per_layer_metrics(cell):
    out = _run(cell, trace=True)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    stage = {"stereo_infer_b64_20s": "encoder_ms.infer", "cpc_pretrain_b32_1s": "cpc_loss_ms.train"}[cell]
    # the CPU has no device trace: only host-side readings are reported
    assert stage in out["metrics"] and not any(k.startswith("idle_pct") for k in out["metrics"])


def test_the_same_seed_gives_the_same_inputs():
    t = TINY["stereo_infer_b64_20s"]["traffic"] | harness.load_json("workloads", "stereo_infer_b64_20s")["traffic"]
    a = traffic.dialogs(traffic.generator("cpu", harness.seed_word(2 ** 31 + 9, 2)), 2, 10, t, "cpu", 100)
    b = traffic.dialogs(traffic.generator("cpu", harness.seed_word(2 ** 31 + 9, 2)), 2, 10, t, "cpu", 100)
    c = traffic.dialogs(traffic.generator("cpu", harness.seed_word(2 ** 31 + 10, 2)), 2, 10, t, "cpu", 100)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 2, 3200) and a[1].shape == (2, 110, 2)


# ---------------------------------------------------------------- faults --
def _halve_vap_loss(monkeypatch):
    from voiceactivityprojection_tpu_torch.train import step

    real = step.loss_fn

    def half(net, batch, conf, generator=None, shard=None):
        rows = len(batch["waveform"]) // 2
        return real(net, {k: v[:rows] for k, v in batch.items()}, conf, generator, shard)

    monkeypatch.setattr(step, "loss_fn", half)


def _halve_cpc_loss(monkeypatch):
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain

    real = cpc_pretrain.cpc_loss

    def half(encoder, heads, waveform, neg_idx, n_predicts=12):
        rows = len(waveform) // 2
        T = cpc_pretrain.encoded_frames(waveform.shape[1])
        return real(encoder, heads, waveform[:rows], neg_idx[:rows] % (rows * T), n_predicts)

    monkeypatch.setattr(cpc_pretrain, "cpc_loss", half)


def _freeze_optimizer(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _alter_probs(monkeypatch):
    from voiceactivityprojection_tpu_torch.models import vap

    real = vap.probs_from_logits

    def altered(*a, **k):
        out = real(*a, **k)
        out["p_now"] = out["p_now"] + 0.01
        return out

    monkeypatch.setattr(vap, "probs_from_logits", altered)


def _alter_tick(monkeypatch):
    from voiceactivityprojection_tpu_torch.inference import streaming_kv

    real = streaming_kv._frame_step

    def altered(*a, **k):
        out = real(*a, **k)
        out["p_now"] = out["p_now"] + 0.01
        return out

    monkeypatch.setattr(streaming_kv, "_frame_step", altered)


def _stale_stream_state(monkeypatch):
    """A tick that leaves the streamer's state as it found it: the rings
    unwritten and the encoder's carry not advanced."""
    from voiceactivityprojection_tpu_torch.inference import streaming_kv
    from voiceactivityprojection_tpu_torch.models import encoder_streaming_exact as exact

    real = exact._run_pipeline

    def stale(enc, x, state, prime):
        return real(enc, x, state, prime)[0], state

    monkeypatch.setattr(streaming_kv, "_write_ring", lambda ring, new, pos: ring)
    monkeypatch.setattr(exact, "_run_pipeline", stale)


FAULTS = {
    "stereo_infer_b64_20s": {"answer altered": _alter_probs},
    "cpc_pretrain_b32_1s": {"state unchanged": _freeze_optimizer, "half the batch": _halve_cpc_loss},
    "stereo_train_frozen_b16_20s": {"state unchanged": _freeze_optimizer, "half the batch": _halve_vap_loss},
    "stereo_stream_kv_s512": {"state unchanged": _stale_stream_state, "answer altered": _alter_tick},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------- counts --
def test_the_counts_equal_hand_values():
    assert flops.stereo_forward_flops(320_000)["total"] == pytest.approx(74.55e9, rel=1e-3)
    train = flops.stereo_train_flops(320_000)
    assert train["forward"] == pytest.approx(74.5e9, rel=1e-3)
    assert train["backward"] == pytest.approx(43.7e9, rel=1e-3)
    assert train["flash_recompute"] == pytest.approx(7.2e9, rel=5e-3)
    assert flops.kv_ring_bytes_per_dialog(1000) == 14 * 2 * 4 * 1000 * 64 * 4 == 28_672_000
    assert flops.kv_tick(1024, 1000)["ring_bytes"] == 1024 * 28_672_000
    # K1 at the inference call's rows: conv1 dominates, 2 * 64000 * 8 * 256 * 256 a row
    assert flops.conv_stack_kernel(128, 320_000)["flops"] == pytest.approx(3.129e12, rel=1e-3)
    assert peaks.least_seconds(495e12, 0.0, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12, "bfloat16") == pytest.approx(1.0)


# ------------------------------------------------------------------ run.py --
def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "vapbench" / "run.py"), "--workload", "stereo_infer_b64_20s",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_run_refuses_an_unknown_cell():
    proc = subprocess.run([sys.executable, str(ROOT / "vapbench" / "run.py"), "--workload", "no_such_cell",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout

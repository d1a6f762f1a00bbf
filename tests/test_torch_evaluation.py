"""PyTorch port, the evaluation harness (``train/evaluation.py``) against
the JAX package on the same numpy inputs: the threshold curves and search
exact; ``EvaluationCollector`` on seeded logits (pooled predictions within
2e-6, targets, regions and the balance debt exact, metrics equal apart
from predictions within 2e-6 of a threshold, ``tests/_torch_eval.py``),
with 0.5 rounding and with transferred thresholds; and the files ``save``
writes."""

import csv
import json

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.train import evaluation as jeval
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch.train import evaluation as teval

from _torch_eval import compare_evaluations, dialog_vad, pooled, recording

pytestmark = pytest.mark.evaluation

BAR = 2e-6


def _curves_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["random", "separable", "one_class", "ties", "grid"])
def test_curves_and_threshold_equal_jax(case):
    rng = np.random.default_rng(0)
    preds = rng.random(400)
    targets = (rng.random(400) < 0.3).astype(np.int64)
    if case == "separable":
        preds = np.where(targets == 1, 0.6 + 0.4 * preds, 0.4 * preds)
    elif case == "one_class":
        targets[:] = 1
    elif case == "ties":
        preds = np.round(preds, 1)  # many predictions on grid points
    thresholds = np.linspace(0.1, 0.9, 7) if case == "grid" else None
    _curves_equal(teval.get_curves(preds, targets, thresholds), jeval.get_curves(preds, targets, thresholds))
    for metric in ("f1_weighted", "balanced_accuracy", "precision", "recall"):
        thr, curves = teval.find_threshold(preds, targets, metric)
        jthr, jcurves = jeval.find_threshold(preds, targets, metric)
        assert thr == jthr
        _curves_equal(curves, jcurves)


def _batches(seed, n=3, scale=2.0):
    """Seeded logits and dialogue VAD, a smaller tail batch last. At scale
    2 the predictions spread over (0, 1); at 1e-3, as from seeded weights,
    they lie within about 1e-4 of 0.5, some within the bar of it."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        B = 4 if i < n - 1 else 2
        logits = (scale * rng.standard_normal((B, 1000, 256))).astype(np.float32)
        out.append((logits, dialog_vad(rng, B=B), float(rng.random()), float(rng.random())))
    return out


@pytest.mark.parametrize("thresholds", [None, {"hs": 0.45, "pred_shift": 0.55, "ls": 0.5}])
@pytest.mark.parametrize("seed, scale", [(0, 2.0), (1, 2.0), (2, 1e-3)])
def test_collector_matches_jax(seed, scale, thresholds):
    batches = _batches(seed, scale=scale)
    with recording(teval) as t_seen, recording(jeval) as j_seen:
        t = teval.EvaluationCollector(tconfig.EventConfig(), seed=0, thresholds=thresholds)
        j = jeval.EvaluationCollector(jconfig.EventConfig(), seed=0, thresholds=thresholds)
    for logits, vad, l1, l2 in batches:
        t.update(torch.from_numpy(logits), vad, l1, l2)
        j.update(logits, vad, l1, l2)
    assert t.events == j.events and t.debts == j.debts
    got, want = t.compute(), j.compute()
    report = compare_evaluations(got, want, pooled(t), pooled(j), BAR, BAR, thresholds)
    assert not report["mismatches"], report
    assert set(pooled(t)) == {"hs", "pred_shift", "ls"}
    assert t.vap_losses == j.vap_losses and len(t_seen) == len(j_seen) == 1
    if scale < 1 and thresholds is None:  # the flip allowance is exercised
        assert report["near"]["test_hs_f1w"] > 0


def test_comparison_catches_a_metric_moved_without_cause():
    """The comparison is not vacuous: a metric changed with no prediction
    near its threshold, a prediction moved past the bar, and a target
    changed are each reported."""
    batches = _batches(0)
    t = teval.EvaluationCollector(tconfig.EventConfig())
    for logits, vad, l1, l2 in batches:
        t.update(torch.from_numpy(logits), vad, l1, l2)
    got, mine = t.compute(), pooled(t)
    assert not compare_evaluations(got, dict(got), mine, mine, BAR, BAR)["mismatches"]
    moved = dict(got, test_ls_acc_0=got["test_ls_acc_0"] + 0.01)
    assert compare_evaluations(moved, got, mine, mine, BAR, BAR)["mismatches"]
    p, tg = mine["hs"]
    shifted = dict(mine, hs=(p + 1e-5, tg))
    assert compare_evaluations(got, got, shifted, mine, BAR, BAR)["mismatches"]
    flipped = dict(mine, hs=(p, 1 - tg))
    assert compare_evaluations(got, got, flipped, mine, BAR, BAR)["mismatches"]


def test_collector_without_threshold_search_and_losses():
    batches = _batches(2, n=2)
    t = teval.EvaluationCollector(tconfig.EventConfig())
    j = jeval.EvaluationCollector(jconfig.EventConfig())
    for logits, vad, _, _ in batches:
        t.update(torch.from_numpy(logits), vad)
        j.update(logits, vad)
    got, want = t.compute(threshold_search=False), j.compute(threshold_search=False)
    assert list(got) == list(want) and np.isnan(got["test_loss"]) and np.isnan(want["test_loss"])
    assert not any(k.startswith("threshold_") for k in got) and t.curves == {}


def test_threshold_transfer_matches_jax():
    """Thresholds found by one collector's search, applied by a second
    collector to the same batches: the metrics binarise at them."""
    batches = _batches(3)
    search = teval.EvaluationCollector(tconfig.EventConfig())
    for logits, vad, l1, l2 in batches:
        search.update(torch.from_numpy(logits), vad, l1, l2)
    found = {k[len("threshold_"):]: v for k, v in search.compute().items() if k.startswith("threshold_")}
    assert set(found) == {"hs", "pred_shift", "ls"}
    t = teval.EvaluationCollector(tconfig.EventConfig(), thresholds=found)
    j = jeval.EvaluationCollector(jconfig.EventConfig(), thresholds=found)
    for logits, vad, l1, l2 in batches:
        t.update(torch.from_numpy(logits), vad, l1, l2)
        j.update(logits, vad, l1, l2)
    got, want = t.compute(threshold_search=False), j.compute(threshold_search=False)
    report = compare_evaluations(got, want, pooled(t), pooled(j), BAR, BAR, found)
    assert not report["mismatches"], report
    p, tg = pooled(t)["hs"]
    acc1 = float(((p >= found["hs"]).astype(int)[tg == 1] == 1).mean())
    assert got["test_hs_acc_1"] == pytest.approx(acc1)


def test_save_writes_the_files_jax_writes(tmp_path):
    batches = _batches(4, n=2)
    cols = {}
    for name, module, conf, wrap in (("port", teval, tconfig, torch.from_numpy), ("jax", jeval, jconfig, None)):
        c = module.EvaluationCollector(conf.EventConfig())
        for logits, vad, l1, l2 in batches:
            c.update(wrap(logits) if wrap else logits, vad, l1, l2)
        result = c.compute()
        c.save(str(tmp_path / name), result)
        with open(tmp_path / name / "metrics.csv") as f:
            rows = list(csv.reader(f))
        assert len(rows) == 2 and rows[0] == list(result)
        assert [float(v) for v in rows[1]] == [float(v) for v in result.values()]
        cols[name] = rows[0]
        with open(tmp_path / name / "thresholds.json") as f:
            assert json.load(f) == {k[len("threshold_"):]: v for k, v in result.items() if k.startswith("threshold_")}
        with np.load(tmp_path / name / "curves.npz") as z:
            cols[name + "_npz"] = sorted(z.files)
            assert z["hs_thresholds"].shape == (101,)
    assert cols["port"] == cols["jax"] and cols["port_npz"] == cols["jax_npz"]
    # the curve PNGs, as JAX's (none where matplotlib is missing, in both)
    assert sorted(p.name for p in (tmp_path / "port").glob("*.png")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    # without a search: metrics.csv only
    c = teval.EvaluationCollector(tconfig.EventConfig())
    c.update(torch.from_numpy(batches[0][0]), batches[0][1])
    c.save(str(tmp_path / "plain"), c.compute(threshold_search=False))
    assert sorted(p.name for p in (tmp_path / "plain").iterdir()) == ["metrics.csv"]

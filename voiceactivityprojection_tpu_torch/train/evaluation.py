"""Test-split evaluation: event metrics and the decision-threshold search
(JAX: train/evaluation.py; reference vap/evaluation.py).

* ``evaluate`` runs the eval step over a loader on the model's device,
  extracts the turn-taking events from each batch's VAD on the host, pools
  the predictions in each event region by family, and writes the metrics.
* ``get_curves`` / ``find_threshold`` sweep 101 decision thresholds over a
  family's pooled predictions: weighted F1, balanced accuracy, precision
  and recall, and the best-F1 threshold.

Per batch, ``get_probs`` runs on the logits' device and only ``p_now`` and
``p_future`` (B, T, 2) come to the host, not the (B, T, 256) logits.
"""

from __future__ import annotations

import csv
import itertools
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.events.events import TurnTakingEvents
from voiceactivityprojection_tpu_torch.events.metrics import EventMetrics, extract_prediction_and_targets
from voiceactivityprojection_tpu_torch.ops.codebook import get_probs
from voiceactivityprojection_tpu_torch.train.step import make_eval_step
from voiceactivityprojection_tpu_torch.utils.io import write_json


def _confusion(preds_bin: np.ndarray, targets: np.ndarray) -> Tuple[int, int, int, int]:
    tp = int(((preds_bin == 1) & (targets == 1)).sum())
    tn = int(((preds_bin == 0) & (targets == 0)).sum())
    fp = int(((preds_bin == 1) & (targets == 0)).sum())
    fn = int(((preds_bin == 0) & (targets == 1)).sum())
    return tp, tn, fp, fn


def get_curves(
    preds: np.ndarray, targets: np.ndarray, thresholds: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """Per threshold (default 0.00, 0.01, ..., 1.00; a prediction at or
    above it is class 1): weighted F1, balanced accuracy, and class 1's
    precision and recall."""
    if thresholds is None:
        thresholds = np.linspace(0.0, 1.0, 101)
    f1w, bacc, prec, rec = [], [], [], []
    targets = np.asarray(targets).astype(np.int64)
    n0 = int((targets == 0).sum())
    n1 = int((targets == 1).sum())
    for t in thresholds:
        pb = (np.asarray(preds) >= t).astype(np.int64)
        tp, tn, fp, fn = _confusion(pb, targets)
        p1 = tp / (tp + fp) if tp + fp else 0.0
        r1 = tp / (tp + fn) if tp + fn else 0.0
        f1_1 = 2 * p1 * r1 / (p1 + r1) if p1 + r1 else 0.0
        p0 = tn / (tn + fn) if tn + fn else 0.0
        r0 = tn / (tn + fp) if tn + fp else 0.0
        f1_0 = 2 * p0 * r0 / (p0 + r0) if p0 + r0 else 0.0
        total = n0 + n1
        f1w.append((f1_0 * n0 + f1_1 * n1) / total if total else 0.0)
        bacc.append((r0 + r1) / 2)
        prec.append(p1)
        rec.append(r1)
    return {
        "thresholds": thresholds,
        "f1_weighted": np.asarray(f1w),
        "balanced_accuracy": np.asarray(bacc),
        "precision": np.asarray(prec),
        "recall": np.asarray(rec),
    }


def find_threshold(
    preds: np.ndarray, targets: np.ndarray, metric: str = "f1_weighted"
) -> Tuple[float, Dict[str, np.ndarray]]:
    """The threshold with the best ``metric`` (the first of equals) and the
    curves."""
    curves = get_curves(preds, targets)
    best = int(np.argmax(curves[metric]))
    return float(curves["thresholds"][best]), curves


class EvaluationCollector:
    """Pools each event family's region predictions over the test split,
    for the fixed-threshold metrics and the threshold search."""

    FAMILIES = ("hs", "pred_shift", "ls", "pred_backchannel")

    def __init__(self, event_conf=None, seed: int = 0, thresholds: Optional[Dict[str, float]] = None):
        """``thresholds`` (family -> decision threshold, as in
        thresholds.json) replaces the metrics' 0.5 rounding: thresholds
        found on one split, applied on another."""
        self.event_extractor = TurnTakingEvents(event_conf, seed=seed)
        self.metrics = EventMetrics(thresholds)
        self.pooled: Dict[str, List[np.ndarray]] = {f: [] for f in self.FAMILIES}
        self.pooled_t: Dict[str, List[np.ndarray]] = {f: [] for f in self.FAMILIES}
        self.vap_losses: List[float] = []
        self.vad_losses: List[float] = []
        self.curves: Dict[str, Dict[str, np.ndarray]] = {}

    def update(self, logits: torch.Tensor, vad: np.ndarray,
               vap_loss: float = float("nan"), vad_loss: float = float("nan")) -> None:
        """One batch: ``logits`` (B, T, 256) on any device, ``vad`` (B, N, 2)
        the ground truth on the host."""
        events = self.event_extractor(vad)
        probs = get_probs(torch.as_tensor(logits).float())
        p_now, p_fut = (probs[k].cpu().numpy() for k in ("p_now", "p_future"))
        preds, targets = extract_prediction_and_targets(p_now, p_fut, events)
        self.metrics.update(preds, targets)
        for fam in self.FAMILIES:
            if preds.get(fam) is not None:
                self.pooled[fam].append(preds[fam])
                self.pooled_t[fam].append(targets[fam])
        self.vap_losses.append(vap_loss)
        self.vad_losses.append(vad_loss)

    def compute(self, threshold_search: bool = True) -> Dict[str, float]:
        def _mean_known(xs: List[float]) -> float:
            # NaN stands for a batch without losses; none at all is NaN
            known = [x for x in xs if not np.isnan(x)]
            return float(np.mean(known)) if known else float("nan")

        out: Dict[str, float] = {
            "test_loss": _mean_known(self.vap_losses),
            "test_loss_va": _mean_known(self.vad_losses),
        }
        out.update({f"test_{k}": v for k, v in self.metrics.compute().items()})
        self.curves = {}
        if threshold_search:
            for fam in self.FAMILIES:
                if self.pooled[fam]:
                    thr, curves = find_threshold(np.concatenate(self.pooled[fam]),
                                                 np.concatenate(self.pooled_t[fam]))
                    out[f"threshold_{fam}"] = thr
                    out[f"best_f1w_{fam}"] = float(curves["f1_weighted"].max())
                    self.curves[fam] = curves
        return out

    def save(self, out_dir: str, result: Dict[str, float]) -> None:
        """``metrics.csv`` (one header row, one value row), ``thresholds.json``
        and ``curves.npz`` (``<family>_<curve>`` arrays) when the search
        ran, with a ``curves_<family>.png`` each where matplotlib imports
        (best effort, as the JAX package's: no figure, no error, without
        it)."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(result))
            w.writerow([result[k] for k in result])
        thresholds = {k.replace("threshold_", ""): v for k, v in result.items() if k.startswith("threshold_")}
        if thresholds:
            write_json(thresholds, os.path.join(out_dir, "thresholds.json"))
        if self.curves:
            np.savez(
                os.path.join(out_dir, "curves.npz"),
                **{f"{fam}_{key}": arr for fam, cur in self.curves.items() for key, arr in cur.items()},
            )
            try:
                from voiceactivityprojection_tpu_torch.utils.plot import plot_threshold_curves

                for fam, cur in self.curves.items():
                    plot_threshold_curves(cur, savepath=os.path.join(out_dir, f"curves_{fam}.png"), title=fam)
            except Exception:
                pass  # the figures are best effort (no matplotlib on the card's machine)


def evaluate(
    model,
    test_loader,
    event_conf=None,
    out_dir: str = "eval",
    limit_batches: Optional[int] = None,
    threshold_search: bool = True,
    thresholds: Optional[Dict[str, float]] = None,
    timings: Optional[Dict[str, float]] = None,
    phrase_probe=None,
) -> Dict[str, float]:
    """The test split through ``model`` (a ``VapModel``, on its device):
    losses, event metrics and, under ``threshold_search``, each family's
    best threshold, saved under ``out_dir``. ``thresholds`` (as loaded from
    a thresholds.json) applies thresholds found on another split.
    ``phrase_probe`` (a ``data/phrases.PhraseProbe``) also runs the phrase
    corpus through the model and merges each region mean into the metrics
    as ``test_<name>`` (JAX: evaluation.py:185-215). A ``timings`` dict,
    when given, receives the host-clock seconds of each stage:
    ``loader_wait_s``, ``eval_step_s`` (to the read of the batch's losses),
    ``events_metrics_s``, ``threshold_search_s``, ``phrase_probe_s``,
    ``save_s``."""
    stages = dict.fromkeys(("loader_wait_s", "eval_step_s", "events_metrics_s", "threshold_search_s",
                            "phrase_probe_s", "save_s"), 0.0)
    eval_step = make_eval_step(model.conf)
    collector = EvaluationCollector(event_conf, thresholds=thresholds)
    t0 = time.perf_counter()
    for batch in itertools.islice(test_loader, limit_batches or None):
        t1 = time.perf_counter()
        stages["loader_wait_s"] += t1 - t0
        out = eval_step(model.net, batch)
        vap_loss, vad_loss = torch.stack([out["vap_loss"], out["vad_loss"]]).float().tolist()
        t2 = time.perf_counter()
        stages["eval_step_s"] += t2 - t1
        collector.update(out["logits"], batch["vad"], vap_loss, vad_loss)
        t0 = time.perf_counter()
        stages["events_metrics_s"] += t0 - t2
    t0 = time.perf_counter()
    result = collector.compute(threshold_search)
    t1 = time.perf_counter()
    stages["threshold_search_s"] = t1 - t0
    if phrase_probe is not None:
        means, _ = phrase_probe.extract_stats(model)
        result.update({f"test_{k}": float(v) for k, v in means.items()})
        stages["phrase_probe_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    collector.save(out_dir, result)
    stages["save_s"] = time.perf_counter() - t1
    if timings is not None:
        timings.update(stages)
    return result

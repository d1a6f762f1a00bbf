"""Event-region prediction/target extraction + classification metrics.

Counterpart of ``voiceactivityprojection_tpu/events/metrics.py``, host-side
NumPy.

`extract_prediction_and_targets` mirrors vap/objective.py:283-382: slices
p_now/p_future over event regions into flat prediction/target vectors per
event family (hs, pred_shift, ls, pred_backchannel; Holds=0/Shifts=1).

`BinaryClassMetrics` replaces torchmetrics Accuracy/F1 (multiclass-2,
per-class accuracy + weighted F1, vap/train.py:260-301) with a small
host-side confusion-matrix accumulator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

Region = Tuple[int, int, int]
BatchRegions = List[List[Region]]


def extract_prediction_and_targets(
    p_now: np.ndarray,
    p_fut: np.ndarray,
    events: Dict[str, BatchRegions],
    p_bc: Optional[np.ndarray] = None,
) -> Tuple[Dict[str, Optional[np.ndarray]], Dict[str, Optional[np.ndarray]]]:
    p_now = np.asarray(p_now)
    p_fut = np.asarray(p_fut)
    batch_size = len(events["hold"])

    preds: Dict[str, list] = {k: [] for k in ("hs", "pred_shift", "ls", "pred_backchannel")}
    targets: Dict[str, list] = {k: [] for k in ("hs", "pred_shift", "ls", "pred_backchannel")}

    for b in range(batch_size):
        # Hold=0 / Shift=1 (vap/objective.py:296-311)
        for s, e, spk in events["shift"][b]:
            p = p_now[b, s:e, spk]
            preds["hs"].append(p)
            targets["hs"].append(np.ones_like(p))
        for s, e, spk in events["hold"][b]:
            p = 1 - p_now[b, s:e, spk]
            preds["hs"].append(p)
            targets["hs"].append(np.zeros_like(p))
        # Shift prediction (vap/objective.py:313-325)
        for s, e, spk in events["pred_shift"][b]:
            p = p_fut[b, s:e, spk]
            preds["pred_shift"].append(p)
            targets["pred_shift"].append(np.ones_like(p))
        for s, e, spk in events["pred_shift_neg"][b]:
            p = 1 - p_fut[b, s:e, spk]
            preds["pred_shift"].append(p)
            targets["pred_shift"].append(np.zeros_like(p))
        # Backchannel prediction (zero-shot path, vap/zero_shot.py:317-330)
        if p_bc is not None:
            for s, e, spk in events.get("pred_backchannel", [[]] * batch_size)[b]:
                p = p_bc[b, s:e, spk]
                preds["pred_backchannel"].append(p)
                targets["pred_backchannel"].append(np.ones_like(p))
            for s, e, spk in events.get("pred_backchannel_neg", [[]] * batch_size)[b]:
                p = p_bc[b, s:e, spk]
                preds["pred_backchannel"].append(p)
                targets["pred_backchannel"].append(np.zeros_like(p))
        # Long/Short (vap/objective.py:349-366): both use raw p_fut
        for s, e, spk in events["long"][b]:
            p = p_fut[b, s:e, spk]
            preds["ls"].append(p)
            targets["ls"].append(np.ones_like(p))
        for s, e, spk in events["short"][b]:
            p = p_fut[b, s:e, spk]
            preds["ls"].append(p)
            targets["ls"].append(np.zeros_like(p))

    out_p: Dict[str, Optional[np.ndarray]] = {}
    out_t: Dict[str, Optional[np.ndarray]] = {}
    for k in preds:
        if preds[k]:
            out_p[k] = np.concatenate(preds[k])
            out_t[k] = np.concatenate(targets[k]).astype(np.int64)
        else:
            out_p[k] = None
            out_t[k] = None
    return out_p, out_t


class BinaryClassMetrics:
    """Confusion-matrix accumulator: per-class accuracy + weighted F1
    (torchmetrics semantics used at vap/train.py:262-301)."""

    def __init__(self):
        self.cm = np.zeros((2, 2), dtype=np.int64)  # [target, pred]

    def update(
        self, probs: np.ndarray, targets: np.ndarray,
        threshold: Optional[float] = None,
    ) -> None:
        # default mirrors the reference, which rounds probs before update
        # (vap/train.py:306-308); an explicit threshold binarizes at
        # probs >= threshold — the find-on-val / apply-at-test transfer
        # flow (reference evaluation.py:144-232 thresholds usage)
        if threshold is None:
            preds = np.rint(np.asarray(probs)).astype(np.int64).clip(0, 1)
        else:
            preds = (np.asarray(probs) >= threshold).astype(np.int64)
        targets = np.asarray(targets).astype(np.int64).ravel()
        self.cm += np.bincount(
            2 * targets + preds.ravel(), minlength=4
        ).reshape(2, 2)

    def reset(self) -> None:
        self.cm[:] = 0

    @property
    def support(self) -> np.ndarray:
        return self.cm.sum(axis=1)

    def accuracy(self) -> np.ndarray:
        """Per-class recall-style accuracy (torchmetrics average='none')."""
        sup = self.support
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = np.diag(self.cm) / sup
        return np.where(sup > 0, acc, 0.0)

    def f1_weighted(self) -> float:
        f1s = []
        for c in (0, 1):
            tp = self.cm[c, c]
            fp = self.cm[1 - c, c]
            fn = self.cm[c, 1 - c]
            denom = 2 * tp + fp + fn
            f1s.append(2 * tp / denom if denom > 0 else 0.0)
        sup = self.support
        total = sup.sum()
        if total == 0:
            return 0.0
        return float((np.asarray(f1s) * sup).sum() / total)


class EventMetrics:
    """Groups per-event-family metrics (hs/ls/sp/bp), mirrors
    VAPModel.get_metrics/metrics_step (vap/train.py:260-330)."""

    FAMILIES = ("hs", "ls", "sp", "bp")
    KEYMAP = {"hs": "hs", "ls": "ls", "sp": "pred_shift", "bp": "pred_backchannel"}

    def __init__(self, thresholds: Optional[Dict[str, float]] = None):
        """`thresholds` maps event-family names (either the short hs/ls/
        sp/bp or the pooled names hs/ls/pred_shift/pred_backchannel, i.e.
        thresholds.json keys) to decision thresholds; families absent
        from the dict keep the reference's 0.5 rounding."""
        self.metrics = {f: BinaryClassMetrics() for f in self.FAMILIES}
        self.thresholds: Dict[str, float] = {}
        for k, v in (thresholds or {}).items():
            short = {v2: k2 for k2, v2 in self.KEYMAP.items()}.get(k, k)
            if short not in self.FAMILIES:
                raise ValueError(f"unknown event family in thresholds: {k!r}")
            self.thresholds[short] = float(v)

    def update(self, preds: Dict[str, Optional[np.ndarray]],
               targets: Dict[str, Optional[np.ndarray]]) -> None:
        for fam in self.FAMILIES:
            key = self.KEYMAP[fam]
            if preds.get(key) is not None:
                self.metrics[fam].update(
                    preds[key], targets[key],
                    threshold=self.thresholds.get(fam),
                )

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for fam in self.FAMILIES:
            m = self.metrics[fam]
            acc = m.accuracy()
            out[f"{fam}_f1w"] = m.f1_weighted()
            out[f"{fam}_acc_0"] = float(acc[0])
            out[f"{fam}_acc_1"] = float(acc[1])
        return out

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()

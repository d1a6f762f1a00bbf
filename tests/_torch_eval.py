"""Two evaluations of one test split compared (the port against the JAX
package on the CPU, or the port on the card against the port on the CPU).
Imports no JAX, so ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` use
it too.

Predictions may differ within ``bar``; a metric then differs only where a
prediction lies within ``bar`` of a decision threshold (0.5, a transferred
threshold, a point of the 101-point search grid): there the decision may
flip. Such a metric is held to the port's own metric code on that side's
pooled predictions, and the confusion matrices may differ by at most the
count of those predictions. Every other metric must be equal.
"""

import contextlib

import numpy as np

from voiceactivityprojection_tpu_torch.events.metrics import BinaryClassMetrics, EventMetrics
from voiceactivityprojection_tpu_torch.train.evaluation import find_threshold

GRID = np.linspace(0.0, 1.0, 101)
FAMILY_OF = {"hs": "hs", "ls": "ls", "sp": "pred_shift", "bp": "pred_backchannel"}


@contextlib.contextmanager
def recording(module):
    """While open, ``module.EvaluationCollector`` (of either package)
    records every collector it makes in ``seen``, and each batch's events
    and balance debt in the collector's ``events`` and ``debts``."""
    base = module.EvaluationCollector
    seen = []

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.events, self.debts = [], []
            extract = self.event_extractor

            def record(vad, *args, **kws):
                out = extract(vad, *args, **kws)
                self.events.append(out)
                self.debts.append(dict(extract.add_extra))
                return out

            self.event_extractor = record
            seen.append(self)

    module.EvaluationCollector = Recording
    try:
        yield seen
    finally:
        module.EvaluationCollector = base


def dialog_vad(rng, B=4, T=1100):
    """Seeded two-speaker VAD with turns, pauses, overlaps and short
    backchannels (frames at 50 Hz), the structure the event templates
    look for."""
    vad = np.zeros((B, T, 2), dtype=np.float32)
    for b in range(B):
        t, ch = 0, int(rng.integers(2))
        while t < T:
            dur = int(rng.integers(30, 220))
            vad[b, t : t + dur, ch] = 1.0
            if rng.random() < 0.35 and dur > 90:  # backchannel of the other
                bt = t + int(rng.integers(20, dur - 50))
                vad[b, bt : bt + int(rng.integers(5, 40)), 1 - ch] = 1.0
            gap = int(rng.integers(-10, 45))
            t += dur + gap
            if rng.random() < 0.6:
                ch = 1 - ch
    return vad


def pooled(collector):
    """Each family's pooled predictions and targets, concatenated."""
    return {f: (np.concatenate(collector.pooled[f]), np.concatenate(collector.pooled_t[f]))
            for f in collector.FAMILIES if collector.pooled[f]}


def near(preds, thresholds, bar):
    """How many predictions lie within ``bar`` of any of ``thresholds``."""
    d = np.abs(np.asarray(preds, np.float64)[:, None] - np.asarray(thresholds, np.float64)[None])
    return int((d <= bar).any(1).sum())


def _cm(preds, targets, thr):
    m = BinaryClassMetrics()
    m.update(preds, targets, threshold=thr)
    return m.cm


def compare_evaluations(got, want, got_pooled, want_pooled, bar, loss_bar, thresholds=None):
    """Compares two ``evaluate`` results and their pooled predictions.
    Returns ``{"mismatches": [...], "max_abs_err": {...}, "near": {...}}``:
    agreement is an empty list of mismatches."""
    bad, err, close = [], {}, {}
    if list(got) != list(want):
        bad.append(f"keys {list(got)} != {list(want)}")
    if set(got_pooled) != set(want_pooled):
        bad.append(f"families {sorted(got_pooled)} != {sorted(want_pooled)}")
    for fam in set(got_pooled) & set(want_pooled):
        (gp, gt), (wp, wt) = got_pooled[fam], want_pooled[fam]
        if gt.shape != wt.shape or not np.array_equal(gt, wt):
            bad.append(f"{fam}: targets differ")
            continue
        err[fam] = float(np.abs(gp.astype(np.float64) - wp).max())
        if err[fam] > bar:
            bad.append(f"{fam}: predictions differ by {err[fam]} > {bar}")
    thr_of = EventMetrics(thresholds).thresholds
    for key in set(got) & set(want):
        g, w = got[key], want[key]
        if key in ("test_loss", "test_loss_va"):
            err[key] = abs(g - w)
            if not err[key] <= loss_bar:
                bad.append(f"{key}: {g} vs {w}")
            continue
        if key.startswith("test_"):
            short = key.split("_")[1]
            fam, thr = FAMILY_OF[short], thr_of.get(short)
            n = near(want_pooled[fam][0], [0.5 if thr is None else thr], bar) if fam in want_pooled else 0
            close[key] = n
            if g == w:
                continue
            if n == 0:
                bad.append(f"{key}: {g} vs {w} with no prediction within {bar} of the threshold")
                continue
            em = EventMetrics(thresholds)
            em.update({fam: got_pooled[fam][0]}, {fam: got_pooled[fam][1]})
            flips = int(np.abs(_cm(*got_pooled[fam], thr)[:, 1] - _cm(*want_pooled[fam], thr)[:, 1]).sum())
            if em.compute()[key[len("test_"):]] != g or flips > n:
                bad.append(f"{key}: {g} vs {w}, {flips} flipped decisions, {n} allowed")
            continue
        fam = key.split("_", 2)[-1] if key.startswith("best_f1w_") else key[len("threshold_"):]
        n = near(want_pooled[fam][0], GRID, bar)
        close[key] = n
        if g == w:
            continue
        thr_g, curves_g = find_threshold(*got_pooled[fam])
        mine = thr_g if key.startswith("threshold_") else float(curves_g["f1_weighted"].max())
        if n == 0 or mine != g:
            bad.append(f"{key}: {g} vs {w}, {n} predictions within {bar} of a grid point")
    return {"mismatches": bad, "max_abs_err": err, "near": close}

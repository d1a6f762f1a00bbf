"""The SIGDIAL-2022 directionality analysis of the phrase probes (JAX:
analyzes/phrases_directionality.py; reference
vap/phrases/evaluation_phrases.py:290-379).

    python -m voiceactivityprojection_tpu_torch.analyzes.phrases_directionality
        --scores phrases_eval/phrases_scores.csv [--out directionality.json]
        [--voices all|heldout|train] [--phrases_root ROOT] [--device cuda|cpu]

Turns ``evaluate_phrases``' per-sample CSV into the test that the model
reads prosody: for each permutation every (phrase, long_short, gender,
phrase_idx) sample is paired with its own regular rendition, and the mean
paired difference in shift probability a region is given with a bootstrap
95 % CI and a two-sided sign test; then the verdicts against the expected
ordering (flattening F0, intensity or durations should lower the shift
probability around the end of the turn; shifting F0 up or down should do
about nothing; ``only_f0`` is a control without a signed expectation).

``--voices heldout`` keeps the samples of the voices the pseudo-dialog
corpus generator holds out of training (``tools/make_phrases_dialog_corpus.py``
``VAL_VOICES``), mapped to (gender, phrase_idx) through the corpus CSV's
``tts`` column (read by ``data/phrases.py``); ``train`` keeps the others.
The analysis is numpy on the host; ``--device`` is resolved as every entry
point's (the card by default: without one it raises). ``analyze`` returns
the report that ``--out`` writes.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
from math import comb
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.utils.device import resolve_device

FALLBACK_HELDOUT = {("female", "4"), ("male", "4")}  # Wavenet-F / -D in the reference corpus


def load_rows(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f))


def paired_diffs(rows, perm: str, region: str) -> np.ndarray:
    """Per-sample (permutation - regular) differences for one region."""
    key = lambda r: (r["phrase"], r["long_short"], r["gender"], r["phrase_idx"])
    reg = {key(r): r for r in rows if r["permutation"] == "regular"}
    out = []
    for r in rows:
        if r["permutation"] != perm:
            continue
        base = reg.get(key(r))
        if base is None:
            continue
        try:
            a, b = float(r.get(region, "")), float(base.get(region, ""))
        except ValueError:
            continue
        if math.isnan(a) or math.isnan(b):
            continue
        out.append(a - b)
    return np.asarray(out)


def bootstrap_ci(d: np.ndarray, n: int = 2000, seed: int = 0) -> Tuple[float, float]:
    rng = np.random.default_rng(seed)
    means = np.sort(rng.choice(d, size=(n, len(d)), replace=True).mean(axis=1))
    return float(means[int(0.025 * n)]), float(means[int(0.975 * n)])


def sign_test_p(d: np.ndarray) -> float:
    """Two-sided sign test (binomial, ties dropped)."""
    nz = d[d != 0]
    n = len(nz)
    if n == 0:
        return 1.0
    k = int((nz < 0).sum())
    tail = sum(comb(n, j) for j in range(min(k, n - k) + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def heldout_keys(phrases_root: str = "") -> Set[Tuple[str, str]]:
    """(gender, phrase_idx) pairs of the voices in ``VAL_VOICES``, from the
    corpus CSV's ``tts`` column, so that an edit of ``VAL_VOICES`` cannot
    desynchronize the split. Where the corpus is unreadable or holds none of
    those voices, the reference corpus's mapping (phrase_idx 4), with the
    reason printed, as JAX falls back."""
    from voiceactivityprojection_tpu_torch.data.phrases import DEFAULT_PHRASES_ROOT, PHRASE_CSV, load_phrase_dataframe
    from voiceactivityprojection_tpu_torch.tools.make_phrases_dialog_corpus import VAL_VOICES

    try:
        rows = load_phrase_dataframe(os.path.join(phrases_root or DEFAULT_PHRASES_ROOT, PHRASE_CSV))
        pairs = {(str(r["gender"]), str(r["phrase_idx"])) for r in rows if r["tts"] in VAL_VOICES}
        assert pairs, f"no corpus rows match VAL_VOICES={VAL_VOICES}"
        return pairs
    except (OSError, KeyError, ValueError, AssertionError) as e:
        print(f"# heldout_keys fallback (phrase_idx 4 = Wavenet-F/D): {e}")
        return set(FALLBACK_HELDOUT)


def select_voices(rows, voices: str, phrases_root: str = ""):
    if voices == "all":
        return rows
    held = heldout_keys(phrases_root)
    keep_held = voices == "heldout"
    return [r for r in rows if ((r["gender"], r["phrase_idx"]) in held) == keep_held]


def analyze(rows) -> Dict[str, Dict]:
    """``{"regions": {perm: {region: {n, mean, ci95, sign_p}}}, "verdicts":
    {...}}`` over the score rows, printing JAX's table and verdict lines."""
    perms = sorted({r["permutation"] for r in rows} - {"regular"})
    report: Dict[str, Dict] = {}
    print(f"{len(rows)} rows, permutations: {perms}\n")
    print(f"{'permutation':15s} {'region':16s} {'n':>4s} {'mean d':>9s} {'95% CI':>20s} {'sign-p':>8s}")
    for perm in perms:
        report[perm] = {}
        for region in ("now_pred", "future_pred", "now_react", "scp_now_pred"):
            d = paired_diffs(rows, perm, region)
            if len(d) < 5:
                continue
            lo, hi = bootstrap_ci(d)
            p = sign_test_p(d)
            report[perm][region] = {"n": int(len(d)), "mean": float(d.mean()), "ci95": [lo, hi], "sign_p": p}
            print(f"{perm:15s} {region:16s} {len(d):4d} {d.mean():+9.4f} [{lo:+8.4f}, {hi:+8.4f}] {p:8.2g}")

    print("\n--- directionality verdicts ---")
    verdicts = {}
    checks = (("flat_f0", "now_pred"), ("flat_f0", "now_react"), ("flat_intensity", "now_pred"),
              ("flat_intensity", "now_react"), ("duration_avg", "now_pred"), ("duration_avg", "now_react"))
    for perm, region in checks:
        r = report.get(perm, {}).get(region)
        if r is None:
            continue
        lo, hi = r["ci95"]
        status = ("CONFIRMED (CI < 0)" if hi < 0 else "directionally consistent (mean < 0, CI spans 0)"
                  if r["mean"] < 0 else "NOT OBSERVED (mean >= 0)")
        verdicts[f"{perm}/{region}"] = {"expected": "drop", "observed_mean": r["mean"], "ci95": r["ci95"],
                                        "status": status}
        print(f"{perm:15s} {region:10s} expected drop; mean d {r['mean']:+.4f} CI [{lo:+.4f}, {hi:+.4f}] -> {status}")
    for perm in ("shift_f0_up", "shift_f0_down"):
        r = report.get(perm, {}).get("now_react")
        if r is None:
            continue
        status = "consistent (|mean| < 0.02)" if abs(r["mean"]) < 0.02 else "unexpectedly large"
        verdicts[f"{perm}/now_react"] = {"expected": "~no effect (contour preserved)", "observed_mean": r["mean"],
                                         "ci95": r["ci95"], "status": status}
        print(f"{perm:15s} {'now_react':10s} expected ~none; mean d {r['mean']:+.4f} -> {status}")
    return {"regions": report, "verdicts": verdicts}


def run(scores: str, out: str = "", voices: str = "all", phrases_root: str = "") -> Dict[str, Dict]:
    """The analysis of the CSV ``scores``, written to ``out`` where given."""
    result = analyze(select_voices(load_rows(scores), voices, phrases_root))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"\nsaved -> {out}")
    return result


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="directionality of the phrase probes (PyTorch port)")
    ap.add_argument("--scores", default="phrases_eval/phrases_scores.csv")
    ap.add_argument("--out", default="")
    ap.add_argument("--phrases_root", default="",
                    help="corpus root for the tts-column voice mapping (default: data/phrases.py's)")
    ap.add_argument("--voices", choices=("all", "heldout", "train"), default="all",
                    help="restrict the analysis by the pseudo-dialog corpus' voice split: 'heldout' keeps only the "
                         "voices of VAL_VOICES, which the probed model never trained on")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    resolve_device(args.device)
    run(args.scores, args.out, args.voices, args.phrases_root)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Prosody probing over the phrase corpus (JAX: root evaluate_phrases.py;
reference vap/phrases/evaluation_phrases.py).

    python -m voiceactivityprojection_tpu_torch.evaluate_phrases
        [--state_dict sd.pt | --checkpoint runs/.../ckpt_best] [--phrases_root DIR] [--out_dir phrases_eval]
        [--permutations regular flat_f0 ...] [--limit N] [--perm_cache DIR] [--directionality]
        [--device cuda|cpu] [--vap_<field> ...]

Each phrase's channel-0 audio goes through each prosodic permutation
(regular, flat F0, F0 only (a 400 Hz low pass), F0 shifted up or down by
10 %, flat intensity, averaged word durations: ``ops/prosody.py``, on the
host), then through the model (one sample a call, on the card unless
``--device cpu``); the mean next-speaker shift probability in the hold,
prediction and reaction regions around the end of the turn (and the
prediction region before the SCP of a long phrase) is written to
``phrases_scores.csv``, the means by permutation and length to
``phrases_aggregate.json``. ``--perm_cache`` keeps each permuted waveform
as ``.npy`` (the host DSP does not depend on the weights), written to a
temporary name and renamed into place; ``--directionality`` runs the
paired analysis of the package's ``analyzes/phrases_directionality.py`` on
the CSV into ``directionality.json``. ``--state_dict`` takes a reference state dict,
``--checkpoint`` a training checkpoint of the port; without either the
weights are drawn from seed 0. A ``timings`` JSON line gives the host-clock
seconds of the host DSP, the model and the file reads and writes.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.data.phrases import DEFAULT_PHRASES_ROOT, PhraseDataset, get_region_shift_probs
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.ops.codebook import get_probs
from voiceactivityprojection_tpu_torch.ops.prosody import (
    duration_avg,
    flatten_intensity,
    flatten_pitch,
    low_pass_filter_resample,
    shift_pitch,
)
from voiceactivityprojection_tpu_torch.utils.io import write_json

PERMUTATIONS = (
    "regular",
    "flat_f0",
    "only_f0",
    "shift_f0_up",
    "shift_f0_down",
    "flat_intensity",
    "duration_avg",
)


def permute_waveform(name: str, x: np.ndarray, sample: Dict) -> np.ndarray:
    """One prosodic permutation of channel-0 audio (1-D)."""
    if name == "regular":
        return x
    if name == "flat_f0":
        return flatten_pitch(x)
    if name == "only_f0":
        return low_pass_filter_resample(x, cutoff_freq=400)
    if name == "shift_f0_up":
        return shift_pitch(x, factor=1.1)
    if name == "shift_f0_down":
        return shift_pitch(x, factor=0.9)
    if name == "flat_intensity":
        return flatten_intensity(x)
    if name == "duration_avg":
        y = duration_avg(x, list(zip(sample["starts"], sample["ends"])))
        n = len(x)
        if len(y) < n:
            y = np.pad(y, (0, n - len(y)))
        return y[:n]
    raise ValueError(f"unknown permutation {name!r}")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VAP phrases prosody evaluation (PyTorch port)")
    parser.add_argument("--state_dict", type=str, default="",
                        help="reference state dict (.pt) or Lightning checkpoint (.ckpt)")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="training checkpoint directory of the port (runs/.../ckpt_best): its params")
    parser.add_argument("--phrases_root", type=str, default=DEFAULT_PHRASES_ROOT)
    parser.add_argument("--out_dir", type=str, default="phrases_eval")
    parser.add_argument("--region_time", type=float, default=0.2)
    parser.add_argument("--permutations", nargs="+", default=list(PERMUTATIONS), choices=PERMUTATIONS)
    parser.add_argument("--limit", type=int, default=0, help="the first N samples only")
    parser.add_argument("--perm_cache", type=str, default=os.path.join(tempfile.gettempdir(), "vap_perm_cache"),
                        help="directory caching permuted audio as .npy by (corpus, permutation, wav name): the "
                             "host DSP is the same for every checkpoint ('' disables)")
    parser.add_argument("--directionality", action="store_true",
                        help="after scoring, run the paired directionality analysis "
                             "(the package's analyzes/phrases_directionality.py) into directionality.json beside the CSV")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    VapConfig.add_argparse_args(parser)
    return parser


def _cached_permutation(args, perm: str, base: np.ndarray, sample: Dict, clock: Dict[str, float]) -> np.ndarray:
    """The permuted waveform, from ``--perm_cache`` where it holds one of
    ``base``'s shape, else computed (and cached)."""
    cache_path = ""
    if args.perm_cache and perm != "regular":
        t0 = time.perf_counter()
        # keyed by the corpus root too: two corpora may share WAV names
        root_key = hashlib.sha1(os.path.abspath(args.phrases_root).encode()).hexdigest()[:10]
        cdir = os.path.join(args.perm_cache, root_key)
        os.makedirs(cdir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(sample["audio_path"]))[0]
        cache_path = os.path.join(cdir, f"{perm}__{stem}.npy")
        cached = np.load(cache_path) if os.path.exists(cache_path) else None
        clock["io_s"] += time.perf_counter() - t0
        if cached is not None and cached.shape == base.shape:
            return cached
    t0 = time.perf_counter()
    audio = permute_waveform(perm, base, sample)
    t1 = time.perf_counter()
    clock["host_dsp_s"] += t1 - t0
    if cache_path:
        # a temporary name, then a rename: a concurrent sweep never loads a
        # half-written file (np.save appends .npy)
        tmp = f"{cache_path}.tmp{os.getpid()}"
        np.save(tmp, np.asarray(audio, np.float32))
        os.replace(tmp + ".npy", cache_path)
        clock["io_s"] += time.perf_counter() - t1
    return audio


def score(model: VapModel, dset: PhraseDataset, args, clock: Dict[str, float]) -> List[Dict]:
    """One CSV row per (sample, permutation)."""
    region_frames = int(args.region_time * dset.vad_hz)
    rows = []
    n = min(len(dset), args.limit) if args.limit else len(dset)
    for i in range(n):
        t0 = time.perf_counter()
        sample = dset[i]
        clock["io_s"] += time.perf_counter() - t0
        base = sample["waveform"][0]
        for perm in args.permutations:
            audio = _cached_permutation(args, perm, base, sample, clock)
            t0 = time.perf_counter()
            stereo = np.stack([audio, np.zeros_like(audio)])[None]
            with torch.inference_mode():
                probs = get_probs(model.forward(stereo)["logits"])
                probs = {k: probs[k].cpu().numpy() for k in ("p_now", "p_future")}
            clock["model_s"] += time.perf_counter() - t0
            rec = {"phrase": sample["phrase"], "long_short": sample["long_short"], "gender": sample["gender"],
                   "phrase_idx": sample["phrase_idx"], "permutation": perm}
            for pp in ("p_now", "p_future"):
                nm = pp.replace("p_", "")
                h, p, r = get_region_shift_probs(probs[pp][0], sample["end"], region_frames)
                rec[f"{nm}_hold"] = float(h.mean()) if h.size else float("nan")
                rec[f"{nm}_pred"] = float(p.mean()) if p.size else float("nan")
                rec[f"{nm}_react"] = float(r.mean()) if r.size else float("nan")
                if sample["long_short"] == "long":
                    h, p, r = get_region_shift_probs(probs[pp][0], sample["scp"], region_frames)
                    rec[f"scp_{nm}_pred"] = float(p.mean()) if p.size else float("nan")
            rows.append(rec)
        if (i + 1) % 20 == 0:
            print(f"{i + 1}/{n} phrases", flush=True)
    return rows


def aggregate(rows: List[Dict], permutations) -> Dict[str, Dict]:
    """Mean shift probabilities by (permutation, length, region)."""
    agg: Dict[str, Dict] = {}
    for perm in permutations:
        sel = [r for r in rows if r["permutation"] == perm]
        agg[perm] = {}
        for ls in ("short", "long"):
            sub = [r for r in sel if r["long_short"] == ls]
            if sub:
                agg[perm][ls] = {k: float(np.nanmean([r.get(k, np.nan) for r in sub]))
                                 for k in ("now_hold", "now_pred", "now_react",
                                           "future_hold", "future_pred", "future_react")}
    return agg


def run_directionality(csv_path: str, out_path: str) -> None:
    """The paired directionality analysis of ``csv_path`` over every voice
    (``analyzes/phrases_directionality.py``), written to ``out_path``."""
    from voiceactivityprojection_tpu_torch.analyzes.phrases_directionality import run

    run(csv_path, out_path)


def main(argv: Optional[List[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    clock = dict.fromkeys(("load_weights_s", "host_dsp_s", "model_s", "io_s"), 0.0)
    t0 = time.perf_counter()
    model = VapModel.from_args(args, device=args.device)
    if not (args.state_dict or args.checkpoint):
        print("WARNING: random-init weights")
    clock["load_weights_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dset = PhraseDataset(root=args.phrases_root)
    os.makedirs(args.out_dir, exist_ok=True)
    clock["io_s"] += time.perf_counter() - t0
    rows = score(model, dset, args, clock)

    t0 = time.perf_counter()
    csv_path = os.path.join(args.out_dir, "phrases_scores.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
        w.writeheader()
        w.writerows(rows)
    write_json(aggregate(rows, args.permutations), os.path.join(args.out_dir, "phrases_aggregate.json"))
    clock["io_s"] += time.perf_counter() - t0
    print(f"Saved -> {csv_path} and phrases_aggregate.json")

    if args.directionality:
        run_directionality(csv_path, os.path.join(args.out_dir, "directionality.json"))
    print(json.dumps({"timings": clock, "device": str(model.device), "rows": len(rows)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

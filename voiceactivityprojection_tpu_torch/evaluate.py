"""Test-split evaluation from a CSV manifest (JAX: evaluate.py).

    python -m voiceactivityprojection_tpu_torch.evaluate --data_test_path test.csv
        (--state_dict sd.pt | --checkpoint runs/.../ckpt_best) [--out_dir eval] [--thresholds thresholds.json]
        [--limit_batches N] [--no_threshold_search] [--device cuda|cpu]
        [--vap_<field> ...] [--data_<field> ...] [--event_<field> ...]

Cuts every session of the manifest into 20 s windows (``--data_*``), runs
the model over them in batches of ``--data_batch_size``, extracts the
turn-taking events from the ground-truth VAD (``--event_*``) and writes
``metrics.csv``, ``thresholds.json``, ``curves.npz`` and, where matplotlib
imports, ``curves_<family>.png`` under ``--out_dir``. Where the phrase
corpus is found under ``--data_phrases_root`` (``--data_phrases_probe``:
-1 when present, the default; 1 required; 0 off) the phrase probe runs too
and its region means join the metrics as ``test_*``.
``--state_dict`` takes a reference state dict (``.pt``) or Lightning
checkpoint (``.ckpt``), ``--checkpoint`` a training checkpoint of the port
(``ckpt_best`` / ``ckpt_last``; an orbax directory of the JAX package
raises); without weights the CLI refuses to run unless
``--allow_random_init`` asks for weights drawn from seed 0 (not the JAX
package's seed-0 weights).

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises. A ``timings`` JSON line
gives the host-clock seconds of each stage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, VapConfig
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
from voiceactivityprojection_tpu_torch.data.phrases import make_phrase_probe
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.train.evaluation import evaluate
from voiceactivityprojection_tpu_torch.utils.io import read_json


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VAP evaluation (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="training checkpoint directory of the port (runs/.../ckpt_best): its params")
    parser.add_argument("--state_dict", type=str, default="",
                        help="reference state dict (.pt) or Lightning checkpoint (.ckpt)")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="evaluate weights drawn from seed 0 (smoke runs only); without it the CLI "
                             "refuses to run when no weights are given")
    parser.add_argument("--out_dir", type=str, default="eval")
    parser.add_argument("--limit_batches", type=int, default=0)
    parser.add_argument("--no_threshold_search", action="store_true")
    parser.add_argument("--thresholds", type=str, default="",
                        help="thresholds.json of an earlier --out_dir (found on another split) to apply")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    VapConfig.add_argparse_args(parser)
    DataConfig.add_argparse_args(parser)
    EventConfig.add_argparse_args(parser)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = get_parser()
    args = parser.parse_args(argv)
    data_conf = DataConfig.args_to_conf(args)
    event_conf = EventConfig.args_to_conf(args)
    if not data_conf.test_path:
        parser.error("--data_test_path is required")
    if not (args.state_dict or args.checkpoint or args.allow_random_init):
        parser.error("no weights given: pass --state_dict (or --allow_random_init for an explicit smoke run)")
    timings = {}
    t0 = time.perf_counter()
    model = VapModel.from_args(args, device=args.device)
    if args.state_dict:
        print(f"Loaded state dict: {args.state_dict}")
    elif args.checkpoint:
        print(f"Restored checkpoint: {args.checkpoint}")
    else:
        print("WARNING: random-init weights (--allow_random_init)")
    timings["load_weights_s"] = time.perf_counter() - t0

    loader = VapDataLoader(
        SlidingWindowDataset(
            data_conf.test_path,
            audio_duration=data_conf.audio_duration,
            horizon=data_conf.horizon_time,
            sample_rate=data_conf.sample_rate,
            frame_hz=data_conf.frame_hz,
        ),
        batch_size=data_conf.batch_size,
        shuffle=False,
        drop_last=False,  # evaluation sees every window: the tail batch stays
    )
    thresholds = None
    if args.thresholds:
        thresholds = read_json(args.thresholds)
        print(f"Applying transferred thresholds: {thresholds}")
    probe = make_phrase_probe(data_conf)
    if probe is not None:
        print(f"Phrase probe: {len(probe.dset)} samples")
    t0 = time.perf_counter()
    result = evaluate(
        model, loader, event_conf,
        out_dir=args.out_dir,
        limit_batches=args.limit_batches or None,
        threshold_search=not args.no_threshold_search,
        thresholds=thresholds,
        timings=timings,
        phrase_probe=probe,
    )
    timings["evaluate_s"] = time.perf_counter() - t0
    for k, v in result.items():
        print(f"{k}: {v}")
    print(f"Saved -> {args.out_dir}/metrics.csv")
    print(json.dumps({"timings": timings, "device": str(model.device), "windows": len(loader.dataset)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

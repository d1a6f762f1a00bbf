"""CPC pretraining CLI of the audio encoder (JAX: root pretrain_cpc.py).

    python -m voiceactivityprojection_tpu_torch.pretrain_cpc --data_train_path train.csv
        [--window_time 1.28] [--batch_size 32] [--steps 100000]
        [--out_dir cpc_runs] [--export_blob] [--device cuda|cpu]

Trains the conv stack and GRU of the encoder with the InfoNCE objective on
mono windows of the manifest's audio (``train/cpc_pretrain.py``), a batch
of random windows a step, decoded on host threads one batch ahead. Every
``--save_every`` steps and at the end it saves ``<out_dir>/cpc_encoder``
(``{"encoder": state dict}`` in torch's format, ``models/checkpoint.py``),
which ``python -m voiceactivityprojection_tpu_torch.train
--init_encoder_from`` takes; ``--export_blob`` also writes
``<out_dir>/cpc_blob.pt`` in the libri-light format the reference's
``load_CPC`` and the JAX package read. Metrics go to
``<out_dir>/cpc_metrics.jsonl`` every ``--log_every`` steps.

The weights are drawn from ``--seed`` in the JAX layout
(``random_params_tree``; the JAX CLI draws its own). Training runs on the
card unless ``--device cpu`` asks for the plain PyTorch path; without a card
the default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset
from voiceactivityprojection_tpu_torch.models.checkpoint import (
    encoder_from_jax,
    export_cpc_blob,
    random_params_tree,
    save_checkpoint,
)
from voiceactivityprojection_tpu_torch.train.cpc_pretrain import (
    init_cpc_heads,
    init_cpc_train_state,
    make_cpc_train_step,
)
from voiceactivityprojection_tpu_torch.utils.device import resolve_device
from voiceactivityprojection_tpu_torch.utils.runtime import everything_deterministic


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="CPC pretraining (PyTorch port)")
    parser.add_argument("--data_train_path", type=str, required=True)
    parser.add_argument("--window_time", type=float, default=1.28, help="CPC_audio sizeWindow 20480 samples")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--steps", type=int, default=100_000)
    parser.add_argument("--learning_rate", type=float, default=2e-4)
    parser.add_argument("--n_predicts", type=int, default=12)
    parser.add_argument("--n_negatives", type=int, default=128)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--save_every", type=int, default=5000)
    parser.add_argument("--out_dir", type=str, default="cpc_runs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--export_blob", action="store_true",
                        help="also write cpc_blob.pt in the libri-light checkpoint format")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    device = resolve_device(args.device)
    everything_deterministic(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    ds = SlidingWindowDataset(args.data_train_path, audio_duration=args.window_time, horizon=0.0, mono=True)
    print(f"{len(ds)} training windows of {args.window_time}s")
    n_samples = ds.n_samples

    tree = random_params_tree(VapConfig(dim=args.dim, encoder_dim=args.dim), seed=args.seed)
    encoder = encoder_from_jax(tree["encoder"])
    heads = init_cpc_heads(torch.Generator().manual_seed(args.seed), args.n_predicts, args.dim, args.dim)
    state = init_cpc_train_state(encoder, heads, learning_rate=args.learning_rate, device=device)
    step_fn = make_cpc_train_step(args.n_predicts, args.n_negatives)
    negatives = torch.Generator().manual_seed(args.seed + 1)
    print(f"Encoder dim {args.dim} on {device}")

    rng = np.random.default_rng(args.seed)
    log_path = os.path.join(args.out_dir, "cpc_metrics.jsonl")
    t0 = time.time()
    # threaded decode, one batch ahead of the step that consumes it
    pool = ThreadPoolExecutor(max_workers=4)

    def load_batch() -> np.ndarray:
        idx = rng.integers(0, len(ds), size=args.batch_size)
        return np.stack(list(pool.map(lambda i: ds[int(i)]["waveform"][0, :n_samples], idx)))

    next_batch = pool.submit(load_batch)
    try:
        with open(log_path, "a") as logf:
            for it in range(args.steps):
                batch = next_batch.result()
                next_batch = pool.submit(load_batch)
                aux = step_fn(state, torch.from_numpy(batch).to(device), negatives)
                if (it + 1) % args.log_every == 0:
                    rec = {
                        "step": it + 1,
                        "cpc_loss": float(aux["cpc_loss"]),
                        "cpc_acc": float(aux["cpc_acc"]),
                        "acc_k1": float(aux["cpc_acc_k1"]),
                        "acc_k12": float(aux["cpc_acc_k12"]),
                        "elapsed_s": round(time.time() - t0, 1),
                    }
                    print(" ".join(f"{k}={v}" for k, v in rec.items()), flush=True)
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
                if (it + 1) % args.save_every == 0 or it + 1 == args.steps:
                    path = os.path.abspath(os.path.join(args.out_dir, "cpc_encoder"))
                    save_checkpoint(path, {"encoder": state.encoder.state_dict()})
                    print(f"saved -> {path}")
                    if args.export_blob:
                        blob = os.path.join(args.out_dir, "cpc_blob.pt")
                        export_cpc_blob(state.encoder, blob)
                        print(f"exported blob -> {blob}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


if __name__ == "__main__":
    sys.exit(main())

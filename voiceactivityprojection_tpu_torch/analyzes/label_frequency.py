"""Projection-label frequencies over a corpus (JAX: analyzes/label_frequency.py;
reference analyzes/model_params_grad.py:90-113).

    python -m voiceactivityprojection_tpu_torch.analyzes.label_frequency --manifest data.csv
        [--audio_duration 20] [--out label_frequency.json] [--top 20] [--device cuda|cpu] [--vap_<field> ...]

The histogram of the projection-window classes (256 by default) over every
VAD window of a manifest (``data/dataset.py`` ``SlidingWindowDataset``),
for class-imbalance analysis and priors. The labels are computed on the
device (``ops/codebook.py`` ``get_labels``; the card unless ``--device
cpu``, and without a card the default raises) in batches of 256 windows,
counted on the host. Writes ``counts``, ``total``, ``n_windows`` and
``entropy_bits`` as JSON; ``label_frequency`` returns them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

BATCH = 256  # windows a device call


def label_frequency(manifest: str, conf: VapConfig, audio_duration: float = 20.0, device="cuda",
                    top: int = 20) -> Dict:
    """The label counts of every window of ``manifest``, with their total,
    the window count and the entropy in bits; prints the ``top`` classes."""
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset
    from voiceactivityprojection_tpu_torch.ops.codebook import codebook_matrix, get_labels

    dev = resolve_device(device)
    ds = SlidingWindowDataset(manifest, audio_duration=audio_duration, horizon=conf.horizon_time)
    counts = np.zeros(conf.n_classes, dtype=np.int64)
    for i in range(0, len(ds), BATCH):
        vads = np.stack([ds[j]["vad"] for j in range(i, min(i + BATCH, len(ds)))])
        labels = get_labels(torch.as_tensor(vads, device=dev), conf.bin_frames).cpu().numpy()
        counts += np.bincount(labels.ravel(), minlength=conf.n_classes)

    total = int(counts.sum())
    states = codebook_matrix(len(conf.bin_times))
    order = np.argsort(counts)[::-1]
    print(f"{len(ds)} windows, {total} label frames")
    print(f"top {top} classes:")
    for idx in order[:top]:
        bits = states[idx].astype(int).tolist()
        print(f"  class {idx:3d}  {counts[idx]:8d} ({counts[idx] / total:6.2%})  A={bits[0]} B={bits[1]}")
    seen = counts[counts > 0] / total
    return {"counts": counts.tolist(), "total": total, "n_windows": len(ds),
            "entropy_bits": float(-(seen * np.log2(seen)).sum())}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="projection-label frequencies over a manifest (PyTorch port)")
    parser.add_argument("--manifest", type=str, required=True)
    parser.add_argument("--audio_duration", type=float, default=20.0)
    parser.add_argument("--out", type=str, default="label_frequency.json")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    VapConfig.add_argparse_args(parser)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from voiceactivityprojection_tpu_torch.utils.io import write_json

    args = get_parser().parse_args(argv)
    result = label_frequency(args.manifest, VapConfig.args_to_conf(args), args.audio_duration, args.device, args.top)
    write_json(result, args.out)
    print(f"Saved -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

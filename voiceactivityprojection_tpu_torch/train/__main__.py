"""Training CLI (JAX: root train.py; the reference's vap/train.py:99-240).

    python -m voiceactivityprojection_tpu_torch.train --data_train_path train.csv
        --data_val_path val.csv [--vap_* ...] [--opt_* ...] [--data_* ...]
        [--event_* ...] [--max_epochs N] [--mono] [--resume_from DIR]
        [--init_encoder_from FILE_OR_DIR] [--limit_batches N] [--device cuda|cpu]

Manifest CSV columns: audio_path,vad_path[,start,end]
(``data/dataset.py``). Writes ``<out_dir>/<run name>/metrics.jsonl`` and
the checkpoints ``ckpt_best`` / ``ckpt_last`` (``train/loop.py``).
``--resume_from`` continues a run from one of them exactly;
``--init_encoder_from`` takes a CPC blob file (``pretrain_cpc
--export_blob``'s ``cpc_blob.pt``) or a checkpoint directory holding the
encoder (``pretrain_cpc``'s ``cpc_encoder``). ``--mono`` switches the
``--vap_*`` flags to the mono model's config.

Training runs on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises.

Data parallelism (JAX: ``--n_devices``, ``--multihost`` and
``jax.distributed.initialize()``, root train.py:35-71): under ``torchrun``
(its ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) each
process joins the group, NCCL on the card and gloo on the CPU, and the
Trainer splits every global batch of ``--data_batch_size`` over the ranks
(``train/loop.py``). ``--n_devices N`` outside ``torchrun`` starts N local
workers of this command itself, one a ``cuda:LOCAL_RANK`` (or N CPU
processes under ``--device cpu``), joined through a file store in a
temporary directory; ``--multihost`` requires ``torchrun``'s environment.
``--device cuda`` never falls back to gloo on the CPU.

    torchrun --nproc_per_node 2 -m voiceactivityprojection_tpu_torch.train ...
    python -m voiceactivityprojection_tpu_torch.train --n_devices 2 ...
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.parallel.mesh import init_distributed, spawn_local, torchrun_env
from voiceactivityprojection_tpu_torch.train.loop import Trainer
from voiceactivityprojection_tpu_torch.utils.runtime import everything_deterministic


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(description="VAP training (PyTorch port)")
    parser.add_argument("--multihost", action="store_true",
                        help="train over the processes torchrun started (its environment is required)")
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--resume_from", type=str, default="",
                        help="checkpoint directory (e.g. runs/.../ckpt_last): the whole training state when its "
                             "sidecar is there (weights, optimizer, rate, epoch, counters, host generators), "
                             "else the params alone")
    parser.add_argument("--init_encoder_from", type=str, default="",
                        help="CPC blob file (cpc_blob.pt) or pretrain_cpc checkpoint directory (cpc_encoder) "
                             "loaded into the fresh weights")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", type=str, default="runs")
    parser.add_argument("--n_devices", type=int, default=0,
                        help="data-parallel ranks: under torchrun its world size (0 = all of it); outside it, "
                             "N > 1 starts N local workers")
    parser.add_argument("--limit_batches", type=int, default=0, help="debug cap")
    parser.add_argument("--mono", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    # --mono switches the --vap_* flags to the mono config's (a superset),
    # read from argv because argparse needs the fields before it parses
    (VapMonoConfig if "--mono" in argv else VapConfig).add_argparse_args(parser)
    OptConfig.add_argparse_args(parser)
    DataConfig.add_argparse_args(parser)
    EventConfig.add_argparse_args(parser)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    distributed = torchrun_env()
    if args.multihost and not distributed:
        raise RuntimeError("--multihost trains over the processes torchrun starts: its environment (RANK, "
                           "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is not set")
    if args.n_devices > 1 and not distributed:
        if torch.device(args.device).type == "cuda" and args.n_devices > torch.cuda.device_count():
            raise ValueError(f"--n_devices {args.n_devices} needs {args.n_devices} cards, "
                             f"{torch.cuda.device_count()} here: one process a card")
        return spawn_local([sys.executable, "-m", "voiceactivityprojection_tpu_torch.train", *argv], args.n_devices)
    if distributed:
        init_distributed(args.device)
    try:
        train(args)
    finally:
        if distributed:
            dist.destroy_process_group()
    return 0


def train(args: argparse.Namespace) -> None:
    everything_deterministic(args.seed)
    trainer = Trainer(
        model_conf=(VapMonoConfig if args.mono else VapConfig).args_to_conf(args),
        opt_conf=OptConfig.args_to_conf(args),
        data_conf=DataConfig.args_to_conf(args),
        event_conf=EventConfig.args_to_conf(args),
        max_epochs=args.max_epochs,
        seed=args.seed,
        out_dir=args.out_dir,
        n_devices=args.n_devices or None,
        limit_batches=args.limit_batches or None,
        device=args.device,
    )
    if trainer.main:
        ranks = f" (rank 0 of {trainer.layout.world})" if trainer.layout is not None else ""
        print(f"Run: {trainer.name} -> {trainer.out_dir} on {trainer.device}{ranks}")
    trainer.fit(resume_from=args.resume_from or None, init_encoder_from=args.init_encoder_from or None)


if __name__ == "__main__":
    sys.exit(main())

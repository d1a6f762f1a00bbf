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
PyTorch path; without a card the default raises. One device only:
``--multihost`` and ``--n_devices`` above 1 raise (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.train.loop import DDP_NOT_PORTED, Trainer
from voiceactivityprojection_tpu_torch.utils.runtime import everything_deterministic


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(description="VAP training (PyTorch port)")
    parser.add_argument("--multihost", action="store_true", help="not ported (ROADMAP Queue 1 item 9): raises")
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
    parser.add_argument("--n_devices", type=int, default=0, help="0 or 1: one device (more raises)")
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


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    if args.multihost or args.n_devices > 1:
        raise NotImplementedError(DDP_NOT_PORTED)
    everything_deterministic(args.seed)
    trainer = Trainer(
        model_conf=(VapMonoConfig if args.mono else VapConfig).args_to_conf(args),
        opt_conf=OptConfig.args_to_conf(args),
        data_conf=DataConfig.args_to_conf(args),
        event_conf=EventConfig.args_to_conf(args),
        max_epochs=args.max_epochs,
        seed=args.seed,
        out_dir=args.out_dir,
        limit_batches=args.limit_batches or None,
        device=args.device,
    )
    print(f"Run: {trainer.name} -> {trainer.out_dir} on {trainer.device}")
    trainer.fit(resume_from=args.resume_from or None, init_encoder_from=args.init_encoder_from or None)


if __name__ == "__main__":
    sys.exit(main())

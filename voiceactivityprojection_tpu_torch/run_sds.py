"""Real-time SDS loop (JAX: run_sds.py; reference: sds/run_sds.py:162-273).

    python -m voiceactivityprojection_tpu_torch.run_sds [-sd state_dict.pt | --checkpoint DIR]
        [--wav file.wav [--realtime]] [--max_chunks N] [--device cuda|cpu]
        [--sds_context_time 20] [--sds_chunk_time 0.02] [--sds_zmq_port 5578]
        [--sds_transformer_mode window|kv] [--vap_<field> ...]

Streams stereo audio (the microphone through pyaudio, or ``--wav``
playback) in hops of ``--sds_chunk_time``, runs the model incrementally
and publishes speaker A's smoothed ``p_now`` over ZMQ PUB, topic
``tt_probs`` (``--sds_zmq_port 0`` publishes nothing). Subscribe with

    python -c "from voiceactivityprojection_tpu_torch.inference.sds import zmq_subscriber
    for p in zmq_subscriber(): print(p)"

The model runs on the card unless ``--device cpu``; without a card the
default raises. The streamers compute in float32, so the weights are
loaded in float32 whatever ``--vap_dtype`` says. Weights: ``-sd`` (a
reference state dict), else ``--checkpoint`` (a training checkpoint of the
port), else drawn from seed 0 with a warning.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from voiceactivityprojection_tpu_torch.config import SDSConfig, VapConfig
from voiceactivityprojection_tpu_torch.inference.sds import TurnTakingSDS, WavSource
from voiceactivityprojection_tpu_torch.models.vap import VapModel


def streaming_model(args: argparse.Namespace) -> VapModel:
    """``VapModel.from_args`` in float32 (the streamers' dtype), with the
    weights' source or a warning printed."""
    if args.vap_dtype != "float32":
        print(f"Streaming computes in float32: --vap_dtype {args.vap_dtype} ignored")
    args = argparse.Namespace(**{**vars(args), "vap_dtype": "float32"})
    model = VapModel.from_args(args, device=args.device)
    if args.state_dict:
        print(f"Loaded state dict: {args.state_dict}")
    elif args.checkpoint:
        print(f"Restored checkpoint: {args.checkpoint}")
    else:
        print("WARNING: random-init weights")
    return model


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="VAP real-time SDS (PyTorch port)")
    parser.add_argument("-sd", "--state_dict", type=str, default="")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--wav", type=str, default="", help="playback source")
    parser.add_argument("--realtime", action="store_true", help="pace wav playback")
    parser.add_argument("--max_chunks", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    SDSConfig.add_argparse_args(parser)
    VapConfig.add_argparse_args(parser)
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    model = streaming_model(args)
    sds_conf = SDSConfig.args_to_conf(args)
    sds = TurnTakingSDS(model, sds_conf)
    if args.wav:
        sds.source = WavSource(args.wav, sds.stream.hop_samples, realtime=args.realtime,
                               sample_rate=sds_conf.sample_rate)
    print(f"SDS: context={sds_conf.context_time}s hop={sds.stream.hop_samples} samples "
          f"mode={sds_conf.transformer_mode} zmq_port={sds_conf.zmq_port} device={model.device}", flush=True)
    t_loop = time.perf_counter()
    hops = []
    sds.run(max_chunks=args.max_chunks or None, log=lambda line: (hops.append(line), print(line)))
    t_end = time.perf_counter()
    print(json.dumps({"timings": {"setup_s": t_loop - t0, "loop_s": t_end - t_loop}, "hops": len(hops),
                      "device": str(model.device)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

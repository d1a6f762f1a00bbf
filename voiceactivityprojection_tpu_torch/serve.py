"""Inference server (JAX: serve.py).

    python -m voiceactivityprojection_tpu_torch.serve [-sd state_dict.pt | --checkpoint DIR]
        [--port 5590] [--batch_size 16] [--chunk_time 20] [--max_wait_ms 25] [--device cuda|cpu]
    python -m voiceactivityprojection_tpu_torch.serve --mode stream [--streams 16]
        [--context_time 20] [--hop_frames 1]

Two modes:
* batch (default): one-shot requests micro-batched into (batch_size, 2,
  chunk_time) forwards of ``VapModel.probs``, in ``--vap_dtype``;
* stream: live dialog sessions on a ``BatchedKVStreamer``; each tick
  advances every session one hop. The streamer computes in float32, so in
  this mode the weights are loaded in float32 whatever ``--vap_dtype``
  says.

``--port 0`` binds a port the OS picks; the "Serving on" line names the
port bound. The model runs on the card unless ``--device cpu``; without a
card the default raises. The protocol is the JAX server's, so either
package's clients talk to it:

    from voiceactivityprojection_tpu_torch.inference.server import VapClient, VapStreamClient
    out = VapClient(port=5590).infer(waveform)        # (2, n) float32
    c = VapStreamClient(port=5590); c.open()
    out = c.push(chunk)                               # (2, hop * 320) float32
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.server import VapServer, VapStreamServer
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.run_sds import streaming_model


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="VAP inference server (PyTorch port)")
    parser.add_argument("-sd", "--state_dict", type=str, default="")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--port", type=int, default=5590, help="0: a port the OS picks")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--chunk_time", type=float, default=20.0)
    parser.add_argument("--max_wait_ms", type=float, default=25.0)
    parser.add_argument("--mode", choices=["batch", "stream"], default="batch")
    parser.add_argument(
        "--streams", type=int, default=16,
        help="concurrent dialog slots a tick; chip_smoke.py phase 15 measured 256 streams at 9.4-15.5 ms a "
             "tick (real time: under the 20 ms hop) on an NVIDIA H100 80GB HBM3 at 700 W")
    parser.add_argument("--context_time", type=float, default=20.0)
    parser.add_argument("--hop_frames", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    VapConfig.add_argparse_args(parser)
    args = parser.parse_args(argv)

    if args.mode == "stream":
        model = streaming_model(args)
        server = VapStreamServer(model, streams=args.streams, context_time=args.context_time,
                                 hop_frames=args.hop_frames, max_wait_ms=args.max_wait_ms)
        what = (f"{args.streams} sessions x {args.context_time}s context, hop {args.hop_frames} frames, "
                f"wait {args.max_wait_ms}ms")
    else:
        model = VapModel.from_args(args, device=args.device)
        if not (args.state_dict or args.checkpoint):
            print("WARNING: random-init weights")
        server = VapServer(model, batch_size=args.batch_size, chunk_time=args.chunk_time,
                           max_wait_ms=args.max_wait_ms)
        what = f"batch {args.batch_size} x {args.chunk_time}s, wait {args.max_wait_ms}ms"
    thread = server.start(port=args.port)
    print(f"Serving ({args.mode}) on tcp://*:{server.port} ({what}, device {model.device})", flush=True)
    try:
        while thread.is_alive():
            thread.join(timeout=0.5)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    sys.exit(main())

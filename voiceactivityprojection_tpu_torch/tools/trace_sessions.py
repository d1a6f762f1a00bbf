"""Which kernels ``utils/profiling.trace`` records, session after session,
in one long process on the card.

    python3 -m voiceactivityprojection_tpu_torch.tools.trace_sessions [--sessions 12]

One float32 ``probs`` call of ``VapConfig()`` at B=10 x 77,744 samples
(the prosody probe's batch: K1 x 5, K2, K4 x 14) is traced ``--sessions``
times, each trace preceded by a heavy ``torch.profiler`` session of
20 bfloat16 calls at B=16 x 20 s whose events are read back
(as ``chip_smoke.py``'s profiles do). For each trace one JSON line names
the kernels found (K1, K2, K4, and how many of PyTorch's own kernels),
the first kernel's name, and the time from the call's span to its first
kernel and from the span to the first K4, in µs of the trace's clock
(a kernel earlier than its span means the device clock and the host clock
disagree). Each session is taken twice: with ``profiling.trace``, which
synchronizes the card on entry and exit (``synced``), and with a bare
``torch.profiler.profile`` (``bare``). Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# name prefixes of the ported kernels in either dtype's route (K1 in float32:
# conv_cn_relu_kernel for conv0, conv_cn_relu_tf32x3_kernel for conv1-conv4;
# K2 gru_ds_f32_cluster_kernel; K4 flash_alibi_tf32x3_kernel)
K_NAMES = {"K1": "conv_cn_relu", "K2": "gru_ds_", "K4": "flash_alibi_"}
LOAD_CALLS = 20


def read_trace(path: str) -> dict:
    with open(glob.glob(os.path.join(path, "*.pt.trace.json"))[0]) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    span = [e for e in events if e.get("name") == "traced_call"]
    found = {k: sum(v in e["name"] for e in kernels) for k, v in K_NAMES.items()}
    t_span = span[0]["ts"] if span else None
    first_k4 = next((e["ts"] for e in kernels if K_NAMES["K4"] in e["name"]), None)
    return {
        "found": found,
        "torch_kernels": sum(not any(v in e["name"] for v in K_NAMES.values()) for e in kernels),
        "first_kernel": kernels[0]["name"][:60] if kernels else None,
        "span_to_first_kernel_us": (kernels[0]["ts"] - t_span) if kernels and t_span is not None else None,
        "span_to_first_k4_us": (first_k4 - t_span) if first_k4 is not None and t_span is not None else None,
        "span_found": bool(span),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_sessions needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from voiceactivityprojection_tpu_torch import VapConfig, VapModel
    from voiceactivityprojection_tpu_torch.utils import profiling

    m32 = VapModel(VapConfig(), device="cuda")
    m16 = VapModel(VapConfig(dtype="bfloat16"), device="cuda")
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal((10, 2, 77_744))).astype(np.float32)
    load = torch.from_numpy((0.1 * rng.standard_normal((16, 2, 320_000))).astype(np.float32)).cuda()
    m32.probs(w)
    torch.cuda.synchronize()
    t_start = time.perf_counter()

    def bare(path):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(path))

    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.sessions):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(LOAD_CALLS):
                    m16.probs(load)
                torch.cuda.synchronize()
            load_events = len(prof.events())
            for kind, ctx in (("synced", profiling.trace), ("bare", bare)):
                path = os.path.join(tmp, f"{kind}{i}")
                with ctx(path):
                    with profiling.span("traced_call"):
                        m32.probs(w)
                torch.cuda.synchronize()
                print(json.dumps({"session": i, "trace": kind,
                                  "profiler_sessions_before": 3 * i + (kind == "bare") + 1,
                                  "load_events": load_events, "process_s": time.perf_counter() - t_start,
                                  **read_trace(path)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of the PyTorch port once, on the card.

    python vapbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--control 1]

From the root of a checkout. The cell's files are found by name under
``vapbench/`` (``workloads/<cell>.json`` names its configuration and its
entry); the metrics it reports are the cell's in ``BENCHMARK.json``: with
``--trace 0`` the end-to-end ones, with ``--trace 1`` the per-layer ones,
read from a profiled stretch after the window and from stages timed alone.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error are the same numbers.

``--control 1`` puts the plain reference, in the precision below the
configuration's (TF32 for float32), in the program's place in the
comparison: its run has to come out not correct.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs(root: Path = ROOT) -> dict:
    """The build and kernel caches of a run, at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    base = root / ".vapbench_cache"
    return {"TRITON_CACHE_DIR": base / "triton", "TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TORCHINDUCTOR_CACHE_DIR": base / "inductor", "CUDA_CACHE_PATH": base / "nv"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in cache_dirs().items():
        os.environ[key] = str(path)
    sys.path.insert(0, str(ROOT))
    import torch

    from vapbench import harness

    def note(what: str) -> None:
        print(f"vapbench: {what} at {harness.seconds_since_process_start():.2f} s", file=sys.stderr, flush=True)

    note("torch imported")

    try:
        workload = harness.load_json("workloads", args.workload)
    except harness.UnknownName as e:
        print(f"vapbench: {e}", file=sys.stderr)
        return 2
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vapbench: cell {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"vapbench: card {harness.card_line()}", file=sys.stderr, flush=True)
    ctx = harness.make_context(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    torch.cuda.set_device(ctx.device)
    torch.set_num_threads(1)  # the host side of every cell is one thread: no idle pool competing for cores
    harness.apply_precision(ctx.config)
    from voiceactivityprojection_tpu_torch.ops import _build

    note("card ready")
    built = _build.build()
    note(f"kernels built ({sorted(built)})" if built else "kernels found built")
    result = harness.run_cell(ctx, control=bool(args.control), setup_clock=harness.seconds_since_process_start)
    note("comparison done")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"vapbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

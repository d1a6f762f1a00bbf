"""Data-parallel scaling rehearsed on one machine (JAX:
examples/multihost_rehearsal.py, with tests/multihost_worker.py).

    python -m voiceactivityprojection_tpu_torch.tools.multihost_rehearsal [--steps 8] [--device cuda|cpu]

For each process count N of 1, 2 and 4 (``rehearse``'s ``procs``) the same global batch (8 x 1 s of
stereo, 150 VAD frames, from a fixed seed) trains with the same weights
(the port's seed-0 draw): one process alone on the whole batch, or N
processes (``parallel/mesh.py`` ``spawn_local``, ``init_distributed`` over
gloo, ``ProcessLayout``), each on its rows, the gradients averaged over
them. Each run takes one step, then ``--steps`` timed steps; the slowest
process's ms a step gives the scaling table (the speed against one
process: with the global batch fixed, ideal is 1.0). On one machine every
configuration shares the cores (and on the card the one card, which the
ranks share through gloo), so the table measures the collectives and the
framework's overhead, not scaling. The first step's losses must agree
across configurations (1e-6 relative), and the final weights are compared with one
process's. Dropout is off: the port's elementwise masks fold in the data
rank, so only at rate 0 is a data-parallel step one process's step.

The model is the dryrun tool's (``tools/dryrun_multichip.py``): on the
CPU the JAX worker's widths (dim 16, one layer a stack), on the card the
default widths with one layer a stack, so that the attention kernels take
their 64-wide heads. Runs on the card unless ``--device cpu``
(without a card the default raises). ``rehearse`` returns the table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.utils.device import resolve_device

GLOBAL_BATCH = 8
LOSS_TOL = 1e-6


def train(device: torch.device, steps: int, layout=None) -> Dict:
    """One configuration's run in this process (under ``layout``, this
    rank's rows): the first step's loss, ms a timed step, the final
    weights."""
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.parallel.mesh import shard_batch
    from voiceactivityprojection_tpu_torch.tools.dryrun_multichip import _conf, _net
    from voiceactivityprojection_tpu_torch.train.step import make_optimizer, make_train_step

    conf = dataclasses.replace(_conf(device), dropout=0.0)
    net = _net(conf, device)
    rng = np.random.default_rng(42)
    batch = {"waveform": (rng.normal(size=(GLOBAL_BATCH, 2, 16000)) * 0.1).astype(np.float32),
             "vad": (rng.random((GLOBAL_BATCH, 150, 2)) < 0.5).astype(np.float32)}
    local = {k: torch.as_tensor(v, device=device) for k, v in shard_batch(batch, layout).items()}
    step = make_train_step(conf, make_optimizer(OptConfig(), net, conf.freeze_encoder), layout)
    loss0 = float(step(net, local, torch.Generator().manual_seed(1))["loss"])
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = step(net, local, torch.Generator().manual_seed(2 + i))
    if steps:
        float(metrics["loss"])  # waits for the last step
    step_ms = 1e3 * (time.perf_counter() - t0) / steps if steps else float("nan")
    return {"loss": loss0, "step_ms": step_ms,
            "weights": {k: v.detach().cpu() for k, v in net.state_dict().items()}}


def _worker(result_dir: str, steps: int, device: str) -> int:
    """One rank of a configuration (started by ``spawn_local``): writes its
    loss and ms, rank 0 also its final weights."""
    import torch.distributed as dist

    from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(device, backend="gloo")  # ranks on one machine share its card, which NCCL refuses
    try:
        layout = ProcessLayout()
        if dev.type == "cpu":  # the ranks share the machine's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // layout.world))
        out = train(dev, steps, layout)
        if layout.rank == 0:
            torch.save(out["weights"], os.path.join(result_dir, "weights.pt"))
        with open(os.path.join(result_dir, f"rank{layout.rank}.json"), "w") as f:
            json.dump({"loss": out["loss"], "step_ms": out["step_ms"]}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def run_config(n_proc: int, steps: int, device: torch.device) -> Dict:
    """The per-process losses and ms, and the final weights, of one
    configuration: one process in this one, else ``n_proc`` ranks."""
    from voiceactivityprojection_tpu_torch.parallel.mesh import spawn_local

    if n_proc == 1:
        out = train(device, steps)
        return {"losses": [out["loss"]], "step_ms": [out["step_ms"]], "weights": out["weights"]}
    with tempfile.TemporaryDirectory(prefix="vap_rehearsal_") as tmp:
        cmd = [sys.executable, "-m", "voiceactivityprojection_tpu_torch.tools.multihost_rehearsal", "--worker", tmp,
               "--steps", str(steps), "--device", device.type]
        rc = spawn_local(cmd, n_proc, timeout_s=900)
        if rc:
            raise RuntimeError(f"{n_proc} processes: a rank exited with {rc}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(n_proc)]
        weights = torch.load(os.path.join(tmp, "weights.pt"))
    return {"losses": [r["loss"] for r in ranks], "step_ms": [r["step_ms"] for r in ranks], "weights": weights}


def rehearse(procs: Sequence[int] = (1, 2, 4), steps: int = 8, device="cuda") -> Dict:
    """The scaling table: for each process count its ms a step (the
    slowest rank's), the speed against the first configuration, its first
    losses and its final weights' largest difference from the first's."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the ranks run
    torch.backends.cudnn.allow_tf32 = False
    rows, base = [], None
    for n in procs:
        res = run_config(n, steps, dev)
        step_ms = max(res["step_ms"])  # the slowest process sets the step
        if base is None:
            base = res
        row = {"procs": n, "step_ms": step_ms, "vs_first": max(base["step_ms"]) / step_ms, "losses": res["losses"],
               "weights_max_diff": max(float((res["weights"][k] - base["weights"][k]).abs().max())
                                       for k in base["weights"])}
        rows.append(row)
        print(f"procs={n}  step={step_ms:7.1f} ms  vs-{procs[0]}-proc={row['vs_first']:5.2f}x  "
              f"weights max diff {row['weights_max_diff']:.2e}", flush=True)
    losses = [l for r in rows for l in r["losses"]]
    spread = max(losses) - min(losses)
    if spread > LOSS_TOL * abs(losses[0]):
        raise AssertionError(f"losses diverged across configurations by {spread:.3g}: {losses}")
    print(f"losses equal across configurations (spread {spread:.2e}): {losses[0]:.6f}", flush=True)
    return {"device": str(dev), "steps": steps, "rows": rows, "loss_spread": spread}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="data-parallel scaling rehearsal on one machine (PyTorch port)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--worker", type=str, default="", help=argparse.SUPPRESS)  # a rank's result directory
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    if args.worker:
        return _worker(args.worker, args.steps, args.device)
    rehearse(steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Data x tensor parallelism over processes, checked against one process,
then context parallelism: the port's ``dryrun_multichip``
(JAX: ``__graft_entry__.py:34-142``).

    python -m voiceactivityprojection_tpu_torch.tools.dryrun_multichip --n N [--device cpu|cuda]

Starts N ranks (``parallel/mesh.py`` ``spawn_local``; under ``torchrun``
the ranks it started). With N >= 4 and even the layout is N/2 data x 2
model ranks (the Megatron shards of ``parallel/tp.py``), else N data ranks.
Every rank draws the same weights from seed 0 and the same global batch of
``n_data`` rows (JAX's shapes: 1 s of stereo, 150 VAD frames), then:

* the mesh's gradients (each rank's rows, its model shard, the gradients
  averaged over the data ranks) against one process's on the whole batch,
  the largest difference over every rank and weight under 1e-4 (JAX's bar,
  ``__graft_entry__.py:109``);
* one train step on the mesh (finite metrics, its ms on the host clock);
* rank 0: ``forward_context_parallel`` over N shards of its device.

On the CPU the model is JAX's dryrun config (dim 16, one layer a stack);
on the card the default widths with one layer a stack, so that the
attention kernels take their 64-wide heads (two a rank under TP). Ranks
that share one card reduce over gloo (NCCL takes one rank a card). Rank 0
prints one JSON line; the exit code is 0 when every check held.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

GRAD_TOL = 1e-4


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="data x tensor parallelism over processes, against one process")
    parser.add_argument("--n", type=int, default=2, help="ranks (processes)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _conf(device: torch.device):
    from voiceactivityprojection_tpu_torch.config import VapConfig

    if device.type == "cuda":
        return VapConfig(channel_layers=1, cross_layers=1)
    return VapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)


def _net(conf, device: torch.device):
    from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
    from voiceactivityprojection_tpu_torch.models.vap import VapNet

    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=0), conf))
    return net.to(device)


def _grads(net, batch, conf) -> Dict[str, torch.Tensor]:
    """The loss's gradients without dropout (JAX's ``loss_fn(..., rng=None)``),
    through the training forward (the inference one fuses the GRU with the
    downsample in a kernel that has no backward)."""
    from voiceactivityprojection_tpu_torch.train.step import loss_fn

    net.zero_grad(set_to_none=True)
    loss_fn(net, batch, dataclasses.replace(conf, dropout=0.0), torch.Generator())[0].backward()
    return {k: p.grad for k, p in net.named_parameters() if p.grad is not None}


def run_rank(n: int, device: str) -> Dict:
    """One rank's checks; returns rank 0's report (every rank's on failure)."""
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.parallel.context import forward_context_parallel
    from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout, init_distributed, make_mesh, shard_batch
    from voiceactivityprojection_tpu_torch.parallel.tp import shard_params_tp
    from voiceactivityprojection_tpu_torch.train.step import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    shared_card = dev.type == "cuda" and n > torch.cuda.device_count()
    dev = init_distributed(device, backend="gloo" if shared_card else None)
    if dist.get_world_size() != n:
        raise ValueError(f"--n {n}, but the group holds {dist.get_world_size()} ranks")
    n_model = 2 if n >= 4 and n % 2 == 0 else 1
    layout = ProcessLayout(n_model)
    conf = _conf(dev)

    B = layout.n_data
    batch = {
        "waveform": torch.from_numpy(np.random.default_rng(0).normal(size=(B, 2, 16000)).astype(np.float32)),
        "vad": torch.from_numpy((np.random.default_rng(1).random((B, 150, 2)) < 0.5).astype(np.float32)),
    }
    on = lambda b: {k: v.to(dev) for k, v in b.items()}
    want = _grads(_net(conf, dev), on(batch), conf)  # one process, the whole batch, unsharded

    net = _net(conf, dev)
    if n_model > 1:
        shard_params_tp(net, layout.model_rank, n_model, layout.model_group)
        want = shard_params_tp(want, layout.model_rank, n_model)
    local = on(shard_batch(batch, layout))
    got = _grads(net, local, conf)
    layout.all_reduce_gradients(net.parameters())
    if set(got) != set(want):
        raise AssertionError(f"the mesh trains other weights than one process: {sorted(set(got) ^ set(want))}")
    diff = torch.tensor(max(float((got[k] - want[k]).abs().max()) for k in got))
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    grad_max_diff = float(diff)

    opt = make_optimizer(OptConfig(), net, conf.freeze_encoder)
    step = make_train_step(conf, opt, layout)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(net, local, torch.Generator().manual_seed(2))
    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
    step_ms = (time.perf_counter() - t0) * 1e3

    report = {"dryrun_multichip": "ok", "rank": layout.rank, "mesh": layout.shape, "ranks": n, "device": str(dev),
              "backend": dist.get_backend(), "grad_max_diff": grad_max_diff, "grad_tol": GRAD_TOL,
              "metrics": metrics, "step_ms": step_ms}
    if layout.rank == 0:
        t50 = 4 * n
        wav = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 2, t50 * 320)).astype(np.float32)).to(dev)
        out = forward_context_parallel(_net(conf, dev), wav, conf, make_mesh(n_data=n, devices=[dev] * n))
        report["context_parallel"] = {k: list(v.shape) for k, v in out.items()}
        if not all(bool(torch.isfinite(v).all()) for v in out.values()) or out["logits"].shape[1] != t50:
            raise AssertionError(f"context parallelism over {n} shards: {report['context_parallel']}")
    ok = grad_max_diff < GRAD_TOL and all(np.isfinite(v) for v in metrics.values())
    if not ok:
        report["dryrun_multichip"] = "failed"
    dist.barrier()
    return report


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    from voiceactivityprojection_tpu_torch.parallel.mesh import TIMEOUT_S, spawn_local, torchrun_env

    if not torchrun_env():
        argv = sys.argv[1:] if argv is None else list(argv)
        return spawn_local([sys.executable, "-m", "voiceactivityprojection_tpu_torch.tools.dryrun_multichip",
                            *argv], args.n, timeout_s=TIMEOUT_S)
    try:
        report = run_rank(args.n, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if report["rank"] == 0 or report["dryrun_multichip"] != "ok":
        print(json.dumps(report), flush=True)
    return 0 if report["dryrun_multichip"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())

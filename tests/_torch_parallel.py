"""Ranks of the port's data and tensor parallelism for the CPU tests
(``tests/test_torch_parallel.py``). No JAX: the tests hold what the ranks
write against the JAX package in their own process.

``run_ranks(tmp, n, mode)`` starts ``n`` processes of this file through the
port's launcher (``parallel/mesh.py`` ``spawn_local``: a ``file://`` store in
a temporary directory, never a fixed port, since the test workers run at
once), joined over gloo, with a time limit at which it kills them all, so
that a hung collective fails one test. Each rank reads its inputs from
``tmp/inputs.npz`` (or ``tmp/args.json``) and writes
``tmp/<mode>_<rank>.npz``.

Modes (the model is ``VapConfig(**NARROW)`` at the weights of
``random_params_tree(conf, seed=SEED)``, dropout 0 unless said):
  tp_forward  n_model = n: the sharded inference forward's logits and vad
  tp_step     n_model = n: one f32 train step on the whole batch
  tp_masks    n_model = n: every elementwise dropout mask of one forward at
              dropout 0.5 (``recorded_masks``)
  dp_step     n_data = n: one train step on the rank's rows
  dp_aug      n_data = n: one augmented step (flip, VAD mask, noise and the
              frequency mask) on the rank's rows
  trainer     n_data = n: ``Trainer(n_devices=n).fit`` on a corpus
"""

import contextlib
import json
import os
import sys
from unittest import mock

import numpy as np

from voiceactivityprojection_tpu_torch.parallel.mesh import spawn_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
SEED = 3
LIMIT_S = 90.0
MASK_RATE = 0.5


def run_ranks(tmp, n: int, mode: str, limit_s: float = LIMIT_S):
    """Runs ``n`` ranks of ``mode``; returns their outputs (one npz each;
    None for ``trainer``). The ranks' output goes to this process's."""
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with mock.patch.dict(os.environ, env):
        rc = spawn_local([sys.executable, os.path.abspath(__file__), mode, str(tmp)], n, timeout_s=limit_s)
    assert rc == 0, f"{n} ranks of {mode}: " + (f"not done in {limit_s} s" if rc == 124 else f"exit {rc}")
    if mode == "trainer":
        return None
    return [dict(np.load(os.path.join(str(tmp), f"{mode}_{r}.npz"))) for r in range(n)]


@contextlib.contextmanager
def recorded_masks():
    """The keep mask of every elementwise dropout drawn inside, in order."""
    import torch

    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    real = DropoutRng.dropout
    masks = []

    def dropout(self, x, rate, tp=None):  # the mask drawn on ones, then again from the same state on x
        state = self.masks.get_state()
        masks.append((real(self, torch.ones_like(x), rate, tp) != 0).numpy())
        self.masks.set_state(state)
        return real(self, x, rate, tp)

    DropoutRng.dropout = dropout
    try:
        yield masks
    finally:
        DropoutRng.dropout = real


# ------------------------------------------------------------------ a rank --
def _net(conf):
    from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
    from voiceactivityprojection_tpu_torch.models.vap import VapNet

    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=SEED), conf))
    return net


def _step_outputs(net, metrics):
    out = {f"metric.{k}": np.asarray(float(v)) for k, v in metrics.items()}
    for name, p in net.named_parameters():
        out[f"new.{name}"] = p.detach().numpy()
        if p.grad is not None:
            out[f"grad.{name}"] = p.grad.numpy()
    return out


def main(mode: str, tmp: str) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import forward
    from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout, init_distributed, make_mesh, shard_batch
    from voiceactivityprojection_tpu_torch.parallel.tp import shard_params_tp
    from voiceactivityprojection_tpu_torch.train import step as tstep

    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    n = dist.get_world_size()
    rank = dist.get_rank()
    out = {}
    if mode == "trainer":
        from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig
        from voiceactivityprojection_tpu_torch.train.loop import Trainer

        a = json.load(open(os.path.join(tmp, "args.json")))
        trainer = Trainer(model_conf=VapConfig(**a["model"]), opt_conf=OptConfig(**a["opt"]),
                          data_conf=DataConfig(**a["data"]), event_conf=EventConfig(**a["events"]),
                          max_epochs=a["max_epochs"], seed=a["seed"], out_dir=a["out_dir"], device="cpu",
                          n_devices=n, limit_batches=a["limit_batches"])
        trainer.fit()
        dist.destroy_process_group()
        return
    inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
    batch = {"waveform": torch.from_numpy(inputs["waveform"]), "vad": torch.from_numpy(inputs["vad"])}
    conf = VapConfig(**NARROW, dropout=0.0, freeze_encoder=bool(inputs.get("freeze", 1)))
    net = _net(conf)
    if mode.startswith("tp_"):
        layout = make_mesh(n_data=1, n_model=n)
        shard_params_tp(net, layout.model_rank, n, layout.model_group)
        if mode == "tp_forward":
            with torch.no_grad():
                o = forward(net, batch["waveform"], conf)
            out = {"logits": o["logits"].numpy(), "vad": o["vad"].numpy()}
        elif mode == "tp_masks":
            with recorded_masks() as masks, torch.no_grad():
                forward(net, batch["waveform"], dataclasses.replace(conf, dropout=MASK_RATE),
                        torch.Generator().manual_seed(0))
            out = {f"mask{i}": m for i, m in enumerate(masks)}
        else:
            opt = tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder)
            metrics = tstep.make_train_step(conf, opt)(net, batch, torch.Generator().manual_seed(0))
            out = _step_outputs(net, metrics)
    else:
        layout = ProcessLayout()
        try:  # a global batch the data ranks do not divide
            shard_batch({k: v[:3] for k, v in batch.items()}, layout)
            out["undivided_raised"] = np.asarray(False)
        except ValueError:
            out["undivided_raised"] = np.asarray(True)
        local = shard_batch(batch, layout)
        opt = tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder)
        if mode == "dp_step":
            metrics = tstep.make_train_step(conf, opt, layout)(net, local, torch.Generator().manual_seed(0))
        else:
            step = tstep.make_train_step_augmented(
                conf, do_flip=True, flip_prob=0.5, do_mask=True, mask_prob=0.5, noise_amplitude=0.01,
                sample_rate=16000, frame_hz=50, layout=layout)
            _, metrics = step(tstep.TrainState(net, opt), local, 5, int(inputs["choice"]))
        out.update(_step_outputs(net, metrics))
    np.savez(os.path.join(tmp, f"{mode}_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

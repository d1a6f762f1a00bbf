"""The training harness: loaders, the augmented train step, validation with
event metrics, the plateau learning rate, early stop and checkpoints.

Counterpart of ``voiceactivityprojection_tpu/train/loop.py`` (the
reference's Lightning ``VAPModel`` + ``Trainer``). Per epoch:

  train:    plan and host pitch of the next batch, its copy to the device
            (pinned, non-blocking), then the augmented train step of the
            batch before it (``train/step.py`` ``make_train_step_augmented``);
            the per-step losses stay on the device until the epoch ends
  validate: the eval step, turn-taking events from the ground-truth VAD,
            event metrics, and the phrase probe where its corpus is found
            (``data/phrases.py``)
  then:     the plateau schedule and early stop on the validation loss,
            ``ckpt_best`` when it improved, ``ckpt_last`` every epoch

A checkpoint is a directory of torch's format (``models/checkpoint.py``:
params, the optimizer's state dict, the step) and a JSON sidecar beside it
written last: the next epoch, the best validation loss, the plateau and
early-stop counters and the three host generators (augmentation plan, data
order, event sampling). The sidecar's ``format`` is ``torch_trainstate_v1``;
its step must equal the tensors' or the resume refuses (a torn save).
Together with ``step_generators(seed, step)`` that makes a resumed run
replay the straight one.

The Trainer runs on the card unless ``device`` names another. With
``n_devices`` > 1 it trains data parallel over that many processes, one a
device (JAX: ``make_mesh(n_data=n_devices)``, loop.py:152), which
``parallel/mesh.py`` ``init_distributed`` has joined (``torchrun``, or the
train CLI's ``--n_devices``): every rank loads its rows of each global
batch of ``batch_size`` and runs the same steps (``find_lr`` too) with the
gradients averaged over the ranks; rank 0 alone validates, logs and writes
the checkpoints, and broadcasts the validation loss so that the plateau
schedule and the early stop decide alike on every rank. ``--resume_from``
loads the same checkpoint on every rank.
"""

from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import asdict
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
from voiceactivityprojection_tpu_torch.events.events import TurnTakingEvents
from voiceactivityprojection_tpu_torch.events.metrics import EventMetrics, extract_prediction_and_targets
from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
from voiceactivityprojection_tpu_torch.models.vap import VapMonoNet, VapNet
from voiceactivityprojection_tpu_torch.ops.codebook import get_probs
from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout
from voiceactivityprojection_tpu_torch.train.augment import Augmentation
from voiceactivityprojection_tpu_torch.train.step import (
    EarlyStopping,
    ReduceLROnPlateau,
    TrainState,
    get_learning_rate,
    make_eval_step,
    make_eval_step_mono,
    make_optimizer,
    make_train_step_augmented,
    set_learning_rate,
)
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

FORMAT = "torch_trainstate_v1"


def data_layout(n_devices: Optional[int]) -> Optional[ProcessLayout]:
    """The data-parallel layout of a Trainer: the process group's, which
    must hold ``n_devices`` ranks where that is given; None for one device
    in a process outside any group."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, 0, world):
            raise ValueError(f"n_devices={n_devices}, but the process group holds {world} ranks")
        return ProcessLayout()
    if n_devices not in (None, 0, 1):
        raise RuntimeError(
            f"n_devices={n_devices} trains over {n_devices} processes: start them with torchrun "
            f"--nproc_per_node {n_devices} (or the train CLI's --n_devices), each joining the group with "
            "parallel.mesh.init_distributed()"
        )
    return None


def run_name(conf: VapConfig, data_conf: Optional[DataConfig] = None) -> str:
    """The architecture in the run's name (JAX: loop.py:57-67)."""
    ad = data_conf.audio_duration if data_conf is not None else 20.0
    ad = int(ad) if float(ad).is_integer() else ad
    return f"VapGPT_{conf.frame_hz}Hz_ad{ad}s_{conf.channel_layers}{conf.cross_layers}{conf.num_heads}"


class JsonlLogger:
    """stdout and a JSONL file, one record a line; with ``VAP_WANDB=1`` and
    the ``wandb`` package importable, every record mirrored to a wandb run
    (project ``VAP_WANDB_PROJECT``, default ``VapGPT``) (JAX: loop.py:70-120)."""

    def __init__(self, path: Optional[str], run_name: Optional[str] = None, enabled: bool = True):
        self.path = path
        self.f = None
        self.enabled = enabled
        self.wandb = None
        if not enabled:  # a rank other than 0: nothing printed, written or mirrored
            return
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.f = open(path, "a")
        if os.environ.get("VAP_WANDB") == "1":
            try:
                import wandb  # type: ignore

                self.wandb = wandb.init(project=os.environ.get("VAP_WANDB_PROJECT", "VapGPT"), name=run_name,
                                        resume="allow")
            except Exception as e:  # the package absent or its init failing: JSONL only
                print(f"wandb mirror disabled: {e}", flush=True)

    def log(self, record: Dict) -> None:
        if not self.enabled:
            return
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()),
              flush=True)
        if self.f:
            self.f.write(json.dumps(record) + "\n")
            self.f.flush()
        if self.wandb is not None:
            step = record.get("step")
            self.wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))},
                           step=step if isinstance(step, int) else None)

    def close(self) -> None:
        if self.f:
            self.f.close()
        if self.wandb is not None:
            self.wandb.finish()


class Trainer:
    def __init__(
        self,
        model_conf: Optional[VapConfig] = None,
        opt_conf: Optional[OptConfig] = None,
        data_conf: Optional[DataConfig] = None,
        event_conf: Optional[EventConfig] = None,
        max_epochs: int = 100,
        seed: int = 0,
        out_dir: str = "runs",
        n_devices: Optional[int] = None,
        limit_batches: Optional[int] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.layout = data_layout(n_devices)
        self.main = self.layout is None or self.layout.rank == 0
        self.device = resolve_device(device)
        self.model_conf = model_conf or VapConfig()
        self.opt_conf = opt_conf or OptConfig()
        self.data_conf = data_conf or DataConfig()
        self.event_conf = event_conf or EventConfig()
        self.max_epochs = max_epochs
        self.seed = seed
        self.limit_batches = limit_batches

        self.name = run_name(self.model_conf, self.data_conf)
        self.out_dir = os.path.join(out_dir, self.name)
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger = JsonlLogger(os.path.join(self.out_dir, "metrics.jsonl") if self.main else None,
                                  run_name=self.name, enabled=self.main)

        self.mono = bool(getattr(self.model_conf, "mono", False))
        dc = self.data_conf
        self.augment = Augmentation(seed=seed, pitch_mode=dc.pitch_mode, probability=dc.augment_probability)
        self.train_step = make_train_step_augmented(
            self.model_conf,
            mono=self.mono,
            do_flip=bool(dc.flip_channels) and not self.mono,
            flip_prob=dc.flip_probability,
            do_mask=bool(dc.mask_vad) and not self.mono,
            mask_prob=dc.mask_vad_probability,
            noise_amplitude=self.augment.noise_amplitude,
            sample_rate=dc.sample_rate,
            frame_hz=dc.frame_hz,
            # vocoder mode shifts pitch on the device inside the step; the
            # host mode shifts before the copy
            pitch_steps=self.augment.pitch_steps if self.augment.pitch_mode == "vocoder" else (),
            layout=self.layout,
        )
        self.eval_step = make_eval_step_mono(self.model_conf) if self.mono else make_eval_step(self.model_conf)
        self.event_extractor = TurnTakingEvents(self.event_conf, seed=seed)
        self.plateau = ReduceLROnPlateau(factor=self.opt_conf.lr_scheduler_factor,
                                         patience=self.opt_conf.lr_scheduler_patience)
        self.early_stop = EarlyStopping(patience=self.opt_conf.patience)
        self._phrase_probe: Any = "unset"  # built at the first validate()

    def phrase_probe(self):
        """The phrase probe of every validation (``data/phrases.py``), or None."""
        if self._phrase_probe == "unset":
            from voiceactivityprojection_tpu_torch.data.phrases import make_phrase_probe

            self._phrase_probe = make_phrase_probe(self.data_conf, mono=self.mono)
        return self._phrase_probe

    # ------------------------------------------------------------------
    def make_loaders(self) -> Tuple[Optional[VapDataLoader], Optional[VapDataLoader]]:
        """The training loader (shuffled, the ragged last batch dropped) and
        the validation loader (in order, every window kept); the mono model
        with ``va_history`` gets the loader's ``vah`` feature. Over processes
        the training loader yields each rank its rows of the global batch;
        validation runs on rank 0 over whole batches."""
        dc = self.data_conf
        va_history = self.mono and bool(getattr(self.model_conf, "va_history", False))
        if va_history:
            bins = int(getattr(self.model_conf, "va_history_bins", 5))
            if len(dc.va_history_times) + 1 != bins:
                raise ValueError(f"va_history_bins={bins} requires {bins - 1} va_history_times, "
                                 f"got {dc.va_history_times}")

        def mk(path: str, shuffle: bool) -> VapDataLoader:
            ds = SlidingWindowDataset(path, audio_duration=dc.audio_duration, horizon=dc.horizon_time,
                                      sample_rate=dc.sample_rate, frame_hz=dc.frame_hz, mono=self.mono,
                                      va_history=va_history, va_history_times=dc.va_history_times)
            shard = (self.layout.data_rank, self.layout.n_data) if shuffle and self.layout else (0, 1)
            return VapDataLoader(ds, batch_size=dc.batch_size, shuffle=shuffle, drop_last=shuffle, seed=self.seed,
                                 shard=shard)

        train = mk(dc.train_path, True) if dc.train_path else None
        val = mk(dc.val_path, False) if dc.val_path else None
        return train, val

    def init_net(self) -> torch.nn.Module:
        """Float32 weights drawn from the seed in the JAX layout
        (``random_params_tree``), on the Trainer's device."""
        net = (VapMonoNet if self.mono else VapNet)(self.model_conf)
        net.load_state_dict(ckpt.params_from_jax(ckpt.random_params_tree(self.model_conf, seed=self.seed),
                                                 self.model_conf))
        return net.to(self.device)

    def _optimizer(self, net: torch.nn.Module) -> torch.optim.Optimizer:
        return make_optimizer(self.opt_conf, net, self.model_conf.freeze_encoder)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One host-to-device copy per array: pinned and non-blocking on the
        card, so that it overlaps the step already queued."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t
        return out

    def _prepare(self, batch: Dict[str, np.ndarray]) -> Tuple[Dict[str, torch.Tensor], int]:
        """The host side of a step: the plan, the host pitch branch, the copy."""
        semis, choice = self.augment.plan()
        if semis is not None:
            batch = dict(batch)
            batch["waveform"] = self.augment.apply_pitch_host(np.asarray(batch["waveform"]), semis)
        return self._to_device(batch), choice

    # ------------------------------------------------------------------
    def find_lr(
        self,
        train_loader,
        net: torch.nn.Module,
        min_lr: float = 1e-7,
        max_lr: float = 1.0,
        num_steps: int = 100,
        smoothing: float = 0.98,
        diverge_factor: float = 4.0,
    ) -> Dict:
        """The learning-rate range test (JAX: loop.py:252-326) on a deep copy
        of ``net`` with a fresh optimizer, so the caller's weights stay as
        they are: the rate swept exponentially over ``num_steps`` batches,
        the bias-corrected smoothed loss recorded, a stop when it passes
        ``diverge_factor`` times the best, and the rate of the steepest
        descent suggested."""
        net = copy.deepcopy(net)
        state = TrainState(net, self._optimizer(net))
        lrs, smooth = [], []
        avg, best = 0.0, float("inf")
        step = 0
        diverged = False
        while step < num_steps and not diverged:
            progressed = False
            for batch in train_loader:
                if step >= num_steps:
                    break
                progressed = True
                lr = float(min_lr * (max_lr / min_lr) ** (step / max(1, num_steps - 1)))
                set_learning_rate(state.opt, lr)
                prepared, choice = self._prepare(batch)
                state, metrics = self.train_step(state, prepared, self.seed + 2, choice)
                loss = float(metrics["loss"])  # the sweep reads every loss
                step += 1
                if not np.isfinite(loss):
                    diverged = True
                    break
                avg = smoothing * avg + (1.0 - smoothing) * loss
                corrected = avg / (1.0 - smoothing**step)
                lrs.append(lr)
                smooth.append(corrected)
                best = min(best, corrected)
                if step > 10 and corrected > diverge_factor * best:
                    diverged = True
                    break
            if not progressed:
                break
        if len(smooth) < 3:
            return {"suggestion": self.opt_conf.learning_rate, "lrs": lrs, "losses": smooth}
        head = min(10, len(smooth) // 3)  # the noisy start
        grad = np.gradient(np.asarray(smooth))
        idx = head + int(np.argmin(grad[head: len(grad) - 1]))
        result = {"suggestion": float(lrs[idx]), "lrs": lrs, "losses": smooth}
        self.logger.log({"lr_find": {"suggestion": result["suggestion"], "steps": len(lrs), "diverged": diverged}})
        return result

    # ------------------------------------------------------------------
    def init_encoder(self, net: torch.nn.Module, path: str) -> None:
        """The pretrained encoder into ``net``: a CPC blob file (libri-light
        format, gEncoder and gAR; the downsample stays as drawn) or a
        checkpoint directory holding ``{"encoder"}`` (``pretrain_cpc``'s
        ``cpc_encoder``; the whole encoder)."""
        if os.path.isfile(path):
            result = net.encoder.load_state_dict(ckpt.load_cpc_blob(os.path.abspath(path)), strict=False)
            left = [k for k in result.missing_keys if not k.startswith("downsample.")]
            if left or result.unexpected_keys:
                raise ValueError(f"{path}: CPC blob does not fit the encoder: missing {left}, "
                                 f"unexpected {result.unexpected_keys}")
        else:
            restored = ckpt.restore_checkpoint(os.path.abspath(path), {"encoder": net.encoder.state_dict()})
            net.encoder.load_state_dict(restored["encoder"])
        print(f"Initialized encoder from {path}")

    def fit(self, resume_from: Optional[str] = None, init_encoder_from: Optional[str] = None) -> TrainState:
        """Train for ``max_epochs``. ``resume_from`` (a ``ckpt_last`` or
        ``ckpt_best`` directory) restores the whole training state when its
        sidecar says ``torch_trainstate_v1``, else only the params;
        ``init_encoder_from`` loads a pretrained encoder into the fresh
        weights (JAX: loop.py:329-554)."""
        train_loader, val_loader = self.make_loaders()
        if train_loader is None:
            raise ValueError("data_conf.train_path is required")

        net = self.init_net()
        if init_encoder_from:
            self.init_encoder(net, init_encoder_from)
        state = TrainState(net, self._optimizer(net))
        start_epoch = 0
        best_val = float("inf")
        resumed_full = False
        if resume_from:
            path = os.path.abspath(resume_from)
            meta = {}
            try:
                with open(path + ".json") as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                pass  # no sidecar: a params-only checkpoint
            if meta.get("format") == FORMAT:
                state, start_epoch, best_val = self._restore_full(state, path, meta, train_loader)
                resumed_full = True
                print(f"Resumed the whole training state from {resume_from} "
                      f"(epoch {start_epoch}, step {meta['step']})")
            else:
                net.load_state_dict(ckpt.restore_checkpoint(path, {"params": None})["params"])
                state = TrainState(net, self._optimizer(net))
                print(f"Resumed params from {resume_from} (params-only checkpoint: the optimizer and "
                      "schedule start fresh)")
        # a whole resume carries the plateau-adjusted rate in the optimizer
        if self.opt_conf.find_learning_rate and not resumed_full:
            found = self.find_lr(train_loader, state.net)
            print(f"lr_find: adopting learning_rate={found['suggestion']:.3g} (swept {len(found['lrs'])} steps)")
            set_learning_rate(state.opt, found["suggestion"])
        base_seed = self.seed + 1

        for epoch in range(start_epoch, self.max_epochs):
            # ---- train: prepare batch i + 1, then dispatch step i
            t0 = time.perf_counter()
            losses = []
            data_wait = prep_s = dispatch_s = 0.0
            n_steps = 0
            it = enumerate(train_loader)
            pending = None
            while True:
                tw = time.perf_counter()
                try:
                    i, batch = next(it)
                except StopIteration:
                    break
                data_wait += time.perf_counter() - tw
                if self.limit_batches and i >= self.limit_batches:
                    break
                n_steps += 1
                tw = time.perf_counter()
                prepared = self._prepare(batch)
                prep_s += time.perf_counter() - tw
                if pending is not None:
                    tw = time.perf_counter()
                    state, metrics = self.train_step(state, pending[0], base_seed, pending[1])
                    dispatch_s += time.perf_counter() - tw
                    losses.append(metrics["loss"])  # on the device: no sync a step
                pending = prepared
            if pending is not None:  # the last prepared batch
                state, metrics = self.train_step(state, pending[0], base_seed, pending[1])
                losses.append(metrics["loss"])
            train_loss = float(np.mean(torch.stack(losses).float().cpu().numpy())) if losses else float("nan")

            train_s = time.perf_counter() - t0
            record = {
                "epoch": epoch,
                "loss": train_loss,
                "lr": get_learning_rate(state.opt),
                "train_s": train_s,
                # host stages (host clock, unrounded): waiting on the loader,
                # plan + host pitch + copy, enqueueing the step
                "data_wait_s": data_wait,
                "prep_s": prep_s,
                "dispatch_s": dispatch_s,
                "steps": n_steps,
            }
            if not self.mono and n_steps and train_s > 0:
                self._mfu(record, n_steps, train_s)

            # ---- validate (rank 0; every rank schedules from its loss)
            stop = False
            if val_loader is not None:
                val = self.validate(state.net, val_loader) if self.main else {}
                record.update(val)
                val_loss = val.get("val_loss", float("nan"))
                if self.layout is not None:
                    (val_loss,) = self.layout.broadcast([val_loss])
                self.plateau.update(state.opt, val_loss)
                stop = self.early_stop.update(val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    self.save(state, "best", epoch=epoch, best_val=best_val, train_loader=train_loader)
            # ckpt_last carries the whole state at the end of every epoch
            self.save(state, "last", epoch=epoch, best_val=best_val, train_loader=train_loader)
            if stop:
                record["early_stop"] = True
            self.logger.log(record)
            if stop:
                break
        if not os.path.isdir(os.path.join(self.out_dir, "ckpt_last")):
            # a fit of no epochs still leaves a resume point in out_dir
            self.save(state, "last", epoch=start_epoch - 1, best_val=best_val, train_loader=train_loader)
        return state

    def _mfu(self, record: Dict, n_steps: int, train_s: float) -> None:
        """``train_tflops`` / ``train_mfu`` over the epoch's wall time, data
        waits included, where the card's peak is known (``utils/flops.py``)."""
        from voiceactivityprojection_tpu_torch.utils.flops import device_peak_tflops, stereo_train_flops

        peak = device_peak_tflops(self.device)
        if not peak:
            return
        peak *= 1 if self.layout is None else self.layout.world
        dc, mc = self.data_conf, self.model_conf
        per_chunk = stereo_train_flops(int(dc.audio_duration * dc.sample_rate), mc.dim, mc.channel_layers,
                                       mc.cross_layers, frozen_encoder=mc.freeze_encoder)["total"]
        achieved = per_chunk * dc.batch_size * n_steps / train_s / 1e12
        record["train_tflops"] = round(achieved, 2)
        record["train_mfu"] = round(achieved / peak, 4)

    # ------------------------------------------------------------------
    def validate(self, net: torch.nn.Module, val_loader, split: str = "val") -> Dict[str, float]:
        """Losses and event metrics over ``val_loader`` and, where the phrase
        corpus is found, the probe through the net's weights: its nine
        ``val_p*`` scalars at ``val``, every region mean at another split
        (JAX: loop.py:557-603)."""
        vap_losses, vad_losses = [], []
        em = EventMetrics()
        for i, batch in enumerate(val_loader):
            if self.limit_batches and i >= self.limit_batches:
                break
            out = self.eval_step(net, batch)
            vap_loss, vad_loss = torch.stack([out["vap_loss"], out["vad_loss"]]).float().tolist()
            vap_losses.append(vap_loss)
            vad_losses.append(vad_loss)
            events = self.event_extractor(np.asarray(batch["vad"]))
            probs = get_probs(out["logits"].float())
            preds, targets = extract_prediction_and_targets(
                probs["p_now"].cpu().numpy(), probs["p_future"].cpu().numpy(), events)
            em.update(preds, targets)
        rec = {
            f"{split}_loss": float(np.mean(vap_losses)) if vap_losses else float("nan"),
            f"{split}_loss_va": float(np.mean(vad_losses)) if vad_losses else float("nan"),
        }
        rec.update({f"{split}_{k}": v for k, v in em.compute().items()})
        probe = self.phrase_probe()
        if probe is not None:
            from voiceactivityprojection_tpu_torch.models.vap import VapModel, VapMonoModel

            model = (VapMonoModel if self.mono else VapModel).over_net(net, self.model_conf)
            means, _ = probe.extract_stats(model)
            if split == "val":
                rec.update(probe.val_log_stats(means))
            else:
                rec.update({f"{split}_{k}": float(v) for k, v in means.items()})
        return rec

    # ------------------------------------------------------------------
    def save(self, state: TrainState, tag: str, epoch: Optional[int] = None, best_val: float = float("inf"),
             train_loader=None) -> None:
        """The whole training state as ``ckpt_{tag}/`` and ``ckpt_{tag}.json``
        (JAX: loop.py:606-664): tensors first, the sidecar last, each replaced
        atomically, so the sidecar commits the checkpoint. Rank 0 alone
        writes."""
        if not self.main:
            return
        path = os.path.abspath(os.path.join(self.out_dir, f"ckpt_{tag}"))
        ev = self.event_extractor.rng.getstate()
        meta = {
            "model_conf": asdict(self.model_conf),
            "opt_conf": asdict(self.opt_conf),
            "step": int(state.step),
            "format": FORMAT,
            "trainer": {
                "next_epoch": (epoch + 1) if epoch is not None else 0,
                "best_val": best_val if np.isfinite(best_val) else None,  # JSON has no Infinity
                "plateau": {"best": self.plateau.best, "bad_epochs": self.plateau.bad_epochs},
                "early_stop": {"best": self.early_stop.best, "bad_epochs": self.early_stop.bad_epochs},
                "augment_rng": self.augment.np_rng.bit_generator.state,
                "loader_rng": train_loader.rng.bit_generator.state if train_loader is not None else None,
                "events_rng": [ev[0], list(ev[1]), ev[2]],
            },
        }
        ckpt.save_checkpoint(path, {"params": state.net.state_dict(), "opt_state": state.opt.state_dict(),
                                    "step": int(state.step)})
        sidecar = os.path.join(self.out_dir, f"ckpt_{tag}.json")
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, sidecar)

    def _restore_full(self, state: TrainState, path: str, meta: Dict, train_loader) -> Tuple[TrainState, int, float]:
        """Inverse of ``save`` (JAX: loop.py:666-707): the weights, the
        optimizer (moments, step counts and the plateau-adjusted rate) into
        an optimizer over the same parameter list, the step, then the host
        counters and generators."""
        restored = ckpt.restore_checkpoint(path, {"params": state.net.state_dict(), "opt_state": None,
                                                  "step": None})
        state.net.load_state_dict(restored["params"])
        state.opt.load_state_dict(restored["opt_state"])
        state.step = int(restored["step"])
        # the tensors are written before the sidecar: steps that disagree
        # mean a crash between the two
        if int(meta.get("step", state.step)) != state.step:
            raise RuntimeError(
                f"Checkpoint {path} is torn: sidecar step {meta.get('step')} != tensor step {state.step} "
                "(crash mid-save?). Resume from the previous ckpt tag."
            )
        tr = meta["trainer"]
        self.plateau.best = tr["plateau"]["best"]
        self.plateau.bad_epochs = tr["plateau"]["bad_epochs"]
        self.early_stop.best = tr["early_stop"]["best"]
        self.early_stop.bad_epochs = tr["early_stop"]["bad_epochs"]
        if tr.get("augment_rng"):
            self.augment.np_rng.bit_generator.state = tr["augment_rng"]
        if tr.get("loader_rng") and train_loader is not None:
            train_loader.rng.bit_generator.state = tr["loader_rng"]
        if tr.get("events_rng"):
            v, st, g = tr["events_rng"]
            self.event_extractor.rng.setstate((v, tuple(st), g))
        best_val = tr.get("best_val")
        return state, int(tr["next_epoch"]), float("inf") if best_val is None else float(best_val)

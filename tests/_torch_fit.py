"""``Trainer.fit`` of the JAX package and of the port side by side on one
corpus from the same weights (JAX's ``init_vap`` replaced by the port's
``random_params_tree``), augmentation off, dropout 0, one device, and the
comparison of their epoch records: losses within 1e-5 relative, the rate
sequence and step counts identical, the validation metrics equal apart
from counted near-threshold predictions, and the phrase probe's ``val_p*``
scalars, where the probe ran, within ``PROBE_TOL``."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from voiceactivityprojection_tpu.config import DataConfig as JDataConfig
from voiceactivityprojection_tpu.config import EventConfig as JEventConfig
from voiceactivityprojection_tpu.config import OptConfig as JOptConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.train import loop as jloop
from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.train import loop as tloop

from _torch_eval import compare_evaluations

NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
EVENTS = dict(min_context_time=1.0, max_time=4.0, bc_negative_pad_left_time=0.4, bc_negative_pad_right_time=0.4)
PROBE_KEYS = tuple(f"val_p{f}_{r}" for f in ("s", "l", "ls") for r in ("hold", "pred", "react"))
PROBE_TOL = 2e-6


def fit_both(corpus, tmp_path, monkeypatch, epochs=3, seed=3, **data_kw):
    """Fits both Trainers; returns ({"jax": rows, "port": rows}, pooled
    predictions by side, JAX's final state, the port's Trainer and state)."""
    kw = dict(NARROW, dropout=0.0)
    tconf = VapConfig(**kw)
    monkeypatch.setattr(jloop, "init_vap",
                        lambda key, conf: jax.tree.map(jnp.asarray, random_params_tree(tconf, seed=seed)))
    data = dict(dict(phrases_probe=0, train_path=corpus, val_path=corpus, batch_size=2, audio_duration=4.0,
                     augment_probability=0.0, flip_channels=False, pitch_mode="resample"), **data_kw)
    pooled = {"jax": [], "port": []}

    def recorder(module, side):
        base = module.extract_prediction_and_targets

        def record(p_now, p_future, events):
            preds, targets = base(p_now, p_future, events)
            pooled[side].append((preds, targets))
            return preds, targets

        monkeypatch.setattr(module, "extract_prediction_and_targets", record)

    recorder(jloop, "jax")
    recorder(tloop, "port")
    jt = jloop.Trainer(model_conf=JVapConfig(**kw), opt_conf=JOptConfig(patience=50, lr_scheduler_patience=0),
                       data_conf=JDataConfig(**data), event_conf=JEventConfig(**EVENTS), max_epochs=epochs,
                       seed=seed, out_dir=str(tmp_path / "jax"), n_devices=1)
    jstate = jt.fit()
    tt = tloop.Trainer(model_conf=tconf, opt_conf=OptConfig(patience=50, lr_scheduler_patience=0),
                       data_conf=DataConfig(**data), event_conf=EventConfig(**EVENTS), max_epochs=epochs, seed=seed,
                       out_dir=str(tmp_path / "port"), device="cpu")
    tstate = tt.fit()
    rows = {side: [json.loads(line) for line in open(os.path.join(t.out_dir, "metrics.jsonl"))]
            for side, t in (("jax", jt), ("port", tt))}
    return rows, pooled, jstate, tt, tstate


def check_rows(rows, pooled, epochs=3):
    """Every epoch record of the port against JAX's (see the module note)."""
    assert len(rows["jax"]) == len(rows["port"]) == epochs
    n_batches = len(pooled["port"]) // epochs
    for epoch, (j, t) in enumerate(zip(rows["jax"], rows["port"])):
        assert set(t) == set(j) - {"train_tflops", "train_mfu"}
        # JAX holds the rate in float32; the port a Python float of it
        assert (t["epoch"], t["steps"], np.float32(t["lr"])) == (j["epoch"], j["steps"], np.float32(j["lr"]))
        for key in ("loss", "val_loss", "val_loss_va"):
            assert abs(t[key] - j[key]) <= 1e-5 * abs(j[key]), (epoch, key, t[key], j[key])
        for key in PROBE_KEYS:
            if key in j:
                assert abs(t[key] - j[key]) <= PROBE_TOL, (epoch, key, t[key], j[key])

        def as_test(row):
            return {"test_" + k[len("val_"):]: v for k, v in row.items()
                    if k.startswith("val_") and k not in PROBE_KEYS}

        def pool(side):
            got = pooled[side][epoch * n_batches:(epoch + 1) * n_batches]
            fams = sorted({f for preds, _ in got for f, v in preds.items() if v is not None})
            return {f: (np.concatenate([p[f] for p, _ in got if p.get(f) is not None]),
                        np.concatenate([tg[f] for p, tg in got if p.get(f) is not None])) for f in fams}

        report = compare_evaluations(as_test(t), as_test(j), pool("port"), pool("jax"), 1e-5,
                                     1e-5 * abs(j["val_loss"]))
        assert not report["mismatches"], (epoch, report)

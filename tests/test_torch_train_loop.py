"""PyTorch port, the training harness on the CPU: the augmented and mono
steps and ``Trainer.fit`` against the JAX package on the same corpus,
weights and draws; the Trainer's own behaviour (exact resume, params-only
resume, a torn checkpoint refused, the LR sweep on a copy, mono with the
VAD history, encoders from a CPC blob or a checkpoint directory, refusals);
torch-format checkpoints; the seeding, FLOP and logging utilities."""

import copy
import dataclasses
import json
import os
import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from voiceactivityprojection_tpu.config import DataConfig as JDataConfig
from voiceactivityprojection_tpu.config import OptConfig as JOptConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.config import VapMonoConfig as JVapMonoConfig
from voiceactivityprojection_tpu.train import augment as jaug
from voiceactivityprojection_tpu.train import loop as jloop
from voiceactivityprojection_tpu.train import step as jstep
from voiceactivityprojection_tpu.utils import flops as jflops
from voiceactivityprojection_tpu_torch import params_from_jax
from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.models import checkpoint as tckpt
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapMonoNet, VapNet
from voiceactivityprojection_tpu_torch.train import augment as taug
from voiceactivityprojection_tpu_torch.train import loop as tloop
from voiceactivityprojection_tpu_torch.train import step as tstep
from voiceactivityprojection_tpu_torch.utils import flops as tflops
from voiceactivityprojection_tpu_torch.utils.runtime import everything_deterministic

from _torch_corpus import dialog_corpus
from _torch_fit import check_rows, fit_both

pytestmark = pytest.mark.train

torch.set_num_threads(2)

NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
FROZEN = ("encoder.gEncoder.", "encoder.gAR.")
EVENTS = dict(min_context_time=1.0, max_time=4.0, bc_negative_pad_left_time=0.4, bc_negative_pad_right_time=0.4)
# one f32 step against JAX: the bars of tests/test_torch_train.py
LOSS_TOL, GRAD_REL, UPDATE_TOL = 2e-6, 1e-5, 5e-7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return dialog_corpus(tmp_path_factory.mktemp("corpus"))


def _data(corpus, **kw):
    return dict(dict(phrases_probe=0, train_path=corpus, val_path=corpus, batch_size=2, audio_duration=4.0), **kw)


def _trainer(corpus, out, max_epochs, conf=None, opt=None, seed=3, data=None, **kw):
    return tloop.Trainer(
        model_conf=conf or VapConfig(**NARROW), opt_conf=opt or OptConfig(patience=50),
        data_conf=DataConfig(**(data or _data(corpus))), event_conf=EventConfig(**EVENTS),
        max_epochs=max_epochs, seed=seed, out_dir=str(out), device="cpu", **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _compare_update(net, jgrads, jnew, before, frozen):
    """Every gradient within GRAD_REL of its leaf's largest, the updated
    weights within UPDATE_TOL where the gradient is clear of that bound."""
    for name, p in net.named_parameters():
        if frozen and name.startswith(FROZEN):
            assert p.grad is None, name
            np.testing.assert_array_equal(p.detach().numpy(), before[name])
            continue
        want = jgrads[name]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_REL * scale, err_msg=name)
        clear = np.abs(want) > max(1e-6, 2 * GRAD_REL * scale)
        np.testing.assert_allclose(p.detach().numpy()[clear], jnew[name][clear], atol=UPDATE_TOL, err_msg=name)


# ---------------------------------------------------------------- steps ---
def test_augmented_train_step_matches_jax(monkeypatch):
    """One f32 step of ``make_train_step_augmented`` at choice 3 (frequency
    mask, then noise) with the flip and the VAD mask on, dropout 0: the JAX
    step's draws (``fold_in(key, 0)``, split as JAX splits it) handed to the
    port; the batch, the losses and the update against JAX at the bars of
    tests/test_torch_train.py (the update where the port's gradient is clear
    of their bound; the gradients themselves are held there)."""
    kw = dict(NARROW, dropout=0.0)
    jconf, tconf = JVapConfig(**kw), VapConfig(**kw)
    tree = random_params_tree(tconf, seed=11)
    rng = np.random.default_rng(2)
    n = 16_000
    batch = {"waveform": (0.1 * rng.standard_normal((2, 2, n))).astype(np.float32),
             "vad": (rng.random((2, n // 320 + 100, 2)) < 0.5).astype(np.float32)}
    aug = dict(do_flip=True, flip_prob=0.5, do_mask=True, mask_prob=0.5, noise_amplitude=0.01,
               sample_rate=16_000, frame_hz=50)
    choice, base = 3, jax.random.key(7)

    # JAX: the whole step, and its batch rebuilt from its keys
    params = jax.tree.map(jnp.asarray, tree)
    tx = jstep.make_optimizer(JOptConfig(), freeze_encoder=True)
    jstate, jm = jstep.make_train_step_augmented(jconf, tx, **aug)(
        jstep.init_train_state(jax.tree.map(jnp.copy, params), tx), jax.tree.map(jnp.asarray, batch), base,
        jnp.int32(choice))  # the step donates its state
    k1, _ = jax.random.split(jax.random.fold_in(base, 0))
    jbatch = jaug.augment_on_device(jax.tree.map(jnp.asarray, batch), k1, jnp.int32(choice), **aug)

    # the port, given those draws
    a1, a2, a3, a4 = jax.random.split(k1, 4)
    b1, b2 = jax.random.split(a4)
    width = int(jax.random.randint(b1, (), 0, 41))
    draws = taug.AugmentDraws(
        flip=torch.from_numpy(np.asarray(jax.random.bernoulli(a1, 0.5, (2,)))),
        mask=torch.from_numpy(np.asarray(jax.random.bernoulli(a2, 0.5, (2,)))),
        band=(width, int(jax.random.randint(b2, (), 0, max(201 - width, 1)))),
        noise=torch.from_numpy(np.asarray(jax.random.normal(a3, (2, 2, n)))))
    seen = {}
    base_apply = taug.augment_on_device

    def apply(batch_, draws_, choice_, **kw_):
        out = base_apply(batch_, draws, choice_, **kw_)
        seen["batch"] = out
        return out

    monkeypatch.setattr(taug, "augment_on_device", apply)
    net = VapNet(tconf)
    net.load_state_dict(params_from_jax(tree, tconf))
    state = tstep.TrainState(net, tstep.make_optimizer(OptConfig(), net, True))
    step = tstep.make_train_step_augmented(tconf, **aug)
    state, tm = step(state, batch, 7, choice)
    assert state.step == 1
    np.testing.assert_array_equal(seen["batch"]["vad"].numpy(), np.asarray(jbatch["vad"]))
    np.testing.assert_allclose(seen["batch"]["waveform"].numpy(), np.asarray(jbatch["waveform"]), atol=1e-5)
    for key in ("loss", "vap_loss", "vad_loss"):
        assert abs(float(tm[key]) - float(jm[key])) <= LOSS_TOL, key
    jnew, before = _flat(jstate.params), _flat(tree)
    for name, p in net.named_parameters():
        if name.startswith(FROZEN):
            assert p.grad is None and np.array_equal(p.detach().numpy(), before[name]), name
            continue
        g = p.grad.numpy()
        clear = np.abs(g) > max(1e-6, 2 * GRAD_REL * float(np.abs(g).max()))
        np.testing.assert_allclose(p.detach().numpy()[clear], jnew[name][clear], atol=UPDATE_TOL, err_msg=name)


def test_step_generators_are_a_fixed_function_of_seed_and_step():
    draw = lambda g: int(torch.randint(0, 2**62, (), generator=g))
    a = [draw(g) for g in tstep.step_generators(5, 12)]
    assert a == [draw(g) for g in tstep.step_generators(5, 12)]
    assert a != [draw(g) for g in tstep.step_generators(5, 13)]
    assert a != [draw(g) for g in tstep.step_generators(6, 12)]
    words = np.random.SeedSequence((5, 12)).generate_state(2)
    assert a == [draw(torch.Generator().manual_seed(int(w))) for w in words]


def _mono_batch(B=2, t50=50, seed=0, bins=5):
    rng = np.random.default_rng(seed)
    return {"waveform": (0.1 * rng.standard_normal((B, 1, t50 * 320))).astype(np.float32),
            "vad": (rng.random((B, t50 + 100, 2)) < 0.4).astype(np.float32),
            "vah": rng.random((B, t50 + 100, bins)).astype(np.float32)}


@pytest.mark.parametrize("history", [False, True])
def test_mono_train_step_matches_jax(history):
    kw = dict(NARROW, dropout=0.0, va_history=history)
    jconf, tconf = JVapMonoConfig(**kw), VapMonoConfig(**kw)
    tree = random_params_tree(tconf, seed=21)
    batch = _mono_batch(seed=1)
    if not history:
        del batch["vah"]
    params = jax.tree.map(jnp.asarray, tree)
    (jloss, jaux), jgrads = jax.value_and_grad(jstep.loss_fn_mono, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch), jconf)
    tx = jstep.make_optimizer(JOptConfig(), freeze_encoder=True)
    jnew = optax.apply_updates(params, tx.update(jgrads, tx.init(params), params)[0])
    jstate, jm = jstep.make_train_step_mono(jconf, tx)(jstep.init_train_state(jax.tree.map(jnp.copy, params), tx),
                                                       jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    assert abs(float(jm["loss"]) - float(jloss)) <= LOSS_TOL
    net = VapMonoNet(tconf)
    net.load_state_dict(params_from_jax(tree, tconf))
    m = tstep.make_train_step_mono(tconf, tstep.make_optimizer(OptConfig(), net, True))(
        net, batch, torch.Generator().manual_seed(0))
    for key in ("loss", "vap_loss", "vad_loss"):
        assert abs(float(m[key]) - float(jm[key])) <= LOSS_TOL, key
    assert float(m["vad_loss"]) == 0.0
    _compare_update(net, _flat(jgrads), _flat(jnew), _flat(tree), frozen=True)


@pytest.mark.parametrize("history", [False, True])
def test_mono_eval_step_matches_jax(history):
    kw = dict(NARROW, va_history=history)
    jconf, tconf = JVapMonoConfig(**kw), VapMonoConfig(**kw)
    tree = random_params_tree(tconf, seed=22)
    batch = _mono_batch(seed=2)
    if not history:
        del batch["vah"]
    want = jstep.make_eval_step_mono(jconf)(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    net = VapMonoNet(tconf)
    net.load_state_dict(params_from_jax(tree, tconf))
    got = tstep.make_eval_step_mono(tconf)(net, batch)
    assert set(got) == set(want)
    for key, atol in (("vap_loss", 1e-5), ("vad_loss", 0.0), ("logits", 2e-5), ("vad_logits", 0.0)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, err_msg=key)


# --------------------------------------------------- the trajectory ---
def test_trainer_fit_matches_jax(corpus, tmp_path, monkeypatch):
    """Three epochs of ``Trainer.fit`` on both sides from the same weights
    (JAX's ``init_vap`` replaced here by the port's ``random_params_tree``),
    augmentation off, dropout 0, one device: epoch losses within 1e-5
    relative, the rate sequence and step counts identical, the validation
    metrics equal apart from counted near-threshold predictions
    (``tests/_torch_fit.py``)."""
    rows, pooled, jstate, tt, tstate = fit_both(corpus, tmp_path, monkeypatch)
    assert tstate.step == int(jstate.step) == 3
    check_rows(rows, pooled)
    # the best checkpoint's weights where the trajectories agree
    params = tckpt.restore_checkpoint(os.path.join(tt.out_dir, "ckpt_last"), {"params": None})["params"]
    jflat = _flat(jax.tree.map(np.asarray, jstate.params))
    for name, value in params.items():
        np.testing.assert_allclose(value.numpy(), jflat[name], atol=1e-5, err_msg=name)


# ------------------------------------------------ Trainer behaviour ---
def _trajectory(*dirs):
    rows = []
    for d in dirs:
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    return [(r["epoch"], r["steps"], r["loss"], r.get("val_loss"), r["lr"]) for r in rows]


def test_resume_is_exact(corpus, tmp_path):
    """Four epochs straight equal two, a resume from ``ckpt_last`` and two
    more: the per-epoch trajectory, every weight, the AdamW moments and step
    counts and the step, at atol 0; with the augmentation on (the vocoder
    pitch shift included) and dropout 0.1, and a plateau patience of 0 so
    that the rate changes (as tests/test_train_loop.py:233)."""
    data = _data(corpus, augment_probability=1.0)
    # a large rate, so that some epoch's validation loss rises and halves it
    opt = OptConfig(patience=50, lr_scheduler_patience=0, learning_rate=0.05)
    straight = _trainer(corpus, tmp_path / "straight", 4, opt=opt, data=data)
    state_a = straight.fit()
    seg1 = _trainer(corpus, tmp_path / "seg1", 2, opt=opt, data=data)
    seg1.fit()
    seg2 = _trainer(corpus, tmp_path / "seg2", 4, opt=opt, data=data)
    state_b = seg2.fit(resume_from=os.path.join(seg1.out_dir, "ckpt_last"))

    traj_a = _trajectory(straight.out_dir)
    traj_b = _trajectory(seg1.out_dir, seg2.out_dir)
    assert [t[0] for t in traj_b] == [0, 1, 2, 3]
    assert traj_a == traj_b
    assert len({t[-1] for t in traj_a}) > 1, "the plateau schedule moved the rate"
    assert state_a.step == state_b.step == 4
    for (name, a), b in zip(state_a.net.state_dict().items(), state_b.net.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = state_a.opt.state_dict(), state_b.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for key in sa["state"][i]:
            assert torch.equal(sa["state"][i][key], sb["state"][i][key]), (i, key)


def test_params_only_checkpoint_resumes(corpus, tmp_path):
    conf = VapConfig(**NARROW)
    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=1), conf))
    legacy = str(tmp_path / "legacy")
    tckpt.save_checkpoint(legacy, {"params": net.state_dict()})
    trainer = _trainer(corpus, tmp_path / "run", 1, data=_data(corpus, val_path=""))
    state = trainer.fit(resume_from=legacy)
    assert state.step == 1
    # the weights it started from were the checkpoint's: the frozen CPC
    for name, value in net.state_dict().items():
        if name.startswith(FROZEN):
            assert torch.equal(state.net.state_dict()[name], value), name


def test_torn_checkpoint_is_refused(corpus, tmp_path):
    seg1 = _trainer(corpus, tmp_path / "seg1", 1, data=_data(corpus, val_path=""))
    seg1.fit()
    ckpt = os.path.join(seg1.out_dir, "ckpt_last")
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    assert meta["format"] == "torch_trainstate_v1" and meta["step"] == 1
    assert os.listdir(ckpt) == ["state.pt"]
    meta["step"] += 7
    with open(ckpt + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="torn"):
        _trainer(corpus, tmp_path / "seg2", 2, data=_data(corpus, val_path="")).fit(resume_from=ckpt)


def test_find_lr_sweeps_a_copy(corpus, tmp_path):
    """The sweep trains a deep copy with a fresh optimizer: the caller's
    weights stay as they were; its suggestion is a swept rate; ``fit``
    adopts it (as tests/test_train_loop.py:193)."""
    trainer = _trainer(corpus, tmp_path, 1, opt=OptConfig(find_learning_rate=True, patience=50),
                       data=_data(corpus, val_path=""))
    train_loader, _ = trainer.make_loaders()
    net = trainer.init_net()
    before = copy.deepcopy(net.state_dict())
    res = trainer.find_lr(train_loader, net, num_steps=12)
    for name, value in net.state_dict().items():
        assert torch.equal(value, before[name]), name
        assert net.state_dict()[name].grad is None
    assert len(res["lrs"]) == len(res["losses"]) <= 12
    assert np.all(np.isfinite(res["losses"])) and np.all(np.diff(res["lrs"]) > 0)
    assert min(res["lrs"]) <= res["suggestion"] <= max(res["lrs"])
    state = trainer.fit()
    assert np.isfinite(tstep.get_learning_rate(state.opt))
    assert tstep.get_learning_rate(state.opt) != OptConfig().learning_rate


def test_mono_fit_with_va_history(corpus, tmp_path):
    """``VapMonoConfig(va_history=True)``: the loader's ``vah`` reaches the
    mono forward and changes the loss, and a mono fit takes its step and
    validates (as tests/test_train_loop.py:143)."""
    conf = VapMonoConfig(**NARROW, va_history=True)
    data = _data(corpus, flip_channels=False, va_history_times=(2.0, 1.0, 0.5, 0.25))
    trainer = _trainer(corpus, tmp_path, 1, conf=conf, data=data)
    train_loader, _ = trainer.make_loaders()
    batch = next(iter(train_loader))
    assert batch["waveform"].shape == (2, 1, 64_000) and batch["vah"].shape == (2, 300, 5)
    assert not np.allclose(batch["vah"], 0.5)
    net = trainer.init_net()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        with_h = float(tstep.loss_fn_mono(net, tb, conf)[0])
        without = float(tstep.loss_fn_mono(net, {k: v for k, v in tb.items() if k != "vah"}, conf)[0])
    assert np.isfinite(with_h) and abs(with_h - without) > 1e-7
    state = trainer.fit()
    assert state.step == 1
    row = json.loads(open(os.path.join(trainer.out_dir, "metrics.jsonl")).readline())
    assert np.isfinite(row["loss"]) and np.isfinite(row["val_loss"]) and row["val_loss_va"] == 0.0
    with pytest.raises(ValueError, match="va_history_bins"):
        _trainer(corpus, tmp_path / "bad", 1, conf=conf,
                 data=_data(corpus, flip_channels=False, va_history_times=(2.0, 1.0, 0.5))).make_loaders()


def test_checkpoint_round_trip(tmp_path):
    """Params, AdamW's state and the step through ``state.pt`` bit for bit;
    a params-only read of a whole state; a mismatched model and a
    directory without ``state.pt`` (an orbax checkpoint) refused."""
    conf = VapConfig(**NARROW)
    net = VapNet(conf)
    net.load_state_dict(params_from_jax(random_params_tree(conf, seed=4), conf))
    opt = tstep.make_optimizer(OptConfig(), net, True)
    step = tstep.make_train_step(conf, opt)
    rng = np.random.default_rng(0)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16_000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    for i in range(2):
        step(net, batch, torch.Generator().manual_seed(i))
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, {"params": net.state_dict(), "opt_state": opt.state_dict(), "step": 2})
    assert sorted(os.listdir(path)) == ["state.pt"]
    full = tckpt.restore_checkpoint(path)
    assert full["step"] == 2
    net2 = VapNet(conf)
    net2.load_state_dict(full["params"])
    opt2 = tstep.make_optimizer(OptConfig(), net2, True)
    opt2.load_state_dict(full["opt_state"])
    for (name, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), name
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"] and s1["state"].keys() == s2["state"].keys()
    for i in s1["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1["state"][i][key], s2["state"][i][key]), (i, key)
    # the next step from either is the same
    m1 = step(net, batch, torch.Generator().manual_seed(9))
    m2 = tstep.make_train_step(conf, opt2)(net2, batch, torch.Generator().manual_seed(9))
    assert float(m1["loss"]) == float(m2["loss"])
    for (name, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), name

    sub = tckpt.restore_checkpoint(path, {"params": net.state_dict()})
    assert set(sub) == {"params"}
    other = VapNet(VapConfig(dim=32, encoder_dim=16, channel_layers=1, cross_layers=1))
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(path, {"params": other.state_dict()})
    with pytest.raises(ValueError, match="holds"):
        tckpt.restore_checkpoint(path, {"encoder": None})
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        tckpt.restore_checkpoint(str(orbax))


def test_init_encoder_from_a_blob_and_a_directory(corpus, tmp_path):
    """A CPC blob (256 wide: the blob format's contract) sets gEncoder and
    gAR and keeps the drawn downsample; a checkpoint directory holding
    ``{"encoder"}`` sets the whole encoder, and ``fit`` starts from it."""
    for conf, path, whole in ((VapConfig(channel_layers=1, cross_layers=1), tmp_path / "cpc_blob.pt", False),
                              (VapConfig(**NARROW), tmp_path / "cpc_encoder", True)):
        enc = tckpt.encoder_from_jax(random_params_tree(conf, seed=9)["encoder"])
        if whole:
            tckpt.save_checkpoint(str(path), {"encoder": enc.state_dict()})
        else:
            tckpt.export_cpc_blob(enc, str(path))
        trainer = _trainer(corpus, tmp_path / f"run{int(whole)}", 1, conf=conf, data=_data(corpus, val_path=""))
        net = trainer.init_net()
        drawn = copy.deepcopy(net.encoder.state_dict())
        trainer.init_encoder(net, str(path))
        for name, value in net.encoder.state_dict().items():
            if name.startswith("downsample.") and not whole:
                assert torch.equal(value, drawn[name]), name
            else:
                assert torch.equal(value, enc.state_dict()[name]), (path, name)
    state = trainer.fit(init_encoder_from=str(path))
    assert state.step == 1
    assert torch.equal(state.net.encoder.gAR.w_hh, enc.gAR.w_hh)  # frozen: still the checkpoint's
    with pytest.raises(ValueError, match="does not match"):
        _trainer(corpus, tmp_path / "wide", 1, data=_data(corpus, val_path="")).init_encoder(
            VapNet(VapConfig(dim=32, encoder_dim=32, channel_layers=1, cross_layers=1)), str(path))


def test_refusals(corpus, tmp_path):
    # the psola mode, refused until ops/prosody.py was ported, now builds
    # (tests/test_torch_probe_cli.py trains with it)
    assert _trainer(corpus, tmp_path, 1, data=_data(corpus, pitch_mode="psola")).augment.pitch_mode == "psola"
    # more than one device needs the processes joined first
    # (tests/test_torch_parallel.py trains over two)
    with pytest.raises(RuntimeError, match="torchrun"):
        _trainer(corpus, tmp_path, 1, n_devices=2)
    with pytest.raises(ValueError, match="train_path"):
        _trainer(corpus, tmp_path, 1, data=_data(corpus, train_path="")).fit()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloop.Trainer(model_conf=VapConfig(**NARROW), data_conf=DataConfig(**_data(corpus)),
                          out_dir=str(tmp_path))


def test_zero_epoch_fit_leaves_a_resume_point(corpus, tmp_path):
    trainer = _trainer(corpus, tmp_path, 0, data=_data(corpus, val_path=""))
    state = trainer.fit()
    assert state.step == 0
    meta = json.load(open(os.path.join(trainer.out_dir, "ckpt_last.json")))
    assert meta["trainer"]["next_epoch"] == 0 and meta["step"] == 0


# ----------------------------------------------------------- utilities ---
def test_run_name_flops_and_peak_match_jax():
    for kw in ({}, NARROW):
        jc, tc = JVapConfig(**kw), VapConfig(**kw)
        for dur in (20.0, 4.0, 2.5):
            assert tloop.run_name(tc, DataConfig(audio_duration=dur)) == jloop.run_name(jc, JDataConfig(audio_duration=dur))
    for args in ((320_000,), (64_000, 16, 1, 1)):
        assert tflops.stereo_forward_flops(*args) == jflops.stereo_forward_flops(*args)
        assert tflops.mono_forward_flops(*args) == jflops.mono_forward_flops(*args)
        for frozen in (True, False):
            assert tflops.stereo_train_flops(*args, frozen_encoder=frozen) == \
                jflops.stereo_train_flops(*args, frozen_encoder=frozen)
    assert tflops.PEAK_BF16_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}
    if not torch.cuda.is_available():
        assert tflops.device_peak_tflops() is None
    assert tflops.device_peak_tflops(torch.device("cpu")) is None


def test_everything_deterministic_seeds_every_generator():
    everything_deterministic(5)
    a = (random.random(), np.random.random(), float(torch.rand(())))
    everything_deterministic(5)
    assert a == (random.random(), np.random.random(), float(torch.rand(())))


def test_jsonl_logger_and_wandb_mirror(tmp_path, monkeypatch):
    """JSONL always; with ``VAP_WANDB=1`` every record's numbers mirrored to
    a wandb run (as tests/test_train_loop.py's logger test)."""
    import sys
    import types

    calls = {}
    fake = types.ModuleType("wandb")

    class _Run:
        def log(self, record, step=None):
            calls.setdefault("records", []).append((dict(record), step))

        def finish(self):
            calls["finished"] = True

    def _init(**kw):
        calls["init"] = kw
        return _Run()

    fake.init = _init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setenv("VAP_WANDB", "1")
    lg = tloop.JsonlLogger(str(tmp_path / "m.jsonl"), run_name="testrun")
    lg.log({"step": 3, "loss": 0.5, "note": "skip-me"})
    lg.close()
    assert calls["init"]["project"] == "VapGPT" and calls["init"]["name"] == "testrun"
    (rec, step), = calls["records"]
    assert rec == {"step": 3, "loss": 0.5} and step == 3 and calls["finished"]
    assert json.loads(open(tmp_path / "m.jsonl").read()) == {"step": 3, "loss": 0.5, "note": "skip-me"}
    calls.clear()
    monkeypatch.delenv("VAP_WANDB")
    lg2 = tloop.JsonlLogger(str(tmp_path / "m2.jsonl"))
    lg2.log({"loss": 1.0})
    lg2.close()
    assert "init" not in calls


def test_configs_the_trainer_reads_match_jax():
    for jcls, tcls in ((JDataConfig, DataConfig), (JOptConfig, OptConfig)):
        assert {f.name: f.default for f in dataclasses.fields(tcls)} == \
            {f.name: f.default for f in dataclasses.fields(jcls)}

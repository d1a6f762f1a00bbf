"""PyTorch port, the frozen-encoder training slice on the CPU: labels,
losses, ``OptConfig`` and one train step (loss, every gradient, the AdamW
update) against the JAX package on the same numpy inputs and weights, the
eval step, dropout determinism, and the repairs that training needed
(trainable parameters, a bf16 cast on the autograd graph)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from voiceactivityprojection_tpu.config import OptConfig as JOptConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.ops import codebook as jcb
from voiceactivityprojection_tpu.ops import losses as jlosses
from voiceactivityprojection_tpu.train import step as jstep
from voiceactivityprojection_tpu_torch import VapConfig, VapModel, params_from_jax
from voiceactivityprojection_tpu_torch.config import OptConfig
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.ops import codebook as tcb
from voiceactivityprojection_tpu_torch.ops import losses as tlosses
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup
from voiceactivityprojection_tpu_torch.train import step as tstep

pytestmark = pytest.mark.train

torch.set_num_threads(2)

NARROW = dict(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
FROZEN = ("encoder.gEncoder.", "encoder.gAR.")


def small_batch(B=2, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    frames = int(50 * seconds) + 100
    return {
        "waveform": rng.normal(size=(B, 2, n)).astype(np.float32) * 0.1,
        "vad": (rng.random((B, frames, 2)) < 0.5).astype(np.float32),
    }


def _net(conf, tree):
    net = tvap.VapNet(conf)
    net.load_state_dict(params_from_jax(tree, conf))
    return net


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


# ------------------------------------------------------------ labels, loss --
def test_labels_match_jax():
    rng = np.random.default_rng(0)
    va = (rng.random((3, 140, 2)) < 0.4).astype(np.float32)
    for bins in ([10, 20, 30, 40], [5, 5]):
        want = np.asarray(jcb.extract_projection_bins(jnp.asarray(va), bins))
        got = tcb.extract_projection_bins(torch.from_numpy(va), bins).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tcb.get_labels(torch.from_numpy(va), bins).numpy(),
            np.asarray(jcb.get_labels(jnp.asarray(va), bins)))
    idx = np.arange(256, dtype=np.int32)
    decoded = tcb.codebook_decode(torch.from_numpy(idx))
    np.testing.assert_array_equal(decoded.numpy(), np.asarray(jcb.codebook_decode(jnp.asarray(idx))))
    enc = tcb.codebook_encode(decoded)
    assert enc.dtype == torch.int32
    np.testing.assert_array_equal(enc.numpy(), idx)
    with pytest.raises(ValueError, match="horizon"):
        tcb.get_labels(torch.zeros(1, 100, 2), [10, 20, 30, 40])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 30, 256))).astype(np.float32)
    labels = rng.integers(0, 256, (2, 25)).astype(np.int32)
    want = np.asarray(jlosses.loss_vap(jnp.asarray(logits), jnp.asarray(labels), reduction))
    got = tlosses.loss_vap(torch.from_numpy(logits), torch.from_numpy(labels), reduction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    z = (4 * rng.standard_normal((2, 30, 2))).astype(np.float32)
    vad = (rng.random((2, 40, 2)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.loss_vad(torch.from_numpy(z), torch.from_numpy(vad)).numpy(),
        np.asarray(jlosses.loss_vad(jnp.asarray(z), jnp.asarray(vad))), rtol=1e-6)


def test_opt_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JOptConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(OptConfig)}
    assert tf == jf


# -------------------------------------------------------------- the step ---
def _jax_step(jconf, tree, batch, freeze):
    params = jax.tree.map(jnp.asarray, tree)
    grad_fn = jax.jit(lambda p, b, r: jax.value_and_grad(jstep.loss_fn, has_aux=True)(p, b, jconf, r))
    (loss, aux), grads = grad_fn(params, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    tx = jstep.make_optimizer(JOptConfig(), freeze_encoder=freeze)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    metrics = {"loss": loss, **aux}
    return {k: float(v) for k, v in metrics.items()}, _flat(grads), _flat(new)


def _port_step(tconf, tree, batch, freeze):
    net = _net(tconf, tree)
    opt = tstep.make_optimizer(OptConfig(), net, freeze)
    metrics = tstep.make_train_step(tconf, opt)(net, batch, torch.Generator().manual_seed(0))
    grads = {n: p.grad for n, p in net.named_parameters()}
    new = {n: p.detach().float().numpy() for n, p in net.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, new


def _compare_step(jres, tres, tree, loss_atol, grad_rel, frozen, update_atol=5e-7):
    (jm, jg, jnew), (tm, tg, tnew) = jres, tres
    for key in ("loss", "vap_loss", "vad_loss"):
        assert abs(tm[key] - jm[key]) <= loss_atol, (key, tm[key], jm[key])
    before = _flat(tree)
    for name, g in tg.items():
        if frozen and name.startswith(FROZEN):
            assert g is None, name  # no gradient reaches the frozen CPC
            np.testing.assert_array_equal(jg[name], 0.0)
            np.testing.assert_array_equal(tnew[name], before[name])
            continue
        want = jg[name]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), want, atol=grad_rel * scale, err_msg=name)
        # Adam's first step is about lr * sign(g): compare where |g| is clear
        # of 0 and of the gradients' tolerance
        clear = np.abs(want) > max(1e-6, 2 * grad_rel * scale)
        np.testing.assert_allclose(tnew[name][clear], jnew[name][clear], atol=update_atol, err_msg=name)
    assert all("mha.m" not in n for n in tg)


@pytest.mark.parametrize("freeze", [True, False])
def test_train_step_matches_jax_f32(freeze):
    """float32, dropout 0: one step's losses, every gradient and the
    updated weights (measured: losses 4.8e-7, gradients 2.3e-6 of each
    leaf's largest, updates 1.2e-7)."""
    kw = dict(NARROW, dropout=0.0, freeze_encoder=freeze)
    jconf, tconf = JVapConfig(**kw), VapConfig(**kw)
    tree = random_params_tree(tconf, seed=3)
    batch = small_batch()
    _compare_step(_jax_step(jconf, tree, batch, freeze), _port_step(tconf, tree, batch, freeze),
                  tree, loss_atol=2e-6, grad_rel=1e-5, frozen=freeze)


def test_train_step_matches_jax_bf16():
    """bfloat16 compute, float32 weights, dropout 0. Both frameworks round
    at other places (JAX's dense attention stores bf16 scores without
    dropout; the port keeps f32 scores, as the kernels do), so the bound is
    looser: losses within 1e-3, gradients within 0.1 of each leaf's largest
    (measured: losses 1.3e-4, gradients 4.9e-2); the AdamW update is held to
    1e-6 where the gradient is clear of that bound (measured 1.2e-7)."""
    kw = dict(NARROW, dropout=0.0, dtype="bfloat16")
    jconf, tconf = JVapConfig(**kw), VapConfig(**kw)
    tree = random_params_tree(tconf, seed=4)
    batch = small_batch(seed=1)
    tres = _port_step(tconf, tree, batch, True)
    assert all(g is None or g.dtype == torch.float32 for g in tres[1].values())
    _compare_step(_jax_step(jconf, tree, batch, True), tres, tree,
                  loss_atol=1e-3, grad_rel=0.1, frozen=True, update_atol=1e-6)


def test_eval_step_matches_jax():
    kw = dict(NARROW, dropout=0.1)
    jconf, tconf = JVapConfig(**kw), VapConfig(**kw)
    tree = random_params_tree(tconf, seed=5)
    batch = small_batch(seed=2)
    want = jstep.make_eval_step(jconf)(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    got = tstep.make_eval_step(tconf)(_net(tconf, tree), batch)
    assert set(got) == set(want)
    for key, atol in (("vap_loss", 1e-5), ("vad_loss", 1e-5), ("logits", 2e-5), ("vad_logits", 2e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, err_msg=key)


# -------------------------------------------------------------- dropout ----
def test_dropout_is_deterministic_per_seed_and_training_lowers_the_loss():
    conf = VapConfig(**NARROW)  # dropout 0.1
    tree = random_params_tree(conf, seed=6)
    batch = {k: torch.from_numpy(v) for k, v in small_batch().items()}
    net = _net(conf, tree)
    loss = lambda seed: float(tstep.loss_fn(net, batch, conf, torch.Generator().manual_seed(seed))[0].detach())
    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    with torch.no_grad():
        assert float(tstep.loss_fn(net, batch, conf)[0]) != loss(1)
    opt = tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder)
    step = tstep.make_train_step(conf, opt)
    losses = [float(step(net, batch, torch.Generator().manual_seed(i))["loss"]) for i in range(8)]
    assert losses[-1] < losses[0], losses


def test_attention_seeds_do_not_depend_on_the_elementwise_masks():
    """The attention sites draw their seeds from the step generator and the
    elementwise sites from a masks generator seeded once from it, so the
    seeds are the same on every device (a CUDA masks generator draws
    another stream)."""
    from voiceactivityprojection_tpu_torch.ops.attention import _dropout_seed
    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    rng = DropoutRng(torch.Generator().manual_seed(4), torch.device("cpu"))
    rng.dropout(torch.ones(64), 0.5)
    ref = torch.Generator().manual_seed(4)
    torch.randint(0, 2**62, (), generator=ref)  # the masks generator's seed
    assert [_dropout_seed(rng.seeds) for _ in range(3)] == [_dropout_seed(ref) for _ in range(3)]


def test_lr_plateau_and_early_stop():
    net = tvap.VapNet(VapConfig(**NARROW))
    opt = tstep.make_optimizer(OptConfig(), net)
    assert tstep.get_learning_rate(opt) == pytest.approx(OptConfig().learning_rate)
    plateau = tstep.ReduceLROnPlateau(factor=0.5, patience=2)
    for value in (1.0, 1.1, 1.2):
        opt = plateau.update(opt, value)
    assert tstep.get_learning_rate(opt) == pytest.approx(OptConfig().learning_rate)
    opt = plateau.update(opt, 1.3)
    assert tstep.get_learning_rate(opt) == pytest.approx(OptConfig().learning_rate * 0.5)
    es = tstep.EarlyStopping(patience=3)
    assert [es.update(v) for v in (1.0, 1.1, 1.2, 1.3)] == [False, False, False, True]
    tstep.set_learning_rate(opt, 1e-5)
    assert tstep.get_learning_rate(opt) == pytest.approx(1e-5)


def test_optimizer_leaves_out_the_frozen_cpc_and_the_slopes():
    net = tvap.VapNet(VapConfig(**NARROW))
    names = {id(p): n for n, p in net.named_parameters()}
    for freeze in (True, False):
        opt = tstep.make_optimizer(OptConfig(), net, freeze)
        group = opt.param_groups[0]
        got = {names[id(p)] for p in group["params"]}
        frozen = {n for n in names.values() if n.startswith(FROZEN)}
        assert got == set(names.values()) - (frozen if freeze else set())
        assert group["eps"] == 1e-8 and group["betas"] == (0.9, 0.999) and group["weight_decay"] == 1e-3
    assert all(n.endswith(".m") for n, _ in net.named_buffers())


def test_non_discrete_loss_not_ported_yet():
    conf = VapConfig(representation="independent", **NARROW)
    with pytest.raises(NotImplementedError):
        tstep.loss_fn(tvap.VapNet(conf), {}, conf)


# -------------------------------------------------------------- repairs ----
def test_params_are_trainable_and_inference_records_no_graph():
    group = ParamGroup(w=(2, 3), b=(3,))
    assert all(p.requires_grad for p in group.parameters())
    conf = VapConfig(**NARROW)
    model = VapModel(conf, device="cpu")
    assert all(p.requires_grad for p in model.net.parameters())
    out = model.probs(small_batch(B=1, seconds=0.5)["waveform"])
    assert all(t.is_inference() and not t.requires_grad for t in out.values())


def test_bf16_cast_delivers_f32_gradients_to_the_weights():
    """In bf16 mode the forward computes with bf16 casts of the float32
    weights on the autograd graph, so every trained weight gets a float32
    gradient; the frozen CPC gets none."""
    conf = VapConfig(dtype="bfloat16", dropout=0.0, **NARROW)
    net = _net(conf, random_params_tree(conf, seed=7))
    batch = {k: torch.from_numpy(v) for k, v in small_batch().items()}
    loss, _ = tstep.loss_fn(net, batch, conf, torch.Generator())
    loss.backward()
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32
        if name.startswith(FROZEN):
            assert p.grad is None, name
        else:
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
    # the cast rounds the slopes through bf16, as the inference cast does
    params = tvap._compute_params(net, conf)
    m = params["ar.layers.0.mha.m"]
    assert m.dtype == torch.bfloat16
    assert torch.equal(m, net.ar.layers[0].mha.m.bfloat16())

"""PyTorch port, CPC pretraining and the CPC blob on the CPU, against the
JAX package on the same numpy inputs and weights: ``cpc_forward``, the
InfoNCE loss and its metrics given the negatives JAX draws, the gradients,
one Adam step against optax, the unused downsample left alone, a short
run that learns, the libri-light blob both ways with its guard rails, and
a pretrained encoder grafted into the VAP model.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.models import checkpoint as jckpt
from voiceactivityprojection_tpu.models.encoder import init_encoder
from voiceactivityprojection_tpu.train import cpc_pretrain as jcpc
from voiceactivityprojection_tpu_torch import VapConfig, params_from_jax
from voiceactivityprojection_tpu_torch.models import checkpoint as tckpt
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapNet, forward
from voiceactivityprojection_tpu_torch.train import cpc_pretrain as tcpc

pytestmark = pytest.mark.train

torch.set_num_threads(2)

DIM, K, N = 16, 4, 8
# float32, the same arithmetic in another order: forward and loss 1e-5,
# gradients 1e-5 of each leaf's largest
ATOL, GRAD_REL = 1e-5, 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def trees():
    key = jax.random.key(0)
    enc = jax.tree.map(np.asarray, init_encoder(jax.random.fold_in(key, 0), DIM))
    heads = jax.tree.map(np.asarray, jcpc.init_cpc_heads(jax.random.fold_in(key, 1), K, DIM, DIM))
    return enc, heads


def _port(trees):
    enc, heads = trees
    return tckpt.encoder_from_jax(enc), tckpt.cpc_heads_from_jax(heads)


def _wave(B=2, n=16000, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


def _neg_idx(key, B, T):
    """The draw of JAX ``cpc_loss`` (cpc_pretrain.py:65) for ``key``."""
    return np.array(jax.random.randint(key, (B, T - K, N), 0, B * T))


def _acc_ties(neg_idx, metric, T=100):
    """An accuracy's bound between the frameworks: the share of contexts
    whose negatives include the positive encoding itself. Their logits tie
    in exact arithmetic, so the argmax follows each framework's rounding
    (at the seeds below one or two such contexts differ)."""
    B, Tc, _ = neg_idx.shape
    flat = np.arange(B)[:, None] * T + np.arange(Tc)[None, :]
    ties = [(neg_idx == (flat + k)[..., None]).any(-1).mean() for k in range(1, K + 1)]
    return {"cpc_acc": float(np.mean(ties)), "cpc_acc_k1": ties[0], "cpc_acc_k12": ties[-1]}[metric] + 1e-7


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def test_cpc_forward_matches_jax(trees):
    w = _wave()
    jz, jc = jcpc.cpc_forward(_jtree(trees[0]), jnp.asarray(w))
    enc, _ = _port(trees)
    z, c = tcpc.cpc_forward(enc, torch.from_numpy(w))
    assert z.shape == c.shape == (2, 100, DIM) == jz.shape
    assert tcpc.encoded_frames(16000) == 100 and tcpc.encoded_frames(20480) == 128
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=ATOL)


def test_cpc_loss_and_metrics_match_jax(trees):
    w = _wave(seed=1)
    key = jax.random.key(3)
    jloss, jaux = jcpc.cpc_loss(_jtree(trees[0]), _jtree(trees[1]), jnp.asarray(w), key, K, N)
    enc, heads = _port(trees)
    neg_idx = _neg_idx(key, 2, 100)
    loss, aux = tcpc.cpc_loss(enc, heads, torch.from_numpy(w), torch.from_numpy(neg_idx), K)
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    assert set(aux) == set(jaux) == {"cpc_loss", "cpc_acc", "cpc_acc_k1", "cpc_acc_k12"}
    assert abs(float(loss) - float(jloss)) <= ATOL
    for name in jaux:
        tol = _acc_ties(neg_idx, name) if name != "cpc_loss" else ATOL
        assert abs(float(aux[name]) - float(jaux[name])) <= tol, name
    # near chance at init, as the JAX package's own test holds
    assert 0.3 * np.log(N + 1) < float(loss) < 3.0 * np.log(N + 1)


def test_cpc_gradients_match_jax(trees):
    w = _wave(seed=2)
    key = jax.random.key(4)

    def jloss(both):
        return jcpc.cpc_loss(both[0], both[1], jnp.asarray(w), key, K, N)[0]

    jenc, jheads = jax.grad(jloss)((_jtree(trees[0]), _jtree(trees[1])))
    want = {**{f"encoder.{k}": v for k, v in _flat(jenc).items()},
            **{f"heads.{k}": v for k, v in _flat(jheads).items()}}
    enc, heads = _port(trees)
    loss, _ = tcpc.cpc_loss(enc, heads, torch.from_numpy(w), torch.from_numpy(_neg_idx(key, 2, 100)), K)
    loss.backward()
    got = {**{f"encoder.{n}": p.grad for n, p in enc.named_parameters()},
           **{f"heads.{n}": p.grad for n, p in heads.named_parameters()}}
    assert set(got) == set(want)
    for name, g in got.items():
        if name.startswith("encoder.downsample."):
            assert g is None, name  # CPC never runs it; JAX's gradient is 0
            np.testing.assert_array_equal(want[name], 0.0)
            continue
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_REL * scale, rtol=0, err_msg=name)


def _jax_step(trees, w, key, lr):
    tx = jcpc.make_cpc_optimizer(lr)
    state = jcpc.init_cpc_train_state(_jtree(trees[0]), _jtree(trees[1]), tx)
    state, aux = jcpc.make_cpc_train_step(tx, K, N)(state, jnp.asarray(w), key)
    return state, {k: float(v) for k, v in aux.items()}


def _port_state(trees, lr):
    enc, heads = _port(trees)
    return tcpc.init_cpc_train_state(enc, heads, learning_rate=lr, device="cpu")


def test_one_adam_step_matches_optax(trees, monkeypatch):
    """One train step: the metrics, and the updated weights where the
    gradient is clear of 0 and of the gradients' tolerance (Adam's first
    step is about lr * sign(g))."""
    w, key, lr = _wave(seed=5), jax.random.key(6), 2e-4
    jstate, jaux = _jax_step(trees, w, key, lr)
    neg_idx = _neg_idx(key, 2, 100)
    monkeypatch.setattr(tcpc, "sample_negatives", lambda gen, B, Tc, n, m: torch.from_numpy(neg_idx))
    state = _port_state(trees, lr)
    before = {n: p.detach().clone() for n, p in state.encoder.named_parameters()}
    aux = tcpc.make_cpc_train_step(K, N)(state, w, torch.Generator().manual_seed(0))
    assert state.step == 1 and int(jstate.step) == 1
    for name in jaux:
        tol = _acc_ties(neg_idx, name) if name != "cpc_loss" else ATOL
        assert abs(float(aux[name]) - jaux[name]) <= tol, name
    want = {**_flat(jax.tree.map(np.asarray, jstate.encoder)),
            **{f"heads.{k}": v for k, v in _flat(jax.tree.map(np.asarray, jstate.heads)).items()}}
    got = {**{n: p for n, p in state.encoder.named_parameters()},
           **{f"heads.{n}": p for n, p in state.heads.named_parameters()}}
    for name, p in got.items():
        if p.grad is None:
            continue
        g = p.grad.numpy()
        clear = np.abs(g) > max(1e-6, 2 * GRAD_REL * float(np.abs(g).max()))
        assert clear.any(), name
        np.testing.assert_allclose(p.detach().numpy()[clear], want[name][clear], atol=5e-7, err_msg=name)
        if not name.startswith("heads."):
            assert not torch.equal(p.detach(), before[name]), name


def test_cpc_step_leaves_the_unused_downsample_unchanged(trees):
    """The port's Encoder holds the downsample, which CPC never runs: it gets
    no gradient and Adam skips it, as JAX's Adam leaves a zero-gradient leaf."""
    w, key = _wave(seed=7), jax.random.key(8)
    jstate, _ = _jax_step(trees, w, key, 2e-4)
    state = _port_state(trees, 2e-4)
    before = {n: p.detach().clone() for n, p in state.encoder.downsample.named_parameters()}
    tcpc.make_cpc_train_step(K, N)(state, w, torch.Generator().manual_seed(1))
    jdown = _flat(jax.tree.map(np.asarray, jstate.encoder["downsample"]))
    for name, p in state.encoder.downsample.named_parameters():
        assert p.grad is None, name
        assert torch.equal(p.detach(), before[name]), name
        np.testing.assert_array_equal(p.detach().numpy(), jdown[name])
    assert all(p.grad is not None for p in state.encoder.gAR.parameters())


def test_cpc_training_reduces_loss(trees):
    """30 steps on a learnable toy signal (sinusoids whose frequency varies
    over the batch) lower the loss, as tests/test_cpc_pretrain.py holds for
    the JAX step."""
    state = _port_state(trees, 1e-3)
    step = tcpc.make_cpc_train_step(K, N)
    t = np.arange(16000) / 16000
    w = np.stack([np.sin(2 * np.pi * f * t) for f in (120.0, 260.0)]).astype(np.float32)
    gen = torch.Generator().manual_seed(4)
    losses = [float(step(state, w, gen)["cpc_loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert state.step == 30


def test_cpc_negatives_come_from_the_generator():
    a = tcpc.sample_negatives(torch.Generator().manual_seed(3), 2, 5, 7, 40)
    b = tcpc.sample_negatives(torch.Generator().manual_seed(3), 2, 5, 7, 40)
    assert a.shape == (2, 5, 7) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 40
    heads = tcpc.init_cpc_heads(torch.Generator().manual_seed(0), 3, 64, 32)
    assert heads.W.shape == (3, 64, 32)
    assert abs(float(heads.W.detach().std()) - 1 / 8) < 0.01


def test_cpc_train_state_defaults_to_the_card(trees, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc, heads = _port(trees)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcpc.init_cpc_train_state(enc, heads)


# --------------------------------------------------------------- CPC blobs --
@pytest.fixture(scope="module")
def enc256():
    return jax.tree.map(np.asarray, init_encoder(jax.random.key(11), 256))


def _cpc_part(flat):
    return {k: v for k, v in flat.items() if not k.startswith("downsample.")}


def test_port_blob_loads_in_jax(enc256, tmp_path):
    enc = tckpt.encoder_from_jax(enc256)
    path = str(tmp_path / "port_cpc.pt")
    tckpt.export_cpc_blob(enc, path)
    got = _flat(jax.tree.map(np.asarray, jckpt.load_cpc_blob(path)))
    want = _cpc_part({n: p.detach().numpy() for n, p in enc.state_dict().items()})
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)


def test_jax_blob_loads_in_the_port(enc256, tmp_path):
    path = str(tmp_path / "jax_cpc.pt")
    jckpt.export_cpc_blob(_jtree(enc256), path)
    got = tckpt.load_cpc_blob(path)
    want = _cpc_part(_flat(enc256))
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    # the same weights through import_cpc_checkpoint on the blob's own dict
    blob = torch.load(path, weights_only=False)
    assert blob["config"] == dict(tckpt.CPC_ARCH_DEFAULTS, arMode="GRU")
    extra = dict(blob["weights"], **{"wPrediction.predictors.0.weight": torch.zeros(3)})
    for name, t in tckpt.import_cpc_checkpoint(extra).items():
        assert torch.equal(t, got[name]), name


@pytest.mark.parametrize("override,match", [
    ({"arMode": "LSTM"}, "arMode"),
    ({"encoder_type": "mfcc"}, "encoder_type"),
    ({"normMode": "batchNorm"}, "normMode"),
    ({"nLevelsGRU": 2}, "nLevelsGRU"),
    ({"cpc_mode": "reverse"}, "reverse"),
    ({"samplingType": "sequential"}, "sequential"),
    ({"hiddenGar": 512}, "hiddenGar"),
    (None, "not a CPC checkpoint"),
])
def test_cpc_blob_guard_rails_match_jax(enc256, tmp_path, override, match):
    path = str(tmp_path / "blob.pt")
    tckpt.export_cpc_blob(tckpt.encoder_from_jax(enc256), path)
    blob = torch.load(path, weights_only=False)
    torch.save({"config": blob["config"]} if override is None
               else {"config": dict(blob["config"], **override), "weights": blob["weights"]}, path)
    with pytest.raises(ValueError, match=match) as port_err:
        tckpt.load_cpc_blob(path)
    with pytest.raises(ValueError) as jax_err:
        jckpt.load_cpc_blob(path)
    assert str(port_err.value) == str(jax_err.value)


def test_jax_trees_into_the_port(trees):
    enc, heads = _port(trees)
    for name, t in enc.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), _flat(trees[0])[name])
    np.testing.assert_array_equal(heads.W.detach().numpy(), trees[1]["W"])
    with pytest.raises(ValueError, match="does not use"):
        tckpt.encoder_from_jax({**trees[0], "extra": np.zeros(2)})
    bad = {**trees[0], "downsample": {**trees[0]["downsample"], "ln": {"w": np.zeros(3), "b": np.zeros(DIM)}}}
    with pytest.raises(ValueError, match="shape"):
        tckpt.encoder_from_jax(bad)


def test_pretrained_encoder_grafts_into_vapnet(trees, tmp_path):
    """An encoder pretrained in the port goes into a VapNet two ways: the
    whole encoder's state under ``encoder.``, and gEncoder + gAR through a
    CPC blob (the downsample stays the VAP model's own)."""
    state = _port_state(trees, 1e-3)
    step = tcpc.make_cpc_train_step(K, N)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, _wave(seed=9), gen)
    conf = VapConfig(dim=DIM, encoder_dim=DIM, channel_layers=1, cross_layers=1)
    sd = params_from_jax(random_params_tree(conf, seed=1), conf)
    sd.update({f"encoder.{k}": v.detach().clone() for k, v in state.encoder.state_dict().items()})
    net = VapNet(conf)
    net.load_state_dict(sd)
    for name, p in state.encoder.named_parameters():
        assert torch.equal(net.encoder.get_parameter(name), p.detach()), name
    wave = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal((1, 2, 8000))).astype(np.float32))
    with torch.no_grad():
        out = forward(net, wave, conf)
    assert out["logits"].shape == (1, 25, 256) and torch.isfinite(out["logits"]).all()

    # through a blob: the VAP encoder is 256 wide
    conf256 = VapConfig(channel_layers=1, cross_layers=1)
    big = tckpt.encoder_from_jax(jax.tree.map(np.asarray, init_encoder(jax.random.key(12), 256)))
    path = str(tmp_path / "pretrained.pt")
    tckpt.export_cpc_blob(big, path)
    net = VapNet(conf256)
    net.load_state_dict(params_from_jax(random_params_tree(conf256, seed=2), conf256))
    down = {n: p.detach().clone() for n, p in net.encoder.downsample.named_parameters()}
    result = net.encoder.load_state_dict(tckpt.load_cpc_blob(path), strict=False)
    assert sorted(result.missing_keys) == sorted(f"downsample.{n}" for n in down)
    assert not result.unexpected_keys
    assert torch.equal(net.encoder.gAR.w_hh.detach(), big.gAR.w_hh.detach())
    for n, p in net.encoder.downsample.named_parameters():
        assert torch.equal(p.detach(), down[n])

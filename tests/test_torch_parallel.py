"""PyTorch port, data and tensor parallelism over processes
(``parallel/mesh.py``, ``parallel/tp.py``, the data-parallel steps, the
Trainer, the train CLI's ``--n_devices`` and ``tools/dryrun_multichip.py``)
against the JAX package and against one process, on the CPU.

The ranks are processes of ``tests/_torch_parallel.py`` joined over gloo
through a file store in ``tmp_path``; JAX runs here on its 8 virtual CPU
devices (``tests/conftest.py``). Bars: the TP forward's logits 2e-5 from
JAX's forward and 1e-6 from the port unsharded; one f32 step at the bars of
``tests/test_torch_train.py`` (losses 2e-6, gradients 1e-5 of each leaf's
largest, updates 5e-7); the data-parallel step 1e-6 from one process on
the whole batch, with the augmentation too; the Trainer's losses 1e-5 from
one process; the dryrun's mesh gradients 1e-4 from one process (JAX's bar)."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from voiceactivityprojection_tpu.config import OptConfig as JOptConfig
from voiceactivityprojection_tpu.config import VapConfig as JVapConfig
from voiceactivityprojection_tpu.models import vap as jvap
from voiceactivityprojection_tpu.parallel import mesh as jmesh
from voiceactivityprojection_tpu.parallel import tp as jtp
from voiceactivityprojection_tpu.train import step as jstep
from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
from voiceactivityprojection_tpu_torch.models import vap as tvap
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import attention as tattn
from voiceactivityprojection_tpu_torch.ops.attention import MHA, attention
from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng, DropoutShard
from voiceactivityprojection_tpu_torch.ops.flash_alibi_train import keep_mask
from voiceactivityprojection_tpu_torch.parallel.mesh import spawn_local
from voiceactivityprojection_tpu_torch.parallel.tp import ModelShard, shard_params_tp, tp_param_specs
from voiceactivityprojection_tpu_torch.train import loop as tloop
from voiceactivityprojection_tpu_torch.train import step as tstep

from _torch_corpus import dialog_corpus
from _torch_parallel import MASK_RATE, NARROW, REPO, SEED, recorded_masks, run_ranks
from test_torch_train import _compare_step, _jax_step, small_batch

pytestmark = [pytest.mark.parallel, pytest.mark.train]

LOGITS_VS_JAX, VS_ONE_PROCESS = 2e-5, 1e-6
LOSS_TOL, GRAD_REL = 2e-6, 1e-5
TRAINER_REL = 1e-5
EVENTS = dict(min_context_time=1.0, max_time=4.0, bc_negative_pad_left_time=0.4, bc_negative_pad_right_time=0.4)


def _inputs(tmp_path, B=2, **extra):
    batch = small_batch(B=B)
    np.savez(tmp_path / "inputs.npz", **batch, **{k: np.asarray(v) for k, v in extra.items()})
    return batch


def _net(conf, tree):
    net = tvap.VapNet(conf)
    net.load_state_dict(params_from_jax(tree, conf))
    return net


def _unshard(outs, key, conf, tp):
    """The whole tensors from every rank's shard of them (``key`` "new" or
    "grad"; ``tp``: the ranks hold model shards, else replicas), the
    replicated ones checked equal across ranks."""
    specs = tp_param_specs(tvap.VapNet(conf)) if tp else {}
    names = {k.split(".", 1)[1] for k in outs[0] if k.startswith(key + ".")}
    whole = {}
    for name in names:
        parts = [o[f"{key}.{name}"] for o in outs]
        dim = specs.get(name)
        if dim is None:
            for p in parts[1:]:  # replicated: equal gradients and updates on every model rank
                np.testing.assert_allclose(p, parts[0], rtol=0, atol=1e-7, err_msg=name)
            whole[name] = parts[0]
        else:
            whole[name] = np.concatenate(parts, axis=dim)
    return whole


def _port_result(outs, conf, net_names, tp):
    metrics = {k.split(".", 1)[1]: float(v) for k, v in outs[0].items() if k.startswith("metric.")}
    grads = _unshard(outs, "grad", conf, tp)
    return metrics, {n: (torch.from_numpy(grads[n]) if n in grads else None) for n in net_names}, \
        _unshard(outs, "new", conf, tp)


# ------------------------------------------------------------------ specs --
def test_tp_specs_equal_jax():
    conf = VapConfig(**NARROW)
    jspecs = jtp.tp_param_specs(jvap.init_vap(jax.random.key(0), JVapConfig(**NARROW)))
    flat, _ = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))
    want = {}
    for path, spec in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        want[name] = None if spec == P() else (0 if spec == P("model", None) else 1)
    got = tp_param_specs(tvap.VapNet(conf))
    assert got == want
    # q, k, v, proj and the FFN pair: one channel layer (6), one cross layer with two MHAs (10)
    assert sum(d is not None for d in got.values()) == 6 + 10


def test_shard_refuses_undivided_heads_and_ffn():
    net = tvap.VapNet(VapConfig(**NARROW))  # 4 heads, FFN width 48
    with pytest.raises(ValueError, match="heads"):
        shard_params_tp(net, 0, 3)
    # 8 heads over 8 ranks, but widths of 20 (q, k, v) and 60 (the FFN) do not split
    with pytest.raises(ValueError, match="does not divide"):
        shard_params_tp(tvap.VapNet(VapConfig(**dict(NARROW, dim=20, num_heads=8))), 0, 8)


def test_head_width_comes_from_the_projection(monkeypatch):
    """A tensor-parallel rank's MHA of a 256-wide model with 4 heads holds
    2 heads, 128 rows of q/k/v: the kernel route is asked about their width,
    64, not 256 / 2 from the input, which stays whole; the scale stays
    1/sqrt(256), so the two ranks' partial outputs sum to the whole
    attention."""
    seen = []
    real = tattn.use_kernels
    monkeypatch.setattr(tattn, "use_kernels", lambda impl, cuda, hd, w: seen.append(hd) or real(impl, cuda, hd, w))
    torch.manual_seed(0)
    full = MHA(256, 4)
    for name in ("query", "key", "value", "proj"):
        torch.nn.init.normal_(getattr(full, name).w, std=0.05)
    x = torch.randn(1, 12, 256)
    want, _ = attention(full, x, x, 4, impl="pallas")
    total = torch.zeros_like(want)
    for r in range(2):
        part = MHA(256, 4)
        for name, dim in (("query", 0), ("key", 0), ("value", 0), ("proj", 1)):
            getattr(part, name).w.data = getattr(full, name).w.data.narrow(dim, r * 128, 128).clone()
        part.m = full.m[2 * r: 2 * r + 2].clone()
        seen.clear()
        out, _ = attention(part, x, x, 2, impl="pallas")
        assert seen == [64], seen
        total += out
    torch.testing.assert_close(total, want, rtol=0, atol=2e-6)


# -------------------------------------------------------------- dropout --
@pytest.mark.parametrize("rows", [1, 3])
def test_attention_seed_offset_gives_the_global_rows(rows):
    """A rank's mask for its rows, from the shifted seed, is bit for bit the
    global batch's mask at those rows; so is the kernel route's attention
    output (plain version) on the rank's rows."""
    B, H, T, rate = 2 * rows, 4, 37, 0.3
    seed = 123456789
    full = keep_mask(B, H, T, seed, rate)
    for r in range(2):
        shard = DropoutShard(row0=r * rows, data_rank=r)
        got = keep_mask(rows, H, T, shard.attention_seed(seed, H), rate)
        assert torch.equal(got, full[r * rows: (r + 1) * rows])
    mha = MHA(64, H)
    for name in ("query", "key", "value", "proj"):
        torch.nn.init.normal_(getattr(mha, name).w, std=0.1)
    x = torch.randn(B, T, 64)
    want, _ = attention(mha, x, x, H, impl="pallas", dropout_rate=rate, generator=torch.Generator().manual_seed(7))
    for r in range(2):
        got, _ = attention(mha, x[r * rows: (r + 1) * rows], x[r * rows: (r + 1) * rows], H, impl="pallas",
                           dropout_rate=rate, generator=torch.Generator().manual_seed(7),
                           shard=DropoutShard(row0=r * rows, data_rank=r))
        torch.testing.assert_close(got, want[r * rows: (r + 1) * rows], rtol=0, atol=1e-6)


def test_elementwise_masks_fold_the_data_rank():
    x = torch.ones(4, 50, 16)

    def draw(shard, x=x, tp=None):
        return DropoutRng(torch.Generator().manual_seed(11), torch.device("cpu"), shard).dropout(x, 0.5, tp)

    one = draw(None)
    assert torch.equal(draw(DropoutShard(row0=0, data_rank=0)), one)
    shard = DropoutShard(row0=2, data_rank=1)
    assert not torch.equal(draw(shard), one)
    # the model ranks of one row block draw alike where their activations are
    # replicated, and a column block each of one full-width mask where they
    # hold a block of the FFN hidden
    tps = [ModelShard(None, 2, m) for m in range(2)]
    assert torch.equal(draw(shard, tp=ModelShard(None, 1, 0)), draw(shard))
    blocks = [draw(shard, x[..., :8], tp) for tp in tps]
    assert torch.equal(torch.cat(blocks, dim=-1), draw(shard))
    assert not torch.equal(blocks[0], blocks[1])
    # the attention seeds of the model ranks differ, with a row block or without
    for sh in (None, shard):
        seeds = [tattn._dropout_seed(torch.Generator().manual_seed(5), 2, sh, tp) for tp in tps]
        assert seeds[0] != seeds[1]


def test_tp_elementwise_masks_are_one_process_masks(tmp_path):
    """Two model ranks at dropout 0.5: every elementwise site's mask is the
    one process's, the FFN hidden's as column blocks of it (no mask repeats
    across the model ranks' halves)."""
    conf = VapConfig(**NARROW, dropout=MASK_RATE)
    batch = _inputs(tmp_path)
    outs = run_ranks(tmp_path, 2, "tp_masks")
    with recorded_masks() as want, torch.no_grad():
        tvap.forward(_net(conf, random_params_tree(conf, seed=SEED)), torch.from_numpy(batch["waveform"]), conf,
                     torch.Generator().manual_seed(0))
    assert all(len(o) == len(want) for o in outs), ([len(o) for o in outs], len(want))
    ffn = {i for i, w in enumerate(want) if w.shape[-1] == 3 * conf.dim}
    blocked = set()
    for i, w in enumerate(want):
        a, b = outs[0][f"mask{i}"], outs[1][f"mask{i}"]
        if a.shape == w.shape:
            np.testing.assert_array_equal(a, w, err_msg=f"site {i}")
            np.testing.assert_array_equal(b, w, err_msg=f"site {i}")
        else:
            blocked.add(i)
            np.testing.assert_array_equal(np.concatenate([a, b], axis=-1), w, err_msg=f"site {i}")
            assert not np.array_equal(a, b), i
    assert blocked == ffn and ffn, (blocked, ffn)


# ---------------------------------------------------------------- launcher --
def test_spawn_local_stops_at_a_failing_rank():
    """Rank 1 fails at once while rank 0 would sleep: the launcher returns
    rank 1's code in seconds and kills rank 0."""
    code = "import os, sys, time; sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)"
    t0 = time.monotonic()
    assert spawn_local([sys.executable, "-c", code], 2, timeout_s=45) == 3
    assert time.monotonic() - t0 < 15


def test_spawn_local_kills_the_ranks_at_its_time_limit():
    t0 = time.monotonic()
    assert spawn_local([sys.executable, "-c", "import time; time.sleep(60)"], 2, timeout_s=1) == 124
    assert time.monotonic() - t0 < 15


# ----------------------------------------------------------------- tensor --
def test_tp_forward_matches_jax_and_unsharded(tmp_path):
    conf = VapConfig(**NARROW, dropout=0.0)
    batch = _inputs(tmp_path)
    outs = run_ranks(tmp_path, 2, "tp_forward")
    tree = random_params_tree(conf, seed=SEED)
    with torch.no_grad():
        want = tvap.forward(_net(conf, tree), torch.from_numpy(batch["waveform"]), conf)
    jout = jvap.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["waveform"]), JVapConfig(**NARROW))
    for o in outs:
        np.testing.assert_allclose(o["logits"], np.asarray(jout["logits"]), rtol=0, atol=LOGITS_VS_JAX)
        np.testing.assert_allclose(o["logits"], want["logits"].numpy(), rtol=0, atol=VS_ONE_PROCESS)
        np.testing.assert_allclose(o["vad"], want["vad"].numpy(), rtol=0, atol=VS_ONE_PROCESS)


def test_tp_step_matches_jax(tmp_path):
    """One f32 step at dropout 0 over two model ranks against JAX's step,
    the gradients and updates put back together from the shards."""
    conf = VapConfig(**NARROW, dropout=0.0)
    batch = _inputs(tmp_path)
    outs = run_ranks(tmp_path, 2, "tp_step")
    tree = random_params_tree(conf, seed=SEED)
    names = [n for n, _ in tvap.VapNet(conf).named_parameters()]
    _compare_step(_jax_step(JVapConfig(**NARROW, dropout=0.0), tree, batch, True), _port_result(outs, conf, names, tp=True),
                  tree, loss_atol=LOSS_TOL, grad_rel=GRAD_REL, frozen=True)


# ------------------------------------------------------------------- data --
def _one_process_step(conf, tree, batch, augmented_choice=None):
    net = _net(conf, tree)
    opt = tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder)
    if augmented_choice is None:
        m = tstep.make_train_step(conf, opt)(net, batch, torch.Generator().manual_seed(0))
    else:
        step = tstep.make_train_step_augmented(conf, do_flip=True, flip_prob=0.5, do_mask=True, mask_prob=0.5,
                                               noise_amplitude=0.01, sample_rate=16000, frame_hz=50)
        _, m = step(tstep.TrainState(net, opt), batch, 5, augmented_choice)
    return {k: float(v) for k, v in m.items()}, net


@pytest.mark.parametrize("freeze", [True, False])
def test_dp_step_matches_one_process_and_jax_mesh(tmp_path, freeze):
    conf = VapConfig(**NARROW, dropout=0.0, freeze_encoder=freeze)
    batch = _inputs(tmp_path, B=4, freeze=int(freeze))
    outs = run_ranks(tmp_path, 2, "dp_step")
    assert all(bool(o["undivided_raised"]) for o in outs)
    tree = random_params_tree(conf, seed=SEED)
    m1, net1 = _one_process_step(conf, tree, batch)
    for o in outs:  # every rank: the global batch's metrics and the same weights
        for k, v in m1.items():
            assert abs(float(o[f"metric.{k}"]) - v) <= VS_ONE_PROCESS, (k, float(o[f"metric.{k}"]), v)
        for name, p in net1.named_parameters():
            np.testing.assert_allclose(o[f"new.{name}"], p.detach().numpy(), rtol=0, atol=VS_ONE_PROCESS,
                                       err_msg=name)
    # JAX's step with the batch sharded over a two-device "data" axis
    jconf = JVapConfig(**NARROW, dropout=0.0, freeze_encoder=freeze)
    jm, jg, _ = _jax_step(jconf, tree, batch, freeze)
    tx = jstep.make_optimizer(JOptConfig(), freeze_encoder=freeze)
    mesh = jmesh.make_mesh(n_data=2)
    with jax.set_mesh(mesh):
        state = jmesh.replicate_tree(jstep.init_train_state(jax.tree.map(jnp.asarray, tree), tx), mesh)
        state, jmetrics = jstep.make_train_step(jconf, tx)(state, jmesh.shard_batch(batch, mesh), jax.random.key(0))
    from test_torch_train import _flat

    jres = ({k: float(v) for k, v in jmetrics.items()}, jg, _flat(jax.device_get(state.params)))
    names = [n for n, _ in net1.named_parameters()]
    _compare_step(jres, _port_result(outs, conf, names, tp=False), tree, loss_atol=LOSS_TOL, grad_rel=GRAD_REL, frozen=freeze)


def test_dp_augmented_step_matches_one_process(tmp_path):
    """Flip, VAD mask, noise and the frequency mask drawn for the global
    batch (choice 3), each rank keeping its rows: the same step as one
    process's."""
    conf = VapConfig(**NARROW, dropout=0.0)
    batch = _inputs(tmp_path, B=4, choice=3)
    outs = run_ranks(tmp_path, 2, "dp_aug")
    m1, net1 = _one_process_step(conf, random_params_tree(conf, seed=SEED), batch, augmented_choice=3)
    for o in outs:
        for k, v in m1.items():
            assert abs(float(o[f"metric.{k}"]) - v) <= VS_ONE_PROCESS, (k, float(o[f"metric.{k}"]), v)
        for name, p in net1.named_parameters():
            np.testing.assert_allclose(o[f"new.{name}"], p.detach().numpy(), rtol=0, atol=VS_ONE_PROCESS,
                                       err_msg=name)


def test_loader_yields_each_rank_its_rows(tmp_path):
    corpus = dialog_corpus(tmp_path, n=5)
    ds = SlidingWindowDataset(corpus, audio_duration=4.0)
    whole = list(VapDataLoader(ds, batch_size=2, shuffle=True, seed=2, prefetch=0))
    parts = [list(VapDataLoader(ds, batch_size=2, shuffle=True, seed=2, prefetch=0, shard=(r, 2))) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 1
    for w, a, b in zip(whole, *parts):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k])
    with pytest.raises(ValueError, match="does not split"):
        VapDataLoader(ds, batch_size=3, shard=(0, 2))


# ---------------------------------------------------------------- trainer --
def test_trainer_two_ranks_match_one_process(tmp_path):
    corpus = dialog_corpus(tmp_path)
    kw = dict(model=dict(NARROW, dropout=0.0), opt=dict(patience=50),
              data=dict(phrases_probe=0, train_path=corpus, val_path=corpus, batch_size=2, audio_duration=4.0),
              events=EVENTS, max_epochs=1, seed=3, limit_batches=2)
    (tmp_path / "args.json").write_text(json.dumps(dict(kw, out_dir=str(tmp_path / "two"))))
    run_ranks(tmp_path, 2, "trainer")
    one = tloop.Trainer(model_conf=VapConfig(**kw["model"]), opt_conf=OptConfig(**kw["opt"]),
                        data_conf=DataConfig(**kw["data"]), event_conf=EventConfig(**EVENTS), max_epochs=1,
                        seed=3, out_dir=str(tmp_path / "one"), device="cpu", limit_batches=2)
    one.fit()
    read = lambda d: [json.loads(l) for l in open(os.path.join(d, one.name, "metrics.jsonl"))]
    two, want = read(tmp_path / "two"), read(tmp_path / "one")
    assert len(two) == len(want) == 1
    for key in ("loss", "val_loss", "val_loss_va"):
        assert abs(two[0][key] - want[0][key]) <= TRAINER_REL * abs(want[0][key]), (key, two[0][key], want[0][key])
    run = tmp_path / "two" / one.name
    assert sorted(p.name for p in run.iterdir()) == sorted(
        ["metrics.jsonl", "ckpt_best", "ckpt_best.json", "ckpt_last", "ckpt_last.json"])


# ---------------------------------------------------------- entry points --
def _module(args, tmp_path, limit_s=90):
    """Runs ``python -m args`` in a session of its own, which the time limit
    kills whole: the launcher and the ranks it started."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "VAP_DIST_INIT_METHOD"):
        env.pop(k, None)
    proc = subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_train_cli_n_devices(tmp_path):
    corpus = dialog_corpus(tmp_path)
    r = _module(["voiceactivityprojection_tpu_torch.train", "--device", "cpu", "--n_devices", "2", "--max_epochs",
                 "1", "--limit_batches", "2", "--out_dir", str(tmp_path / "runs"), "--data_train_path", corpus,
                 "--data_val_path", corpus, "--data_batch_size", "2", "--data_audio_duration", "4.0",
                 "--data_phrases_probe", "0", "--vap_dim", "16", "--vap_encoder_dim", "16",
                 "--vap_channel_layers", "1", "--vap_cross_layers", "1"], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "(rank 0 of 2)" in r.stdout
    run = tmp_path / "runs" / "VapGPT_50Hz_ad4s_114"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["loss"])
    assert (run / "ckpt_last" / "state.pt").exists()


def test_dryrun_tool_four_ranks(tmp_path):
    r = _module(["voiceactivityprojection_tpu_torch.tools.dryrun_multichip", "--n", "4", "--device", "cpu"],
                tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    report = json.loads([l for l in r.stdout.splitlines() if l.startswith("{")][-1])
    assert report["dryrun_multichip"] == "ok" and report["mesh"] == {"data": 2, "model": 2}
    assert report["grad_max_diff"] < 1e-4
    assert report["context_parallel"]["logits"] == [1, 16, 256]

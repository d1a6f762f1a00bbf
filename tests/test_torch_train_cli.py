"""PyTorch port, the training CLIs on the CPU (``--device cpu``):
``python -m voiceactivityprojection_tpu_torch.train`` and its resume,
``pretrain_cpc --export_blob`` then ``train --init_encoder_from`` the blob
or the encoder checkpoint, ``--mono``; ``run`` and ``evaluate
--checkpoint`` on the trained ``ckpt_best`` against the same model built in
this process from that checkpoint's params; the refusals (an orbax
directory, no card for the default device, more than one device)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu_torch import evaluate as eval_cli
from voiceactivityprojection_tpu_torch import pretrain_cpc
from voiceactivityprojection_tpu_torch import run as run_cli
from voiceactivityprojection_tpu_torch.config import EventConfig, VapConfig
from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
from voiceactivityprojection_tpu_torch.models.checkpoint import load_cpc_blob, restore_checkpoint
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.ops.audio import load_waveform
from voiceactivityprojection_tpu_torch.train import __main__ as train_cli
from voiceactivityprojection_tpu_torch.train.evaluation import evaluate
from voiceactivityprojection_tpu_torch.utils.io import read_json, tensor_dict_to_json

from _torch_corpus import dialog_corpus

pytestmark = pytest.mark.train

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]
EVENTS = ["--event_min_context_time", "1.0", "--event_max_time", "4.0", "--event_bc_negative_pad_left_time", "0.4",
          "--event_bc_negative_pad_right_time", "0.4"]
RUN_NAME = "VapGPT_50Hz_ad4s_114"


def _data(corpus, val=True):
    return (["--data_train_path", corpus] + (["--data_val_path", corpus] if val else [])
            + ["--data_batch_size", "2", "--data_audio_duration", "4.0", "--data_phrases_probe", "0"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A corpus and a two-epoch run of the train CLI at the narrow width."""
    root = tmp_path_factory.mktemp("train_cli")
    corpus = dialog_corpus(root)
    out = root / "runs"
    train_cli.main(["--device", "cpu", "--max_epochs", "2", "--out_dir", str(out)] + _data(corpus) + SMALL + EVENTS)
    return {"root": root, "corpus": corpus, "run": out / RUN_NAME}


def _rows(run):
    with open(run / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_checkpoints_and_resumes(trained):
    run = trained["run"]
    rows = _rows(run)
    assert [r["epoch"] for r in rows] == [0, 1] and [r["steps"] for r in rows] == [1, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in rows)
    assert {"data_wait_s", "prep_s", "dispatch_s", "val_hs_f1w"} <= set(rows[0])
    for tag in ("best", "last"):
        assert os.listdir(run / f"ckpt_{tag}") == ["state.pt"]
        meta = json.load(open(run / f"ckpt_{tag}.json"))
        assert meta["format"] == "torch_trainstate_v1" and meta["model_conf"]["dim"] == 16
    assert json.load(open(run / "ckpt_last.json"))["step"] == 2
    # resume to a third epoch in another out_dir
    out = trained["root"] / "resumed"
    train_cli.main(["--device", "cpu", "--max_epochs", "3", "--out_dir", str(out), "--resume_from",
                    str(run / "ckpt_last")] + _data(trained["corpus"]) + SMALL + EVENTS)
    assert [r["epoch"] for r in _rows(out / RUN_NAME)] == [2]
    assert json.load(open(out / RUN_NAME / "ckpt_last.json"))["step"] == 3


def test_pretrain_cpc_blob_then_train_from_it(trained):
    """``pretrain_cpc --export_blob`` (256 wide, the blob format's width),
    then ``train --init_encoder_from`` the blob and the checkpoint
    directory: the frozen encoder in the trained checkpoint is the
    pretrained one."""
    cpc = trained["root"] / "cpc"
    pretrain_cpc.main(["--device", "cpu", "--data_train_path", trained["corpus"], "--batch_size", "2", "--steps",
                       "2", "--log_every", "1", "--n_negatives", "8", "--out_dir", str(cpc), "--export_blob"])
    logs = [json.loads(line) for line in open(cpc / "cpc_metrics.jsonl")]
    assert [r["step"] for r in logs] == [1, 2] and all(np.isfinite(r["cpc_loss"]) for r in logs)
    encoder = restore_checkpoint(str(cpc / "cpc_encoder"), {"encoder": None})["encoder"]
    blob = load_cpc_blob(str(cpc / "cpc_blob.pt"))
    assert set(blob) == {k for k in encoder if not k.startswith("downsample.")}
    for k, v in blob.items():
        assert torch.equal(v, encoder[k]), k
    wide = ["--vap_channel_layers", "1", "--vap_cross_layers", "1"]
    for source in ("cpc_blob.pt", "cpc_encoder"):
        out = trained["root"] / f"from_{source}"
        train_cli.main(["--device", "cpu", "--max_epochs", "1", "--out_dir", str(out), "--init_encoder_from",
                        str(cpc / source)] + _data(trained["corpus"], val=False) + wide + EVENTS)
        params = restore_checkpoint(str(out / "VapGPT_50Hz_ad4s_114" / "ckpt_last"), {"params": None})["params"]
        for k, v in blob.items():  # the downsample trains, the frozen CPC does not
            assert torch.equal(params[f"encoder.{k}"], v), (source, k)


def test_mono_train_cli(trained):
    out = trained["root"] / "mono"
    train_cli.main(["--mono", "--device", "cpu", "--max_epochs", "1", "--out_dir", str(out), "--vap_va_history",
                    "1", "--data_va_history_times", "2.0", "1.0", "0.5", "0.25", "--data_flip_channels", "0"]
                   + _data(trained["corpus"]) + SMALL + EVENTS)
    rows = _rows(out / RUN_NAME)
    assert len(rows) == 1 and rows[0]["steps"] == 1 and rows[0]["val_loss_va"] == 0.0
    meta = json.load(open(out / RUN_NAME / "ckpt_last.json"))
    assert meta["model_conf"]["mono"] and meta["model_conf"]["va_history"]


def test_run_cli_checkpoint_equals_the_model_in_process(trained, tmp_path):
    wav = os.path.join(os.path.dirname(trained["corpus"]), "dialog0.wav")
    ckpt = str(trained["run"] / "ckpt_best")
    out = tmp_path / "out.json"
    run_cli.main(["-a", wav, "--checkpoint", ckpt, "-o", str(out), "--device", "cpu"] + SMALL)
    conf = VapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
    model = VapModel(conf, restore_checkpoint(ckpt, {"params": None})["params"], device="cpu")
    waveform, _ = load_waveform(wav, sample_rate=16_000)
    want, _ = run_cli.extract_waveform(model, waveform[None])
    assert read_json(str(out)) == json.loads(json.dumps(tensor_dict_to_json(want)))


def test_evaluate_cli_checkpoint_equals_the_model_in_process(trained, tmp_path):
    ckpt = str(trained["run"] / "ckpt_best")
    eval_cli.main(["--device", "cpu", "--checkpoint", ckpt, "--data_test_path", trained["corpus"],
                   "--data_audio_duration", "4.0", "--data_batch_size", "2", "--out_dir", str(tmp_path / "cli"),
                   "--data_phrases_probe", "0"] + SMALL + EVENTS)
    conf = VapConfig(dim=16, encoder_dim=16, channel_layers=1, cross_layers=1)
    model = VapModel(conf, restore_checkpoint(ckpt, {"params": None})["params"], device="cpu")
    loader = VapDataLoader(SlidingWindowDataset(trained["corpus"], audio_duration=4.0), batch_size=2,
                           shuffle=False, drop_last=False)
    events = EventConfig(min_context_time=1.0, max_time=4.0, bc_negative_pad_left_time=0.4,
                         bc_negative_pad_right_time=0.4)
    want = evaluate(model, loader, events, out_dir=str(tmp_path / "in"))
    with open(tmp_path / "cli" / "metrics.csv") as f:
        header, values = f.read().splitlines()
    assert dict(zip(header.split(","), map(float, values.split(",")))) == want


def test_checkpoint_flag_refusals_and_precedence(trained, tmp_path):
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    wav = os.path.join(os.path.dirname(trained["corpus"]), "dialog0.wav")
    with pytest.raises(ValueError, match="orbax"):
        run_cli.main(["-a", wav, "--checkpoint", str(orbax), "-o", str(tmp_path / "o.json"), "--device", "cpu"]
                     + SMALL)
    with pytest.raises(ValueError, match="orbax"):
        eval_cli.main(["--device", "cpu", "--checkpoint", str(orbax), "--data_test_path", trained["corpus"],
                       "--data_phrases_probe", "0"] + SMALL)
    with pytest.raises(ValueError, match="orbax"):
        train_cli.main(["--device", "cpu", "--max_epochs", "1", "--out_dir", str(tmp_path / "r"), "--resume_from",
                        str(orbax)] + _data(trained["corpus"], val=False) + SMALL)
    # --state_dict comes before --checkpoint
    from voiceactivityprojection_tpu_torch.models.checkpoint import export_vap_state_dict

    params = restore_checkpoint(str(trained["run"] / "ckpt_best"), {"params": None})["params"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_vap_state_dict(params).items()}
    torch.save(sd, tmp_path / "w.pt")
    args = run_cli.get_args(["-a", wav, "-sd", str(tmp_path / "w.pt"), "--checkpoint", str(orbax)] + SMALL)
    model = VapModel.from_args(args, device="cpu")
    for k, v in params.items():
        assert torch.equal(model.net.state_dict()[k], v), k


def test_default_device_and_devices_refused(trained, tmp_path, monkeypatch):
    # --multihost needs torchrun's environment; --n_devices 2 runs
    # (tests/test_torch_parallel.py), on the card one process a card
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "VAP_DIST_INIT_METHOD"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--device", "cpu", "--multihost"] + _data(trained["corpus"]) + SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--out_dir", str(tmp_path / "t")] + _data(trained["corpus"]) + SMALL)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="one process a card"):
        train_cli.main(["--n_devices", "2", "--out_dir", str(tmp_path / "t")] + _data(trained["corpus"]) + SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_cpc.main(["--data_train_path", trained["corpus"], "--out_dir", str(tmp_path / "c")])
    assert not (tmp_path / "t").exists() and not (tmp_path / "c").exists()


def test_train_module_runs_as_a_program(trained, tmp_path):
    r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.train", "--device", "cpu",
                        "--max_epochs", "1", "--out_dir", str(tmp_path)] + _data(trained["corpus"], val=False)
                       + SMALL + EVENTS, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Run: VapGPT_50Hz_ad4s_114" in r.stdout
    assert (tmp_path / RUN_NAME / "ckpt_last" / "state.pt").is_file()

"""PyTorch port, isolation from JAX and from the card's absence.

The port imports neither ``jax`` nor anything of ``voiceactivityprojection_tpu``
(checked in a fresh interpreter, since this process already imported JAX
through conftest, and by scanning the sources), and its entry points
default to the card and refuse to run without it.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import voiceactivityprojection_tpu_torch as port
from voiceactivityprojection_tpu_torch import VapConfig, VapModel
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.model

PKG = Path(port.__file__).resolve().parent
REPO = PKG.parent


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_fresh_import_pulls_in_no_jax():
    assert {
        "voiceactivityprojection_tpu_torch.train.step",
        "voiceactivityprojection_tpu_torch.ops.conv_fused",
        "voiceactivityprojection_tpu_torch.parallel.mesh",
        "voiceactivityprojection_tpu_torch.parallel.context",
        "voiceactivityprojection_tpu_torch.utils.io",
        "voiceactivityprojection_tpu_torch.utils.native",
        "voiceactivityprojection_tpu_torch.ops.audio",
        "voiceactivityprojection_tpu_torch.ops.vad",
        "voiceactivityprojection_tpu_torch.ops.objective_variants",
        "voiceactivityprojection_tpu_torch.inference.extraction",
        "voiceactivityprojection_tpu_torch.run",
        "voiceactivityprojection_tpu_torch.events",
        "voiceactivityprojection_tpu_torch.events.events",
        "voiceactivityprojection_tpu_torch.events.metrics",
        "voiceactivityprojection_tpu_torch.events.zero_shot",
        "voiceactivityprojection_tpu_torch.train.evaluation",
        "voiceactivityprojection_tpu_torch.data",
        "voiceactivityprojection_tpu_torch.data.dataset",
        "voiceactivityprojection_tpu_torch.data.phrases",
        "voiceactivityprojection_tpu_torch.evaluate",
        "voiceactivityprojection_tpu_torch.utils.runtime",
        "voiceactivityprojection_tpu_torch.utils.flops",
        "voiceactivityprojection_tpu_torch.ops.pitchshift",
        "voiceactivityprojection_tpu_torch.train.augment",
        "voiceactivityprojection_tpu_torch.train.loop",
        "voiceactivityprojection_tpu_torch.train.__main__",
        "voiceactivityprojection_tpu_torch.pretrain_cpc",
        "voiceactivityprojection_tpu_torch.models.encoder_streaming_exact",
        "voiceactivityprojection_tpu_torch.inference.streaming",
        "voiceactivityprojection_tpu_torch.inference.streaming_kv",
        "voiceactivityprojection_tpu_torch.inference.sds",
        "voiceactivityprojection_tpu_torch.inference.server",
        "voiceactivityprojection_tpu_torch.run_sds",
        "voiceactivityprojection_tpu_torch.serve",
        "voiceactivityprojection_tpu_torch.ops.prosody",
        "voiceactivityprojection_tpu_torch.data.backchannel",
        "voiceactivityprojection_tpu_torch.utils.plot",
        "voiceactivityprojection_tpu_torch.utils.profiling",
        "voiceactivityprojection_tpu_torch.evaluate_phrases",
        "voiceactivityprojection_tpu_torch.load_output",
        "voiceactivityprojection_tpu_torch.parallel.tp",
        "voiceactivityprojection_tpu_torch.tools.dryrun_multichip",
        "voiceactivityprojection_tpu_torch.tools.trace_sessions",
    } <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'voiceactivityprojection_tpu' or m.startswith('voiceactivityprojection_tpu.')"
        " or m == 'matplotlib' or m.startswith('matplotlib.'))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "voiceactivityprojection_tpu"), (
                    f"{path}: imports {name}"
                )


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VapModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VapModel(VapConfig(dtype="bfloat16"), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_package_exports():
    assert set(port.__all__) >= {"VapConfig", "VapModel", "params_from_jax"}

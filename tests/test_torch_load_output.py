"""PyTorch port, ``python -m voiceactivityprojection_tpu_torch.load_output``
(``load_np`` and the summary) against the JAX package's root
``load_output.py`` on a JSON that the port's ``run`` CLI wrote."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from voiceactivityprojection_tpu_torch import load_output as tlo
from voiceactivityprojection_tpu_torch import run as trun

pytestmark = pytest.mark.inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ARGS = ["--vap_dim", "16", "--vap_encoder_dim", "16", "--vap_channel_layers", "1", "--vap_cross_layers", "1"]


@pytest.fixture(scope="module")
def output(tmp_path_factory):
    d = tmp_path_factory.mktemp("load_output")
    x = (0.2 * np.random.default_rng(0).standard_normal((16000 * 2, 2))).clip(-1, 1)
    wavfile.write(d / "a.wav", 16000, (x * 32767).astype(np.int16))
    trun.main(["-a", str(d / "a.wav"), "-o", str(d / "a.json"), "--device", "cpu"] + SMALL_ARGS)
    return d / "a.json"


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_load_output", os.path.join(ROOT, "load_output.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_np_equals_jax(output):
    got, want = tlo.load_np(str(output)), _jax_script().load_np(str(output))
    assert list(got) == list(want) and {"p_now", "p_future", "probs", "vad", "H"} <= set(got)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    # a vad_list stays a list
    vl = output.parent / "vl.json"
    vl.write_text('{"vad_list": [[[0.0, 1.0]], []], "p_now": [[0.5, 0.5]]}')
    assert tlo.load_np(str(vl))["vad_list"] == [[[0.0, 1.0]], []]


def test_summary_equals_jax_script(output):
    outs = [subprocess.run([sys.executable] + argv + [str(output)], cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
            for argv in (["-m", "voiceactivityprojection_tpu_torch.load_output"], ["load_output.py"])]
    assert all(o.returncode == 0 for o in outs), [o.stderr[-2000:] for o in outs]
    assert outs[0].stdout == outs[1].stdout and "p_now: (1, 100, 2) float64" in outs[0].stdout
    usage = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.load_output"], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and usage.stdout.startswith("usage:")

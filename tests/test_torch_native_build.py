"""PyTorch port, the native audio library's first build under concurrent
first use (``utils/native.py``): six processes meet a copy of ``native/``
with no library at once, and every one of them loads the complete library
(the build links into a temporary name, renames it into place and runs
under a file lock). The repo's own ``native/`` is never touched."""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.functional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 6
LIMIT_S = 120
STAGGER_S = 0.2

CHILD = r"""
import os, sys, time
import numpy as np
from voiceactivityprojection_tpu_torch.utils import native

native.NATIVE_DIR = sys.argv[1]
go = os.path.join(sys.argv[1], "go")
while not os.path.exists(go):
    time.sleep(0.005)
time.sleep(float(sys.argv[2]))  # staggered, so that one build ends while another links
lib = native.get_lib()
x = np.sin(np.arange(2205, dtype=np.float32) / 7.0).astype(np.float32)
y = native.resample_poly(x, 160, 441)
print("RESULT", lib is not None, os.path.getsize(native.so_path()), None if y is None else float(np.abs(y).sum()))
"""


def test_six_processes_build_and_load_one_library(tmp_path):
    if shutil.which("make") is None or shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler here: the native library cannot be built")
    nat = tmp_path / "native"
    nat.mkdir()
    for name in ("Makefile", "vapaudio.cpp"):
        shutil.copy(os.path.join(REPO, "native", name), nat / name)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(nat), str(STAGGER_S * i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(N_PROCS)]
    try:
        time.sleep(0.5)  # let every child reach the barrier, then release them
        (nat / "go").write_text("")
        outs = [p.communicate(timeout=LIMIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1].split()
        results.append((line[1], int(line[2]), line[3]))
    size = os.path.getsize(nat / "libvapaudio.so")
    assert all(r == ("True", size, results[0][2]) for r in results), results
    assert results[0][2] != "None" and np.isfinite(float(results[0][2]))
    # nothing half-built is left beside it
    assert sorted(os.listdir(nat)) == sorted(["Makefile", "vapaudio.cpp", "libvapaudio.so", ".libvapaudio.lock", "go"])

"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``voiceactivityprojection_tpu_torch/build/`` under a name that holds
the hash of the source, the shared headers and the flags, so a changed
source is rebuilt on its next use. ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for every one of them.

Nothing here runs at import: the first kernel launch builds what it needs.
A missing ``nvcc`` or a failed build raises; no caller falls back to the
plain PyTorch versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES: Tuple[str, ...] = (
    "conv_stack", "gru_downsample", "flash_alibi", "gru_recurrence", "flash_alibi_train",
    "gru_backward", "conv_fused", "kv_attention", "linear_tf32x3",
)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of the C interfaces (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from csrc/ at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns ``{name: compiler output}`` (the
    ``-Xptxas -v`` register and shared-memory report) for what it built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check_cuda_tensor(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_aligned(t: torch.Tensor, what: str, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    tensor-core kernels copy rows in 16-byte pieces)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{what}: data must start on a {nbytes}-byte boundary, got address "
                         f"{t.data_ptr():#x}")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def stream_handle() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def grad_requested(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``: a kernel without
    a backward raises then instead of returning a tensor cut from the graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch (cudaGetLastError)")

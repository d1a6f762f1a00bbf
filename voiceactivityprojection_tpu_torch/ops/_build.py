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

The launch ledger counts every C entry call of the kernel wrappers by op
and kernel. Each wrapper module declares its op's kernel names at import
(``declare_kernels``); ``check_launch(rc, op, kernel)`` checks a launch
and counts it, and an undeclared name raises. Readers take a snapshot
(``launch_counts``) and the difference since it (``launches_since``);
``launch_totals`` gives each op's launches without its auxiliary kernels
(a weight's split, a slice sum). A CUDA graph's capture is taken back and
each replay adds what it recorded (``add_launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES: Tuple[str, ...] = (
    "conv_stack", "gru_downsample", "flash_alibi", "gru_recurrence", "flash_alibi_train",
    "gru_backward", "conv_fused", "kv_attention", "linear_tf32x3", "cpc_infonce",
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


def stream_handle(t: torch.Tensor) -> int:
    """The raw current stream of CUDA tensor ``t``'s device (no Stream
    object, whose making costs several microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def grad_requested(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``: a kernel without
    a backward raises then instead of returning a tensor cut from the graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# {op: {kernel: launches}} since the process started, in declaration order
Counts = Dict[str, Dict[str, int]]
_LEDGER: Counts = {}
_AUXILIARY: Dict[str, FrozenSet[str]] = {}
_ALL_DECLARED = False


def declare_kernels(op: str, kernels: Sequence[str], auxiliary: Sequence[str] = ()) -> None:
    """Declare ``op``'s kernels: ``kernels`` its main launch's routes,
    ``auxiliary`` the launches beside it that ``launch_totals`` leaves out.
    Declaring an op again with the same names keeps its counts."""
    names = (*kernels, *auxiliary)
    if op in _LEDGER:
        if tuple(_LEDGER[op]) != names:
            raise ValueError(f"launch ledger: {op!r} declared as {tuple(_LEDGER[op])}, now as {names}")
        return
    _LEDGER[op] = dict.fromkeys(names, 0)
    _AUXILIARY[op] = frozenset(auxiliary)


def _row(op: str, kernel: str) -> Dict[str, int]:
    row = _LEDGER.get(op)
    if row is None or kernel not in row:
        raise ValueError(f"launch ledger: no kernel {kernel!r} declared for {op!r} "
                         f"(declared: {tuple(row) if row is not None else tuple(_LEDGER)})")
    return row


def check_launch(rc: int, op: str, kernel: str) -> None:
    """Raise if the C entry's launch of ``op``'s ``kernel`` failed (``rc``:
    its cudaGetLastError), else count it in the ledger."""
    row = _row(op, kernel)
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA error {rc} at launch of {kernel!r} (cudaGetLastError)")
    row[kernel] += 1


def _declare_all() -> None:
    """Import every module of ``ops/`` once: each kernel wrapper declares
    its op at import, so every reading holds every op."""
    global _ALL_DECLARED
    if not _ALL_DECLARED:
        _ALL_DECLARED = True
        for path in sorted(Path(__file__).parent.glob("*.py")):
            importlib.import_module(f"{__package__}.{path.stem}")


def launch_counts() -> Counts:
    """A snapshot of the ledger: every op, by kernel."""
    _declare_all()
    return {op: dict(row) for op, row in _LEDGER.items()}


def launches_since(before: Counts) -> Counts:
    """Every op's launches by kernel since ``before`` (a
    ``launch_counts()``)."""
    _declare_all()
    return {op: {k: n - before.get(op, {}).get(k, 0) for k, n in row.items()} for op, row in _LEDGER.items()}


def launch_totals(counts: Counts) -> Dict[str, int]:
    """Each op's launches in ``counts`` without its auxiliary kernels."""
    return {op: sum(n for k, n in row.items() if k not in _AUXILIARY.get(op, ())) for op, row in counts.items()}


def add_launches(counts: Counts, times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the ledger: a CUDA graph's replay adds
    what its capture recorded, ``times=-1`` takes the capture back."""
    for op, row in counts.items():
        for k, n in row.items():
            _row(op, k)[k] += times * n

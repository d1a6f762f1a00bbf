"""ctypes binding of the repo's native audio library (``native/vapaudio.cpp``).

Counterpart of ``voiceactivityprojection_tpu/utils/native.py:18-180``, with
the same C interface: ``libvapaudio.so`` is built with ``make -C native``
at first use where a compiler is present and is loaded once per process.
Every function returns ``None`` when the library is missing or fails, and
the callers (``ops/audio.py``) then take scipy, and say which one ran.

Several processes may reach the first use at once (test workers, loader
threads of several runs). The build links into a temporary name in
``native/`` and ``os.replace``s it into place, so no process ever sees a
half-written library, and it builds and loads under an ``fcntl.flock`` on
``native/.libvapaudio.lock``. A library that exists but does not load (a
file another process, such as the JAX package's loader, is still linking)
is rebuilt under the lock and loaded again, not cached as missing.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import math
import os
import subprocess
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
SO_NAME = "libvapaudio.so"
LOCK_NAME = ".libvapaudio.lock"

# the loaded library (or None once loading failed), by path
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def so_path(native_dir: Optional[str] = None) -> str:
    return os.path.join(native_dir or NATIVE_DIR, SO_NAME)


@contextlib.contextmanager
def _locked(native_dir: str) -> Iterator[None]:
    """An exclusive ``flock`` on the directory's lock file (none where the
    directory is not writable: then nothing is built there either)."""
    try:
        f = open(os.path.join(native_dir, LOCK_NAME), "a")
    except OSError:
        yield
        return
    with f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(native_dir: str) -> bool:
    """Links ``libvapaudio.so`` into a temporary name and renames it into
    place (the Makefile's ``TARGET`` set on the command line)."""
    tmp = f"{SO_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", native_dir, f"TARGET={tmp}"], check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(native_dir, tmp), so_path(native_dir))
    except (OSError, subprocess.SubprocessError):
        with contextlib.suppress(OSError):
            os.remove(os.path.join(native_dir, tmp))
        return False
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)
    lib.vap_wav_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, ctypes.POINTER(ctypes.c_long), c_int_p]
    lib.vap_wav_info.restype = ctypes.c_int
    lib.vap_wav_read.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, c_float_p]
    lib.vap_wav_read.restype = ctypes.c_long
    lib.vap_resample_poly.argtypes = [c_float_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_float_p]
    lib.vap_resample_poly.restype = ctypes.c_long
    lib.vap_deinterleave_i16.argtypes = [ctypes.POINTER(ctypes.c_int16), ctypes.c_long, ctypes.c_int, c_float_p]
    lib.vap_deinterleave_i16.restype = None
    lib.vap_rle_i32.argtypes = [c_i32_p, ctypes.c_long, c_i32_p, c_i32_p, c_i32_p]
    lib.vap_rle_i32.restype = ctypes.c_long
    return lib


def _load(native_dir: str) -> Optional[ctypes.CDLL]:
    """Builds where the source is and the library is not, then loads; a
    library that is there but does not load is built again once. Called
    under the lock."""
    path = so_path(native_dir)
    can_build = os.path.exists(os.path.join(native_dir, "vapaudio.cpp"))
    if not os.path.exists(path) and not (can_build and _build(native_dir)):
        return None
    try:
        return _declare(ctypes.CDLL(path))
    except OSError:  # not loadable here, or a file another process is still linking
        if not (can_build and _build(native_dir)):
            return None
    try:
        return _declare(ctypes.CDLL(path))
    except OSError:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built first if its source is here and it is not."""
    path = so_path()
    if path not in _LIBS:
        with _locked(NATIVE_DIR):
            _LIBS[path] = _load(NATIVE_DIR)
    return _LIBS[path]


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str) -> Optional[Tuple[int, int, int, int]]:
    """(sample_rate, channels, n_frames, bits), or None."""
    lib = get_lib()
    if lib is None:
        return None
    sr, ch, n, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    rc = lib.vap_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(n), ctypes.byref(bits))
    if rc != 0:
        return None
    return sr.value, ch.value, n.value, bits.value


def wav_read(path: str, start_frame: int = 0, n_frames: Optional[int] = None) -> Optional[Tuple[np.ndarray, int]]:
    """((channels, n) float32, sample_rate), or None."""
    lib = get_lib()
    info = wav_info(path) if lib is not None else None
    if info is None:
        return None
    sr, ch, total, _ = info
    if n_frames is None:
        n_frames = total - start_frame
    n_frames = max(0, min(n_frames, total - start_frame))
    buf = np.empty(n_frames * ch, dtype=np.float32)
    got = lib.vap_wav_read(path.encode(), start_frame, n_frames, _fptr(buf))
    if got < 0:
        return None
    return np.ascontiguousarray(buf[: got * ch].reshape(got, ch).T), sr


def resample_poly(x: np.ndarray, up: int, down: int) -> Optional[np.ndarray]:
    """Polyphase resampling of (ch, n) or (n,) float32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    # the C filter has about 20 * max(up, down) taps: reduce the ratio first
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    x = np.ascontiguousarray(x, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    ch, n = x.shape
    out = np.empty((ch, -(-n * up // down)), dtype=np.float32)
    if lib.vap_resample_poly(_fptr(x), n, ch, up, down, _fptr(out)) < 0:
        return None
    return out[0] if squeeze else out


def deinterleave_i16(raw: bytes, channels: int = 2) -> Optional[np.ndarray]:
    """Interleaved int16 frames -> (channels, n) float32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.frombuffer(raw, dtype=np.int16)
    n = len(x) // channels
    out = np.empty((channels, n), dtype=np.float32)
    lib.vap_deinterleave_i16(x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n, channels, _fptr(out))
    return out


def rle_i32(x: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Run-length encoding of a 1-D int32 array: (starts, durations, values)."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int32)
    n = len(x)
    starts, durs, vals = (np.empty(n, dtype=np.int32) for _ in range(3))
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    r = lib.vap_rle_i32(p(x), n, p(starts), p(durs), p(vals))
    return starts[:r].copy(), durs[:r].copy(), vals[:r].copy()

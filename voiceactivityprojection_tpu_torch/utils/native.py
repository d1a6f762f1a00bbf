"""ctypes binding of the repo's native audio library (``native/vapaudio.cpp``).

Counterpart of ``voiceactivityprojection_tpu/utils/native.py:18-180``, with
the same C interface: ``libvapaudio.so`` is built with ``make -C native``
at first use where a compiler is present and is loaded once per process.
Every function returns ``None`` when the library is missing or fails, and
the callers (``ops/audio.py``) then take scipy, and say which one ran.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
SO_PATH = os.path.join(NATIVE_DIR, "libvapaudio.so")

# the loaded library (or None once loading failed), by path
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", NATIVE_DIR], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(SO_PATH)


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


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built first if its source is here and it is not."""
    if SO_PATH not in _LIBS:
        if not os.path.exists(SO_PATH) and os.path.exists(os.path.join(NATIVE_DIR, "vapaudio.cpp")):
            _build()
        try:
            _LIBS[SO_PATH] = _declare(ctypes.CDLL(SO_PATH))
        except OSError:  # missing, or not loadable here
            _LIBS[SO_PATH] = None
    return _LIBS[SO_PATH]


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

"""ctypes binding for the native JPEG decoder (counterpart of
geoguessr_ai_tpu/data/native/jpeg.py), built from ``jpeg_decode.cpp`` at
first use.

The library is compiled once with g++ (libjpeg and pthreads) into
``build/native/`` of the checkout, never next to the source, and rebuilt
when the source is newer.  With ``GEO_TPU_NO_NATIVE=1`` a missing or stale
library is not built.  Callers fall back to PIL when the toolchain or
libjpeg is missing (``data.pipeline.decode_jpeg``), so this module is an
accelerator, never a hard dependency; ``available()`` says whether it
loaded and ``build_error()`` why not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from geoguessr_ai_torch.config import REPO_ROOT

_SRC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "jpeg_decode.cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
SO_PATH = os.path.join(BUILD_DIR, "_jpeg_native.so")

_lib = None
_lock = threading.Lock()
_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compiles the library into a private file, then moves it into place
    (another process may build at the same time).  Returns None, or the
    tail of the compiler's stderr on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
           _SRC_PATH, "-ljpeg", "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if out.returncode != 0:
        return (out.stderr.strip() or f"g++ exited {out.returncode}")[-400:]
    os.replace(tmp, SO_PATH)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        stale = os.path.exists(SO_PATH) and (
            os.path.getmtime(_SRC_PATH) > os.path.getmtime(SO_PATH))
        if not os.path.exists(SO_PATH) or stale:
            if os.environ.get("GEO_TPU_NO_NATIVE") == "1":
                _error = "GEO_TPU_NO_NATIVE=1"
                return None
            _error = _build()
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(SO_PATH)
        except OSError as e:
            _error = str(e)
            return None
        lib.gg_decode_resize.restype = ctypes.c_int
        lib.gg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.gg_decode_batch.restype = None
        lib.gg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (the tail of the compiler's
    stderr, the loader's error, or the override), or None."""
    _load()
    return _error


def decode_resize(blob: bytes, size: int) -> np.ndarray:
    """Decode one JPEG to (size, size, 3) uint8.  Raises on decode error."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native jpeg decoder unavailable: {_error}")
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.gg_decode_resize(
        blob, len(blob), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        size, size)
    if rc != 0:
        raise ValueError(f"jpeg decode failed (code {rc})")
    return out


def decode_batch(blobs: List[bytes], size: int,
                 n_threads: int = 0) -> np.ndarray:
    """Decode JPEGs to (n, size, size, 3) uint8 in parallel; an image that
    fails to decode comes back as zeros (a black placeholder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native jpeg decoder unavailable: {_error}")
    n = len(blobs)
    out = np.zeros((n, size, size, 3), np.uint8)
    if n == 0:
        return out
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    status = (ctypes.c_int * n)()
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    lib.gg_decode_batch(
        bufs, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        size, size, n_threads, status)
    for i in range(n):
        if status[i] != 0:
            out[i] = 0
    return out

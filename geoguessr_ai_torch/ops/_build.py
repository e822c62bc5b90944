"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Libraries are built at first use from the sources in this
checkout and cached under ``<repo>/build/kernels/`` by a hash of the
source, the shared headers and the flags, so an edited source is rebuilt.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point, by library name.
SIGNATURES: Dict[str, tuple] = {
    "attention_qkv": ("attention_qkv_bf16", (_P, _P, _P, _I, _I, _I, _F, _P)),
    "fb_s2": (
        "fb_s2_bf16",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    ),
    "fused_block": (
        "fused_block_bf16",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _F, _F, _P),
    ),
    "attention_qkv_bwd": (
        "attention_qkv_bwd_bf16",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    ),
    "attention_bwd_merged": (
        "attention_bwd_merged_bf16",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    ),
    "fb4d": (
        "fb4d_bf16",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _F, _F, _P),
    ),
    "mbconv": (
        "mbconv_bf16",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    ),
    "clip_flash": ("clip_flash_bf16", (_P, _P, _I, _I, _I, _F, _P)),
    "clip_flash_proj": (
        "clip_flash_proj_bf16",
        (_P, _P, _P, _I, _I, _I, _F, _P),
    ),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first use "
            "and need the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compiles every library in ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns the wall seconds taken;
    raises with the compiler's output if one fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``, or "" when it was cached."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its entry point's argtypes set;
    builds it first when needed."""
    build((name,))
    lib = ctypes.CDLL(str(_target(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib


def entry(name: str):
    """The C entry point of library ``name``."""
    return getattr(library(name), SIGNATURES[name][0])

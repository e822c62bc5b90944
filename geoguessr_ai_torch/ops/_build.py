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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _twins(name: str, argtypes: tuple) -> Dict[str, tuple]:
    """An entry point and its f32 twin: ``<name>_bf16`` and ``<name>_f32``
    take the same arguments, their tensors in bf16 and in f32."""
    return {f"{name}_bf16": argtypes, f"{name}_f32": argtypes}


#: A window-attention core's plan query: (W, N, H, hd, G, rows, int *out).
_PLAN = (_I, _I, _I, _I, _I, _I, _P)


def _tiled(name: str, kind: str, argtypes: tuple) -> Dict[str, tuple]:
    """A window-attention entry, its f32 twin, its bf16 entry of the other
    item kind (``<name>_<kind>_bf16``, the same arguments: the tile knobs
    of ``window_attention``) and its library's plan query."""
    return {**_twins(name, argtypes), f"{name}_{kind}_bf16": argtypes,
            f"{name}_plan": _PLAN}


def _tiled_bwd(name: str, argtypes: tuple) -> Dict[str, tuple]:
    """A backward entry of the Hopper backward core (``_tiled`` with its
    64-row bf16 kind) and the plan query of the core's f32 kind,
    ``<name>_plan_f32``."""
    return {**_tiled(name, "q64", argtypes), f"{name}_plan_f32": _PLAN}


#: Entry points of every library, by library name: C name -> argtypes.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "attention_qkv": _tiled("attention_qkv", "q128", (
        _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    "fb_s2": _tiled("fb_s2", "q128", (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P)),
    "fused_block": _tiled("fused_block", "q128", (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _F, _P)),
    "attention_qkv_bwd": _tiled_bwd("attention_qkv_bwd", (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    "attention_bwd_merged": _tiled_bwd("attention_bwd_merged", (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    "attention_bwd_qtiled": _tiled_bwd("attention_bwd_qtiled", (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    "attention_headmajor": {
        **_tiled("attention_qtiled", "q128", (
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
        **_tiled("attention_batched", "q128", (
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    },
    "fb4d": _tiled("fb4d", "q128", (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P)),
    "mbconv": _twins("mbconv", (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "fused_mbconv_exp": {
        "fused_mbconv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P),
        "fused_mbconv_v2_bf16": (_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P),
    },
    "tiled_gemm": {
        "tiled_gemm_bf16": (_P, _P, _P, _I, _I, _I, _P),
        "tiled_gemm_s8": (_P, _P, _P, _I, _I, _I, _P),
        "tiled_gemm_plan": (_I, _I, _I, _I, _P),
    },
    "clip_flash": _twins("clip_flash", (_P, _P, _I, _I, _I, _I, _F, _P)),
    "clip_flash_proj": _twins("clip_flash_proj", (
        _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    "smem_probe": {"smem_probe_f32": (_P, _P, _I, _I, _I, _P)},
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


def library_path(name: str) -> Path:
    """The shared library of ``name`` from this checkout's sources, built
    first when needed."""
    build((name,))
    return _target(name)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its entry points' argtypes set;
    builds it first when needed."""
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def entry(name: str, fn_name: Optional[str] = None):
    """The C entry point ``fn_name`` of library ``name``; the library's
    only one when ``fn_name`` is None."""
    if fn_name is None:
        (fn_name,) = SIGNATURES[name]
    return getattr(library(name), fn_name)


#: The C entry suffix of each activation dtype the kernels take.
ENTRY_SUFFIX = {"torch.bfloat16": "bf16", "torch.float32": "f32"}


def typed_entry(name: str, fn: str, dtype):
    """The entry ``<fn>_bf16`` or ``<fn>_f32`` of library ``name`` for
    tensors of ``dtype``; raises ValueError for any other dtype."""
    suffix = ENTRY_SUFFIX.get(str(dtype))
    if suffix is None:
        raise ValueError(f"the kernels take torch.bfloat16 or torch.float32, "
                         f"got {dtype}")
    return entry(name, f"{fn}_{suffix}")

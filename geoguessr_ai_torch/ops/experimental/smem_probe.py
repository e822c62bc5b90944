"""21 x through six staged copies in shared memory (K14): the probe of the
shared-memory opt-in.

Counterpart of ``probe`` in tools/exp_r4_vmem.py, with which the JAX
package asked whether a kernel that needs more fast memory than the
compiler's default limit runs once ``vmem_limit_bytes`` raises it: its
kernel adds x * 1, ..., x * 6 for x (1, 1024, 1024) f32 through a 24 MiB
VMEM scratch.  On Hopper the limit is the 48 KB of shared memory a block
gets unless the kernel opts into more (``csrc/smem_probe.cu``: 192 KiB a
block).  Nothing in either package's models calls it;
``python -m geoguessr_ai_torch.tools.exp_r4_vmem`` runs the probe.

``smem_probe(x, limit)``: x (1, R, C) f32 with R a multiple of 8 and C
of 4 (the kernel moves float4) -> (R, C) f32.  A CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.  ``limit`` is the counterpart of
``vmem_limit_bytes``: None launches without the opt-in, so the launch is
refused and ``smem_probe`` raises the CUDA error; a number of bytes is
handed to ``cudaFuncSetAttribute`` first.
"""

from __future__ import annotations

import torch

from geoguessr_ai_torch.ops.window_attention import _check, _raise_on, _stream

#: Launches of the kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {"_smem_probe_cuda": 0}

#: Copies of x the kernel stages (the Pallas scratch's leading axis).
SLABS = 6
#: Rows of x one block stages: SLABS * ROWS * C * 4 bytes of shared memory.
ROWS = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _smem_probe_plain(x, limit=None):
    """Mirror of ``kern``: the SLABS products x * (i + 1), summed in the
    kernel's order i = 0..5."""
    s = x[0] * 1.0
    for i in range(1, SLABS):
        s = s + x[0] * (i + 1.0)
    return s


def smem_bytes(cols: int) -> int:
    """Dynamic shared memory of one K14 block for rows of ``cols``."""
    return 4 * SLABS * ROWS * cols


def _smem_probe_cuda(x, limit=None):
    from geoguessr_ai_torch.ops import _build

    _, R, C = x.shape
    _check("x", x, (1, R, C), torch.float32)
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    err = _build.entry("smem_probe")(x.data_ptr(), out.data_ptr(), R, C,
                                     int(limit or 0), _stream())
    _raise_on(err, "_smem_probe_cuda")
    LAUNCHES["_smem_probe_cuda"] += 1
    return out


def smem_probe(x, limit=None):
    """sum over i = 1..6 of i * x[0] -> (R, C) f32, x (1, R, C) f32."""
    if x.dim() != 3 or x.shape[0] != 1 or x.shape[1] % ROWS or \
            x.shape[2] % 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be (1, R, C) float32 with R a multiple of "
                         f"{ROWS} and C of 4, got {tuple(x.shape)} {x.dtype}")
    fn = _smem_probe_cuda if x.is_cuda else _smem_probe_plain
    return fn(x, limit)

"""Does a kernel that needs more fast memory than the default limit run
once the limit is raised?

    python -m geoguessr_ai_torch.tools.exp_r4_vmem [case,case,...]

The port of tools/exp_r4_vmem.py, under its name and with its cases.  Each
case runs in a subprocess (a refused launch must not end the batch), and
the tool prints the JSON lines the JAX tool prints: the case's own lines,
then ``{"case", "result": "CRASH", "rc", ...}`` when its process failed or
``{"case", "result": "done", ...}`` when it ended.

  probe_default  K14 (``ops.experimental.smem_probe``) with no opt-in: its
                 192 KiB of shared memory a block is over the 48 KB
                 default, so the launch is refused -> expected CRASH
                 (proves the probe exercises the limit)
  probe_v64      the same kernel with the opt-in raised to the card's
                 ``shared_memory_per_block_optin`` -> ok, s = 21.0
                 (x = ones, out = 21 x)

The JAX tool's seven other cases run the JAX package's window-attention
kernels with tile knobs and its ``VMEM_LIMIT_BYTES`` raised; the port's
kernels have no such knobs yet (ROADMAP.md, Queue 1 item 16), so those
cases raise NotImplementedError.  Needs a GPU: without one the tool exits
non-zero and runs nothing on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: The JAX tool's ``vmem_limit_bytes`` of its *_v64 cases.
V64 = 64 * 1024 * 1024
#: x of the JAX probe.
SHAPE = (1, 1024, 1024)
#: The JAX tool's cases that set window-attention tile knobs, with the
#: knobs each sets (geoguessr_ai_tpu/ops/window_attention.py).
KNOB_CASES = {
    "s2bat_v64": {"VMEM_LIMIT_BYTES": V64, "S2_HEAD_BATCHED": True,
                  "S2_BLOCK_Q": 256},
    "fbwb8_v64": {"VMEM_LIMIT_BYTES": V64, "FUSED_BLOCK_WB": 8,
                  "FUSED_BLOCK_SCORE_BYTES": 32 * 1024 * 1024},
    "s2bq1024_v64": {"VMEM_LIMIT_BYTES": V64, "S2_BLOCK_Q": 1024},
    "s2hb12_v64": {"VMEM_LIMIT_BYTES": V64, "S2_HEAD_BLOCK": 12,
                   "S2_BLOCK_Q": 512},
    "stack4_v64": {"VMEM_LIMIT_BYTES": V64,
                   "_BWD_STACK_BYTES": 4 * 1024 * 1024},
    "bwdbq512_v64": {"VMEM_LIMIT_BYTES": V64, "_BWD_BLOCK_Q": 512},
    "train_both_v64": {"VMEM_LIMIT_BYTES": V64,
                       "_BWD_STACK_BYTES": 4 * 1024 * 1024,
                       "_BWD_BLOCK_Q": 512},
}


def log(**kw):
    print(json.dumps(kw), flush=True)


def probe(limit):
    """K14 on x = ones with the opt-in ``limit`` ("optin": the card's
    largest; None: none).  Logs s = out[0, 0] and the kernel's launches."""
    import torch

    from geoguessr_ai_torch.ops.experimental import smem_probe as sp

    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a GPU: K14 has no CPU mode")
    if limit == "optin":
        limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    x = torch.ones(SHAPE, dtype=torch.float32, device="cuda")
    sp.reset_launches()
    out = sp.smem_probe(x, limit)
    torch.cuda.synchronize()
    log(result="ok", s=float(out[0, 0]), limit=limit,
        smem_bytes=sp.smem_bytes(SHAPE[2]),
        launches=sp.LAUNCHES["_smem_probe_cuda"])


def knob_case(name):
    raise NotImplementedError(
        f"{name} sets the JAX window-attention tile knobs "
        f"{sorted(KNOB_CASES[name])}; the port's kernels have no "
        "counterparts yet (ROADMAP.md, Queue 1 item 16)")


CASES = {
    "probe_default": lambda: probe(None),
    "probe_v64": lambda: probe("optin"),
    **{name: (lambda name=name: knob_case(name)) for name in KNOB_CASES},
}


def main(argv=None):
    """Runs the named cases (all by default), each in a subprocess;
    returns the JSON records it printed."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 and argv[0] == "--case":
        CASES[argv[1]]()
        return []
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a GPU")
    names = argv[0].split(",") if argv else list(CASES)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    records = []

    def emit(**kw):
        records.append(kw)
        log(**kw)

    for name in names:
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "geoguessr_ai_torch.tools.exp_r4_vmem",
             "--case", name],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600,
        )
        wall = round(time.time() - t0, 1)
        for line in proc.stdout.splitlines():
            try:
                emit(case=name, **json.loads(line))
            except (json.JSONDecodeError, TypeError):
                emit(case=name, raw=line[:200])
        if proc.returncode != 0:
            emit(case=name, result="CRASH", rc=proc.returncode, wall_s=wall,
                 stderr_tail=proc.stderr[-500:])
        else:
            emit(case=name, result="done", wall_s=wall)
    return records


if __name__ == "__main__":
    main()

"""Does a kernel that needs more fast memory than the default limit run
once the limit is raised, and what do the window-attention tile knobs do?

    python -m geoguessr_ai_torch.tools.exp_r4_vmem [case,case,...] [--ref PATH]
        [--iters N]

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

The JAX tool's seven other cases set the JAX window-attention tile knobs;
here each sets the port's counterparts (``KNOB_CASES``: the JAX knobs, the
port knobs, the JAX knobs with no counterpart) in
``ops/window_attention.py`` and runs:

  embed  the TinyViT-21M-512 static-int8 forward at B=512 as the JAX
         ``tools/exp_r4_s2noproj.py`` ``run_case`` builds it (seeded
         weights, calibrated on the CPU in f32 on 2 images, quant sites
         fc1 and fc2; the batch drawn on the card from a seed), one
         warm-up and 10 timed calls: ms, img/s, panos/s, and
         ``min_cosine`` of its first 8 embeddings to the reference's (the
         first embed case of the batch, or ``--ref PATH``);
  train  the B=16 SuperGuessr ``train_step`` (TinyViT-21M-512, the cells
         of ``data/geocells/centroid_table.npz``) as the JAX
         ``tools/exp_r4_remat.py`` ``_train_case(16)`` builds it (seeded
         state, a random batch), one warm-up and 6 timed steps: ms,
         panos/s, the first step's loss.

``--iters N`` times N calls or steps instead (a quick check).

Every record of these cases also holds ``port_knobs`` and
``no_counterpart``.  Needs a GPU: without one the tool exits non-zero and
runs nothing on the CPU.
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
#: The JAX module's defaults of the q-tile knobs the cases raise.
JAX_S2_BLOCK_Q = 128
JAX_BWD_BLOCK_Q = 256

#: The JAX tool's cases that set window-attention tile knobs: what each
#: runs, the JAX knobs it sets (geoguessr_ai_tpu/ops/window_attention.py),
#: the port knobs it sets instead (geoguessr_ai_torch/ops/
#: window_attention.py) and the JAX knobs the port has no counterpart for.
#: The rule: VMEM_LIMIT_BYTES = 64 MiB raises the limit to the card's
#: largest, SMEM_LIMIT_BYTES = None; a JAX q tile raised above its default
#: (S2_BLOCK_Q 128, _BWD_BLOCK_Q 256) takes the port's larger kind
#: (FWD_Q_ROWS 128; BWD_Q_ROWS 128, which is also the default); the byte
#: and window knobs carry over as they are (_BWD_STACK_BYTES as
#: BWD_PARTIAL_BYTES).  S2_HEAD_BATCHED and S2_HEAD_BLOCK have none: an
#: item of the Hopper cores is one head.
KNOB_CASES = {
    "s2bat_v64": {
        "run": "embed",
        "jax": {"VMEM_LIMIT_BYTES": V64, "S2_HEAD_BATCHED": True,
                "S2_BLOCK_Q": 256},
        "port": {"SMEM_LIMIT_BYTES": None, "FWD_Q_ROWS": 128},
        "no_counterpart": ["S2_HEAD_BATCHED"],
    },
    "fbwb8_v64": {
        "run": "embed",
        "jax": {"VMEM_LIMIT_BYTES": V64, "FUSED_BLOCK_WB": 8,
                "FUSED_BLOCK_SCORE_BYTES": 32 * 1024 * 1024},
        "port": {"SMEM_LIMIT_BYTES": None, "FUSED_BLOCK_WB": 8,
                 "FUSED_BLOCK_SCORE_BYTES": 32 * 1024 * 1024},
        "no_counterpart": [],
    },
    "s2bq1024_v64": {
        "run": "embed",
        "jax": {"VMEM_LIMIT_BYTES": V64, "S2_BLOCK_Q": 1024},
        "port": {"SMEM_LIMIT_BYTES": None, "FWD_Q_ROWS": 128},
        "no_counterpart": [],
    },
    "s2hb12_v64": {
        "run": "embed",
        "jax": {"VMEM_LIMIT_BYTES": V64, "S2_HEAD_BLOCK": 12,
                "S2_BLOCK_Q": 512},
        "port": {"SMEM_LIMIT_BYTES": None, "FWD_Q_ROWS": 128},
        "no_counterpart": ["S2_HEAD_BLOCK"],
    },
    "stack4_v64": {
        "run": "train",
        "jax": {"VMEM_LIMIT_BYTES": V64,
                "_BWD_STACK_BYTES": 4 * 1024 * 1024},
        "port": {"SMEM_LIMIT_BYTES": None,
                 "BWD_PARTIAL_BYTES": 4 * 1024 * 1024},
        "no_counterpart": [],
    },
    "bwdbq512_v64": {
        "run": "train",
        "jax": {"VMEM_LIMIT_BYTES": V64, "_BWD_BLOCK_Q": 512},
        "port": {"SMEM_LIMIT_BYTES": None, "BWD_Q_ROWS": 128},
        "no_counterpart": [],
        "note": "BWD_Q_ROWS 128 is the port's largest kind and its default",
    },
    "train_both_v64": {
        "run": "train",
        "jax": {"VMEM_LIMIT_BYTES": V64,
                "_BWD_STACK_BYTES": 4 * 1024 * 1024, "_BWD_BLOCK_Q": 512},
        "port": {"SMEM_LIMIT_BYTES": None,
                 "BWD_PARTIAL_BYTES": 4 * 1024 * 1024, "BWD_Q_ROWS": 128},
        "no_counterpart": [],
        "note": "BWD_Q_ROWS 128 is the port's largest kind and its default",
    },
}
#: Where the embed cases keep their embeddings (inside the checkout,
#: ignored by git): ``<case>_emb.npy``, and the reference ``ref_emb.npy``.
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "exp_r4_vmem")
REF_EMB = os.path.join(OUT_DIR, "ref_emb.npy")
#: run_case's batch and timed calls; _train_case's batch and timed steps.
EMBED_BATCH = 512
EMBED_ITERS = 10
TRAIN_BATCH = 16
TRAIN_ITERS = 6
#: _train_case's FLOP count of one image's forward (3x for a train step),
#: over the card's bf16 peak (989 TFLOP/s, an H100 SXM's).
IMAGE_FLOPS = 54e9
PEAK_BF16_FLOP_S = 989e12


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


def set_knobs(port_knobs):
    """Sets the port's window-attention tile knobs (each call of the bf16
    cores reads them) and checks them."""
    from geoguessr_ai_torch.ops import window_attention as wa

    for name, value in port_knobs.items():
        if name not in wa.TILE_KNOBS:
            raise ValueError(f"{name} is no tile knob of the port")
        setattr(wa, name, value)
    wa.tile_knobs()


def _need_gpu():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this case needs a GPU: the kernels have no CPU "
                         "mode here")


def embed_run(save=None, ref=None, iters=EMBED_ITERS, images=EMBED_BATCH):
    """run_case's forward under the knobs set: returns its record (ms,
    img/s, panos/s over ``iters`` timed calls after one warm-up, and
    min_cosine when ``ref`` names a file of reference embeddings) and its
    first 8 embeddings, saved to ``save`` when given.  ``images``: the
    forward takes only the batch's first images (a reference of the first
    8 rows)."""
    import dataclasses

    import numpy as np
    import torch

    from geoguessr_ai_torch.models.super_guessr import init_parameters_
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
    from geoguessr_ai_torch.ops.quant import calibrate_act_stats

    _need_gpu()
    base = TinyViTConfig.tiny_vit_21m_512()
    model = TinyViT(dataclasses.replace(base, quant_mode="static",
                                        quant_sites=("fc1", "fc2")))
    init_parameters_(model, 0)
    host = {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    cal = TinyViT(dataclasses.replace(base, dtype=torch.float32,
                                      quant_mode="calibrate"))
    cal.load_state_dict(host, strict=True)
    cal.eval()

    def apply_calibrate(variables, xx):
        cal.act_stats = variables.get("act_stats", {})
        with torch.inference_mode():
            out = cal(xx)
        return out, {"act_stats": dict(cal.act_stats)}

    stats = calibrate_act_stats(apply_calibrate, {}, [torch.from_numpy(
        rng.normal(0, 1, (2, 512, 512, 3)).astype(np.float32))])
    del cal
    model.cast_weights_()
    model.to("cuda").eval()
    model.act_scales = {k: v.to("cuda") for k, v in stats.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((EMBED_BATCH, 512, 512, 3), generator=gen, device="cuda",
                    dtype=torch.bfloat16)[:images]
    with torch.inference_mode():
        t0 = time.time()
        model(x)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / max(iters, 1)
        emb = model(x)[:8].float().cpu().numpy()
    rec = dict(result="ok", B=images, first_call_s=round(first_s, 1),
               finite=bool(np.isfinite(emb).all()))
    if iters:
        rec.update(ms=round(dt * 1e3, 1), img_s=round(images / dt, 1),
                   panos_s=round(images / dt / 4, 1), iters=iters)
    del x, model
    torch.cuda.empty_cache()
    if save:
        os.makedirs(os.path.dirname(save), exist_ok=True)
        np.save(save, emb)
    if ref and os.path.exists(ref):
        want = np.load(ref)
        cos = (emb * want).sum(-1) / (np.linalg.norm(emb, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        rec["min_cosine"] = round(float(cos.min()), 6)
    return rec, emb


def train_run(iters=TRAIN_ITERS):
    """_train_case(16)'s step under the knobs set: its record (the first
    step's seconds and loss, ms and panos/s over ``iters`` timed
    steps)."""
    import numpy as np
    import torch

    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    _need_gpu()
    B = TRAIN_BATCH
    state, batch, centroids = fixture_train_setup(B, seed=0)
    rng = np.random.default_rng(0)
    pixels = batch["pixel_values"]
    batch["pixel_values"] = torch.from_numpy(
        rng.normal(0, 1, tuple(pixels.shape)).astype(np.float32)).to(
            pixels.device, pixels.dtype)
    batch["coords"] = torch.from_numpy(np.stack(
        [rng.uniform(-170, 170, B), rng.uniform(-60, 60, B)],
        axis=-1).astype(np.float32)).to(batch["coords"].device)
    t0 = time.time()
    _, metrics = train_step(state, batch, centroids)
    loss0 = float(metrics["loss"])
    first_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, metrics = train_step(state, batch, centroids)
    float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    return dict(result="ok", B=B, iters=iters, first_step_s=round(first_s, 1),
                ms=round(dt * 1e3, 1), panos_s=round(B / dt, 1),
                train_mfu_h100=round(B / dt * 4 * 3 * IMAGE_FLOPS
                                     / PEAK_BF16_FLOP_S, 4),
                loss=round(loss0, 3), finite=bool(np.isfinite(loss0)))


def knob_case(name, ref=None, iters=None):
    """One KNOB_CASES case: sets its port knobs and runs it (``iters``
    timed calls or steps, by default the JAX tool's); logs its record with
    ``port_knobs`` and ``no_counterpart``.  An embed case keeps its
    embeddings and writes the reference when none exists."""
    case = KNOB_CASES[name]
    set_knobs(case["port"])
    extra = {"port_knobs": case["port"],
             "no_counterpart": case["no_counterpart"]}
    if "note" in case:
        extra["note"] = case["note"]
    if case["run"] == "embed":
        ref = ref or REF_EMB
        rec, emb = embed_run(os.path.join(OUT_DIR, f"{name}_emb.npy"), ref,
                             EMBED_ITERS if iters is None else iters)
        if not os.path.exists(ref):
            import numpy as np

            np.save(ref, emb)
            extra["reference"] = "this case's embeddings"
    else:
        rec = train_run(TRAIN_ITERS if iters is None else iters)
    log(**rec, **extra)


CASES = {
    "probe_default": lambda: probe(None),
    "probe_v64": lambda: probe("optin"),
    **{name: (lambda name=name: knob_case(name)) for name in KNOB_CASES},
}


def main(argv=None):
    """Runs the named cases (all by default), each in a subprocess;
    returns the JSON records it printed.  ``--ref PATH``: the embed cases'
    min_cosine against the embeddings in PATH (else against the first
    embed case of the batch); ``--iters N``: N timed calls or steps."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ref = iters = None
    if "--ref" in argv:
        i = argv.index("--ref")
        ref = os.path.abspath(argv[i + 1])
        del argv[i:i + 2]
    if "--iters" in argv:
        i = argv.index("--iters")
        iters = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) > 1 and argv[0] == "--case":
        if argv[1] in KNOB_CASES:
            knob_case(argv[1], ref, iters)
        else:
            CASES[argv[1]]()
        return []
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a GPU")
    names = argv[0].split(",") if argv else list(CASES)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if ref is None and os.path.exists(REF_EMB):
        os.remove(REF_EMB)  # the batch's first embed case is the reference
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
             "--case", name, *(["--ref", ref] if ref else []),
             *(["--iters", str(iters)] if iters is not None else [])],
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

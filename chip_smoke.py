#!/usr/bin/env python3
"""Smoke test of the PyTorch port (geoguessr_ai_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit) and the versions;
2. build the CUDA kernels from ``geoguessr_ai_torch/ops/csrc`` and print
   the build seconds;
3. hold each kernel (K1, K2, K3) against its plain PyTorch version on the
   card, in bf16, at the shapes the serving path gives it at bucket 16,
   and time kernel, plain version, SDPA and the bound;
4. build the full-width ServingEngine (TinyViT-21M-512, 12647 cells,
   seeded random weights) on the card, serve the fixture panorama and 32
   concurrent MicroBatcher requests with every launch counter set to 0
   first, and check that each kernel ran; print latency and panos/s;
5. serve the fixture panorama through the same weights on the CPU in f32
   (the plain path) and compare embedding and top-1 cell;
6. hold the attention backward kernels (K4, K5) against their plain
   versions at the shapes a B=16 train step gives them, d_qkv and d_bias
   each, and time kernel, plain version, SDPA's backward and the bound;
7. for each autograd op (fused_block_attention, _noproj,
   window_attention_qkv) at its train shape: the input gradients through
   the kernels against autograd through the plain version;
8. ``train()`` at full width (TinyViT-21M-512 bf16 compute, f32 master
   weights, 12647 cells) for TRAIN_STEPS steps of TRAIN_BATCH fixture
   panoramas with every launch counter set to 0 first: finite losses and
   grad norms, each kernel's exact launches per step and per validation
   forward (an out-of-memory error fails the run); then train_step's p50
   on a fixed batch, panos/s and peak memory;
9. one train step of the same weights and batch (B=2) on the card in bf16
   and on the CPU in f32 and in bf16 (the plain path): loss, per-module
   gradient cosines and the updated BatchNorm running statistics;
10. hold the CLIP attention kernels (K6, K11) against their plain versions
    in bf16 at the shapes the CLIP ViT-L/14-336 serving path gives them at
    bucket 16 and at ViT-B/32's N=50, and time kernel, plain version,
    SDPA and the bound;
11. build the full-width CLIP ViT-L/14-336 ServingEngine (12647 cells,
    seeded random weights) on the card, serve the fixture panorama and 32
    concurrent MicroBatcher requests with every launch counter set to 0
    first: K6 exactly 24 launches per forward and no other kernel; print
    latency and panos/s; then the same weights with ``pallas_fuse_proj``:
    K11 exactly 24 per forward, its embedding against the K6 engine's;
12. serve the fixture panorama through the same CLIP weights on the CPU in
    f32 (the plain path) and compare embedding and top-1 cell;
13. hold the bulk-embedding kernels (K9, the 4D fused block; K10, the fused
    MBConv) against their plain versions in bf16 at the serving bucket-16
    shapes (64 images) and at the embed batch (512 images), and time
    kernel, plain version, the library yardstick (SDPA on K9's q, k, v; the
    cuDNN conv2d composition for K10) and the bound;
14. the bulk-embedding path: ``build_embedding_sqlite`` over a source
    SQLite of the four fixture JPEGs repeated to 1100 rows, through an
    ``Embedder`` in the embed configuration (TinyViT-21M-512 bf16, K1 at
    stages 1 and 3, ``fused_mbconv``, ``fused_block_4d``; seeded weights)
    with every launch counter set to 0 first: 1100 finite 576-wide rows,
    exact launches per B=512 forward (K10 2, K9 2, K1 2, K2 6, K3 0), the
    fixture images' embeddings against the CPU f32 forward of the same
    weights; then ``Embedder`` p50 at B=512, img/s, panos/s and peak memory
    with both knobs on and with both off;
15. serve the fixture panorama through a TinyViT engine with both knobs
    on (K10 2, K9 2, K2 6, K3 2, K1 0 launches a forward) against the
    default engine of phase 4, and its bucket-16 p50;
16. print the kernel JSON line, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import concurrent.futures as cf
import gc
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: Published H100 SXM peaks (NVIDIA data sheet), used for the bound.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
#: Kernel vs plain version, both bf16 on the card: max |k - p| over
#: max |p|.  Both round q/k/v and p to bf16 at different points (the kernel
#: also rounds unnormalised p and sums in another order), so a few bf16
#: ulps (2^-8 each) of the output's range.
KERNEL_REL_TOL = 2e-2
#: GPU bf16 engine vs CPU f32 engine on the fixture panorama.
MIN_COSINE = 0.999
#: An op's input gradients through the kernels vs autograd through its
#: plain version, both bf16 on the card: max |k - p| / max |p|.  The plain
#: backward rounds dp = g.v and the GEMM cotangents to bf16 where the
#: kernels keep f32, so a few bf16 ulps of the gradient's range.
GRAD_REL_TOL = 2e-2
#: One train step on the card in bf16 vs on the CPU (same weights, same
#: batch): relative loss difference to the f32 step; cosine of each
#: top-level module's flattened gradient; cosine of the updated running
#: statistics.  Each module's gradient on the card must reach
#: TRAIN_GRAD_MIN_COSINE against the plain path in bf16, and against the
#: f32 step either TRAIN_GRAD_MIN_COSINE or, where bf16 itself falls short
#: of it, the plain bf16 path's own cosine less TRAIN_GRAD_BF16_MARGIN:
#: upstream of stage 3 any bf16 step, kernels or none, drifts further from
#: f32 than 0.99 allows, and it drifts through the batch-statistics
#: BatchNorm (tests/test_torch_port_train.py
#: test_bf16_gradients_drift_from_f32_through_batch_statistics_bn).  The
#: JAX package's own bf16 train step drifts as far at TinyViT-21M's depth
#: (test_bf16_train_step_drifts_from_f32_as_the_jax_bf16_step_does).  The
#: plain bf16 path's cosines to f32 are printed beside the card's; PERF.md
#: has the numbers.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_MIN_COSINE = 0.99
TRAIN_GRAD_BF16_MARGIN = 0.01
TRAIN_STATS_MIN_COSINE = 0.999
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from geoguessr_ai_torch.ops import _build

    secs = _build.build()
    log(f"build_seconds {secs:.2f} ({len(_build.SIGNATURES)} kernels)")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

#: (kernel, label, W, N, C, H): the shapes the serving path gives each
#: kernel at bucket 16 (64 images); K1 also at the embed config's stage 3.
KERNEL_CASES = (
    ("K1", "stage1", 1024, 256, 192, 6),
    ("K1", "embed_stage3", 64, 256, 576, 18),
    ("K2", "stage2", 64, 1024, 384, 12),
    ("K3", "stage3", 64, 256, 576, 18),
)
KERNEL_META = {
    "K1": ("_fused_block_cuda", "geoguessr_ai_torch/ops/csrc/fused_block.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:1078"),
    "K2": ("_fb_s2_cuda", "geoguessr_ai_torch/ops/csrc/fb_s2.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:1485"),
    "K3": ("_attention_qkv_fused_cuda",
           "geoguessr_ai_torch/ops/csrc/attention_qkv.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:351"),
}


def _case_inputs(W, N, C, H, gen):
    """Inputs as the model hands them over: bf16 activations, bias and
    weights (the (in, out) weight a transposed view of the stored (out, in)
    one), f32 LayerNorm parameters and biases."""
    dev = "cuda"
    D = C
    bf = torch.bfloat16

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to(dev)

    return dict(
        x=randn(W, N, C).to(bf),
        ln_scale=randn(C, std=0.1, mean=1.0),
        ln_bias=randn(C, std=0.1),
        w_qkv=randn(3 * D, C, std=C ** -0.5).to(bf).t(),
        b_qkv=randn(3 * D, std=0.1),
        w_proj=randn(C, D, std=D ** -0.5).to(bf).t(),
        b_proj=randn(C, std=0.1),
        bias=randn(H, N, N, std=0.5).to(bf),
    )


def _bound_ms(kernel, W, N, C, H):
    D, hd = C, 32
    attn_flops = 4.0 * W * H * N * N * hd
    bias_bytes = H * N * N * 2
    x_bytes = W * N * C * 2
    if kernel == "K3":
        flops = attn_flops
        nbytes = W * N * 3 * D * 2 + bias_bytes + W * N * D * 2
    elif kernel == "K2":
        flops = 2.0 * W * N * C * 3 * D + attn_flops
        nbytes = x_bytes + C * 3 * D * 2 + bias_bytes + W * N * D * 2
    else:
        flops = 2.0 * W * N * C * 3 * D + attn_flops + 2.0 * W * N * D * C
        nbytes = (x_bytes + C * 3 * D * 2 + D * C * 2 + bias_bytes
                  + W * N * C * 2)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_ms(qkv, bias, scale, H):
    """One scaled_dot_product_attention call on the same qkv and bias (the
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    W, N, D3 = qkv.shape
    hd = D3 // (3 * H)
    parts = qkv.view(W, N, H, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = (parts[i].contiguous() for i in range(3))
    mask = bias.to(qkv.dtype)[None]
    return cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=scale))


def phase_kernels():
    from geoguessr_ai_torch.ops import window_attention as wa

    rows = {}
    gen = torch.Generator().manual_seed(SEED)
    for kernel, label, W, N, C, H in KERNEL_CASES:
        a = _case_inputs(W, N, C, H, gen)
        scale = (C // H) ** -0.5
        if kernel == "K3":
            qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"],
                                   a["w_qkv"], a["b_qkv"], 1e-5)
            args = (qkv, a["bias"], scale, H)
            kern, plain = wa._attention_qkv_fused_cuda, wa._attention_qkv_fused_plain
        elif kernel == "K2":
            args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                    a["b_qkv"], a["bias"], scale, H, 1e-5)
            kern, plain = wa._fb_s2_cuda, wa._fb_s2_plain
        else:
            args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                    a["b_qkv"], a["w_proj"], a["b_proj"], a["bias"], scale,
                    H, 1e-5)
            kern, plain = wa._fused_block_cuda, wa._fused_block_plain
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{kernel} {label}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        rel = max_abs / max(float(want.float().abs().max()), 1e-30)
        finite = bool(torch.isfinite(got).all())
        ms = cuda_time_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=3)
        qkv_in = args[0] if kernel == "K3" else wa._ln_qkv_plain(
            a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"], 1e-5)
        sdpa_ms = _sdpa_ms(qkv_in, a["bias"], scale, H)
        bound, bound_by = _bound_ms(kernel, W, N, C, H)
        ok = finite and rel <= KERNEL_REL_TOL
        log(f"{kernel} {label} W={W} N={N} C={C} H={H}")
        log(f"  max_abs_err {max_abs:.6g}")
        log(f"  max_rel_err {rel:.6g} (tolerance {KERNEL_REL_TOL})")
        log(f"  kernel_ms {ms:.4f}")
        log(f"  plain_ms {plain_ms:.4f}")
        log(f"  library_ms {sdpa_ms:.4f} (scaled_dot_product_attention on "
            f"the same qkv and bias)")
        log(f"  bound_ms {bound:.4f} ({bound_by})")
        if not ok:
            fail(f"{kernel} {label}: kernel disagrees with its plain version "
                 f"(rel {rel:.3g}, finite {finite})")
        rows[(kernel, label)] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
            bound_ms=bound, bound_by=bound_by)
        del a, args, got, want, qkv_in
        torch.cuda.empty_cache()
    wa.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the guess path on the card
# ---------------------------------------------------------------------------

#: Kernel launches one TinyViT-21M-512 forward makes: 2 stage-1 blocks
#: (K1), 6 stage-2 blocks (K2), 2 stage-3 blocks (K3).
LAUNCHES_PER_FORWARD = {"K1": 2, "K2": 6, "K3": 2}
NUM_REQUESTS = 32


def _fixture_views(engine):
    from geoguessr_ai_torch.data.pipeline import decode_jpeg

    paths = sorted(glob.glob(os.path.join(HERE, "tests", "fixtures",
                                          "heading=*.jpg")))
    if len(paths) != 4:
        fail(f"expected 4 fixture views, found {len(paths)}")
    views = []
    for p in paths:
        with open(p, "rb") as f:
            views.append(decode_jpeg(f.read(), engine.image_size))
    return paths, np.stack(views)


def _p50_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_serve():
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.engine import MicroBatcher, ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(seed=SEED)  # device None: the GPU
    log(f"engine_build_seconds {time.perf_counter() - t0:.2f} "
        f"(TinyViT-21M-512 bf16, {engine.table.num_cells} cells)")
    paths, views = _fixture_views(engine)
    batcher = MicroBatcher(engine)
    batcher.warmup()
    torch.cuda.synchronize()

    wa.reset_launches()
    result = engine.predict_images(paths)
    rng = np.random.default_rng(SEED)
    requests = [views[rng.permutation(4)] for _ in range(NUM_REQUESTS)]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(NUM_REQUESTS) as pool:
        served = list(pool.map(batcher.predict, requests))
    burst_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: wa.LAUNCHES[KERNEL_META[k][0]] for k in KERNEL_META}

    # predict_images, then one forward per MicroBatcher batch (warmup()
    # calls the engine directly and ran before the counters were reset)
    forwards = 1 + sum(batcher.batch_sizes.values())
    log(f"served fixture panorama: lat {result.lat:.6f} lon {result.lon:.6f} "
        f"top {result.top_ids}")
    log(f"served {len(served)} concurrent requests in {burst_s:.3f} s, "
        f"batches by bucket {batcher.batch_sizes}")
    for r in [result] + served:
        if not (np.isfinite(r.embedding).all() and np.isfinite(r.lat)
                and np.isfinite(r.lon) and np.isfinite(r.top_probs).all()):
            fail("non-finite output from the guess path")
        if r.embedding.shape != (4, engine.config.embed_dim):
            fail(f"embedding shape {r.embedding.shape}")
    for k, per in LAUNCHES_PER_FORWARD.items():
        log(f"launches {k} {launches[k]} over {forwards} forwards")
        if launches[k] < per * forwards:
            fail(f"{k} launched {launches[k]} times, expected at least "
                 f"{per} per forward x {forwards}")

    for bucket in (1, 16):
        batch = np.repeat(views[None], bucket, axis=0)
        p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=10)
        log(f"bucket {bucket}: p50 {p50:.2f} ms, {bucket / p50 * 1e3:.2f} "
            f"panos/s")
    return engine, paths, result, launches


# ---------------------------------------------------------------------------
# Phase 5: the same weights on the CPU in f32 (the plain path)
# ---------------------------------------------------------------------------


def _view_cosines(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def phase_cpu_reference(paths, gpu_result):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    cpu = ServingEngine(device="cpu", seed=SEED,
                        backbone_config=TinyViTConfig(dtype=torch.float32))
    ref = cpu.predict_images(paths)
    cos = _view_cosines(gpu_result.embedding, ref.embedding)
    log(f"cpu f32 vs gpu bf16: min view cosine {cos.min():.6f} "
        f"(>= {MIN_COSINE}), top-1 cell cpu {ref.top_ids[0]} "
        f"gpu {gpu_result.top_ids[0]}, lat/lon cpu {ref.lat:.4f},"
        f"{ref.lon:.4f} gpu {gpu_result.lat:.4f},{gpu_result.lon:.4f}")
    if cos.min() < MIN_COSINE:
        fail(f"embedding cosine {cos.min():.6f} < {MIN_COSINE}")
    if ref.top_ids[0] != gpu_result.top_ids[0]:
        fail("top-1 cell differs between the CPU and the GPU")


# ---------------------------------------------------------------------------
# Phase 6: the attention backward kernels against their plain versions
# ---------------------------------------------------------------------------

#: (kernel, label, W, N, H): the shapes a train step of TRAIN_BATCH
#: panoramas (64 images) gives K4 (stages 1 and 3) and K5 (stage 2); hd=32.
BWD_CASES = (
    ("K4", "stage1", 1024, 256, 6),
    ("K4", "stage3", 64, 256, 18),
    ("K5", "stage2", 64, 1024, 12),
)
BWD_META = {
    "K4": ("_attention_qkv_bwd_cuda",
           "geoguessr_ai_torch/ops/csrc/attention_qkv_bwd.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:560"),
    "K5": ("_attention_bwd_merged_cuda",
           "geoguessr_ai_torch/ops/csrc/attention_bwd_merged.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:1708"),
}


def _bwd_bound_ms(kernel, W, N, H):
    """Five N x N x hd products per (window, head): s, dp, dv, dq, dk.
    Bytes: qkv and g read once, the bias read once (bf16 into K4, f32 into
    K5), d_qkv (bf16) and d_bias (f32) written once."""
    hd = 32
    D = H * hd
    flops = 10.0 * W * H * N * N * hd
    nbytes = (2 * W * N * 3 * D * 2 + W * N * D * 2
              + H * N * N * (2 if kernel == "K4" else 4) + H * N * N * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_bwd_ms(qkv, bias, g, scale, H):
    """The backward of one scaled_dot_product_attention call on the same
    q, k, v and an (H, N, N) bias that requires grad, timed as
    forward+backward minus forward (the yardstick only; the port never
    calls it).  Returns (ms or None, what was timed or why not)."""
    import torch.nn.functional as F

    W, N, D3 = qkv.shape
    hd = D3 // (3 * H)
    parts = qkv.view(W, N, H, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = (parts[i].contiguous().requires_grad_() for i in range(3))
    b = bias.to(qkv.dtype).detach().requires_grad_()
    go = g.view(W, N, H, hd).transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=b[None],
                                              scale=scale)

    try:
        both = cuda_time_ms(lambda: torch.autograd.grad(fwd(), (q, k, v, b),
                                                        go), iters=5)
    except RuntimeError as e:
        return None, ("no SDPA backend takes a bias gradient here: "
                      + str(e).splitlines()[0][:160])
    return both - cuda_time_ms(fwd, iters=5), (
        "scaled_dot_product_attention forward+backward minus forward, bias "
        "requires grad")


def _rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def phase_backward_kernels():
    from geoguessr_ai_torch.ops import window_attention as wa

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    for kernel, label, W, N, H in BWD_CASES:
        D = H * 32
        scale = 32 ** -0.5
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        g = torch.randn(W, N, D, generator=gen).to("cuda", torch.bfloat16)
        name = BWD_META[kernel][0]
        kern = getattr(wa, name)
        plain = (wa._attention_qkv_bwd_plain if kernel == "K4"
                 else wa._attention_bwd_merged_plain)
        args = (qkv, bias, g, scale, H)
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        log(f"{kernel} {label} W={W} N={N} H={H} (bias {'bf16' if kernel == 'K4' else 'f32'})")
        errs = {}
        for out, a, b in (("d_qkv", got[0], want[0]), ("d_bias", got[1], want[1])):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"{kernel} {label} {out}: {tuple(a.shape)} {a.dtype} != "
                     f"{tuple(b.shape)} {b.dtype}")
            abs_err, rel = _rel_err(a, b)
            finite = bool(torch.isfinite(a).all())
            log(f"  {out} max_abs_err {abs_err:.6g} max_rel_err {rel:.6g} "
                f"(tolerance {KERNEL_REL_TOL}) finite {finite}")
            if not finite or rel > KERNEL_REL_TOL:
                fail(f"{kernel} {label}: {out} disagrees with the plain "
                     f"version (rel {rel:.3g}, finite {finite})")
            errs[out] = abs_err
        del got, want
        ms = cuda_time_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=3)
        lib_ms, lib_note = _sdpa_bwd_ms(qkv, bias, g, scale, H)
        bound, bound_by = _bwd_bound_ms(kernel, W, N, H)
        log(f"  kernel_ms {ms:.4f}")
        log(f"  plain_ms {plain_ms:.4f}")
        log(f"  library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"({lib_note})")
        log(f"  bound_ms {bound:.4f} ({bound_by})")
        rows[(kernel, label)] = dict(
            max_abs_err=errs["d_qkv"], max_abs_err_dbias=errs["d_bias"],
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library_note=lib_note, bound_ms=bound, bound_by=bound_by)
        del qkv, bias, g, args
        torch.cuda.empty_cache()
    wa.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# Phase 7: each autograd op's input gradients, kernels vs plain autograd
# ---------------------------------------------------------------------------

#: (op, W, N, C, H): each op at the shape of a TRAIN_BATCH train step; the
#: 4D block takes the same 1024 windows as 64 images of the 64x64 stage-1
#: map.
OP_CASES = (
    ("fused_block_attention", 1024, 256, 192, 6),
    ("fused_block_attention_noproj", 64, 1024, 384, 12),
    ("window_attention_qkv", 64, 256, 576, 18),
    ("fused_block_attention_4d", 1024, 256, 192, 6),
)
STAGE1_MAP, STAGE1_WINDOW = 64, 16


def _op_leaves(op, W, N, C, H, gen):
    """Inputs as a train step hands them to the op: bf16 activations, f32
    master weights stored (out, in), an f32 bias; each requires grad.
    Returns (names, leaves)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to("cuda")

    x = randn(W, N, C).to(torch.bfloat16)
    if op == "fused_block_attention_4d":
        x = x.reshape(-1, STAGE1_MAP, STAGE1_MAP, C)
    p = dict(ln_scale=randn(C, std=0.1, mean=1.0), ln_bias=randn(C, std=0.1),
             w_qkv=randn(3 * C, C, std=C ** -0.5), b_qkv=randn(3 * C, std=0.1),
             w_proj=randn(C, C, std=C ** -0.5), b_proj=randn(C, std=0.1),
             bias=randn(H, N, N, std=0.5))
    if op == "window_attention_qkv":
        leaves = {"qkv": wa._ln_qkv_plain(x, p["ln_scale"], p["ln_bias"],
                                          p["w_qkv"].t(), p["b_qkv"], 1e-5),
                  "bias": p["bias"]}
    else:
        keys = ["ln_scale", "ln_bias", "w_qkv", "b_qkv"]
        if op != "fused_block_attention_noproj":
            keys += ["w_proj", "b_proj"]
        leaves = {"x": x, **{k: p[k] for k in keys + ["bias"]}}
    return (list(leaves),
            [t.detach().requires_grad_() for t in leaves.values()])


def _op_call(fn, op, leaves, scale, H):
    """fn called as the model calls the op: (in, out) weights as transposed
    views of the stored (out, in) ones."""
    if op == "window_attention_qkv":
        return fn(*leaves, scale, H)
    x, ls, lb, wq, bq, *rest = leaves
    if op == "fused_block_attention_4d":
        wp, bp, bias = rest
        return fn(x, ls, lb, wq.t(), bq, wp.t(), bp, bias, scale, H,
                  STAGE1_WINDOW, 1e-5)
    if op == "fused_block_attention":
        wp, bp, bias = rest
        return fn(x, ls, lb, wq.t(), bq, wp.t(), bp, bias, scale, H, 1e-5)
    return fn(x, ls, lb, wq.t(), bq, rest[0], scale, H, 1e-5)


def phase_op_gradients():
    from geoguessr_ai_torch.ops import window_attention as wa

    plain = {"fused_block_attention": wa._fused_block_plain,
             "fused_block_attention_noproj": wa._fb_s2_plain,
             "window_attention_qkv": wa._attention_qkv_fused_plain,
             "fused_block_attention_4d": wa._fb4d_plain}
    gen = torch.Generator().manual_seed(SEED + 2)
    for op, W, N, C, H in OP_CASES:
        names, leaves = _op_leaves(op, W, N, C, H, gen)
        scale = (C // H) ** -0.5
        out = _op_call(getattr(wa, op), op, leaves, scale, H)
        if out.grad_fn is None:
            fail(f"{op}: a CUDA output of inputs that require grad has no "
                 "grad_fn")
        gout = torch.randn(out.shape, generator=gen).to("cuda", out.dtype)
        got = torch.autograd.grad(out, leaves, gout)
        want = torch.autograd.grad(_op_call(plain[op], op, leaves, scale, H),
                                   leaves, gout)
        torch.cuda.synchronize()
        log(f"op gradients {op} W={W} N={N} C={C} H={H} "
            f"(tolerance {GRAD_REL_TOL})")
        for name, a, b in zip(names, got, want):
            abs_err, rel = _rel_err(a, b)
            finite = bool(torch.isfinite(a).all())
            log(f"  d_{name} max_abs_err {abs_err:.6g} max_rel_err {rel:.6g}"
                f" finite {finite}")
            if a.shape != b.shape or not finite or rel > GRAD_REL_TOL:
                fail(f"{op}: gradient of {name} through the kernels "
                     f"disagrees with the plain path (rel {rel:.3g})")
        del leaves, out, got, want
        torch.cuda.empty_cache()
    wa.reset_launches()


# ---------------------------------------------------------------------------
# Phase 8: the train path at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16
TRAIN_STEPS = 6
#: Kernel launches of one train step: forward K1 at the 2 stage-1 blocks,
#: K2 at the 6 stage-2 blocks, K3 at the 2 stage-3 blocks and again in each
#: K1 backward (the attention recompute); K4 in the backward of stages 1
#: and 3, K5 in that of stage 2.  train() must launch exactly these per
#: step plus LAUNCHES_PER_FORWARD per validation forward.
LAUNCHES_PER_TRAIN_STEP = {"K1": 2, "K2": 6, "K3": 4, "K4": 4, "K5": 6}
ALL_META = {**KERNEL_META, **BWD_META}


def phase_train():
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import TrainConfig
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train.coordinator import train
    from geoguessr_ai_torch.train.fixtures import (
        fixture_records,
        fixture_train_setup,
    )
    from geoguessr_ai_torch.train.steps import train_step
    from geoguessr_ai_torch.utils.logging import MetricsLogger

    class Recorder(MetricsLogger):
        """Keeps every logged row with the host time it arrived (logging
        reads the device scalars, so a row marks the end of its step)."""

        def __init__(self):
            super().__init__()
            self.rows = []

        def log(self, metrics, step):
            self.rows.append((time.perf_counter(), step,
                              {k: float(v) for k, v in metrics.items()}))

    cfg = TrainConfig(batch_size=TRAIN_BATCH, log_every_steps=1, seed=SEED)
    records = fixture_records(TRAIN_BATCH * (TRAIN_STEPS + 1), seed=SEED)
    split = TRAIN_BATCH * TRAIN_STEPS
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    rec = Recorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launches()
    t0 = time.perf_counter()
    summary = train(cfg, records[:split], records[split:], table,
                    metrics_logger=rec, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: wa.LAUNCHES[m[0]] for k, m in ALL_META.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = [(t, m) for t, _, m in rec.rows if "train/loss" in m]
    log(f"train(): TinyViT-21M-512 bf16 compute, f32 master weights, "
        f"{table.num_cells} cells, batch {TRAIN_BATCH} panoramas, "
        f"{len(steps)} steps + validation in {wall_s:.2f} s")
    if len(steps) != TRAIN_STEPS:
        fail(f"train() logged {len(steps)} steps, expected {TRAIN_STEPS}")
    for i, (_, m) in enumerate(steps):
        log(f"  step {i + 1}: loss {m['train/loss']:.6f} grad_norm "
            f"{m['train/grad_norm']:.6f} param_norm {m['train/param_norm']:.4f}")
        if not (math.isfinite(m["train/loss"])
                and math.isfinite(m["train/grad_norm"])):
            fail(f"non-finite loss or grad_norm at train step {i + 1}")
    if not math.isfinite(summary.get("val_loss", float("nan"))):
        fail(f"validation gave no finite val_loss: {summary}")
    log(f"  val_loss {summary['val_loss']:.6f} val_top1 "
        f"{summary['val_top1']:.4f}")
    loop_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(steps, steps[1:])]
    log(f"  train() loop p50 {float(np.median(loop_ms)):.2f} ms per step "
        f"(host decode and upload included; steps 2-{TRAIN_STEPS})")
    log(f"  peak device memory {peak_gb:.3f} GB "
        f"(torch.cuda.max_memory_allocated)")
    # each validation run is one eval forward per full batch of records
    val_forwards = (sum("val_loss" in m for _, _, m in rec.rows)
                    * (len(records[split:]) // TRAIN_BATCH))
    for k, per in LAUNCHES_PER_TRAIN_STEP.items():
        want = (per * TRAIN_STEPS
                + LAUNCHES_PER_FORWARD.get(k, 0) * val_forwards)
        log(f"  launches {k} {launches[k]} over {TRAIN_STEPS} steps + "
            f"{val_forwards} validation forwards (expected {want}: {per} "
            f"per step)")
        if launches[k] != want:
            fail(f"{k} launched {launches[k]} times in train(), expected "
                 f"{per} per step x {TRAIN_STEPS} + "
                 f"{LAUNCHES_PER_FORWARD.get(k, 0)} per validation forward "
                 f"x {val_forwards} = {want}")
    del summary
    gc.collect()
    torch.cuda.empty_cache()

    # train_step alone on a fixed device batch: 1 warm-up, then timed
    state, batch, centroids = fixture_train_setup(TRAIN_BATCH, seed=SEED)
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, centroids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times[1:]))
    log(f"train_step p50 {p50:.2f} ms ({TRAIN_BATCH} panoramas, fixed device "
        f"batch, steps 2-{TRAIN_STEPS}: "
        f"{', '.join(f'{t:.2f}' for t in times[1:])}), "
        f"{TRAIN_BATCH / p50 * 1e3:.2f} panos/s")
    del state, batch, centroids
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: one train step on the card (bf16) against the CPU (f32, bf16)
# ---------------------------------------------------------------------------

CPU_TRAIN_BATCH = 2


def _top_module(name):
    parts = name.split(".")
    return parts[1] if parts[0] == "backbone" else parts[0]


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / max(float(a.norm() * b.norm()), 1e-300))


def _train_step_grads(device, dtype):
    """One train step of the fixture batch at CPU_TRAIN_BATCH: (loss, the
    gradients handed to the optimizer, the updated running statistics),
    all on the host in f32."""
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    state, batch, centroids = fixture_train_setup(
        CPU_TRAIN_BATCH, device=device, seed=SEED, dtype=dtype)
    grads = {}
    step = state.optimizer.step

    def capture(params, g):
        grads.update({n: t.detach().float().cpu() for n, t in g.items()})
        return step(params, g)

    state.optimizer.step = capture
    t0 = time.perf_counter()
    _, metrics = train_step(state, batch, centroids)
    loss = float(metrics["loss"])
    log(f"train step {device} {dtype}: batch {CPU_TRAIN_BATCH} panoramas, "
        f"loss {loss:.6f}, {time.perf_counter() - t0:.2f} s")
    stats = {n: b.detach().float().cpu()
             for n, b in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


def phase_train_vs_cpu():
    gl, gg, gs = _train_step_grads("cuda", "bfloat16")
    cl, cg, cs = _train_step_grads("cpu", "float32")
    bl, bg, bs = _train_step_grads("cpu", "bfloat16")
    rel = abs(gl - cl) / abs(cl)
    log(f"  loss gpu {gl:.6f} cpu f32 {cl:.6f} rel {rel:.3g} "
        f"(tolerance {TRAIN_LOSS_RTOL}); cpu bf16 {bl:.6f}")
    bad = [] if rel <= TRAIN_LOSS_RTOL else ["loss"]
    modules = sorted({_top_module(n) for n in cg})
    for mod in modules:
        names = [n for n in cg if _top_module(n) == mod]

        def flat(g):
            return torch.cat([g[n].flatten() for n in names])

        cos_plain = _cosine(flat(gg), flat(bg))
        cos = _cosine(flat(gg), flat(cg))
        cos_bf = _cosine(flat(bg), flat(cg))
        want = min(TRAIN_GRAD_MIN_COSINE, cos_bf - TRAIN_GRAD_BF16_MARGIN)
        log(f"  grad cosine {mod}: gpu vs cpu bf16 {cos_plain:.6f} "
            f"(>= {TRAIN_GRAD_MIN_COSINE}); gpu vs cpu f32 {cos:.6f} "
            f"(>= {want:.6f}); cpu bf16 vs cpu f32 {cos_bf:.6f}")
        if not (cos_plain >= TRAIN_GRAD_MIN_COSINE and cos >= want):
            bad.append(f"grad {mod}")
    for kind in ("running_mean", "running_var"):
        names = [n for n in cs if n.endswith(kind)]
        cos = _cosine(torch.cat([gs[n] for n in names]),
                      torch.cat([cs[n] for n in names]))
        worst = min(_cosine(gs[n], cs[n]) for n in names)
        log(f"  updated {kind} cosine {cos:.6f} over {len(names)} BatchNorms "
            f"(>= {TRAIN_STATS_MIN_COSINE}), lowest single layer {worst:.6f}")
        if not cos >= TRAIN_STATS_MIN_COSINE:
            bad.append(kind)
    if bad:
        fail(f"train step on the card disagrees with the CPU steps: {bad}")


# ---------------------------------------------------------------------------
# Phase 10: the CLIP attention kernels against their plain versions
# ---------------------------------------------------------------------------

#: (kernel, label, B, N, D, H): CLIP ViT-L/14-336 at serving bucket 16 (64
#: images) and ViT-B/32's N=50 (one partial tile); hd=64.
CLIP_CASES = (
    ("K6", "vit_l14_bucket16", 64, 577, 1024, 16),
    ("K6", "vit_b32", 64, 50, 768, 12),
    ("K11", "vit_l14_bucket16", 64, 577, 1024, 16),
    ("K11", "vit_b32", 64, 50, 768, 12),
)
CLIP_META = {
    "K6": ("_flash_cuda", "geoguessr_ai_torch/ops/csrc/clip_flash.cu",
           "geoguessr_ai_tpu/ops/clip_attention.py:134"),
    "K11": ("_flash_proj_cuda",
            "geoguessr_ai_torch/ops/csrc/clip_flash_proj.cu",
            "geoguessr_ai_tpu/ops/clip_attention.py:247"),
}


def _clip_bound_ms(kernel, B, N, D, H):
    """4 B H N^2 hd attention flops (+ 2 B N D^2 for K11's projection);
    bytes: qkv read once, the output written once (+ K11's weight)."""
    flops = 4.0 * B * H * N * N * (D // H)
    nbytes = B * N * 3 * D * 2 + B * N * D * 2
    if kernel == "K11":
        flops += 2.0 * B * N * D * D
        nbytes += D * D * 2
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_clip_kernels():
    import torch.nn.functional as F

    from geoguessr_ai_torch.ops import clip_attention as ca

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for kernel, label, B, N, D, H in CLIP_CASES:
        hd = D // H
        scale = hd ** -0.5
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to(
            "cuda", torch.bfloat16)
        if kernel == "K6":
            args = (qkv, scale, H)
            kern, plain = ca._flash_cuda, ca._flash_plain
        else:
            args = (qkv, w, scale, H)
            kern, plain = ca._flash_proj_cuda, ca._flash_proj_plain
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{kernel} {label}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        max_abs, rel = _rel_err(got, want)
        finite = bool(torch.isfinite(got).all())
        del got, want
        ms = cuda_time_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=3)
        # SDPA on the same q, k, v (head-major copies made outside the
        # timing); the yardstick only, the port never calls it
        q, k, v = (t.contiguous() for t in
                   qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4))
        sdpa_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        o = F.scaled_dot_product_attention(q, k, v, scale=scale).transpose(
            1, 2).reshape(B, N, D)
        sdpa_mm_ms = sdpa_ms + cuda_time_ms(lambda: o @ w)
        bound, bound_by = _clip_bound_ms(kernel, B, N, D, H)
        log(f"{kernel} {label} B={B} N={N} D={D} H={H} hd={hd}")
        log(f"  max_abs_err {max_abs:.6g}")
        log(f"  max_rel_err {rel:.6g} (tolerance {KERNEL_REL_TOL})")
        log(f"  kernel_ms {ms:.4f}")
        log(f"  plain_ms {plain_ms:.4f}")
        if kernel == "K6":
            log(f"  library_ms {sdpa_ms:.4f} (scaled_dot_product_attention "
                "on the same q, k, v)")
        else:
            log(f"  library_ms null [SDPA + matmul {sdpa_mm_ms:.4f}]")
        log(f"  bound_ms {bound:.4f} ({bound_by})")
        if not (finite and rel <= KERNEL_REL_TOL):
            fail(f"{kernel} {label}: kernel disagrees with its plain version "
                 f"(rel {rel:.3g}, finite {finite})")
        rows[(kernel, label)] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
            sdpa_mm_ms=sdpa_mm_ms, bound_ms=bound, bound_by=bound_by)
        del qkv, w, args, q, k, v, o
        torch.cuda.empty_cache()
    ca.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# Phase 11: the CLIP guess path on the card
# ---------------------------------------------------------------------------

#: Kernel launches of one CLIP ViT-L/14-336 forward: one per encoder layer.
CLIP_LAUNCHES_PER_FORWARD = 24


def _clip_serve_launches(engine, paths, views, burst):
    """Serves the fixture panorama (and with ``burst`` NUM_REQUESTS
    concurrent MicroBatcher requests) with every counter set to 0 first.
    Returns (fixture result, forwards, CLIP launches, TinyViT launches)."""
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.engine import MicroBatcher

    batcher = MicroBatcher(engine)
    if burst:
        batcher.warmup()
    torch.cuda.synchronize()
    ca.reset_launches()
    wa.reset_launches()
    result = engine.predict_images(paths)
    served = []
    if burst:
        rng = np.random.default_rng(SEED)
        requests = [views[rng.permutation(4)] for _ in range(NUM_REQUESTS)]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(NUM_REQUESTS) as pool:
            served = list(pool.map(batcher.predict, requests))
        log(f"served {len(served)} concurrent requests in "
            f"{time.perf_counter() - t0:.3f} s, batches by bucket "
            f"{batcher.batch_sizes}")
    torch.cuda.synchronize()
    for r in [result] + served:
        if not (np.isfinite(r.embedding).all() and np.isfinite(r.lat)
                and np.isfinite(r.lon) and np.isfinite(r.top_probs).all()):
            fail("non-finite output from the CLIP guess path")
        if r.embedding.shape != (4, engine.config.embed_dim):
            fail(f"CLIP embedding shape {r.embedding.shape}")
    forwards = 1 + sum(batcher.batch_sizes.values())
    return result, forwards, dict(ca.LAUNCHES), dict(wa.LAUNCHES)


def _check_clip_launches(label, forwards, clip, tinyvit, kernel):
    want = {name: 0 for name, _, _ in CLIP_META.values()}
    want[CLIP_META[kernel][0]] = CLIP_LAUNCHES_PER_FORWARD * forwards
    log(f"{label}: launches {clip} over {forwards} forwards (expected "
        f"{want}: {CLIP_LAUNCHES_PER_FORWARD} {kernel} per forward); "
        f"TinyViT kernels {sum(tinyvit.values())}")
    if clip != want:
        fail(f"{label}: CLIP kernel launches {clip}, expected {want}")
    if any(tinyvit.values()):
        fail(f"{label}: a TinyViT kernel ran on the CLIP path: {tinyvit}")


def phase_clip_serve():
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(backbone="clip", seed=SEED)  # the GPU
    log(f"engine_build_seconds {time.perf_counter() - t0:.2f} (CLIP "
        f"ViT-L/14-336 bf16, {engine.table.num_cells} cells)")
    paths, views = _fixture_views(engine)
    result, forwards, clip, tinyvit = _clip_serve_launches(
        engine, paths, views, burst=True)
    log(f"served fixture panorama (CLIP): lat {result.lat:.6f} lon "
        f"{result.lon:.6f} top {result.top_ids}")
    _check_clip_launches("CLIP K6 engine", forwards, clip, tinyvit, "K6")
    launches = {"K6": clip[CLIP_META["K6"][0]]}
    for bucket in (1, 16):
        batch = np.repeat(views[None], bucket, axis=0)
        p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=10)
        log(f"CLIP bucket {bucket}: p50 {p50:.2f} ms, "
            f"{bucket / p50 * 1e3:.2f} panos/s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    fused = ServingEngine(backbone="clip", seed=SEED,
                          backbone_config=CLIPVisionConfig.vit_l_14_336(
                              pallas_fuse_proj=True))
    fres, forwards, clip, tinyvit = _clip_serve_launches(
        fused, paths, views, burst=False)
    _check_clip_launches("CLIP K11 engine (pallas_fuse_proj)", forwards,
                         clip, tinyvit, "K11")
    launches["K11"] = clip[CLIP_META["K11"][0]]
    cos = _view_cosines(fres.embedding, result.embedding)
    log(f"CLIP K11 engine vs K6 engine: min view cosine {cos.min():.6f} "
        f"(>= {MIN_COSINE}), top-1 cell {fres.top_ids[0]} / "
        f"{result.top_ids[0]}")
    if cos.min() < MIN_COSINE or fres.top_ids[0] != result.top_ids[0]:
        fail("the pallas_fuse_proj engine disagrees with the K6 engine")
    batch = np.repeat(views[None], 16, axis=0)
    p50 = _p50_ms(lambda: fused.predict_batch(batch), reps=10)
    log(f"CLIP pallas_fuse_proj bucket 16: p50 {p50:.2f} ms, "
        f"{16 / p50 * 1e3:.2f} panos/s")
    del fused
    gc.collect()
    torch.cuda.empty_cache()
    return paths, result, launches


# ---------------------------------------------------------------------------
# Phase 12: the same CLIP weights on the CPU in f32 (the plain path)
# ---------------------------------------------------------------------------


def phase_clip_cpu_reference(paths, gpu_result):
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    cpu = ServingEngine(backbone="clip", device="cpu", seed=SEED,
                        backbone_config=CLIPVisionConfig.vit_l_14_336(
                            dtype=torch.float32))
    ref = cpu.predict_images(paths)
    cos = _view_cosines(gpu_result.embedding, ref.embedding)
    log(f"CLIP cpu f32 vs gpu bf16: min view cosine {cos.min():.6f} "
        f"(>= {MIN_COSINE}; views {', '.join(f'{c:.6f}' for c in cos)}), "
        f"top-1 cell cpu {ref.top_ids[0]} gpu {gpu_result.top_ids[0]}, "
        f"lat/lon cpu {ref.lat:.4f},{ref.lon:.4f} gpu {gpu_result.lat:.4f},"
        f"{gpu_result.lon:.4f} ({time.perf_counter() - t0:.1f} s)")
    if cos.min() < MIN_COSINE:
        fail(f"CLIP embedding cosine {cos.min():.6f} < {MIN_COSINE}")
    if ref.top_ids[0] != gpu_result.top_ids[0]:
        fail("CLIP top-1 cell differs between the CPU and the GPU")


# ---------------------------------------------------------------------------
# Phase 13: the bulk-embedding kernels against their plain versions
# ---------------------------------------------------------------------------

#: Images per batch: the serving bucket 16 (64 images) and the embed batch.
EMBED_KERNEL_IMAGES = (64, 512)
#: The plain versions run 64 images at a time (their f32 intermediates at
#: 512 images would not fit beside the kernels' buffers).
PLAIN_SLICE = 64
EMBED_META = {
    "K9": ("_fb4d_cuda", "geoguessr_ai_torch/ops/csrc/fb4d.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:1869"),
    "K10": ("_mbconv_cuda", "geoguessr_ai_torch/ops/csrc/mbconv.cu",
            "geoguessr_ai_tpu/ops/mbconv.py:164"),
}
#: Stage 0 of TinyViT-21M-512: a 128x128 map, C=96, E=384.
MB_MAP, MB_C, MB_E = 128, 96, 384


def _sliced(fn, args, images):
    """fn over the leading (image) axis of args[0] in PLAIN_SLICE slices."""
    return torch.cat([fn(args[0][i:i + PLAIN_SLICE], *args[1:])
                      for i in range(0, images, PLAIN_SLICE)])


def _mbconv_inputs(B, gen):
    """bf16 x, bf16 conv weights in the JAX layouts (transposed views of the
    stored OI ones, as the model passes them) and folded BN pairs."""
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to("cuda")

    def folded(n):
        return fold_bn(randn(n, std=0.1, mean=1.0), randn(n, std=0.1),
                       randn(n, std=0.1), randn(n, std=0.1, mean=1.0).abs())

    C, E = MB_C, MB_E
    bf = torch.bfloat16
    return (randn(B, MB_MAP, MB_MAP, C).to(bf),
            randn(E, C, std=C ** -0.5).to(bf).t(), *folded(E),
            randn(3, 3, E, std=1 / 3).to(bf), *folded(E),
            randn(C, E, std=E ** -0.5).to(bf).t(), *folded(C))


def _mbconv_bound_ms(B):
    """Two 1x1 GEMMs (2 C E flops a pixel each) and 9 depthwise MACs a
    pixel and expanded channel; bytes: x in, out, the weights once."""
    px = B * MB_MAP * MB_MAP
    flops = px * (4.0 * MB_C * MB_E + 18.0 * MB_E)
    nbytes = 2 * px * MB_C * 2 + 2 * MB_C * MB_E * 2 + 9 * MB_E * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _mbconv_cudnn_ms(args, exact=False):
    """The same function as one chain of cuDNN convolutions (1x1,
    depthwise 3x3, 1x1) with the folded BN and GELU between, in bf16
    channels-last: the yardstick only; the port never calls it."""
    import torch.nn.functional as F

    x, w1, s1, b1, w2, s2, b2, w3, s3, b3 = args
    bf = torch.bfloat16
    E = w1.shape[1]
    xc = x.permute(0, 3, 1, 2)
    k1 = w1.t().contiguous()[:, :, None, None]
    k2 = w2.permute(2, 0, 1).contiguous()[:, None]
    k3 = w3.t().contiguous()[:, :, None, None]
    sb = [t.to(bf)[None, :, None, None] for t in (s1, b1, s2, b2, s3, b3)]
    approx = "none" if exact else "tanh"

    def chain():
        h = F.gelu(F.conv2d(xc, k1) * sb[0] + sb[1], approximate=approx)
        h = F.gelu(F.conv2d(h, k2, padding=1, groups=E) * sb[2] + sb[3],
                   approximate=approx)
        return F.gelu(xc + F.conv2d(h, k3) * sb[4] + sb[5], approximate=approx)

    return cuda_time_ms(chain, iters=5)


def _embed_kernel_case(kernel, images, gen):
    """(kernel fn, plain fn, args, bound, bound_by, library ms, what the
    library call is) at ``images`` images."""
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    if kernel == "K10":
        args = _mbconv_inputs(images, gen)
        bound, bound_by = _mbconv_bound_ms(images)
        return (lambda *a: mbconv._mbconv_cuda(*a, False),
                lambda *a: mbconv._mbconv_plain(*a, False), args, bound,
                bound_by, _mbconv_cudnn_ms(args),
                "cuDNN conv2d 1x1, depthwise, 1x1 with folded BN and GELU")
    C, H, N = 192, 6, STAGE1_WINDOW ** 2
    W = images * (STAGE1_MAP // STAGE1_WINDOW) ** 2
    a = _case_inputs(W, N, C, H, gen)
    x4 = a["x"].reshape(images, STAGE1_MAP, STAGE1_MAP, C)
    scale = (C // H) ** -0.5
    args = (x4, a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
            a["w_proj"], a["b_proj"], a["bias"])
    bound, bound_by = _bound_ms("K1", W, N, C, H)
    qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                           a["b_qkv"], 1e-5)
    sdpa = _sdpa_ms(qkv, a["bias"], scale, H)
    del qkv
    tail = (scale, H, STAGE1_WINDOW, 1e-5)
    return (lambda *a: wa._fb4d_cuda(*a, *tail),
            lambda *a: wa._fb4d_plain(*a, *tail), args, bound, bound_by,
            sdpa, "scaled_dot_product_attention on its q, k, v and bias")


def phase_embed_kernels():
    rows = {}
    gen = torch.Generator().manual_seed(SEED + 4)
    for kernel in ("K10", "K9"):
        for images in EMBED_KERNEL_IMAGES:
            kern, plain, args, bound, bound_by, lib_ms, lib_what = \
                _embed_kernel_case(kernel, images, gen)
            got = kern(*args)
            torch.cuda.synchronize()
            want = _sliced(plain, args, images)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                fail(f"{kernel} {images} images: shape {tuple(got.shape)} != "
                     f"{tuple(want.shape)}")
            max_abs, rel = _rel_err(got, want)
            finite = bool(torch.isfinite(got).all())
            del got, want
            ms = cuda_time_ms(lambda: kern(*args))
            plain_ms = cuda_time_ms(lambda: _sliced(plain, args, images),
                                    iters=2)
            log(f"{kernel} {images} images, input {tuple(args[0].shape)}")
            log(f"  max_abs_err {max_abs:.6g}")
            log(f"  max_rel_err {rel:.6g} (tolerance {KERNEL_REL_TOL})")
            log(f"  kernel_ms {ms:.4f}")
            log(f"  plain_ms {plain_ms:.4f}")
            log(f"  library_ms null [{lib_what} {lib_ms:.4f}]")
            log(f"  bound_ms {bound:.4f} ({bound_by})")
            if not (finite and rel <= KERNEL_REL_TOL):
                fail(f"{kernel} {images} images: kernel disagrees with its "
                     f"plain version (rel {rel:.3g}, finite {finite})")
            rows[(kernel, images)] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                lib_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
            del args
            gc.collect()
            torch.cuda.empty_cache()
    _reset_all_launches()
    return rows


def _reset_all_launches():
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    for mod in (wa, mbconv, ca):
        mod.reset_launches()


def _tinyvit_launches():
    """K1-K5, K9 and K10 launches since the last reset, by kernel id."""
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    meta = {**ALL_META, "K9": EMBED_META["K9"]}
    out = {k: wa.LAUNCHES[m[0]] for k, m in meta.items()}
    out["K10"] = mbconv.LAUNCHES[EMBED_META["K10"][0]]
    return out


# ---------------------------------------------------------------------------
# Phase 14: the bulk-embedding path
# ---------------------------------------------------------------------------

EMBED_ROWS = 1100
EMBED_BATCH = 512
#: Launches of one B=512 forward of the embed configuration: K10 at the 2
#: stage-0 blocks, K9 at the 2 stage-1 blocks, K2 at the 6 stage-2 blocks,
#: K1 at the 2 stage-3 blocks; no other kernel.
EMBED_LAUNCHES_PER_FORWARD = {"K10": 2, "K9": 2, "K1": 2, "K2": 6, "K3": 0,
                              "K4": 0, "K5": 0}


def _embedder_p50(emb, images, label):
    """p50 of Embedder.__call__ on a fixed host batch (1 warm-up, 5 timed),
    and the peak device memory over those calls."""
    emb(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p50 = _p50_ms(lambda: emb(images), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = images.shape[0]
    log(f"Embedder {label}: B={n} p50 {p50:.2f} ms, {n / p50 * 1e3:.2f} img/s, "
        f"{n / p50 * 1e3 / 4:.2f} panos/s, peak device memory {peak_gb:.3f} GB")
    return p50, peak_gb


def phase_embed(paths):
    from geoguessr_ai_torch.config import BackboneConfig, EmbedBuildConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
        read_embeddings,
    )

    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    rng = np.random.default_rng(SEED)
    coords = rng.uniform((-60.0, -180.0), (70.0, 180.0),
                         (EMBED_ROWS // 4 + 1, 2))
    bb = BackboneConfig.tinyvit()
    emb = Embedder(bb, model_config=bulk_embed_config(), seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "raw.sqlite")
        out = os.path.join(tmp, "emb.sqlite")
        create_sqlite_from_records(src, (
            {"location_id": f"loc{i // 4:05d}", "lat": coords[i // 4, 0],
             "lon": coords[i // 4, 1], "heading": 90 * (i % 4),
             "image": blobs[i % 4]} for i in range(EMBED_ROWS)))
        telemetry = []
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        written = build_embedding_sqlite(
            src, out, EmbedBuildConfig(quant_mode="none"), embedder=emb,
            log_fn=telemetry.append, predecoded=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _tinyvit_launches()
        rows = read_embeddings(out)
    forwards = -(-EMBED_ROWS // EMBED_BATCH)
    log(f"build_embedding_sqlite: {written} rows written in {wall_s:.2f} s "
        f"(predecoded, batch {EMBED_BATCH}, {forwards} forwards; "
        f"ThroughputMeter {telemetry[-1]['throughput_img_per_s']:.2f} img/s "
        "with the decode of every row)")
    if written != EMBED_ROWS or len(rows) != EMBED_ROWS:
        fail(f"embed wrote {written} rows, read back {len(rows)}, expected "
             f"{EMBED_ROWS}")
    dims = {r.embedding_dim for r in rows}
    table = np.stack([r.embedding for r in rows])
    if dims != {576} or table.shape != (EMBED_ROWS, 576):
        fail(f"embedding dims {dims}, table {table.shape}")
    if not np.isfinite(table).all():
        fail("non-finite embedding written")
    for k, per in EMBED_LAUNCHES_PER_FORWARD.items():
        log(f"  launches {k} {launches[k]} over {forwards} forwards "
            f"(expected {per * forwards})")
        if launches[k] != per * forwards:
            fail(f"embed path: {k} launched {launches[k]} times, expected "
                 f"{per} per forward x {forwards}")

    # the four fixture images against the CPU f32 forward of the same weights
    views = np.stack([decode_jpeg(b, emb.image_size) for b in blobs])
    by_heading = {int(r.heading): r.embedding for r in rows
                  if r.location_id == "loc00000"}
    got = np.stack([by_heading[90 * i] for i in range(4)])
    t0 = time.perf_counter()
    cpu = Embedder(bb, device="cpu", seed=SEED,
                   model_config=bulk_embed_config(dtype=torch.float32))
    ref = cpu(views)
    cos = _view_cosines(got, ref)
    log(f"embed gpu bf16 vs cpu f32 on the fixture images: min cosine "
        f"{cos.min():.6f} (>= {MIN_COSINE}; {', '.join(f'{c:.6f}' for c in cos)})"
        f" ({time.perf_counter() - t0:.1f} s)")
    if cos.min() < MIN_COSINE:
        fail(f"embed cosine {cos.min():.6f} < {MIN_COSINE}")
    del cpu

    batch = views[np.arange(EMBED_BATCH) % 4]
    on = _embedder_p50(emb, batch, "embed config, fused_mbconv and "
                                   "fused_block_4d on")
    emb_on = emb(batch[:4])
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    off_emb = Embedder(bb, model_config=bulk_embed_config(False), seed=SEED)
    off = _embedder_p50(off_emb, batch, "embed config, both knobs off (K1 at "
                                        "stage 1, eager MBConv)")
    cos = _view_cosines(emb_on, off_emb(batch[:4]))
    log(f"  knobs on vs off: min cosine {cos.min():.6f}; p50 {on[0]:.2f} vs "
        f"{off[0]:.2f} ms ({off[0] / on[0]:.3f}x), peak {on[1]:.3f} vs "
        f"{off[1]:.3f} GB")
    del off_emb
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the guess path with both knobs
# ---------------------------------------------------------------------------

#: Launches of one serving forward (default stages) with both knobs on.
KNOB_SERVE_LAUNCHES = {"K10": 2, "K9": 2, "K2": 6, "K3": 2, "K1": 0}


def phase_knob_serve(paths, default_result):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    engine = ServingEngine(seed=SEED, backbone_config=TinyViTConfig(
        fused_mbconv=True, fused_block_4d=True))
    engine.predict_images(paths)  # warm-up, before the counters
    torch.cuda.synchronize()
    _reset_all_launches()
    result = engine.predict_images(paths)
    torch.cuda.synchronize()
    launches = _tinyvit_launches()
    cos = _view_cosines(result.embedding, default_result.embedding)
    log(f"knob engine (fused_mbconv, fused_block_4d) vs default engine: min "
        f"view cosine {cos.min():.6f} (>= {MIN_COSINE}), top-1 cell "
        f"{result.top_ids[0]} / {default_result.top_ids[0]}; launches "
        f"{ {k: launches[k] for k in KNOB_SERVE_LAUNCHES} }")
    if cos.min() < MIN_COSINE or result.top_ids[0] != default_result.top_ids[0]:
        fail("the knob engine disagrees with the default engine")
    for k, per in KNOB_SERVE_LAUNCHES.items():
        if launches[k] != per:
            fail(f"knob engine: {k} launched {launches[k]} times in one "
                 f"forward, expected {per}")
    _, views = _fixture_views(engine)
    batch = np.repeat(views[None], 16, axis=0)
    p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=10)
    log(f"knob engine bucket 16: p50 {p50:.2f} ms, {16 / p50 * 1e3:.2f} "
        f"panos/s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the kernels line
# ---------------------------------------------------------------------------


def main():
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    _, paths, result, serve_launches = phase_serve()
    phase_cpu_reference(paths, result)
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(phase_backward_kernels())
    phase_op_gradients()
    train_launches = phase_train()
    phase_train_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    clip_rows = phase_clip_kernels()
    clip_paths, clip_result, clip_launches = phase_clip_serve()
    phase_clip_cpu_reference(clip_paths, clip_result)
    gc.collect()
    torch.cuda.empty_cache()
    embed_rows = phase_embed_kernels()
    embed_launches = phase_embed(paths)
    knob_launches = phase_knob_serve(paths, result)

    main_case = {"K1": "stage1", "K2": "stage2", "K3": "stage3",
                 "K4": "stage1", "K5": "stage2"}
    kernels = []
    for k, (name, source, replaces) in ALL_META.items():
        row = rows[(k, main_case[k])]
        if k in BWD_META:
            # SDPA's backward computes K4's and K5's function
            library = row["library_ms"]
        else:
            # SDPA computes K3's function; K1/K2 add LN, GEMMs around it
            library = row["sdpa_ms"] if k == "K3" else None
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serve_launches.get(k, 0) + train_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": library,
        }
        if k in ("K1", "K2"):
            entry["sdpa_attention_ms"] = row["sdpa_ms"]
        if k in BWD_META:
            entry["max_abs_err_dbias"] = row["max_abs_err_dbias"]
        kernels.append(entry)
    for k, (name, source, replaces) in CLIP_META.items():
        row = clip_rows[(k, "vit_l14_bucket16")]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": clip_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # SDPA computes K6's function; K11 adds the out-projection
            "library_ms": row["sdpa_ms"] if k == "K6" else None,
            "vit_b32_ms": clip_rows[(k, "vit_b32")]["ms"],
        }
        if k == "K11":
            entry["sdpa_matmul_ms"] = row["sdpa_mm_ms"]
        kernels.append(entry)
    for k, (name, source, replaces) in EMBED_META.items():
        row = embed_rows[(k, EMBED_BATCH)]  # the embed batch: the main path
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": embed_launches[k] + knob_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # no one PyTorch call computes either function
            "library_ms": None,
            ("sdpa_attention_ms" if k == "K9" else "cudnn_chain_ms"):
                row["lib_ms"],
            "bucket16_ms": embed_rows[(k, 64)]["ms"],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

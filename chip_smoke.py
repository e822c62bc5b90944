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
   for K4 (bf16: the Hopper core) also its window groups, grids and the
   device time of each of its launches (torch.profiler), and K7's;
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
    SDPA and the bound (K6's bf16 entry is the Hopper kernel: TMA loads,
    wgmma products, warp-specialised, persistent);
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
16. hold the head-major attention kernels (K8a, K8b) against
    ``_attention_plain`` at the head-major serving shapes and the
    two-kernel backward (K7) at the B=16 train shape against its plain
    version and against K5 on the same inputs, K7's outputs bitwise equal
    over two calls; time kernel, plain version, SDPA (forward, or its
    backward for K7) and the bound; K7's window groups and grids;
17. with ``QKV_KERNEL_MIN_N`` raised, serve the head-major engine (every
    attention stage through ``window_attention``): exact launches of one
    forward at bucket 1 (K8b 2, K8a 8) and 16 (K8b 4, K8a 6), no other
    TinyViT kernel, against the default engine of phase 4, and its p50s;
    then phase 9's train step on the card against the CPU in the same
    configuration;
18. with ``BWD_MERGED`` False, ``train()`` at full width for 3 steps of 16
    panoramas: K7 exactly 6 launches a step, K5 none; one train step from
    the same seeded state and batch with K5 and with K7 (loss, the whole
    gradient's cosine and each stage-2 attention leaf's) and both
    train_step p50s;
19. one B=16 train step with remat off, "full" and "dots" from the same
    state and batch: loss, gradient cosine, running statistics moved once,
    peak device memory;
20. every TinyViT attention kernel (K1-K5, K7, K8a, K8b, K9) at head dims
    16 and 64 and CLIP's (K6, K11) at 16 and 32 against their plain
    versions; K4's and K5's d_bias and d_qkv bitwise equal over two calls
    at the B=16 train shapes;
21. the experimental kernels: K12a and K12b against their plain mirror at
    64 and 256 images of (128, 128, 96), E=384 (K12b bitwise equal to
    K12a; the cuDNN conv chain as the yardstick), K13 at the JAX tool's
    four shapes in int8 (exactly the plain product) and bf16, with TOPS,
    the bound and what sets it, the library call and the int8/bf16 rate
    ratios; then, with the counters at 0, the entry points that run them
    (``ops.experimental.fused_mbconv``'s benchmark and
    ``tools.exp_int8_gemm``);
22. the static-int8 embed path: ``Embedder(quant_mode="static")`` at
    B=512 (calibrated on the first batch): exact launches of one forward
    (K1 4, K2 6, no K3, K9, K10), cosine to the unquantized CPU f32 forward
    of the same weights (>= 0.99, the JAX gate) and to the port's static
    CPU forward with the same scales (>= 0.999, 8 images), p50 beside
    quant_mode "none", peak memory; then ``build_embedding_sqlite`` with
    the default ``EmbedBuildConfig()`` over the 1100 fixture rows;
23. the CLIP engine with ``quantize_gemms``: K6 exactly 24 launches a
    forward, cosine >= 0.99 to the K6 engine of phase 11, bucket-16 p50;
24. the f32 compute dtype (``BackboneConfig(dtype="float32")``): every
    f32 entry of K1-K11 against its plain f32 version at the shapes of
    phases 3, 6, 10, 13 and 16 (max |err| / max |ref| <= 1e-3, which bf16
    operands would not meet), timed beside the f32 library call and the f32
    bound (4 bytes an element at 3.35 TB/s, products at the 495 TFLOP/s
    TF32 peak);
25. the f32 engines at bucket 16 (TinyViT default, head-major and with
    both knobs; CLIP-L with K6 and with K11) and the f32 ``Embedder`` of
    ``bulk_embed_config()`` at 64 images: exact launches of one forward,
    every panorama's views at cosine >= 0.9999 to the CPU f32 engine of
    phase 5 or 12 (or the CPU f32 embed forward of phase 14), the same
    top-1 cell, p50;
26. phase 9's B=2 train step in f32 on the card, with K5 and with K7,
    against the CPU f32 step: loss within 1e-4, every gradient leaf and the
    running statistics at cosine >= 0.9999, exact launches;
27. K14: the port's ``tools.exp_r4_vmem`` runs ``probe_default`` (must
    crash: no shared-memory opt-in) and ``probe_v64`` (must print s = 21.0
    after one launch) in subprocesses; then the kernel against its plain
    version, timed beside ``torch.mul`` and its 2.50 us bound;
28. print the kernel JSON line, then ``{"ok": true, "device": ...}`` last.

Times: ``kernel_ms`` times a kernel or a library call by 10 (or 50)
launches between two CUDA events; where that reads under SHORT_MS (0.5
ms; under about 0.3 ms it reads the rate at which the host enqueues the
calls), it re-times the call as device time (``device_time_ms``: 20
launches in one CUDA graph, replayed 5 times between two events).  Phases
3, 10, 16 and 27 time their kernels and library calls so; the plain
versions and the other phases keep the event loop.
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
PEAK_TF32_FLOP_S = 495e12
PEAK_F32_FLOP_S = 67e12
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


#: Below about 0.3 ms a loop of launches between two events reads the
#: rate at which the host enqueues them, not the card: kernel_ms re-times
#: a call under this many ms as device time (0.5, so that a kernel near
#: 0.3 ms and its library call are read by the same clock).
SHORT_MS = 0.5


def device_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call: iters calls captured in one CUDA
    graph (after a warm-up on a side stream), the graph replayed reps
    times between two events, so no host work falls inside the timed
    window.  Each call allocates its outputs from the graph's pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def kernel_ms(fn, iters: int = 10) -> float:
    """A kernel's or library call's time: cuda_time_ms, or for a call
    under SHORT_MS by that reading, its device_time_ms."""
    ms = cuda_time_ms(fn, iters)
    return device_time_ms(fn) if ms < SHORT_MS else ms


def _bound(flops, nbytes, peak=PEAK_BF16_FLOP_S):
    """(the least time in ms for ``flops`` operations at ``peak`` (bf16 by
    default) and ``nbytes`` bytes at the card's published peaks, which of
    the two bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _peak(elem):
    """The tensor-core peak of a call whose operands take ``elem`` bytes:
    bf16, or TF32 for f32 (the card's f32 tensor-core rate)."""
    return PEAK_BF16_FLOP_S if elem == 2 else PEAK_TF32_FLOP_S


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


def _case_inputs(W, N, C, H, gen, dtype=torch.bfloat16):
    """Inputs as the model hands them over: activations, bias and weights
    in the compute dtype (the (in, out) weight a transposed view of the
    stored (out, in) one), f32 LayerNorm parameters and biases."""
    dev = "cuda"
    D = C
    bf = dtype

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


def _bound_ms(kernel, W, N, C, H, elem=2):
    """K1-K3 (and K9 as K1): ``elem`` bytes an activation, weight and bias
    element; an f32 call's products against the TF32 peak."""
    D, hd, e = C, 32, elem
    attn_flops = 4.0 * W * H * N * N * hd
    bias_bytes = H * N * N * e
    x_bytes = W * N * C * e
    if kernel == "K3":
        flops = attn_flops
        nbytes = W * N * 3 * D * e + bias_bytes + W * N * D * e
    elif kernel == "K2":
        flops = 2.0 * W * N * C * 3 * D + attn_flops
        nbytes = x_bytes + C * 3 * D * e + bias_bytes + W * N * D * e
    else:
        flops = 2.0 * W * N * C * 3 * D + attn_flops + 2.0 * W * N * D * C
        nbytes = (x_bytes + C * 3 * D * e + D * C * e + bias_bytes
                  + W * N * C * e)
    return _bound(flops, nbytes, _peak(elem))


def _sdpa_ms(qkv, bias, scale, H):
    """One scaled_dot_product_attention call on the same qkv and bias (the
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    W, N, D3 = qkv.shape
    hd = D3 // (3 * H)
    parts = qkv.view(W, N, H, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = (parts[i].contiguous() for i in range(3))
    mask = bias.to(qkv.dtype)[None]
    return kernel_ms(
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
        ms = kernel_ms(lambda: kern(*args))
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
    return ref


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


def _bwd_bound_ms(kernel, W, N, H, elem=2):
    """Five N x N x hd products per (window, head): s, dp, dv, dq, dk.
    Bytes: qkv and g read once, the bias read once (in the activations'
    ``elem`` bytes into K4, f32 into K5 and K7), d_qkv and d_bias (f32)
    written once.  K7 computes K5's function, so it has K5's bound: the
    products its d_bias launch computes again are its design's, not work
    the function needs."""
    hd = 32
    D = H * hd
    flops = 10.0 * W * H * N * N * hd
    nbytes = (2 * W * N * 3 * D * elem + W * N * D * elem
              + H * N * N * (elem if kernel == "K4" else 4) + H * N * N * 4)
    return _bound(flops, nbytes, _peak(elem))


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


def _bwd_plan(kernel, W, N, H, dtype=torch.bfloat16):
    """What one K4 or K7 call launches at (W, N, H), as a log line: in
    bf16 the Hopper core's window groups G (``_bwd_groups``), the items of
    each of its persistent launches and their grid (one block of 384
    threads an SM at most); in f32 the first design's grids, which the
    twins keep."""
    from geoguessr_ai_torch.ops import window_attention as wa

    Np = -(-N // 64) * 64
    if dtype == torch.bfloat16:
        G = wa._bwd_groups(W, Np, H)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        items = wa._bwd_items(W, Np, H, G)
        grid = {k: min(n, sms) for k, n in items.items()}
        return (f"bf16 core: G={G} window groups; items {items}; grid "
                f"{grid} x 384 threads" + (" + the sum of the G partials"
                                           if G > 1 else ""))
    rows = f"({Np // 64}, {H}, {W})"
    dbias = f"({Np // 64}, {Np // 64}, {H})"
    if kernel == "K7":
        return (f"f32 twin: grids ({H}, {W}) and {dbias} x 128 threads, "
                f"d_bias over all {W} windows in one block a tile")
    return (f"f32 twin: grids {rows} x 3 and {dbias} x 128 threads, d_bias "
            f"over all {W} windows in one block a tile")


#: The launches of K4's and K7's bf16 core by kernel name.
_BWD_LAUNCH_NAMES = ("stats", "dkdv", "dq", "dbias")


def _launch_ms(fn, calls=3):
    """Device ms a call of each kernel that fn() launches, read from a
    torch.profiler trace of ``calls`` calls after a warm-up (its device
    events, as profile_forward reads them): the bf16 core's launches by
    role (``attn_bwd_sm90<HD, MODE, ...>``), the sum of the d_bias
    partials, and any other kernel by its name.  None when the trace
    holds no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = evt.name
        if "attn_bwd_sm90<" in key:
            key = _BWD_LAUNCH_NAMES[int(key.split("<")[1].split(",")[1])]
        elif "dbias_reduce" in key:
            key = "dbias_sum"
        else:
            key = key.split("(")[0].split("<")[0].replace("void ", "")
        out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / calls / 1e3
    return out or None


def _log_launch_ms(launch_ms):
    log("  launch_ms (device, torch.profiler) " + (
        ", ".join(f"{k} {v:.4f}" for k, v in launch_ms.items())
        if launch_ms else "not measured (the trace holds no device kernels)"))


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
        if kernel == "K4":
            log(f"  {_bwd_plan(kernel, W, N, H)}")
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
        launch_ms = _launch_ms(lambda: kern(*args))
        _log_launch_ms(launch_ms)
        rows[(kernel, label)] = dict(
            max_abs_err=errs["d_qkv"], max_abs_err_dbias=errs["d_bias"],
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library_note=lib_note, bound_ms=bound, bound_by=bound_by,
            launch_ms=launch_ms)
        del qkv, bias, g, args
        torch.cuda.empty_cache()
    # K7's launches at its train shape (phase 16 holds K7 itself): read
    # here, where the traces have come back whole; in phase 16 one came
    # back short of the event timer's total
    W, N, H = K7_CASE
    qkv = torch.randn(W, N, 3 * H * 32, generator=gen).to("cuda",
                                                          torch.bfloat16)
    bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
    g = torch.randn(W, N, H * 32, generator=gen).to("cuda", torch.bfloat16)
    log(f"K7 stage2 W={W} N={N} H={H}: its launches")
    rows[("K7", "launch_ms")] = _launch_ms(
        lambda: wa._attention_bwd_qtiled_cuda(qkv, bias, g, 32 ** -0.5, H))
    _log_launch_ms(rows[("K7", "launch_ms")])
    del qkv, bias, g
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


def _train_step_grads(device, dtype, fields=None):
    """One train step of the fixture batch at CPU_TRAIN_BATCH: (loss, the
    gradients handed to the optimizer, the updated running statistics),
    all on the host in f32.  ``fields`` are TinyViTConfig fields over
    TinyViT-21M-512's."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    config = None if fields is None else TinyViTConfig(
        dtype=getattr(torch, dtype), **fields)
    state, batch, centroids = fixture_train_setup(
        CPU_TRAIN_BATCH, device=device, seed=SEED, dtype=dtype,
        model_config=config)
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


def phase_train_vs_cpu(fields=None):
    gl, gg, gs = _train_step_grads("cuda", "bfloat16", fields)
    cl, cg, cs = _train_step_grads("cpu", "float32", fields)
    bl, bg, bs = _train_step_grads("cpu", "bfloat16", fields)
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
    return cl, cg, cs


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


def _clip_bound_ms(kernel, B, N, D, H, elem=2):
    """4 B H N^2 hd attention flops (+ 2 B N D^2 for K11's projection);
    bytes: qkv read once, the output written once (+ K11's weight)."""
    flops = 4.0 * B * H * N * N * (D // H)
    nbytes = B * N * 3 * D * elem + B * N * D * elem
    if kernel == "K11":
        flops += 2.0 * B * N * D * D
        nbytes += D * D * elem
    return _bound(flops, nbytes, _peak(elem))


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
        ms = kernel_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=3)
        # SDPA on the same q, k, v (head-major copies made outside the
        # timing); the yardstick only, the port never calls it
        q, k, v = (t.contiguous() for t in
                   qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4))
        sdpa_ms = kernel_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        o = F.scaled_dot_product_attention(q, k, v, scale=scale).transpose(
            1, 2).reshape(B, N, D)
        sdpa_mm_ms = sdpa_ms + kernel_ms(lambda: o @ w)
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
    return ref


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


def _mbconv_inputs(B, gen, dtype=torch.bfloat16):
    """x and conv weights in the compute dtype, in the JAX layouts
    (transposed views of the stored OI ones, as the model passes them) and
    folded BN pairs."""
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to("cuda")

    def folded(n):
        return fold_bn(randn(n, std=0.1, mean=1.0), randn(n, std=0.1),
                       randn(n, std=0.1), randn(n, std=0.1, mean=1.0).abs())

    C, E = MB_C, MB_E
    bf = dtype
    return (randn(B, MB_MAP, MB_MAP, C).to(bf),
            randn(E, C, std=C ** -0.5).to(bf).t(), *folded(E),
            randn(3, 3, E, std=1 / 3).to(bf), *folded(E),
            randn(C, E, std=E ** -0.5).to(bf).t(), *folded(C))


def _mbconv_bound_ms(B, elem=2):
    """Two 1x1 GEMMs (2 C E flops a pixel each) and 9 depthwise MACs a
    pixel and expanded channel; bytes: x in, out, the weights once."""
    px = B * MB_MAP * MB_MAP
    flops = px * (4.0 * MB_C * MB_E + 18.0 * MB_E)
    nbytes = 2 * px * MB_C * elem + 2 * MB_C * MB_E * elem + 9 * MB_E * 4
    return _bound(flops, nbytes, _peak(elem))


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


def _embed_kernel_case(kernel, images, gen, dtype=torch.bfloat16):
    """(kernel fn, plain fn, args, bound, bound_by, library ms, what the
    library call is) at ``images`` images, in ``dtype``."""
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    elem = torch.finfo(dtype).bits // 8
    if kernel == "K10":
        args = _mbconv_inputs(images, gen, dtype)
        bound, bound_by = _mbconv_bound_ms(images, elem)
        return (lambda *a: mbconv._mbconv_cuda(*a, False),
                lambda *a: mbconv._mbconv_plain(*a, False), args, bound,
                bound_by, _mbconv_cudnn_ms(args),
                "cuDNN conv2d 1x1, depthwise, 1x1 with folded BN and GELU")
    C, H, N = 192, 6, STAGE1_WINDOW ** 2
    W = images * (STAGE1_MAP // STAGE1_WINDOW) ** 2
    a = _case_inputs(W, N, C, H, gen, dtype)
    x4 = a["x"].reshape(images, STAGE1_MAP, STAGE1_MAP, C)
    scale = (C // H) ** -0.5
    args = (x4, a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
            a["w_proj"], a["b_proj"], a["bias"])
    bound, bound_by = _bound_ms("K1", W, N, C, H, elem)
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
    embed_ref = ref

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
    return launches, embed_ref


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
# Phase 16: the head-major attention kernels (K8a, K8b) and the two-kernel
# large-N backward (K7) against their plain versions
# ---------------------------------------------------------------------------

#: (kernel, label, W, H, N): the shapes the head-major serving path gives
#: K8b (stage 1 and stage 3 at bucket 16) and K8a (stage 2 at bucket 16,
#: stage 3 at bucket 1: W=4 is no multiple of BLOCK_W).
HEADMAJOR_CASES = (
    ("K8b", "stage1_bucket16", 1024, 6, 256),
    ("K8b", "stage3_bucket16", 64, 18, 256),
    ("K8a", "stage2_bucket16", 64, 12, 1024),
    ("K8a", "stage3_bucket1", 4, 18, 256),
)
HEADMAJOR_META = {
    "K8a": ("_attention_qtiled_cuda",
            "geoguessr_ai_torch/ops/csrc/attention_headmajor.cu",
            "geoguessr_ai_tpu/ops/window_attention.py:97"),
    "K8b": ("_attention_batched_cuda",
            "geoguessr_ai_torch/ops/csrc/attention_headmajor.cu",
            "geoguessr_ai_tpu/ops/window_attention.py:165"),
}
K7_META = ("_attention_bwd_qtiled_cuda",
           "geoguessr_ai_torch/ops/csrc/attention_bwd_qtiled.cu",
           "geoguessr_ai_tpu/ops/window_attention.py:694")
#: K7 at stage 2 of a TRAIN_BATCH train step.
K7_CASE = (64, 1024, 12)


def _headmajor_bound_ms(W, H, N, elem=2):
    """Two N x N x 32 products per (window, head); q, k, v read and the
    output written once (``elem`` bytes an element), the f32 bias read
    once."""
    return _bound(4.0 * W * H * N * N * 32,
                  4 * W * H * N * 32 * elem + H * N * N * 4, _peak(elem))


def _headmajor_sdpa_ms(q, k, v, bias, scale):
    """One scaled_dot_product_attention call on the same q, k, v with the
    f32 bias as a float mask (the yardstick only; the port never calls
    it).  Returns (ms, what was timed)."""
    import torch.nn.functional as F

    for mask, what in ((bias[None], "f32 bias as a float mask"),
                       (bias.to(q.dtype)[None], "bias cast to bf16 (no "
                        "SDPA backend takes an f32 mask with bf16 q)")):
        try:
            return kernel_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale)), what
        except RuntimeError:
            continue
    return None, "no SDPA backend takes this mask"


def phase_headmajor_kernels():
    from geoguessr_ai_torch.ops import window_attention as wa

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 5)
    scale = 32 ** -0.5
    for kernel, label, W, H, N in HEADMAJOR_CASES:
        q, k, v = (torch.randn(W, H, N, 32, generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        kern = getattr(wa, HEADMAJOR_META[kernel][0])
        args = (q, k, v, bias, scale)
        got = kern(*args)
        torch.cuda.synchronize()
        want = wa._attention_plain(*args)
        max_abs, rel = _rel_err(got, want)
        finite = bool(torch.isfinite(got).all())
        del got, want
        ms = kernel_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: wa._attention_plain(*args), iters=3)
        lib_ms, lib_what = _headmajor_sdpa_ms(*args)
        bound, bound_by = _headmajor_bound_ms(W, H, N)
        log(f"{kernel} {label} W={W} H={H} N={N} (f32 bias)")
        log(f"  max_abs_err {max_abs:.6g}")
        log(f"  max_rel_err {rel:.6g} (tolerance {KERNEL_REL_TOL})")
        log(f"  kernel_ms {ms:.4f}")
        log(f"  plain_ms {plain_ms:.4f}")
        log(f"  library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"(scaled_dot_product_attention, {lib_what})")
        log(f"  bound_ms {bound:.4f} ({bound_by})")
        if not (finite and rel <= KERNEL_REL_TOL):
            fail(f"{kernel} {label}: kernel disagrees with its plain version "
                 f"(rel {rel:.3g}, finite {finite})")
        rows[(kernel, label)] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=bound_by)
        del q, k, v, bias, args
        torch.cuda.empty_cache()

    W, N, H = K7_CASE
    D = H * 32
    qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
    bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
    g = torch.randn(W, N, D, generator=gen).to("cuda", torch.bfloat16)
    args = (qkv, bias, g, scale, H)
    got = wa._attention_bwd_qtiled_cuda(*args)
    again = wa._attention_bwd_qtiled_cuda(*args)
    torch.cuda.synchronize()
    log(f"K7 stage2 W={W} N={N} H={H} (f32 bias; the d_qkv side and the "
        f"d_bias side as separate launches)")
    log(f"  {_bwd_plan('K7', W, N, H)}")
    stable = torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])
    log(f"  d_bias and d_qkv bitwise equal over two calls: {stable}")
    if not stable:
        fail("K7: two calls on the same inputs gave different bits")
    del again
    errs = {}
    for ref_name, ref in (("plain", wa._attention_bwd_qtiled_plain),
                          ("K5", wa._attention_bwd_merged_cuda)):
        want = ref(*args)
        torch.cuda.synchronize()
        for out, a, b in (("d_qkv", got[0], want[0]),
                          ("d_bias", got[1], want[1])):
            abs_err, rel = _rel_err(a, b)
            finite = bool(torch.isfinite(a).all())
            log(f"  {out} vs {ref_name} max_abs_err {abs_err:.6g} "
                f"max_rel_err {rel:.6g} (tolerance {KERNEL_REL_TOL})")
            if a.shape != b.shape or a.dtype != b.dtype or not finite \
                    or rel > KERNEL_REL_TOL:
                fail(f"K7: {out} disagrees with {ref_name} (rel {rel:.3g}, "
                     f"finite {finite})")
            errs.setdefault(out, abs_err)
        del want
    del got
    ms = cuda_time_ms(lambda: wa._attention_bwd_qtiled_cuda(*args))
    k5_ms = cuda_time_ms(lambda: wa._attention_bwd_merged_cuda(*args))
    plain_ms = cuda_time_ms(lambda: wa._attention_bwd_qtiled_plain(*args),
                            iters=3)
    lib_ms, lib_note = _sdpa_bwd_ms(qkv, bias, g, scale, H)
    bound, bound_by = _bwd_bound_ms("K7", W, N, H)
    log(f"  kernel_ms {ms:.4f} (K5 on the same inputs {k5_ms:.4f})")
    log(f"  plain_ms {plain_ms:.4f}")
    log(f"  library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'} "
        f"({lib_note})")
    log(f"  bound_ms {bound:.4f} ({bound_by})")
    rows[("K7", "stage2")] = dict(
        max_abs_err=errs["d_qkv"], max_abs_err_dbias=errs["d_bias"], ms=ms,
        k5_ms=k5_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
        bound_by=bound_by)
    del qkv, bias, g, args
    torch.cuda.empty_cache()
    _reset_all_launches()
    return rows


# ---------------------------------------------------------------------------
# Phase 17: the head-major guess path
# ---------------------------------------------------------------------------

#: Launches of one head-major forward (QKV_KERNEL_MIN_N raised): stage 1
#: (W = 16 windows an image) and stage 3 (one window an image) take K8b
#: when W is a multiple of BLOCK_W, stage 2 (N=1024) K8a.
HEADMAJOR_LAUNCHES = {
    1: {"K8b": 2, "K8a": 8},   # 4 images: stage 3's W=4 takes K8a
    16: {"K8b": 4, "K8a": 6},  # 64 images
}


def _headmajor_launches():
    from geoguessr_ai_torch.ops import window_attention as wa

    out = {k: wa.LAUNCHES[m[0]] for k, m in HEADMAJOR_META.items()}
    out.update(_tinyvit_launches())
    return out


def phase_headmajor_serve(paths, default_result):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.profile_forward import HEAD_MAJOR, HEAD_MAJOR_MIN_N
    from geoguessr_ai_torch.serving.engine import ServingEngine

    saved = wa.QKV_KERNEL_MIN_N
    wa.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N
    try:
        engine = ServingEngine(seed=SEED,
                               backbone_config=TinyViTConfig(**HEAD_MAJOR))
        _, views = _fixture_views(engine)
        result = engine.predict_images(paths)  # warm-up, before the counters
        torch.cuda.synchronize()
        total = dict.fromkeys(HEADMAJOR_META, 0)
        for bucket, want in HEADMAJOR_LAUNCHES.items():
            batch = np.repeat(views[None], bucket, axis=0)
            engine.predict_batch(batch)  # this bucket's warm-up
            torch.cuda.synchronize()
            _reset_all_launches()
            engine.predict_batch(batch)
            torch.cuda.synchronize()
            launches = _headmajor_launches()
            want = {k: want.get(k, 0) for k in launches}
            log(f"head-major engine bucket {bucket}: launches in one forward "
                f"{launches} (expected {want})")
            if launches != want:
                fail(f"head-major engine bucket {bucket}: launches "
                     f"{launches}, expected {want}")
            for k in total:
                total[k] += launches[k]
        cos = _view_cosines(result.embedding, default_result.embedding)
        log(f"head-major engine vs default engine: min view cosine "
            f"{cos.min():.6f} (>= {MIN_COSINE}), top-1 cell "
            f"{result.top_ids[0]} / {default_result.top_ids[0]}")
        if cos.min() < MIN_COSINE or \
                result.top_ids[0] != default_result.top_ids[0]:
            fail("the head-major engine disagrees with the default engine")
        if not np.isfinite(result.embedding).all():
            fail("non-finite output from the head-major engine")
        for bucket in (1, 16):
            batch = np.repeat(views[None], bucket, axis=0)
            p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=10)
            log(f"head-major engine bucket {bucket}: p50 {p50:.2f} ms, "
                f"{bucket / p50 * 1e3:.2f} panos/s")
        del engine
    finally:
        wa.QKV_KERNEL_MIN_N = saved
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_headmajor_train_vs_cpu():
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.profile_forward import HEAD_MAJOR, HEAD_MAJOR_MIN_N

    saved = wa.QKV_KERNEL_MIN_N
    wa.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N
    try:
        log("head-major train step (QKV_KERNEL_MIN_N raised, every stage "
            "through window_attention):")
        phase_train_vs_cpu(HEAD_MAJOR)
    finally:
        wa.QKV_KERNEL_MIN_N = saved
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 18: the two-kernel backward (K7) in train() and in train_step
# ---------------------------------------------------------------------------

K7_TRAIN_STEPS = 3
#: K7 at the 6 stage-2 blocks of every step; K5 not at all.
K7_LAUNCHES_PER_STEP = {"K7": 6, "K5": 0}
#: The same step with K5 and with K7: relative loss difference, the cosine
#: of the whole flattened gradient, and the cosine of each leaf that K7's
#: cotangents reach first, the attention leaves of the stage-2 blocks (both
#: compute the same cotangents in f32 and round them to bf16 once; only
#: sum orders differ).
K7_LOSS_RTOL = 1e-3
K7_GRAD_MIN_COSINE = 0.9999
K7_STAGE2_LEAVES = ("stage2_block", ".attn.")
#: Timed steps after the compared one.
K7_STEP_REPS = 5


def _k7_k5_launches():
    from geoguessr_ai_torch.ops import window_attention as wa

    return {"K7": wa.LAUNCHES[K7_META[0]], "K5": wa.LAUNCHES[BWD_META["K5"][0]]}


def _step_grads_and_p50(fields=None, reps=5):
    """(loss, flattened f32 gradient on the host, running statistics,
    train_step p50 ms over ``reps`` more steps, peak device memory GB of
    the first step, the gradients by name) of one TRAIN_BATCH train step of
    the fixture batch from the seeded state."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    config = None if fields is None else TinyViTConfig(**fields)
    state, batch, centroids = fixture_train_setup(TRAIN_BATCH, seed=SEED,
                                                  model_config=config)
    grads = {}
    step = state.optimizer.step

    def capture(params, g):
        if not grads:
            grads.update({n: t.detach().float().cpu() for n, t in g.items()})
        return step(params, g)

    state.optimizer.step = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, metrics = train_step(state, batch, centroids)
    loss = float(metrics["loss"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = {n: b.detach().float().cpu()
             for n, b in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, centroids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    flat = torch.cat([grads[n].flatten() for n in sorted(grads)])
    del state, batch, centroids
    gc.collect()
    torch.cuda.empty_cache()
    return loss, flat, stats, float(np.median(times)), peak_gb, grads


def phase_k7_train():
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import TrainConfig
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train.coordinator import train
    from geoguessr_ai_torch.train.fixtures import fixture_records

    saved = wa.BWD_MERGED
    wa.BWD_MERGED = False
    try:
        cfg = TrainConfig(batch_size=TRAIN_BATCH, log_every_steps=1,
                          seed=SEED)
        records = fixture_records(TRAIN_BATCH * (K7_TRAIN_STEPS + 1),
                                  seed=SEED)
        split = TRAIN_BATCH * K7_TRAIN_STEPS
        table = CentroidTable.load(C.CENTROID_TABLE_PATH)
        torch.cuda.synchronize()
        _reset_all_launches()
        summary = train(cfg, records[:split], records[split:], table,
                        max_steps=K7_TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = _k7_k5_launches()
        log(f"train() with BWD_MERGED=False: {K7_TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} panoramas, val_loss {summary['val_loss']:.6f}, "
            f"launches {launches}")
        if not math.isfinite(summary.get("val_loss", float("nan"))):
            fail(f"train() with BWD_MERGED=False: no finite val_loss "
                 f"{summary}")
        for k, per in K7_LAUNCHES_PER_STEP.items():
            if launches[k] != per * K7_TRAIN_STEPS:
                fail(f"train() with BWD_MERGED=False: {k} launched "
                     f"{launches[k]} times, expected {per} per step x "
                     f"{K7_TRAIN_STEPS}")
        del summary
        gc.collect()
        torch.cuda.empty_cache()
        _reset_all_launches()
        two = _step_grads_and_p50(reps=K7_STEP_REPS)
        two_launches = _k7_k5_launches()
    finally:
        wa.BWD_MERGED = saved
    _reset_all_launches()
    merged = _step_grads_and_p50(reps=K7_STEP_REPS)
    merged_launches = _k7_k5_launches()
    steps = 1 + K7_STEP_REPS
    log(f"  launches over the {steps} steps of each: K7 step "
        f"{two_launches}, K5 step {merged_launches}")
    if two_launches != {"K7": 6 * steps, "K5": 0} or \
            merged_launches != {"K7": 0, "K5": 6 * steps}:
        fail("the K5-vs-K7 comparison did not run K7 and K5 as configured")
    rel = abs(two[0] - merged[0]) / abs(merged[0])
    cos = _cosine(two[1], merged[1])
    log(f"train_step BWD_MERGED=True (K5) vs False (K7), same state and "
        f"batch: loss {merged[0]:.6f} / {two[0]:.6f} rel {rel:.3g} "
        f"(tolerance {K7_LOSS_RTOL}); gradient cosine {cos:.8f} "
        f"(>= {K7_GRAD_MIN_COSINE})")
    log(f"  train_step p50 K5 {merged[3]:.2f} ms, K7 {two[3]:.2f} ms "
        f"({TRAIN_BATCH} panoramas, fixed device batch)")
    leaves = sorted(n for n in merged[5]
                    if all(part in n for part in K7_STAGE2_LEAVES))
    if not leaves:
        fail("the train step has no stage-2 attention gradients")
    worst = 1.0
    for n in leaves:
        a, b = two[5][n], merged[5][n]
        leaf_cos = _cosine(a, b)
        worst = min(worst, leaf_cos)
        _, leaf_rel = _rel_err(a, b)
        log(f"  {n}: cosine {leaf_cos:.8f} max_rel_err {leaf_rel:.3g} "
            f"bitwise equal {torch.equal(a, b)}")
    log(f"  stage-2 attention leaves: {len(leaves)}, lowest cosine "
        f"{worst:.8f} (>= {K7_GRAD_MIN_COSINE})")
    if rel > K7_LOSS_RTOL or cos < K7_GRAD_MIN_COSINE \
            or worst < K7_GRAD_MIN_COSINE:
        fail("the K7 train step disagrees with the K5 one")
    return launches["K7"]


# ---------------------------------------------------------------------------
# Phase 19: remat
# ---------------------------------------------------------------------------

#: remat off, "full" and "dots" from the same state and batch: the forward
#: is the same computation, so the loss agrees to f32 noise and the running
#: statistics (moved once, by the forward) to f32 noise; the gradients
#: agree as the recompute repeats the same kernels.
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_MIN_COSINE = 0.9999
REMAT_STATS_RTOL = 1e-5


def phase_remat():
    base = _step_grads_and_p50(reps=3)
    log(f"remat off: train_step B={TRAIN_BATCH} loss {base[0]:.6f}, p50 "
        f"{base[3]:.2f} ms, peak device memory {base[4]:.3f} GB")
    for policy in ("full", "dots"):
        got = _step_grads_and_p50(dict(remat=True, remat_policy=policy),
                                  reps=3)
        rel = abs(got[0] - base[0]) / abs(base[0])
        cos = _cosine(got[1], base[1])
        worst = max(float((got[2][n] - base[2][n]).abs().max()
                          / base[2][n].abs().max().clamp_min(1e-30))
                    for n in base[2])
        log(f"remat {policy}: loss {got[0]:.6f} rel {rel:.3g} (<= "
            f"{REMAT_LOSS_RTOL}); gradient cosine {cos:.8f} (>= "
            f"{REMAT_GRAD_MIN_COSINE}); running statistics max rel diff "
            f"{worst:.3g} (<= {REMAT_STATS_RTOL}); p50 {got[3]:.2f} ms; peak "
            f"device memory {got[4]:.3f} GB ({got[4] / base[4]:.3f} of "
            f"remat off)")
        if rel > REMAT_LOSS_RTOL or cos < REMAT_GRAD_MIN_COSINE \
                or worst > REMAT_STATS_RTOL:
            fail(f"remat {policy} disagrees with remat off")


# ---------------------------------------------------------------------------
# Phase 20: the attention kernels at head dims 16 and 64 (CLIP's at 16 and
# 32), and K4's / K5's d_bias bitwise stable at the train shapes
# ---------------------------------------------------------------------------

#: (kernel, hd, W, N, C, H): each TinyViT attention kernel at head dims 16
#: and 64, with D = C a multiple of 64 for the fused kernels' GEMMs.
HEAD_DIM_CASES = tuple(
    (k, hd, W, N, C, H)
    for hd, C, H in ((16, 128, 8), (64, 384, 6))
    for k, W, N in (("K1", 64, 256), ("K2", 16, 1024), ("K3", 64, 256),
                    ("K9", 64, 256), ("K4", 64, 256), ("K5", 16, 1024),
                    ("K7", 16, 1024), ("K8a", 16, 1024), ("K8b", 64, 256)))
#: (kernel, hd, B, N, H): CLIP's kernels at CLIP test_tiny's head dim 32
#: and at 16, N=577 as ViT-L/14-336's.
CLIP_HEAD_DIM_CASES = (("K6", 32, 16, 577, 8), ("K11", 32, 16, 577, 8),
                       ("K6", 16, 16, 577, 16), ("K11", 16, 16, 577, 16))


def _head_dim_case(kernel, hd, W, N, C, H, gen):
    """(kernel fn, plain fn, args) for one case of HEAD_DIM_CASES."""
    from geoguessr_ai_torch.ops import window_attention as wa

    scale = hd ** -0.5
    if kernel in ("K4", "K5", "K7"):
        D = H * hd
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda",
                                                         torch.bfloat16)
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        g = torch.randn(W, N, D, generator=gen).to("cuda", torch.bfloat16)
        name, plain = {"K4": ("_attention_qkv_bwd_cuda",
                              wa._attention_qkv_bwd_plain),
                       "K5": ("_attention_bwd_merged_cuda",
                              wa._attention_bwd_merged_plain),
                       "K7": ("_attention_bwd_qtiled_cuda",
                              wa._attention_bwd_qtiled_plain)}[kernel]
        return getattr(wa, name), plain, (qkv, bias, g, scale, H)
    if kernel in ("K8a", "K8b"):
        q, k, v = (torch.randn(W, H, N, hd, generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        fn = (wa._attention_qtiled_cuda if kernel == "K8a"
              else wa._attention_batched_cuda)
        return fn, wa._attention_plain, (q, k, v, bias, scale)
    a = _case_inputs(W, N, C, H, gen)
    if kernel == "K1":
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["w_proj"], a["b_proj"], a["bias"], scale, H, 1e-5)
        return wa._fused_block_cuda, wa._fused_block_plain, args
    if kernel == "K2":
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["bias"], scale, H, 1e-5)
        return wa._fb_s2_cuda, wa._fb_s2_plain, args
    if kernel == "K9":
        side = int(round((W * N) ** 0.5))
        x4 = a["x"].reshape(1, side, side, C)
        args = (x4, a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["w_proj"], a["b_proj"], a["bias"], scale, H,
                int(round(N ** 0.5)), 1e-5)
        return wa._fb4d_cuda, wa._fb4d_plain, args
    qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                           a["b_qkv"], 1e-5)
    return (wa._attention_qkv_fused_cuda, wa._attention_qkv_fused_plain,
            (qkv, a["bias"], scale, H))


def phase_head_dims():
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(SEED + 7)
    worst = {}
    for kernel, hd, W, N, C, H in HEAD_DIM_CASES:
        if kernel in ("K4", "K7"):
            log(f"{kernel}@hd{hd} W={W} N={N} H={H}: "
                f"{_bwd_plan(kernel, W, N, H)}")
        kern, plain, args = _head_dim_case(kernel, hd, W, N, C, H, gen)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for a, b in pairs:
            _, rel = _rel_err(a, b)
            finite = bool(torch.isfinite(a).all())
            worst[(kernel, hd)] = max(worst.get((kernel, hd), 0.0), rel)
            if a.shape != b.shape or not finite or rel > KERNEL_REL_TOL:
                fail(f"{kernel} at head dim {hd} disagrees with its plain "
                     f"version (rel {rel:.3g}, finite {finite})")
        del got, want, args
    for kernel, hd, B, N, H in CLIP_HEAD_DIM_CASES:
        D = H * hd
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda",
                                                         torch.bfloat16)
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to(
            "cuda", torch.bfloat16)
        args = (qkv, hd ** -0.5, H) if kernel == "K6" else \
            (qkv, w, hd ** -0.5, H)
        kern, plain = ((ca._flash_cuda, ca._flash_plain) if kernel == "K6"
                       else (ca._flash_proj_cuda, ca._flash_proj_plain))
        _, rel = _rel_err(kern(*args), plain(*args))
        worst[(kernel, hd)] = rel
        if rel > KERNEL_REL_TOL:
            fail(f"{kernel} at head dim {hd} disagrees with its plain "
                 f"version (rel {rel:.3g})")
    log("head dims: max_rel_err against the plain versions (tolerance "
        f"{KERNEL_REL_TOL}): " + ", ".join(
            f"{k}@hd{hd} {r:.4g}" for (k, hd), r in sorted(worst.items())))
    for kernel, label, W, N, H in BWD_CASES:
        D = H * 32
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda",
                                                         torch.bfloat16)
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        g = torch.randn(W, N, D, generator=gen).to("cuda", torch.bfloat16)
        fn = getattr(wa, BWD_META[kernel][0])
        first = fn(qkv, bias, g, 32 ** -0.5, H)
        second = fn(qkv, bias, g, 32 ** -0.5, H)
        same = (torch.equal(first[1], second[1]),
                torch.equal(first[0], second[0]))
        log(f"{kernel} {label} W={W}: d_bias bitwise equal over two calls "
            f"{same[0]}, d_qkv {same[1]}"
            + (f" ({_bwd_plan(kernel, W, N, H)})" if kernel == "K4" else ""))
        if not all(same):
            fail(f"{kernel} {label}: the backward is not bitwise stable")
        del qkv, bias, g, first, second
    wa.reset_launches()
    ca.reset_launches()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 21: the experimental kernels (K12a, K12b, K13) against their plain
# versions, then the entry points that run them
# ---------------------------------------------------------------------------

EXP_META = {
    "K12a": ("_fused_mbconv_cuda",
             "geoguessr_ai_torch/ops/csrc/fused_mbconv_exp.cu",
             "geoguessr_ai_tpu/ops/experimental/fused_mbconv.py:68"),
    "K12b": ("_fused_mbconv_v2_cuda",
             "geoguessr_ai_torch/ops/csrc/fused_mbconv_exp.cu",
             "geoguessr_ai_tpu/ops/experimental/fused_mbconv.py:199"),
    "K13": ("_tiled_matmul_cuda",
            "geoguessr_ai_torch/ops/csrc/tiled_gemm.cu",
            "tools/exp_int8_pallas.py:43"),
}
#: Images of the K12 checks: the bucket-16 stage-0 batch and the JAX
#: module's benchmark batch.
EXP_MBCONV_IMAGES = (64, 256)
#: The JAX tool's (M, K, N) shapes.
K13_SHAPES = ((4096, 2048, 4096), (4096, 4096, 4096), (131072, 384, 1536),
              (131072, 1536, 384))
PEAK_INT8_OPS_S = 1979e12


def _exp_mbconv_inputs(B, gen):
    """The JAX benchmark's inputs: x * 0.5, weights and biases * 0.1."""
    def t(shape, scale, dtype):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    C, E = MB_C, MB_E
    bf, f32 = torch.bfloat16, torch.float32
    return (t((B, MB_MAP, MB_MAP, C), 0.5, bf), t((C, E), 0.1, bf),
            t((E,), 0.1, f32), t((3, 3, E), 0.1, f32), t((E,), 0.1, f32),
            t((E, C), 0.1, bf), t((C,), 0.1, f32))


def _exp_chain_ms(args):
    """conv 1x1 -> GELU -> depthwise -> GELU -> conv 1x1 -> GELU with the
    plain biases, as cuDNN convolutions in bf16: the yardstick only."""
    import torch.nn.functional as F

    x, w1, b1, wdw, b2, w3, b3 = args
    bf = torch.bfloat16
    E = w1.shape[1]
    xc = x.permute(0, 3, 1, 2)
    k1 = w1.t().contiguous()[:, :, None, None]
    k2 = wdw.to(bf).permute(2, 0, 1).contiguous()[:, None]
    k3 = w3.t().contiguous()[:, :, None, None]
    bb = [b.to(bf)[None, :, None, None] for b in (b1, b2, b3)]

    def chain():
        h = F.gelu(F.conv2d(xc, k1) + bb[0], approximate="tanh")
        h = F.gelu(F.conv2d(h, k2, padding=1, groups=E) + bb[1],
                   approximate="tanh")
        return F.gelu(xc + F.conv2d(h, k3) + bb[2], approximate="tanh")

    return cuda_time_ms(chain, iters=5)


def _k13_bound_ms(M, K, N, int8):
    ops = 2.0 * M * K * N
    elem = 1 if int8 else 2
    nbytes = (M * K + K * N) * elem + 4 * M * N
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / (PEAK_INT8_OPS_S if int8 else PEAK_BF16_FLOP_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def _k13_library(a, b, int8):
    """One PyTorch call: torch._int_mm for int8; for bf16 torch.mm with an
    f32 output where this PyTorch has out_dtype, else torch.matmul (bf16
    out).  Returns (fn, what)."""
    if int8:
        return (lambda: torch._int_mm(a, b)), "torch._int_mm (int32 out)"
    try:
        torch.mm(a[:16, :16], b[:16, :16], out_dtype=torch.float32)
        return ((lambda: torch.mm(a, b, out_dtype=torch.float32)),
                "torch.mm(out_dtype=float32)")
    except (TypeError, RuntimeError):
        return (lambda: torch.matmul(a, b)), "torch.matmul (bf16 out)"


def phase_experimental():
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg
    from geoguessr_ai_torch.tools import exp_int8_gemm

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 8)
    for images in EXP_MBCONV_IMAGES:
        args = _exp_mbconv_inputs(images, gen)
        with torch.inference_mode():
            got = fm._fused_mbconv_cuda(*args)
            got2 = fm._fused_mbconv_cuda(*args, v2=True)
            torch.cuda.synchronize()
            want = _sliced(fm._fused_mbconv_plain, args, images)
            max_abs, rel = _rel_err(got, want)
            same = torch.equal(got, got2)
            finite = bool(torch.isfinite(got).all())
            del got, got2, want
            ms_a = cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args))
            ms_b = cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args,
                                                               v2=True))
            plain_ms = cuda_time_ms(
                lambda: _sliced(fm._fused_mbconv_plain, args, images),
                iters=2)
            chain_ms = _exp_chain_ms(args)
        bound, bound_by = _mbconv_bound_ms(images)
        log(f"K12a / K12b {images} images, x {tuple(args[0].shape)}, E "
            f"{MB_E}: max_abs_err {max_abs:.6g} max_rel_err {rel:.6g} "
            f"(tolerance {KERNEL_REL_TOL}); K12b bitwise equal to K12a "
            f"{same}")
        log(f"  K12a kernel_ms {ms_a:.4f}, K12b kernel_ms {ms_b:.4f}, "
            f"plain_ms {plain_ms:.4f}, cudnn_chain_ms {chain_ms:.4f}, "
            f"bound_ms {bound:.4f} ({bound_by})")
        if not (finite and rel <= KERNEL_REL_TOL and same):
            fail(f"K12 {images} images: rel {rel:.3g}, finite {finite}, "
                 f"K12b equal to K12a {same}")
        for k, ms in (("K12a", ms_a), ("K12b", ms_b)):
            rows[(k, images)] = dict(max_abs_err=max_abs, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=bound_by, lib_ms=chain_ms)
        del args
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 9)
    for M, K, N in K13_SHAPES:
        tops = {}
        for int8 in (True, False):
            if int8:
                a = torch.randint(-127, 128, (M, K), generator=gen,
                                  dtype=torch.int8).cuda()
                b = torch.randint(-127, 128, (K, N), generator=gen,
                                  dtype=torch.int8).cuda()
                out_dtype = torch.int32
            else:
                a = torch.randn(M, K, generator=gen).to("cuda",
                                                        torch.bfloat16)
                b = torch.randn(K, N, generator=gen).to("cuda",
                                                        torch.bfloat16)
                out_dtype = torch.float32
            got = tg._tiled_matmul_cuda(a, b, out_dtype)
            want = tg._tiled_matmul_plain(a, b, out_dtype)
            torch.cuda.synchronize()
            if int8:
                exact = torch.equal(got, want)
                max_abs, rel = _rel_err(got, want)
                ok = exact
            else:
                max_abs, rel = _rel_err(got, want)
                ok = rel <= KERNEL_REL_TOL and bool(torch.isfinite(got).all())
            del got, want
            kind = "int8" if int8 else "bf16"
            ms = cuda_time_ms(lambda: tg._tiled_matmul_cuda(a, b, out_dtype))
            plain_ms = cuda_time_ms(
                lambda: tg._tiled_matmul_plain(a, b, out_dtype), iters=2)
            lib, lib_what = _k13_library(a, b, int8)
            lib_ms = cuda_time_ms(lib)
            bound, bound_by, t_bytes, t_ops = _k13_bound_ms(M, K, N, int8)
            ops = 2.0 * M * K * N
            tops[kind] = (ops / ms / 1e9, ops / lib_ms / 1e9)
            log(f"K13 {kind} (M, K, N) = ({M}, {K}, {N}): "
                + (f"int32 exactly equal to the plain product {ok}"
                   if int8 else f"max_rel_err {rel:.6g} (tolerance "
                                f"{KERNEL_REL_TOL})"))
            log(f"  kernel_ms {ms:.4f} ({tops[kind][0]:.1f} TOPS), plain_ms "
                f"{plain_ms:.4f}, library_ms {lib_ms:.4f} ({lib_what}, "
                f"{tops[kind][1]:.1f} TOPS), bound_ms {bound:.4f} "
                f"({bound_by}: bytes {t_bytes:.4f} ms, operations "
                f"{t_ops:.4f} ms)")
            if not ok:
                fail(f"K13 {kind} ({M}, {K}, {N}) disagrees with its plain "
                     f"version (rel {rel:.3g})")
            rows[("K13", kind, (M, K, N))] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, lib_ms=lib_ms,
                lib_what=lib_what, tops=tops[kind][0])
            del a, b
            torch.cuda.empty_cache()
        log(f"  int8 / bf16 rate at ({M}, {K}, {N}): K13 "
            f"{tops['int8'][0] / tops['bf16'][0]:.3f}, library "
            f"{tops['int8'][1] / tops['bf16'][1]:.3f}")

    # the entry points, with the counters at 0 just before each
    fm.reset_launches()
    fm._bench(reps=2)
    launches = dict(fm.LAUNCHES)
    tg.reset_launches()
    exp_int8_gemm.main(["--reps", "2"])
    launches.update(tg.LAUNCHES)
    log(f"experimental entry points: launches {launches}")
    for k in ("K12a", "K12b", "K13"):
        if not launches[EXP_META[k][0]]:
            fail(f"{k} was not launched by its entry point")
    torch.cuda.empty_cache()
    return rows, {k: launches[m[0]] for k, m in EXP_META.items()}


# ---------------------------------------------------------------------------
# Phase 22: the static-int8 embed path (the default EmbedBuildConfig)
# ---------------------------------------------------------------------------

#: Launches of one B=512 forward of the static config (JAX's static
#: Embedder): K1 at the 2 blocks of each of stages 1 and 3, K2 at the 6
#: stage-2 blocks; no K3, K9 or K10.
STATIC_LAUNCHES_PER_FORWARD = {"K1": 4, "K2": 6, "K3": 0, "K9": 0, "K10": 0,
                               "K4": 0, "K5": 0}
#: The JAX gate of the int8 path against the unquantized f32 forward
#: (tests/test_quant.py), and the static forward on the card against the
#: same static forward on the CPU with the same weights and scales.
STATIC_MIN_COSINE = 0.99
STATIC_SELF_MIN_COSINE = 0.999
STATIC_SELF_IMAGES = 8


def phase_static_embed(paths):
    import dataclasses

    from geoguessr_ai_torch.config import BackboneConfig, EmbedBuildConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
        static_config,
    )
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
        read_embeddings,
    )

    bb = BackboneConfig.tinyvit()
    blobs = [open(p, "rb").read() for p in paths]
    emb = Embedder(bb, quant_mode="static", seed=SEED)
    views = np.stack([decode_jpeg(b, emb.image_size) for b in blobs])
    batch = views[np.arange(EMBED_BATCH) % 4]
    emb(batch)  # calibrates on the first batch, as the builder's first call
    torch.cuda.synchronize()
    _reset_all_launches()
    out = emb(batch)
    torch.cuda.synchronize()
    launches = _tinyvit_launches()
    log(f"static Embedder B={EMBED_BATCH}: {len(emb.model.act_scales)} "
        f"calibrated sites, launches of one forward "
        f"{ {k: launches[k] for k in STATIC_LAUNCHES_PER_FORWARD} }")
    if out.shape != (EMBED_BATCH, 576) or not np.isfinite(out).all():
        fail(f"static embeddings {out.shape}, finite "
             f"{np.isfinite(out).all()}")
    for k, per in STATIC_LAUNCHES_PER_FORWARD.items():
        if launches[k] != per:
            fail(f"static embed: {k} launched {launches[k]} times in one "
                 f"forward, expected {per}")

    t0 = time.perf_counter()
    cpu = Embedder(bb, device="cpu", seed=SEED, model_config=dataclasses.replace(
        static_config()[0], dtype=torch.float32, quant_mode="none"))
    ref = cpu(views)
    del cpu
    cos = _view_cosines(out[:4], ref)
    log(f"static gpu vs unquantized cpu f32 on the fixture images: min "
        f"cosine {cos.min():.6f} (>= {STATIC_MIN_COSINE}; "
        f"{', '.join(f'{c:.6f}' for c in cos)}) "
        f"({time.perf_counter() - t0:.1f} s)")
    if cos.min() < STATIC_MIN_COSINE:
        fail(f"static embed cosine {cos.min():.6f} < {STATIC_MIN_COSINE}")
    t0 = time.perf_counter()
    cpu_static = Embedder(bb, quant_mode="static", device="cpu", seed=SEED,
                          model_config=dataclasses.replace(
                              static_config()[0], dtype=torch.float32))
    cpu_static.model.act_scales = {k: v.cpu() for k, v in
                                   emb.model.act_scales.items()}
    n = STATIC_SELF_IMAGES
    cos = _view_cosines(out[:n], cpu_static(batch[:n]))
    del cpu_static
    log(f"static gpu vs the port's static cpu forward (f32, same weights and "
        f"scales) on {n} images: min cosine {cos.min():.6f} (>= "
        f"{STATIC_SELF_MIN_COSINE}) ({time.perf_counter() - t0:.1f} s)")
    if cos.min() < STATIC_SELF_MIN_COSINE:
        fail(f"static gpu vs static cpu cosine {cos.min():.6f}")

    static = _embedder_p50(emb, batch, "static int8 (PROD_QUANT_SITES)")
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    none_emb = Embedder(bb, seed=SEED, model_config=dataclasses.replace(
        static_config()[0], quant_mode="none"))
    none = _embedder_p50(none_emb, batch, "the same config, quant_mode none")
    log(f"  static vs none: p50 {static[0]:.2f} vs {none[0]:.2f} ms "
        f"({none[0] / static[0]:.3f}x), peak {static[1]:.3f} vs "
        f"{none[1]:.3f} GB")
    del none_emb
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    coords = rng.uniform((-60.0, -180.0), (70.0, 180.0),
                         (EMBED_ROWS // 4 + 1, 2))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "raw.sqlite")
        dst = os.path.join(tmp, "emb.sqlite")
        create_sqlite_from_records(src, (
            {"location_id": f"loc{i // 4:05d}", "lat": coords[i // 4, 0],
             "lon": coords[i // 4, 1], "heading": 90 * (i % 4),
             "image": blobs[i % 4]} for i in range(EMBED_ROWS)))
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        written = build_embedding_sqlite(src, dst)  # EmbedBuildConfig()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        build_launches = _tinyvit_launches()
        rows = read_embeddings(dst)
    forwards = -(-EMBED_ROWS // EMBED_BATCH)
    table = np.stack([r.embedding for r in rows]) if rows else np.zeros(0)
    log(f"build_embedding_sqlite with the default EmbedBuildConfig() "
        f"(quant_mode {EmbedBuildConfig().quant_mode!r}): {written} rows in "
        f"{wall_s:.2f} s, launches {build_launches}")
    if written != EMBED_ROWS or table.shape != (EMBED_ROWS, 576) or \
            not np.isfinite(table).all():
        fail(f"default-config build wrote {written} rows, table "
             f"{table.shape}")
    for k, per in STATIC_LAUNCHES_PER_FORWARD.items():
        if build_launches[k] != per * forwards:
            fail(f"default-config build: {k} launched {build_launches[k]} "
                 f"times, expected {per} x {forwards}")
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + build_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# Phase 23: CLIP with quantize_gemms
# ---------------------------------------------------------------------------

#: The JAX gate of CLIP's int8 path against its unquantized forward
#: (tests/test_quant.py).
CLIP_INT8_MIN_COSINE = 0.99


def phase_clip_int8(paths, clip_result):
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    engine = ServingEngine(backbone="clip", seed=SEED,
                           backbone_config=CLIPVisionConfig.vit_l_14_336(
                               quantize_gemms=True))
    _, views = _fixture_views(engine)
    result, forwards, clip, tinyvit = _clip_serve_launches(
        engine, paths, views, burst=False)
    _check_clip_launches("CLIP int8 engine (quantize_gemms)", forwards, clip,
                         tinyvit, "K6")
    cos = _view_cosines(result.embedding, clip_result.embedding)
    log(f"CLIP int8 engine vs the K6 engine: min view cosine {cos.min():.6f} "
        f"(>= {CLIP_INT8_MIN_COSINE}), top-1 cell {result.top_ids[0]} / "
        f"{clip_result.top_ids[0]}")
    if cos.min() < CLIP_INT8_MIN_COSINE:
        fail(f"CLIP int8 cosine {cos.min():.6f} < {CLIP_INT8_MIN_COSINE}")
    batch = np.repeat(views[None], 16, axis=0)
    p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=5)
    log(f"CLIP int8 bucket 16: p50 {p50:.2f} ms, {16 / p50 * 1e3:.2f} "
        f"panos/s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return clip[CLIP_META["K6"][0]]


# ---------------------------------------------------------------------------
# Phase 24: every f32 entry against its plain f32 version at the main
# path's shapes
# ---------------------------------------------------------------------------

#: f32 kernel vs its plain f32 version on the card: max |k - p| / max |p|.
#: The f32 entries split each operand into a bf16 (hi, lo) pair (about
#: 2^-17 of error a product); bf16 operands, at 2^-9 each (about 4e-3),
#: would not meet it.
F32_REL_TOL = 1e-3
#: The f32 main paths against the CPU f32 ones (phases 5, 9, 12, 14): the
#: same arithmetic to the kernels' split products and sum orders.
F32_MIN_COSINE = 0.9999
F32_TRAIN_LOSS_RTOL = 1e-4
F32_TRAIN_GRAD_MIN_COSINE = 0.9999
#: Gradient leaves below this share of the largest leaf norm are at the
#: rounding-noise floor of a step (phase 26).
F32_NOISE_FLOOR = 1e-6
#: (kernel, label, shape): each K1-K11 kernel at the shape its main path
#: gives it (serving bucket 16, the B=16 train shapes, CLIP-L bucket 16,
#: the embed batch of 512 images), as the bf16 phases run it.
F32_CASES = (
    ("K1", "stage1", (1024, 256, 192, 6)),
    ("K1", "embed_stage3", (64, 256, 576, 18)),
    ("K2", "stage2", (64, 1024, 384, 12)),
    ("K3", "stage3", (64, 256, 576, 18)),
    ("K4", "stage1", (1024, 256, 6)),
    ("K4", "stage3", (64, 256, 18)),
    ("K5", "stage2", (64, 1024, 12)),
    ("K7", "stage2", (64, 1024, 12)),
    ("K8a", "stage2_bucket16", (64, 12, 1024)),
    ("K8b", "stage1_bucket16", (1024, 6, 256)),
    ("K9", "embed", (EMBED_BATCH,)),
    ("K10", "embed", (EMBED_BATCH,)),
    ("K6", "vit_l14_bucket16", (64, 577, 1024, 16)),
    ("K11", "vit_l14_bucket16", (64, 577, 1024, 16)),
)
F32_META = {**ALL_META, **CLIP_META, **EMBED_META, **HEADMAJOR_META,
            "K7": K7_META}


def _f32_case(kernel, shape, gen):
    """(kernel fn, plain fn, args, bound, bound_by, library) of one
    F32_CASES case, every operand f32; library is None or a function that
    times one PyTorch call of the same function: (ms or None, what)."""
    import torch.nn.functional as F

    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import window_attention as wa

    f32 = torch.float32
    if kernel in ("K9", "K10"):
        kern, plain, args, bound, bound_by, ms, what = _embed_kernel_case(
            kernel, shape[0], gen, f32)
        # no one PyTorch call computes either function: the yardstick
        return (kern, lambda *a: _sliced(plain, a, shape[0]), args, bound,
                bound_by, lambda: (None, f"[{what} in f32 {ms:.4f}]"))
    kern = getattr(ca if kernel in CLIP_META else wa, F32_META[kernel][0])
    if kernel in ("K6", "K11"):
        B, N, D, H = shape
        hd = D // H
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda")
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to("cuda")
        q, k, v = (t.contiguous() for t in
                   qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4))
        bound, bound_by = _clip_bound_ms(kernel, B, N, D, H, 4)
        if kernel == "K6":
            return (kern, ca._flash_plain, (qkv, hd ** -0.5, H), bound,
                    bound_by, lambda: (cuda_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, scale=hd ** -0.5)),
                        "scaled_dot_product_attention in f32"))
        return (kern, ca._flash_proj_plain, (qkv, w, hd ** -0.5, H), bound,
                bound_by, None)
    if kernel in ("K8a", "K8b"):
        W, H, N = shape
        q, k, v = (torch.randn(W, H, N, 32, generator=gen).to("cuda")
                   for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        bound, bound_by = _headmajor_bound_ms(W, H, N, 4)
        return (kern, wa._attention_plain, (q, k, v, bias, 32 ** -0.5),
                bound, bound_by,
                lambda: _headmajor_sdpa_ms(q, k, v, bias, 32 ** -0.5))
    if kernel in ("K4", "K5", "K7"):
        W, N, H = shape
        D = H * 32
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda")
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        g = torch.randn(W, N, D, generator=gen).to("cuda")
        plain = {"K4": wa._attention_qkv_bwd_plain,
                 "K5": wa._attention_bwd_merged_plain,
                 "K7": wa._attention_bwd_qtiled_plain}[kernel]
        bound, bound_by = _bwd_bound_ms(kernel, W, N, H, 4)
        args = (qkv, bias, g, 32 ** -0.5, H)
        return (kern, plain, args, bound, bound_by,
                lambda: _sdpa_bwd_ms(qkv, bias, g, 32 ** -0.5, H))
    W, N, C, H = shape
    a = _case_inputs(W, N, C, H, gen, f32)
    scale = (C // H) ** -0.5
    bound, bound_by = _bound_ms(kernel, W, N, C, H, 4)
    if kernel == "K3":
        qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"],
                               a["w_qkv"], a["b_qkv"], 1e-5)
        return (kern, wa._attention_qkv_fused_plain,
                (qkv, a["bias"], scale, H), bound, bound_by,
                lambda: (_sdpa_ms(qkv, a["bias"], scale, H),
                         "scaled_dot_product_attention in f32"))
    if kernel == "K2":
        return (kern, wa._fb_s2_plain,
                (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                 a["b_qkv"], a["bias"], scale, H, 1e-5), bound, bound_by,
                None)
    return (kern, wa._fused_block_plain,
            (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
             a["w_proj"], a["b_proj"], a["bias"], scale, H, 1e-5), bound,
            bound_by, None)


def phase_f32_kernels():
    rows = {}
    gen = torch.Generator().manual_seed(SEED + 10)
    for kernel, label, shape in F32_CASES:
        kern, plain, args, bound, bound_by, lib = _f32_case(kernel, shape,
                                                            gen)
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        errs = []
        for a, b in pairs:
            if a.shape != b.shape or {a.dtype, b.dtype} != {torch.float32}:
                fail(f"{kernel} f32 {label}: {tuple(a.shape)} {a.dtype} != "
                     f"{tuple(b.shape)} {b.dtype}")
            errs.append((*_rel_err(a, b), bool(torch.isfinite(a).all())))
        del got, want
        ms = cuda_time_ms(lambda: kern(*args), iters=5)
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=2)
        lib_ms, lib_what = (None, "") if lib is None else lib()
        log(f"{kernel} f32 {label} {shape}: max_abs_err "
            + ", ".join(f"{e[0]:.6g}" for e in errs) + " max_rel_err "
            + ", ".join(f"{e[1]:.6g}" for e in errs)
            + f" (tolerance {F32_REL_TOL})")
        if kernel in ("K4", "K7"):
            log(f"  {_bwd_plan(kernel, shape[0], shape[1], shape[2], torch.float32)}")
        log(f"  kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}"
            f"{f' ({lib_what})' if lib_what else ''}, bound_ms {bound:.4f} "
            f"({bound_by}: f32 bytes at 3.35 TB/s, products at the TF32 "
            f"peak)")
        if not all(fin and rel <= F32_REL_TOL for _, rel, fin in errs):
            fail(f"{kernel} f32 {label}: kernel disagrees with its plain "
                 f"f32 version ({errs})")
        rows[(kernel, label)] = dict(
            max_abs_err=errs[0][0], max_rel_err=max(e[1] for e in errs),
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by=bound_by)
        del args
        gc.collect()
        torch.cuda.empty_cache()
    _reset_all_launches()
    return rows


# ---------------------------------------------------------------------------
# Phase 25: the f32 guess path: every engine, and the f32 Embedder
# ---------------------------------------------------------------------------

F32_BUCKET = 16
#: One bucket-16 forward of each f32 TinyViT engine: the default stages,
#: the head-major engine (QKV_KERNEL_MIN_N raised) and both knobs.
F32_TINYVIT_ENGINES = (
    ("default", {}, LAUNCHES_PER_FORWARD),
    ("head-major", "HEAD_MAJOR", HEADMAJOR_LAUNCHES[16]),
    ("knobs", {"fused_mbconv": True, "fused_block_4d": True},
     KNOB_SERVE_LAUNCHES),
)
#: The f32 Embedder of bulk_embed_config() at 64 images a forward (the
#: bf16 batch of 512 would need ~2x its 26 GB).
F32_EMBED_BATCH = 64


def _all_launches():
    """Every K1-K11 kernel's launches since the last reset, by id."""
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import window_attention as wa

    out = _headmajor_launches()
    out["K7"] = wa.LAUNCHES[K7_META[0]]
    out.update({k: ca.LAUNCHES[m[0]] for k, m in CLIP_META.items()})
    return out


def _f32_serve(label, engine, views, cpu_ref, want, total):
    """Serves a bucket of F32_BUCKET fixture panoramas (after a warm-up)
    with every counter at 0: exact launches ``want`` of one forward, no
    other kernel; every panorama against the CPU f32 result; p50."""
    batch = np.repeat(views[None], F32_BUCKET, axis=0)
    engine.predict_batch(batch)  # warm-up
    torch.cuda.synchronize()
    _reset_all_launches()
    results = engine.predict_batch(batch)
    torch.cuda.synchronize()
    launches = _all_launches()
    want = {k: want.get(k, 0) for k in launches}
    cos = min(float(_view_cosines(r.embedding, cpu_ref.embedding).min())
              for r in results)
    same_top1 = all(r.top_ids[0] == cpu_ref.top_ids[0] for r in results)
    finite = all(np.isfinite(r.embedding).all() for r in results)
    p50 = _p50_ms(lambda: engine.predict_batch(batch), reps=5)
    log(f"f32 {label} engine, bucket {F32_BUCKET}: launches {launches}; min "
        f"view cosine to the CPU f32 engine {cos:.8f} (>= {F32_MIN_COSINE}), "
        f"same top-1 cell {same_top1}; p50 {p50:.2f} ms, "
        f"{F32_BUCKET / p50 * 1e3:.2f} panos/s")
    if launches != want:
        fail(f"f32 {label} engine: launches {launches}, expected {want}")
    if not (finite and cos >= F32_MIN_COSINE and same_top1):
        fail(f"f32 {label} engine disagrees with the CPU f32 engine")
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def phase_f32_serve(tinyvit_ref, clip_ref, embed_ref):
    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.profile_forward import HEAD_MAJOR, HEAD_MAJOR_MIN_N
    from geoguessr_ai_torch.serving.engine import ServingEngine

    f32 = torch.float32
    total = {}
    for label, fields, want in F32_TINYVIT_ENGINES:
        head_major = fields == "HEAD_MAJOR"
        fields = HEAD_MAJOR if head_major else fields
        saved = wa.QKV_KERNEL_MIN_N
        if head_major:
            wa.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N
        try:
            engine = ServingEngine(seed=SEED, backbone_config=TinyViTConfig(
                dtype=f32, **fields))
            _, views = _fixture_views(engine)
            _f32_serve(f"TinyViT {label}", engine, views, tinyvit_ref, want,
                       total)
            del engine
        finally:
            wa.QKV_KERNEL_MIN_N = saved
        gc.collect()
        torch.cuda.empty_cache()
    for fuse in (False, True):
        engine = ServingEngine(backbone="clip", seed=SEED,
                               backbone_config=CLIPVisionConfig.vit_l_14_336(
                                   dtype=f32, pallas_fuse_proj=fuse))
        _, views = _fixture_views(engine)
        kernel = "K11" if fuse else "K6"
        _f32_serve(f"CLIP {kernel}", engine, views, clip_ref,
                   {kernel: CLIP_LAUNCHES_PER_FORWARD}, total)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    emb = Embedder(BackboneConfig.tinyvit(), seed=SEED,
                   model_config=bulk_embed_config(dtype=f32))
    _, images = _fixture_views(emb)
    batch = images[np.arange(F32_EMBED_BATCH) % 4]
    emb(batch)  # warm-up
    torch.cuda.synchronize()
    _reset_all_launches()
    out = emb(batch)
    torch.cuda.synchronize()
    launches = _all_launches()
    want = {k: EMBED_LAUNCHES_PER_FORWARD.get(k, 0) for k in launches}
    cos = float(_view_cosines(out[:4], embed_ref).min())
    p50, peak = _embedder_p50(emb, batch, "f32, embed config with both "
                                          "knobs")
    log(f"f32 Embedder B={F32_EMBED_BATCH}: launches {launches}; min "
        f"cosine to the CPU f32 forward {cos:.8f} (>= {F32_MIN_COSINE})")
    if launches != want:
        fail(f"f32 Embedder: launches {launches}, expected {want}")
    if not (np.isfinite(out).all() and cos >= F32_MIN_COSINE):
        fail("the f32 Embedder disagrees with the CPU f32 forward")
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phase 26: an f32 train step on the card against the CPU's
# ---------------------------------------------------------------------------


def phase_f32_train(cpu_step):
    """The B=2 train step of phase 9 in f32 on the card, with K5 and with
    K7 (BWD_MERGED False), each against phase 9's CPU f32 step: loss, every
    gradient leaf's cosine, the running statistics; exact launches."""
    from geoguessr_ai_torch.ops import window_attention as wa

    cl, cg, cs = cpu_step
    total = {}
    for merged in (True, False):
        saved = wa.BWD_MERGED
        wa.BWD_MERGED = merged
        try:
            _reset_all_launches()
            gl, gg, gs = _train_step_grads("cuda", "float32")
            torch.cuda.synchronize()
            launches = _all_launches()
        finally:
            wa.BWD_MERGED = saved
        want = dict(LAUNCHES_PER_TRAIN_STEP)
        if not merged:
            want["K7"], want["K5"] = want.pop("K5"), 0
        want = {k: want.get(k, 0) for k in launches}
        label = "K5" if merged else "K7"
        rel = abs(gl - cl) / abs(cl)
        modules = sorted({_top_module(n) for n in cg})
        mod_cos = {m: _cosine(*(torch.cat([g[n].flatten() for n in cg
                                           if _top_module(n) == m])
                                for g in (gg, cg))) for m in modules}
        # A leaf whose gradient is zero in exact arithmetic (a bias that
        # reaches the loss only through a batch-statistics BatchNorm, which
        # removes any per-channel constant) holds rounding noise on both
        # sides: its cosine says nothing.  Those leaves are the ones below
        # F32_NOISE_FLOOR of the largest gradient norm, listed with it.
        top = max(float(cg[n].norm()) for n in cg)
        leaves = [n for n in cg if float(cg[n].norm()) > F32_NOISE_FLOOR * top]
        floor = sorted(set(cg) - set(leaves))
        cos = {n: _cosine(gg[n], cg[n]) for n in leaves}
        worst = min(cos, key=cos.get)
        worst_mod = min(mod_cos, key=mod_cos.get)
        stats = min(_cosine(gs[n], cs[n]) for n in cs)
        log(f"f32 train step ({label}) on the card vs the CPU f32 step: loss "
            f"{gl:.8f} / {cl:.8f} rel {rel:.3g} (<= {F32_TRAIN_LOSS_RTOL}); "
            f"lowest module gradient cosine {mod_cos[worst_mod]:.8f} "
            f"({worst_mod}); {len(leaves)} gradient leaves, lowest cosine "
            f"{cos[worst]:.8f} ({worst}; >= {F32_TRAIN_GRAD_MIN_COSINE}); "
            f"lowest running statistics cosine {stats:.8f}; launches "
            f"{launches}")
        log(f"  {len(floor)} leaves at the noise floor (norm < "
            f"{F32_NOISE_FLOOR} x {top:.4g}): " + ", ".join(
                f"{n} {float(cg[n].norm()):.3g}/{float(gg[n].norm()):.3g}"
                for n in floor))
        if launches != want:
            fail(f"f32 train step ({label}): launches {launches}, expected "
                 f"{want}")
        if rel > F32_TRAIN_LOSS_RTOL or cos[worst] < F32_TRAIN_GRAD_MIN_COSINE \
                or mod_cos[worst_mod] < F32_TRAIN_GRAD_MIN_COSINE \
                or stats < F32_TRAIN_GRAD_MIN_COSINE:
            fail(f"the f32 train step ({label}) disagrees with the CPU f32 "
                 "step")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phase 27: K14, the shared-memory opt-in, and its tool
# ---------------------------------------------------------------------------

K14_META = ("_smem_probe_cuda", "geoguessr_ai_torch/ops/csrc/smem_probe.cu",
            "tools/exp_r4_vmem.py:35")
#: K14 against its plain version on a seeded normal x: six f32 products
#: summed in the same order, so equal; the tolerance allows another order.
K14_REL_TOL = 1e-6


def phase_smem_probe():
    """The port's exp_r4_vmem tool runs both probe cases in subprocesses:
    probe_default must crash (the launch over 48 KB is refused) and
    probe_v64 print s = 21.0 with one launch; then the kernel against its
    plain version, timed beside torch.mul and its bound."""
    from geoguessr_ai_torch.ops.experimental import smem_probe as sp
    from geoguessr_ai_torch.tools import exp_r4_vmem

    records = exp_r4_vmem.main(["probe_default,probe_v64"])
    by_case = {}
    for r in records:
        by_case.setdefault(r["case"], []).append(r)
    crashed = any(r.get("result") == "CRASH"
                  for r in by_case.get("probe_default", []))
    ok = [r for r in by_case.get("probe_v64", []) if r.get("result") == "ok"]
    launches = ok[0]["launches"] if ok else 0
    log(f"exp_r4_vmem: probe_default crashed {crashed}; probe_v64 "
        f"{ok[0] if ok else by_case.get('probe_v64')}")
    if not crashed:
        fail("probe_default did not crash: the probe does not exercise the "
             "shared-memory limit")
    if not ok or ok[0]["s"] != 21.0 or launches != 1:
        fail(f"probe_v64 did not give s = 21.0 with one launch: {ok}")

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    gen = torch.Generator().manual_seed(SEED + 11)
    ones = torch.ones(1, 1024, 1024, device="cuda")
    x = torch.randn(1, 1024, 1024, generator=gen).to("cuda")
    exact = torch.equal(sp._smem_probe_cuda(ones, optin),
                        torch.full((1024, 1024), 21.0, device="cuda"))
    got = sp._smem_probe_cuda(x, optin)
    want = sp._smem_probe_plain(x)
    max_abs, rel = _rel_err(got, want)
    ms = kernel_ms(lambda: sp._smem_probe_cuda(x, optin), iters=50)
    plain_ms = kernel_ms(lambda: sp._smem_probe_plain(x), iters=50)
    lib_ms = kernel_ms(lambda: torch.mul(x, 21.0), iters=50)
    bound, bound_by = _bound(11.0 * x.numel(), 2 * 4 * x.numel(),
                             PEAK_F32_FLOP_S)
    log(f"K14 (1, 1024, 1024) f32, {sp.smem_bytes(1024)} B of shared memory "
        f"a block (opt-in {optin}): 21.0 exactly at x = ones {exact}; "
        f"max_abs_err {max_abs:.6g} max_rel_err {rel:.6g} (tolerance "
        f"{K14_REL_TOL})")
    log(f"  kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
        f"{lib_ms:.4f} (torch.mul(x, 21.0)), bound_ms {bound:.4f} "
        f"({bound_by})")
    if not (exact and rel <= K14_REL_TOL):
        fail("K14 disagrees with its plain version")
    sp.reset_launches()
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                launches=launches)


# ---------------------------------------------------------------------------
# Phase 28: the kernels line
# ---------------------------------------------------------------------------


def main():
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    _, paths, result, serve_launches = phase_serve()
    tinyvit_ref = phase_cpu_reference(paths, result)
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(phase_backward_kernels())
    phase_op_gradients()
    train_launches = phase_train()
    cpu_step = phase_train_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    clip_rows = phase_clip_kernels()
    clip_paths, clip_result, clip_launches = phase_clip_serve()
    clip_ref = phase_clip_cpu_reference(clip_paths, clip_result)
    gc.collect()
    torch.cuda.empty_cache()
    embed_rows = phase_embed_kernels()
    embed_launches, embed_ref = phase_embed(paths)
    knob_launches = phase_knob_serve(paths, result)
    hm_rows = phase_headmajor_kernels()
    hm_launches = phase_headmajor_serve(paths, result)
    phase_headmajor_train_vs_cpu()
    k7_launches = phase_k7_train()
    phase_remat()
    phase_head_dims()
    exp_rows, exp_launches = phase_experimental()
    static_launches = phase_static_embed(paths)
    clip_int8_launches = phase_clip_int8(clip_paths, clip_result)
    f32_rows = phase_f32_kernels()
    f32_launches = phase_f32_serve(tinyvit_ref, clip_ref, embed_ref)
    for k, n in phase_f32_train(cpu_step).items():
        f32_launches[k] += n
    k14 = phase_smem_probe()

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
            "launches": (serve_launches.get(k, 0) + train_launches[k]
                         + static_launches.get(k, 0)),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": library,
        }
        if k in ("K1", "K2"):
            entry["sdpa_attention_ms"] = row["sdpa_ms"]
        if k in BWD_META:
            entry["max_abs_err_dbias"] = row["max_abs_err_dbias"]
        if k == "K4":
            entry["launch_ms"] = row["launch_ms"]
            stage3 = rows[("K4", "stage3")]
            entry["stage3"] = {key: stage3[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "launch_ms")}
        kernels.append(entry)
    for k, (name, source, replaces) in CLIP_META.items():
        row = clip_rows[(k, "vit_l14_bucket16")]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": clip_launches[k] + (clip_int8_launches
                                            if k == "K6" else 0),
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
    for k, (name, source, replaces) in HEADMAJOR_META.items():
        main_label = ("stage2_bucket16" if k == "K8a"
                      else "stage1_bucket16")
        row = hm_rows[(k, main_label)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": hm_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # SDPA with the bias as a float mask computes the function
            "library_ms": row["library_ms"],
            "other_shapes_ms": {label: r["ms"] for (kk, label), r
                                in hm_rows.items()
                                if kk == k and label != main_label},
        })
    row = hm_rows[("K7", "stage2")]
    kernels.append({
        "name": K7_META[0], "route": "cuda", "source": K7_META[1],
        "replaces": K7_META[2], "launches": k7_launches,
        "max_abs_err": row["max_abs_err"],
        "max_abs_err_dbias": row["max_abs_err_dbias"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # SDPA's backward computes K7's function (as K4's and K5's)
        "library_ms": row["library_ms"], "k5_same_inputs_ms": row["k5_ms"],
        "launch_ms": rows[("K7", "launch_ms")],
    })
    for k in ("K12a", "K12b"):
        name, source, replaces = EXP_META[k]
        row = exp_rows[(k, EXP_MBCONV_IMAGES[-1])]  # the JAX benchmark's batch
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": exp_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # no one PyTorch call computes the function
            "library_ms": None, "cudnn_chain_ms": row["lib_ms"],
            "bucket16_ms": exp_rows[(k, EXP_MBCONV_IMAGES[0])]["ms"],
        })
    name, source, replaces = EXP_META["K13"]
    main_shape = K13_SHAPES[1]  # (4096, 4096, 4096): the int8 rate shows
    row = exp_rows[("K13", "int8", main_shape)]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": exp_launches["K13"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["lib_ms"],
        "main_case": f"int8 {main_shape}",
        "other_cases": {f"{key[1]} {key[2]}": {
            "ms": r["ms"], "tops": r["tops"], "bound_ms": r["bound_ms"],
            "library_ms": r["lib_ms"]}
            for key, r in exp_rows.items() if key[0] == "K13"},
    })
    # the f32 entries: launches over the f32 main paths (phases 25-26)
    for (k, label), row in f32_rows.items():
        name, source, replaces = F32_META[k]
        kernels.append({
            "name": f"{name}[f32 {label}]", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": f32_launches[k], "max_abs_err": row["max_abs_err"],
            "max_rel_err": row["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    kernels.append({
        "name": K14_META[0], "route": "cuda", "source": K14_META[1],
        "replaces": K14_META[2], "launches": k14["launches"],
        "max_abs_err": k14["max_abs_err"], "ms": k14["ms"],
        "plain_ms": k14["plain_ms"], "bound_ms": k14["bound_ms"],
        "bound_by": k14["bound_by"],
        # torch.mul(x, 21.0) computes the same function in one call
        "library_ms": k14["library_ms"],
    })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (geoguessr_ai_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit) and the versions;
2. build the CUDA kernels from ``geoguessr_ai_torch/ops/csrc`` and print
   the build seconds; fail if a library exports a GNU-unique symbol
   (``nm -D``: a function-local static shared by every library of the
   process);
3. hold each kernel (K1, K2, K3) against its plain PyTorch version on the
   card, in bf16, at the shapes the serving path gives it at bucket 16
   (K1 also at the embed configuration's stage 3, C = 576), and time
   kernel, plain version, SDPA and the bound; K1 and K2 (the Hopper
   LayerNorm + GEMM core, then the forward core; K1's out-projection on
   the GEMM core again) and K3 (the forward core) bitwise equal over two
   calls; K1's three and K2's two launches' device time (torch.profiler)
   on a line of their own;
4. build the full-width ServingEngine (TinyViT-21M-512, 12647 cells,
   seeded random weights) on the card, serve the fixture panorama and 32
   concurrent MicroBatcher requests with every launch counter set to 0
   first, and check that each kernel ran; print latency and panos/s;
5. serve the fixture panorama through the same weights on the CPU in f32
   (the plain path) and compare embedding and top-1 cell;
6. hold the attention backward kernels (K4, K5) against their plain
   versions at the shapes a B=16 train step gives them, d_qkv and d_bias
   each, and time kernel, plain version, SDPA's backward and the bound;
   for each (bf16: the Hopper core, K5 with one window group) also its
   window groups, grids and the device time of each of its launches
   (torch.profiler), and K7's;
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
    wgmma products, warp-specialised, persistent; K11's bf16 entry runs it
    and then the Hopper GEMM core on its output: K11 bitwise equal to the
    core applied to K6's output and over two calls, its two launches'
    device time, traced in a fresh process and required, beside cuBLAS's
    o @ w);
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
    cuDNN conv2d composition for K10) and the bound; K9 and K10 (the
    Hopper kernels) bitwise equal over two calls, K9 equal to K1 on the
    partitioned map bit for bit at 64 images, K9's three launches' device
    time, and K10 also at C = 64 and C = 32 (four images each) against its
    plain version;
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
    ``_attention_plain`` at the head-major serving shapes (in bf16 both run
    the Hopper forward core, K8b's window groups, items and grid logged),
    each bitwise equal over two calls, and K8b's output bits on seeded
    inputs equal to its bits before K3 and K8a shared its core
    (``K8B_BITS``); then the two-kernel backward (K7) at the B=16 train
    shape against its plain version and against K5 on the same inputs,
    whose d_qkv and d_bias K7's must equal bit for bit (the same core, one
    window group), K7's outputs bitwise equal over two calls; time kernel,
    plain version, SDPA (forward, or its backward for K7) and the bound;
    K7's window groups and grids;
17. with ``QKV_KERNEL_MIN_N`` raised, serve the head-major engine (every
    attention stage through ``window_attention``): exact launches of one
    forward at bucket 1 (K8b 2, K8a 8) and 16 (K8b 4, K8a 6), no other
    TinyViT kernel, against the default engine of phase 4, and its p50s;
    then phase 9's train step on the card against the CPU in the same
    configuration;
18. with ``BWD_MERGED`` False, ``train()`` at full width for 3 steps of 16
    panoramas: K7 exactly 6 launches a step, K5 none; one train step from
    the same seeded state and batch with K5 and with K7 (loss, the whole
    gradient's cosine and each stage-2 attention leaf's, which must be
    bitwise equal: in bf16 both run the same core at one window group)
    and both train_step p50s;
19. one B=16 train step with remat off, "full" and "dots" from the same
    state and batch: loss, gradient cosine, running statistics moved once,
    peak device memory;
20. every TinyViT attention kernel (K1-K5, K7, K8a, K8b, K9) at head dims
    16 and 64 and CLIP's (K6, K11) at 16 and 32 against their plain
    versions, K9 equal to K1 on the partitioned map bit for bit at both;
    K4's and K5's d_bias and d_qkv bitwise equal over two calls at the
    B=16 train shapes;
21. the experimental kernels: K12a and K12b (the PLAIN kind of K10's
    Hopper kernel) against their plain mirror at 64 and 256 images of
    (128, 128, 96), E=384, and at C = 32, 64 and 96 on a ragged 48 x 40
    map, each bitwise equal over two calls and K12b bitwise equal to K12a
    (the cuDNN conv chain as the yardstick), K13 (the Hopper GEMM
    core) at the JAX tool's four shapes in int8 (exactly the plain
    product) and bf16, each bitwise equal over two calls, with TOPS (b
    K-major, as the kernel reads it; also from a (K, N) b, whose transpose
    the wrapper copies at every call), the bound and what sets it, the
    library call and the int8/bf16 rate ratios; then, with the counters at
    0, the entry points that run them
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
    phases 3, 6, 10, 13 and 16, and K4 at phase 31's TinyViT-5M-224 shapes
    (max |err| / max |ref| <= 1e-3, which bf16 operands would not meet),
    timed beside the f32 library call and the f32 bound (4 bytes an
    element at 3.35 TB/s, products at the 495 TFLOP/s TF32 peak); K4's,
    K5's and K7's f32 entries (the backward core's f32 kind) also bitwise
    over two calls, their plan mirror equal to the CUDA plan query, each
    launch's device time, and K7 on K5's stage-2 inputs bitwise K5's;
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
28. the rest of the guess path: (a) the seeded engine's weights written
    as a reference .pt by the port's exporters and served by
    ``ServingEngine(checkpoint=)`` (backbone loaded), bitwise equal to the
    seeded engine on the fixture panorama; (c) fixture views decoded at
    640 and 384 px and resized on the card against the CPU f32 engine, and
    the resize's cost at 16 panoramas; (b) the hierarchical engine (16
    heads at D = 576): exact K1-K3 launches of phase 4 over two forwards,
    logits against its CPU f32 twin with and without masks, p50s at
    buckets 1 and 16 beside mean fusion; (d) ProtoRefiner at full scale
    (12647 cells x 8 prototypes x 576, 16 f16 members of 64 dims each) at
    B = 16, card against CPU, with and without members, timed; (e)
    ``run_benchmark`` with the .pt on a fixture SQLite; (f) the HTTP
    handlers serving 8 concurrent submissions through the MicroBatcher;
29. training up to the coordinator's surface (all at full width, 12647
    cells, fixture panoramas; temp directories): (a) the decoder that runs
    (native libjpeg, built into build/native/, or PIL and why), native
    against PIL at 512 from the 640 px views (mean |diff| < 4.0, the JAX
    gate), a corrupt blob in ``decode_batch`` decoded to zeros, ms a view
    and ``PanoramaBatchIterator`` panos/s both ways; (b) ``train()`` for 3
    epochs of 2 steps of 16 with ``keep_last_n=2``, and again for 2 epochs
    then resumed for the third: the third epoch's losses within 1e-5
    relative, every parameter at cosine >= 0.99999, each store holding
    last, best and 2 epoch directories, exact K1-K5 launches; the
    checkpoint's size and save seconds, sync and async; (c)
    ``ServingEngine(checkpoint=<run>/best)`` bitwise equal to the engine on
    the weights the run held at that epoch; (d) ``qat_storage``: one
    calibration, every amax finite and positive, exact launches, the loop
    p50 beside phase 8's; (e) the head alone (backbone "none") for 20 steps
    on an embedding SQLite that ``build_embedding_sqlite`` wrote: no
    TinyViT launch, the loss falling; (f) hierarchical fusion: exact
    launches, nonzero self-attention gradients; (g) ``main()`` in a fresh
    process on a fixture SQLite (``DATASET_SQLITE_PATH``,
    ``GEO_TPU_CKPT_DIR``) for one epoch, then phase (b)'s ``train()`` under
    a ``StepProfiler`` whose trace must hold the LN + GEMM, forward and
    backward cores' kernels;
30. CLIP training and contrastive pretraining (full width, 12647 cells,
    temp directories): (a) ``train()`` on CLIP ViT-L/14-336 for 2 epochs
    of 2 steps of 16 fixture panoramas: K6 exactly 24 launches in each
    train and validation forward and none in the backward, no other
    kernel, finite losses, every leaf outside ``layer23``,
    ``post_layernorm`` and the head bitwise unchanged and every leaf
    inside them moved; loop p50 and peak memory; (b) one B=2 train step
    at full width and 2 layers on the card in bf16 against the CPU in f32:
    loss, the whole gradient's cosine, the trainable set; (c) ``train()``
    with ``pallas_fuse_proj``: K11 24 a forward, K6 none; (d)
    ``ServingEngine(backbone="clip", checkpoint=<run>/best)`` bitwise
    equal to the engine on the weights the run held; (e) ``pretrain()``
    (the vision tower, the 12-layer text tower, the vendored BPE) over 64
    captioned fixture rows, batches of 16, two micro-batches an update,
    4 micro-steps: K6 exactly 24 a micro-step, only ``visual_projection``
    and ``logit_scale`` moved, ``step_0000002`` and ``last`` written and
    reloaded; ``pretrain_step`` p50 and peak memory; (f) the port's
    tokenizer (a stdlib word scanner) gives the JAX tokenizer's recorded
    ids (``BPE_GOLDEN``);
31. the TinyViT country finetune at TinyViT-5M-224 (temp directories;
    no pandas): (a) seeded geocell pickles of three countries loaded by
    the port's ``GeocellManager`` and its ``build_centroid_table`` tool;
    (b) 321 fixture rows labelled by ``prepare_country_dataset`` (256
    train, 64 validation); (c) ``finetune()`` at full width (bf16 compute,
    f32 master weights) for 4 steps of 64 with every launch counter at 0
    first: finite losses, K4 exactly 10 launches a step and no other
    kernel, none in the validation forward, finite top-1 / top-5,
    ``best/`` and ``class_map.json`` written and ``best`` reloaded giving
    the in-memory model's eval logits bit for bit; the step's p50
    (synchronised), the loop's p50 and peak memory; (d) one B=4 finetune
    step on the card in bf16 against the CPU in f32 and bf16 under phase
    9's gates, then in f32 against the CPU in f32 under phase 26's gates
    (K4 exactly 10 launches, no other kernel); (e) K4 at the finetune's
    three ragged shapes (W, N, H) =
    (1024, 49, 4), (64, 196, 5), (64, 49, 10) against its plain version,
    timed beside SDPA's backward, with the bound of the real and of the
    padded work; (f) ``extract_embeddings`` on the card against the CPU
    f32 forward (cosine >= 0.999 a row), the ``build_prototype_bank``
    tool's bank functions on them, ``extract_embeddings_parquet``'s ImportError
    where pandas is absent; the phase under 90 s;
32. training off the object store, in a temp directory holding a file://
    bucket (``GEO_TPU_STORE_URL``), ``GEO_TPU_CKPT_DIR`` and the fetch
    cache; no network: (a) ``collect_points`` over 48 seeded points in two
    polygons with a fetch function answering the fixture JPEGs, into a
    ledger, 16 holdout panoramas by ``ingest_local_folder``, both
    snapshots merged, the same points again collecting none; (b)
    ``build_sqlite_from_snapshot`` of both: the snapshots' keys with the
    store's bytes; (c) ``main_streaming`` at full width (TinyViT-21M-512
    bf16, B=16, one epoch of 3 steps, the holdout validating) against
    ``train()`` on (b)'s SQLites: K1-K5 exactly phase 8's counts for 3
    steps and a validation forward and no other kernel in each, the same
    step and validation losses to RESUME_LOSS_RTOL, the fetch cache one
    file a snapshot key, ``last`` and ``best`` written; both runs' step
    p50 (synchronised), loop p50 and peak memory beside phase 8's loop
    p50; (d) ``best`` uploaded to the registry: ``run_benchmark(
    clip_checkpoint_index=0)`` gives ``run_benchmark(checkpoint=best)``'s
    guesses bit for bit; after a newer upload, index 1 gives ``best``
    again; (e) ``PanoramaStream`` over the holdout snapshot bitwise
    ``PanoramaBatchIterator`` over its SQLite rows, and host panos/s with
    the cache cold, warm and from the SQLite; (f)
    ``download_random_panorama(seed=)`` guessed by the TinyViT engine
    bitwise as the ingested files, and the inference entry point's
    fallback (no images, no fixture) printing the guess of the panorama it
    downloaded; the phase under 60 s;
33. two ranks on the one card over gloo (``parallel.mesh.spawn_ranks``, a
    ``file://`` rendezvous; NCCL refuses two ranks on one device), each
    driving the full-width TinyViT-21M-512 (seeded weights): (a) MESH_STEPS
    data-axis ``train_step``s of its 8 panoramas of the 16-panorama
    fixture batch with the launch counters at 0 first: K1-K5 exactly
    LAUNCHES_PER_TRAIN_STEP a step and no other kernel, each step's loss
    equal on both ranks and within TRAIN_LOSS_RTOL of one process's on
    the whole batch on the same card, the first step's averaged gradient
    at cosine >= TRAIN_GRAD_MIN_COSINE to one process's in every
    top-level module, BatchNorm's running statistics bitwise equal across
    the ranks; the gradient all-reduce timed alone; (b) a dp=2
    ``Embedder`` (``bulk_embed_config()``) over 2 x 64 seeded images
    against one process's at cosine >= 0.999 a row; (c) one model-axis
    step (mp=2: the cell layer split, fc1 / fc2 a Megatron pair, qkv /
    proj gathered before K1-K3; all collectives are all-reduces, which
    gloo carries on CUDA tensors) at B=4 with exact launches, against one
    process under (a)'s gates; the phase under 60 s.  Its times are two
    ranks sharing one card, not a multi-card measurement;
34. the window-attention tile knobs (``ops/window_attention.py``
    ``TILE_KNOBS``; ``phase_tile_knobs``): (a) the wrapper's plan mirror
    of every call of the phase against each library's CUDA plan query,
    and SMEM_LIMIT_BYTES at 48 KiB refusing every bf16 core call with
    ValueError before a launch; (b) K1-K5, K7-K9 at production shapes
    with every knob set to its default bitwise equal to the knobs
    untouched; (c) BWD_Q_ROWS 64 (K4 at the train and the TinyViT-5M-224
    shapes, K5 and K7 at stage 2), FWD_Q_ROWS 128 (K1-K3, K8a, K8b, K9),
    FUSED_BLOCK_WB 8 under a 32 MiB budget (K1, K9) and BWD_PARTIAL_BYTES
    4 MiB (K4 stage 3) against the plain versions (max |err| / max |ref| <=
    2e-2), one launch a call, bitwise over two calls, timed beside the
    default and the library call; (d) ``tools.exp_r4_vmem``'s
    ``s2bq1024_v64`` and ``train_both_v64`` in subprocesses, one timed call
    or step each (result "ok"; the embed case's first 8 embeddings at
    cosine >= 0.999 to a default-knob run here); the phase under 90 s;
35. print the kernel JSON line, then ``{"ok": true, "device": ...}`` last.

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
    unique = {}
    for name in _build.SIGNATURES:
        unique[name] = _gnu_unique_symbols(_build.library_path(name))
        if unique[name]:
            log(f"GNU-unique symbols of {name}: {unique[name]}")
    log(f"GNU-unique symbols exported: {sum(map(len, unique.values()))} in "
        f"{len(unique)} libraries")
    if any(unique.values()):
        fail("a library exports GNU-unique symbols: one object across the "
             "libraries of a process (give the function internal linkage)")


def _gnu_unique_symbols(path):
    """The symbols ``nm -D --defined-only`` marks ``u`` (GNU unique) in the
    shared library at ``path``: a function-local static of an inline or
    template function with external linkage, which the dynamic linker makes
    one object across every library of the process that defines it."""
    out = subprocess.run(["nm", "-D", "--defined-only", "-C", str(path)],
                         capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nm failed on {path}: {out.stderr.strip()}")
    return [line.split(" ", 2)[2] for line in out.stdout.splitlines()
            if line.split(" ")[1:2] == ["u"]]


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
        return (torch.randn(*shape, generator=gen, device=gen.device) * std
                + mean).to(dev)

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
        launch_ms = None
        # the Hopper cores: every output element from one thread in an
        # order fixed by the shape
        stable = torch.equal(got, kern(*args))
        log(f"{kernel} {label}: bitwise equal over two calls {stable}")
        if not stable:
            fail(f"{kernel} {label}: two calls on the same inputs gave "
                 f"different bits")
        if kernel in ("K1", "K2"):
            launch_ms = _launch_ms(lambda: kern(*args))
            log(f"{kernel} {label} launch_ms (device, torch.profiler) " + (
                ", ".join(f"{k} {v:.4f}" for k, v in launch_ms.items())
                if launch_ms else "not measured (the trace holds no device "
                "kernels)"))
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
            bound_ms=bound, bound_by=bound_by, launch_ms=launch_ms)
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


def profiled_ms(fn, calls: int = 5):
    """Device time of one fn() call as the sum of the device kernels'
    times in a torch.profiler trace of ``calls`` calls (after a warm-up),
    over the calls; None when the trace holds no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.time_range.elapsed_us() for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / calls if us else None


def _sdpa_bwd_ms(qkv, bias, g, scale, H):
    """The backward of one scaled_dot_product_attention call on the same
    q, k, v and an (H, N, N) bias that requires grad, as device time:
    forward+backward minus forward, each by ``device_time_ms`` (calls
    captured in one CUDA graph and replayed, so the host's launch rate
    stays outside the timed window), or where capture fails by the sum of
    the profiler's device kernel times (``profiled_ms``).  The yardstick
    only; the port never calls it.  Returns (ms or None, what was timed or
    why not)."""
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

    def both():
        return torch.autograd.grad(fwd(), (q, k, v, b), go)

    try:
        both()
    except RuntimeError as e:
        return None, ("no SDPA backend takes a bias gradient here: "
                      + str(e).splitlines()[0][:160])
    what = ("scaled_dot_product_attention forward+backward minus forward, "
            "bias requires grad, device time")
    try:
        return (device_time_ms(both, iters=5) - device_time_ms(fwd, iters=5),
                what + " (one CUDA graph of 5 calls, replayed 5 times)")
    except RuntimeError as e:
        torch.cuda.synchronize()
        fb, f = profiled_ms(both), profiled_ms(fwd)
        if fb is None or f is None:
            return None, ("not measured: graph capture failed ("
                          + str(e).splitlines()[0][:120] + ") and the "
                          "profiler's trace holds no device kernels")
        return fb - f, what + (" (torch.profiler's kernel sum; graph capture "
                               "failed: " + str(e).splitlines()[0][:120]
                               + ")")


def _rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def _bwd_plan(kernel, W, N, H, dtype=torch.bfloat16):
    """What one K4, K5 or K7 call launches at (W, N, H), as a log line: the
    Hopper core's kind (bf16, or f32), its window groups G
    (``_bwd_groups``; one for K5), the items of each of its persistent
    launches and their grid (one block of 384 threads an SM at most)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    Np = -(-N // 64) * 64
    G = 1 if kernel == "K5" else wa._bwd_groups(W, Np, H)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    items = wa._bwd_items(W, Np, H, G)
    grid = {k: min(n, sms) for k, n in items.items()}
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    return (f"{kind} core: G={G} window groups; items {items}; grid "
            f"{grid} x 384 threads" + (" + the sum of the G partials"
                                       if G > 1 else ""))


#: The launches of K4's and K7's bf16 core by kernel name.
_BWD_LAUNCH_NAMES = ("stats", "dkdv", "dq", "dbias")


def _launch_ms(fn, calls=3):
    """Device ms a call of each kernel that fn() launches, read from a
    torch.profiler trace of ``calls`` calls after a warm-up (its device
    events, as profile_forward reads them): the bf16 backward core's
    launches by role (``attn_bwd_sm90<HD, MODE, ...>``), the sum of the
    d_bias partials, the LayerNorm + GEMM core's by kind
    (``ln_gemm_sm90<KB, KIND, MAP>``: the qkv GEMM or the out-projection),
    the GEMM core's (``gemm_sm90<KIND, BN>``, K11's out-projection) as
    proj_gemm, the forward core's and K6's kernel as the attention, and
    any other kernel by its name;
    each a call's, over the calls the trace holds.  None when the trace
    holds no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, counts = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = evt.name
        if "attn_bwd_sm90<" in key or "attn_bwd_f32_sm90<" in key:
            key = _BWD_LAUNCH_NAMES[int(key.split("<")[1].split(",")[1])]
        elif "dbias_reduce" in key:
            key = "dbias_sum"
        elif "ln_gemm_sm90<" in key:
            key = ("qkv_gemm", "proj_gemm")[
                int(key.split("<")[1].split(",")[1])]
        elif "gemm_sm90<" in key:  # the GEMM core: K11's projection
            key = "proj_gemm"
        elif "attention_fwd_sm90<" in key or "clip_flash_sm90<" in key:
            key = "attention"
        else:
            key = key.split("(")[0].split("<")[0].replace("void ", "")
        out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3
        counts[key] = counts.get(key, 0) + 1
    if not out:
        return None
    # a trace can come back holding fewer than ``calls`` calls: divide by
    # the calls it holds, the fewest launches of any one kernel
    traced = min(min(counts.values()), calls)
    return {k: v / traced for k, v in out.items()}


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
#: Stage 1's channels and heads (hd 32).
STAGE1_C, STAGE1_HEADS = 192, 6


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
    loop_p50 = float(np.median(loop_ms))
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
    return launches, loop_p50


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


def _step_disagreements(gl, gg, cl, cg, bl, bg):
    """The loss and each top-level module's gradient of a train step on
    the card in bf16 (gl, gg) against the CPU's in f32 (cl, cg) and in
    bf16 (bl, bg), logged, under TRAIN_LOSS_RTOL and the gradient gates;
    returns what fails them."""
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
    return bad


def phase_train_vs_cpu(fields=None):
    gl, gg, gs = _train_step_grads("cuda", "bfloat16", fields)
    cl, cg, cs = _train_step_grads("cpu", "float32", fields)
    bl, bg, bs = _train_step_grads("cpu", "bfloat16", fields)
    bad = _step_disagreements(gl, gg, cl, cg, bl, bg)
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


def _core_of_k6(qkv, w, scale, H):
    """The GEMM core applied to K6's output: K13's bf16 kind (K11's
    mainloop, an f32 output) on ``_flash_cuda``'s o, padded with zero rows
    to whole 128-row tiles as K13 takes them, rounded to bf16 as the core's
    bf16 kind rounds; the rows past B N add nothing to the others."""
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    B, N, D = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    o = ca._flash_cuda(qkv, scale, H).reshape(B * N, D)
    padded = torch.zeros(-(-(B * N) // 128) * 128, D, dtype=o.dtype,
                         device=o.device)
    padded[:B * N] = o
    c = tg._tiled_matmul_cuda(padded, w.to(o.dtype), torch.float32)
    return c[:B * N].to(torch.bfloat16).reshape(B, N, D)


def _k11_trace(B, N, D, H, tries=3):
    """K11's launches at (B, N, D, H) by device time (``_launch_ms``), on
    seeded inputs: the first of ``tries`` traces that holds both its
    launches, or the last one."""
    from geoguessr_ai_torch.ops import clip_attention as ca

    gen = torch.Generator().manual_seed(SEED + 3)
    qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(D, D, generator=gen) * D ** -0.5).to(
        "cuda", torch.bfloat16).t().contiguous().t()
    for _ in range(tries):
        split = _launch_ms(
            lambda: ca._flash_proj_cuda(qkv, w, (D // H) ** -0.5, H))
        if split and {"attention", "proj_gemm"} <= set(split):
            break
    return split


def _k11_launch_split(case):
    """K11's two launches, the attention and the projection, by device time
    at ``case`` (B, N, D, H), traced in a process of its own: torch.profiler
    traces of K11 taken late in a run of every phase, or after another
    trace of it in the same process, have come back empty.  Fails unless
    the trace holds both launches."""
    code = ("import json, chip_smoke as cs; "
            f"print(json.dumps(cs._k11_trace(*{tuple(case)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        fail(f"K11 {case}: its launch trace failed:\n{out.stderr[-3000:]}")
    split = json.loads(out.stdout.strip().splitlines()[-1])
    if not split or not {"attention", "proj_gemm"} <= set(split):
        fail(f"K11 {case}: the trace holds not both its launches: {split}")
    return split


def phase_clip_kernels():
    import torch.nn.functional as F

    from geoguessr_ai_torch.ops import clip_attention as ca

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for kernel, label, B, N, D, H in CLIP_CASES:
        hd = D // H
        scale = hd ** -0.5
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        # w_proj in (in, out) layout as the CLIP tower hands it over: the
        # transpose view of the (out, in) weight, which K11 reads as it is
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to(
            "cuda", torch.bfloat16).t().contiguous().t()
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
        extra = {}
        if kernel == "K11":
            # K6's kernel, then the GEMM core on its output: bit for bit
            # the core applied to K6's output, and the same bits twice
            stable = torch.equal(got, kern(*args))
            same = torch.equal(got, _core_of_k6(qkv, w, scale, H))
            log(f"K11 {label}: bitwise equal over two calls {stable}, "
                f"bitwise equal to the GEMM core on K6's output {same}")
            if not (stable and same):
                fail(f"K11 {label}: stable {stable}, equal to the core on "
                     f"K6's output {same}")
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
        mm_ms = kernel_ms(lambda: o @ w)
        sdpa_mm_ms = sdpa_ms + mm_ms
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
        if kernel == "K11":
            # cuBLAS's o @ w as the projection's yardstick (the port never
            # calls it)
            extra["matmul_ms"] = mm_ms
            log(f"  yardstick: cuBLAS o @ w {mm_ms:.4f} ms (SDPA "
                f"{sdpa_ms:.4f} ms)")
        if not (finite and rel <= KERNEL_REL_TOL):
            fail(f"{kernel} {label}: kernel disagrees with its plain version "
                 f"(rel {rel:.3g}, finite {finite})")
        rows[(kernel, label)] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
            sdpa_mm_ms=sdpa_mm_ms, bound_ms=bound, bound_by=bound_by, **extra)
        del qkv, w, args, q, k, v, o
        torch.cuda.empty_cache()
    for kernel, label, B, N, D, H in CLIP_CASES:
        if kernel == "K11":
            split = _k11_launch_split((B, N, D, H))
            log(f"K11 {label} launch_ms (device, torch.profiler, a process "
                "of its own) " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in split.items()))
            rows[("K11", label)]["launch_ms"] = split
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


def _mbconv_inputs(B, gen, dtype=torch.bfloat16, C=MB_C, E=MB_E):
    """x and conv weights in the compute dtype, in the JAX layouts
    (transposed views of the stored OI ones, as the model passes them) and
    folded BN pairs; stage 0's C and E unless given."""
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to("cuda")

    def folded(n):
        return fold_bn(randn(n, std=0.1, mean=1.0), randn(n, std=0.1),
                       randn(n, std=0.1), randn(n, std=0.1, mean=1.0).abs())

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
    C, H, N = STAGE1_C, STAGE1_HEADS, STAGE1_WINDOW ** 2
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


def _k9_equals_k1(got, args, label=""):
    """Fails unless K9's output ``got`` on ``args`` (``_fb4d_cuda``'s)
    equals K1's on the partitioned map bit for bit: in bf16 both run the
    same GEMM and attention instances over the same window-ordered rows and
    window groups."""
    from geoguessr_ai_torch.ops import window_attention as wa

    x4, weights, (scale, heads, window, eps) = args[0], args[1:8], args[8:]
    k1 = wa.window_unpartition(
        wa._fused_block_cuda(wa.window_partition(x4, window), *weights,
                             scale, heads, eps), window, x4.shape[1:3])
    same = torch.equal(got, k1)
    log(f"K9 {tuple(x4.shape)}{label}: equal to K1 on the partitioned map "
        f"bit for bit {same}")
    if not same:
        fail(f"K9 {tuple(x4.shape)}{label}: differs from K1 on the "
             f"partitioned map")


def phase_embed_kernels():
    rows = {}
    gen = torch.Generator().manual_seed(SEED + 4)
    for kernel in ("K10", "K9"):
        for images in EMBED_KERNEL_IMAGES:
            kern, plain, args, bound, bound_by, lib_ms, lib_what = \
                _embed_kernel_case(kernel, images, gen)
            got = kern(*args)
            torch.cuda.synchronize()
            # the Hopper kernels: every output element from one thread in an
            # order fixed by the shape
            stable = torch.equal(got, kern(*args))
            log(f"{kernel} {images} images: bitwise equal over two calls "
                f"{stable}")
            if not stable:
                fail(f"{kernel} {images} images: two calls on the same "
                     f"inputs gave different bits")
            launch_ms = None
            if kernel == "K9":
                if images == EMBED_KERNEL_IMAGES[0]:
                    scale = (STAGE1_C // STAGE1_HEADS) ** -0.5
                    _k9_equals_k1(got, (*args, scale, STAGE1_HEADS,
                                        STAGE1_WINDOW, 1e-5))
                launch_ms = _launch_ms(lambda: kern(*args))
                log(f"K9 {images} images launch_ms (device, torch.profiler) "
                    + (", ".join(f"{k} {v:.4f}" for k, v in launch_ms.items())
                       if launch_ms else "not measured (the trace holds no "
                       "device kernels)"))
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
                lib_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                launch_ms=launch_ms)
            del args
            gc.collect()
            torch.cuda.empty_cache()
    _mbconv_other_channels(gen)
    _reset_all_launches()
    return rows


#: (C, E) of K10's other channel counts, at MB_OTHER_IMAGES images.
MB_OTHER_CHANNELS = ((64, 256), (32, 128))
MB_OTHER_IMAGES = 4


def _mbconv_other_channels(gen):
    """K10 at C = 64 and 32 against its plain version (the kernel's other
    instances: one 64-channel box, one 32-channel box with the 64-byte
    swizzle)."""
    from geoguessr_ai_torch.ops import mbconv

    for C, E in MB_OTHER_CHANNELS:
        args = _mbconv_inputs(MB_OTHER_IMAGES, gen, C=C, E=E)
        got = mbconv._mbconv_cuda(*args, False)
        again = mbconv._mbconv_cuda(*args, False)
        torch.cuda.synchronize()
        want = mbconv._mbconv_plain(*args, False)
        max_abs, rel = _rel_err(got, want)
        finite = bool(torch.isfinite(got).all())
        stable = torch.equal(got, again)
        log(f"K10 C={C} E={E} {MB_OTHER_IMAGES} images: max_abs_err "
            f"{max_abs:.6g} max_rel_err {rel:.6g} (tolerance "
            f"{KERNEL_REL_TOL}), bitwise equal over two calls {stable}")
        if not (finite and stable and rel <= KERNEL_REL_TOL):
            fail(f"K10 C={C}: kernel disagrees with its plain version (rel "
                 f"{rel:.3g}, finite {finite}, stable {stable})")
        del args, got, again, want


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


def _write_fixture_sqlite(path, blobs, rows):
    """A raw SQLite dataset of ``rows`` images: the four fixture JPEGs
    repeated, four headings a location at seeded coordinates."""
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    rng = np.random.default_rng(SEED)
    coords = rng.uniform((-60.0, -180.0), (70.0, 180.0), (rows // 4 + 1, 2))
    create_sqlite_from_records(path, (
        {"location_id": f"loc{i // 4:05d}", "lat": coords[i // 4, 0],
         "lon": coords[i // 4, 1], "heading": 90 * (i % 4),
         "image": blobs[i % 4]} for i in range(rows)))


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
    from geoguessr_ai_torch.data.sqlite_dataset import read_embeddings

    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    bb = BackboneConfig.tinyvit()
    emb = Embedder(bb, model_config=bulk_embed_config(), seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "raw.sqlite")
        out = os.path.join(tmp, "emb.sqlite")
        _write_fixture_sqlite(src, blobs, EMBED_ROWS)
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
#: K8b's bf16 output bits (``k8b_bits``) at stages 1 and 3 of the
#: head-major serving path at a bucket of 16, as the kernel gave them
#: before K3 and K8a shared its core (commit cb69073, on the H100).
K8B_BITS = {(1024, 6, 256): "4e27000f462493e8",
            (64, 18, 256): "9c4ce39319439d49"}


def k8b_bits(W, H, N, seed=11):
    """The first 16 hex digits of the SHA-256 of K8b's bf16 output on q, k,
    v and an f32 bias made by numpy from ``seed`` (hd 32)."""
    import hashlib

    from geoguessr_ai_torch.ops import window_attention as wa

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((W, H, N, 32),
                                                    dtype=np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal(
        (H, N, N), dtype=np.float32) * 0.5).to("cuda")
    out = wa._attention_batched_cuda(q, k, v, bias, 32 ** -0.5)
    torch.cuda.synchronize()
    return hashlib.sha256(
        out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


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


def _headmajor_plan(W, H, N):
    """What one bf16 K8b call launches at (W, H, N), as a log line: the
    Hopper kernel's window groups G (``_headmajor_groups``), the windows
    an item walks, its (64-query tile, group, head) items and its grid
    (one block of 384 threads an SM at most)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    G = wa._headmajor_groups(W, H, N)
    items = wa._headmajor_items(W, H, N, G)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"bf16 Hopper kernel: G={G} window groups of {W // G}-"
            f"{-(-W // G)} windows; {items} items (64-query tile, group, "
            f"head); grid {min(items, sms)} x 384 threads, "
            f"{items / min(items, sms):.2f} items a block")


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
        stable = torch.equal(got, kern(*args))
        log(f"{kernel} {label}: bitwise equal over two calls {stable}")
        if not stable:
            fail(f"{kernel} {label}: two calls on the same inputs gave "
                 "different bits")
        want = wa._attention_plain(*args)
        max_abs, rel = _rel_err(got, want)
        finite = bool(torch.isfinite(got).all())
        del got, want
        ms = kernel_ms(lambda: kern(*args))
        plain_ms = cuda_time_ms(lambda: wa._attention_plain(*args), iters=3)
        lib_ms, lib_what = _headmajor_sdpa_ms(*args)
        bound, bound_by = _headmajor_bound_ms(W, H, N)
        log(f"{kernel} {label} W={W} H={H} N={N} (f32 bias)")
        if kernel == "K8b":
            log(f"  {_headmajor_plan(W, H, N)}")
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

    for (W, H, N), want in K8B_BITS.items():
        got = k8b_bits(W, H, N)
        log(f"K8b W={W} H={H} N={N}: output bits {got} (expected {want}, "
            "its bits before the forward core was shared)")
        if got != want:
            fail(f"K8b W={W} H={H} N={N}: its output bits changed")

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
        if ref_name == "K5":
            # one window group here, so K7 runs K5's launches
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            log(f"  d_qkv and d_bias bitwise equal to K5's: {same}")
            if not same:
                fail("K7: d_qkv or d_bias differs from K5's bits")
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
    worst, equal = 1.0, 0
    for n in leaves:
        a, b = two[5][n], merged[5][n]
        leaf_cos = _cosine(a, b)
        worst = min(worst, leaf_cos)
        equal += torch.equal(a, b)
        _, leaf_rel = _rel_err(a, b)
        log(f"  {n}: cosine {leaf_cos:.8f} max_rel_err {leaf_rel:.3g} "
            f"bitwise equal {torch.equal(a, b)}")
    log(f"  stage-2 attention leaves: {len(leaves)}, lowest cosine "
        f"{worst:.8f} (>= {K7_GRAD_MIN_COSINE}), bitwise equal {equal} "
        f"(all: K5 and K7 run the same core at one window group)")
    if rel > K7_LOSS_RTOL or cos < K7_GRAD_MIN_COSINE \
            or worst < K7_GRAD_MIN_COSINE:
        fail("the K7 train step disagrees with the K5 one")
    if equal != len(leaves):
        fail("the K7 train step's stage-2 attention leaves are not the K5 "
             "step's bits")
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
        if kernel in ("K4", "K5", "K7"):
            log(f"{kernel}@hd{hd} W={W} N={N} H={H}: "
                f"{_bwd_plan(kernel, W, N, H)}")
        kern, plain, args = _head_dim_case(kernel, hd, W, N, C, H, gen)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        if kernel == "K9":
            _k9_equals_k1(got, args, f" at head dim {hd}")
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
            + f" ({_bwd_plan(kernel, W, N, H)})")
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


#: K12 at its other channel counts on a ragged map: (C, E), then (B, H, W).
EXP_OTHER_CHANNELS = ((32, 128), (64, 256), (96, 384))
EXP_OTHER_SHAPE = (3, 48, 40)


def _exp_mbconv_inputs(B, gen, C=MB_C, E=MB_E, H=MB_MAP, W=MB_MAP):
    """The JAX benchmark's inputs: x * 0.5, weights and biases * 0.1."""
    def t(shape, scale, dtype):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    bf, f32 = torch.bfloat16, torch.float32
    return (t((B, H, W, C), 0.5, bf), t((C, E), 0.1, bf),
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


def _exp_mbconv_check(what, args, images):
    """K12a and K12b on args against the plain mirror: each bitwise equal
    over two calls, K12b bitwise equal to K12a.  Returns (max_abs_err,
    max_rel_err) of K12a."""
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm

    got = fm._fused_mbconv_cuda(*args)
    again = fm._fused_mbconv_cuda(*args)
    got2 = fm._fused_mbconv_cuda(*args, v2=True)
    again2 = fm._fused_mbconv_cuda(*args, v2=True)
    torch.cuda.synchronize()
    stable_a, stable_b = torch.equal(got, again), torch.equal(got2, again2)
    same = torch.equal(got, got2)
    del again, again2, got2
    want = _sliced(fm._fused_mbconv_plain, args, images)
    max_abs, rel = _rel_err(got, want)
    finite = bool(torch.isfinite(got).all())
    del got, want
    log(f"K12a / K12b {what}: max_abs_err {max_abs:.6g} max_rel_err "
        f"{rel:.6g} (tolerance {KERNEL_REL_TOL}); bitwise equal over two "
        f"calls: K12a {stable_a}, K12b {stable_b}; K12b bitwise equal to "
        f"K12a {same}")
    if not (finite and rel <= KERNEL_REL_TOL and stable_a and stable_b
            and same):
        fail(f"K12 {what}: rel {rel:.3g}, finite {finite}, stable K12a "
             f"{stable_a} K12b {stable_b}, K12b equal to K12a {same}")
    return max_abs, rel


def phase_experimental():
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg
    from geoguessr_ai_torch.tools import exp_int8_gemm

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 8)
    for C, E in EXP_OTHER_CHANNELS:
        B, H, W = EXP_OTHER_SHAPE
        with torch.inference_mode():
            _exp_mbconv_check(f"C={C} E={E} x {(B, H, W, C)}",
                              _exp_mbconv_inputs(B, gen, C, E, H, W), B)
    for images in EXP_MBCONV_IMAGES:
        args = _exp_mbconv_inputs(images, gen)
        with torch.inference_mode():
            max_abs, rel = _exp_mbconv_check(f"{images} images", args, images)
            ms_a = cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args))
            ms_b = cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args,
                                                               v2=True))
            plain_ms = cuda_time_ms(
                lambda: _sliced(fm._fused_mbconv_plain, args, images),
                iters=2)
            chain_ms = _exp_chain_ms(args)
        bound, bound_by = _mbconv_bound_ms(images)
        log(f"  K12a kernel_ms {ms_a:.4f}, K12b kernel_ms {ms_b:.4f}, "
            f"plain_ms {plain_ms:.4f}, cudnn_chain_ms {chain_ms:.4f}, "
            f"bound_ms {bound:.4f} ({bound_by})")
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
            # b as the kernel reads it, K-major (the transpose view of an
            # (N, K) tensor), made once outside the timing; from the (K, N)
            # b the wrapper makes that copy at every call
            bk = b.t().contiguous().t()
            got = tg._tiled_matmul_cuda(a, bk, out_dtype)
            want = tg._tiled_matmul_plain(a, b, out_dtype)
            stable = torch.equal(got, tg._tiled_matmul_cuda(a, bk, out_dtype))
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
            ms = kernel_ms(lambda: tg._tiled_matmul_cuda(a, bk, out_dtype))
            kn_ms = kernel_ms(lambda: tg._tiled_matmul_cuda(a, b, out_dtype))
            plain_ms = cuda_time_ms(
                lambda: tg._tiled_matmul_plain(a, b, out_dtype), iters=2)
            lib, lib_what = _k13_library(a, b, int8)
            lib_ms = kernel_ms(lib)
            bound, bound_by, t_bytes, t_ops = _k13_bound_ms(M, K, N, int8)
            ops = 2.0 * M * K * N
            tops[kind] = (ops / ms / 1e9, ops / lib_ms / 1e9)
            log(f"K13 {kind} (M, K, N) = ({M}, {K}, {N}): "
                + (f"int32 exactly equal to the plain product {ok}"
                   if int8 else f"max_rel_err {rel:.6g} (tolerance "
                                f"{KERNEL_REL_TOL})")
                + f"; bitwise equal over two calls {stable}")
            log(f"  kernel_ms {ms:.4f} ({tops[kind][0]:.1f} TOPS), plain_ms "
                f"{plain_ms:.4f}, library_ms {lib_ms:.4f} ({lib_what}, "
                f"{tops[kind][1]:.1f} TOPS), bound_ms {bound:.4f} "
                f"({bound_by}: bytes {t_bytes:.4f} ms, operations "
                f"{t_ops:.4f} ms); from the (K, N) b, with the wrapper's "
                f"transpose copy, {kn_ms:.4f}")
            if not (ok and stable):
                fail(f"K13 {kind} ({M}, {K}, {N}) disagrees with its plain "
                     f"version (rel {rel:.3g}) or between two calls "
                     f"(stable {stable})")
            rows[("K13", kind, (M, K, N))] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, lib_ms=lib_ms,
                lib_what=lib_what, tops=tops[kind][0], kn_ms=kn_ms)
            del a, b, bk
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
    launches.update({f"K13 {k}": n for k, n in tg.LAUNCHES_BY_TYPE.items()})
    log(f"experimental entry points: launches {launches}")
    for k in ("K12a", "K12b", "K13"):
        if not launches[EXP_META[k][0]]:
            fail(f"{k} was not launched by its entry point")
    for k in ("K13 int8", "K13 bf16"):
        if not launches[k]:
            fail(f"{k} was not launched by its entry point")
    torch.cuda.empty_cache()
    return rows, {**{k: launches[m[0]] for k, m in EXP_META.items()},
                  **{k: n for k, n in launches.items()
                     if k.startswith("K13 ")}}


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
    from geoguessr_ai_torch.data.sqlite_dataset import read_embeddings

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

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "raw.sqlite")
        dst = os.path.join(tmp, "emb.sqlite")
        _write_fixture_sqlite(src, blobs, EMBED_ROWS)
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
#: the embed batch of 512 images), as the bf16 phases run it, and K4 at
#: the B=64 finetune's TinyViT-5M-224 shapes (FT_K4_CASES; N padded to 64
#: inside the wrapper).
F32_CASES = (
    ("K1", "stage1", (1024, 256, 192, 6)),
    ("K1", "embed_stage3", (64, 256, 576, 18)),
    ("K2", "stage2", (64, 1024, 384, 12)),
    ("K3", "stage3", (64, 256, 576, 18)),
    ("K4", "stage1", (1024, 256, 6)),
    ("K4", "stage3", (64, 256, 18)),
    ("K4", "5m224_stage1", (1024, 49, 4)),
    ("K4", "5m224_stage2", (64, 196, 5)),
    ("K4", "5m224_stage3", (64, 49, 10)),
    ("K5", "stage2", (64, 1024, 12)),
    ("K7", "stage2", (64, 1024, 12)),
    ("K8a", "stage2_bucket16", (64, 12, 1024)),
    ("K8b", "stage1_bucket16", (1024, 6, 256)),
    ("K8b", "stage3_bucket16", (64, 18, 256)),
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


def _f32_bwd_checks(kernel, label, shape, kern, args, got):
    """K4's, K5's and K7's f32 entries (the backward core's f32 kind): the
    plan mirror against the CUDA plan query, two calls bitwise equal, and
    at K5's stage 2 K7's call on the same inputs bitwise K5's (one window
    group, t in a second pass: the same launches).  Returns a log line."""
    from geoguessr_ai_torch.ops import window_attention as wa

    W, N, H = shape
    Np = -(-N // 64) * 64
    what = _knob_plan_check(kernel, (W, Np, H, None),
                            wa._knobs_for(kernel, torch.float32), elem=4)
    again = kern(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{kernel} f32 {label}: two calls differ")
    del again
    line = f"f32 kind: {what}; bitwise over two calls"
    if kernel == "K5":
        k7 = wa._attention_bwd_qtiled_cuda(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, k7))
        line += f"; K7 on these inputs bitwise K5's: {same}"
        if not same:
            fail(f"K7 f32 at {shape} differs from K5 f32 (one window group)")
    return line


def phase_f32_kernels():
    rows = {}
    gen = torch.Generator().manual_seed(SEED + 10)
    for kernel, label, shape in F32_CASES:
        kern, plain, args, bound, bound_by, lib = _f32_case(kernel, shape,
                                                            gen)
        got = kern(*args)
        torch.cuda.synchronize()
        bwd_line = (_f32_bwd_checks(kernel, label, shape, kern, args, got)
                    if kernel in ("K4", "K5", "K7") else None)
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
        # the backward core's f32 kind as device time (a loop between two
        # events reads the wrapper's host work at the 5M-224 shapes)
        ms = (device_time_ms(lambda: kern(*args))
              if bwd_line else cuda_time_ms(lambda: kern(*args), iters=5))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=2)
        lib_ms, lib_what = (None, "") if lib is None else lib()
        log(f"{kernel} f32 {label} {shape}: max_abs_err "
            + ", ".join(f"{e[0]:.6g}" for e in errs) + " max_rel_err "
            + ", ".join(f"{e[1]:.6g}" for e in errs)
            + f" (tolerance {F32_REL_TOL})")
        if bwd_line:
            log(f"  {_bwd_plan(kernel, shape[0], shape[1], shape[2], torch.float32)}")
            log(f"  {bwd_line}")
            _log_launch_ms(_launch_ms(lambda: kern(*args)))
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


def _f32_step_gates(label, gl, gg, cl, cg, launches, want, stats=None):
    """A step on the card in f32 (loss gl, gradients gg) against the CPU's
    f32 step (cl, cg), logged: the loss within F32_TRAIN_LOSS_RTOL, each
    top-level module's and each gradient leaf's cosine at least
    F32_TRAIN_GRAD_MIN_COSINE, the running statistics' lowest cosine
    (``stats``, where the step has them) too, and exactly the launches
    ``want``; fails otherwise."""
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
    log(f"{label} on the card vs the CPU f32 step: loss "
        f"{gl:.8f} / {cl:.8f} rel {rel:.3g} (<= {F32_TRAIN_LOSS_RTOL}); "
        f"lowest module gradient cosine {mod_cos[worst_mod]:.8f} "
        f"({worst_mod}); {len(leaves)} gradient leaves, lowest cosine "
        f"{cos[worst]:.8f} ({worst}; >= {F32_TRAIN_GRAD_MIN_COSINE}); "
        + ("" if stats is None else
           f"lowest running statistics cosine {stats:.8f}; ")
        + f"launches {launches}")
    log(f"  {len(floor)} leaves at the noise floor (norm < "
        f"{F32_NOISE_FLOOR} x {top:.4g}): " + ", ".join(
            f"{n} {float(cg[n].norm()):.3g}/{float(gg[n].norm()):.3g}"
            for n in floor))
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    if rel > F32_TRAIN_LOSS_RTOL or cos[worst] < F32_TRAIN_GRAD_MIN_COSINE \
            or mod_cos[worst_mod] < F32_TRAIN_GRAD_MIN_COSINE \
            or (stats is not None and stats < F32_TRAIN_GRAD_MIN_COSINE):
        fail(f"the {label} disagrees with the CPU f32 step")


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
        _f32_step_gates(f"f32 train step ({label})", gl, gg, cl, cg,
                        launches, want,
                        min(_cosine(gs[n], cs[n]) for n in cs))
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
# Phase 28: the rest of the guess path: checkpoint, resize, hierarchical
# fusion, member-bank refinement, the benchmark and the HTTP handlers
# ---------------------------------------------------------------------------

#: The full-scale refinement bank: the repo's 12647 cells, 8 prototypes a
#: cell at D = 576 (f32), 16 members a prototype reduced to 64 dims (f16).
BANK_PROTOS, BANK_MEMBERS, BANK_REDUCED = 8, 16, 64
REFINE_BATCH = 16
#: Concurrent submissions through the HTTP handlers.
API_SUBMISSIONS = 8
#: Panoramas benchmarked from the fixture SQLite's test split.
BENCH_SAMPLES = 16


def _export_reference_pt(model, config, path):
    """Writes a SuperGuessr's weights as the reference .pt layout through
    the port's exporters: the head by super_guessr_head_to_reference, the
    TinyViT by tinyvit_to_timm under ``base_model.backbone.``."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models.convert import to_jax_variables
    from geoguessr_ai_torch.models.torch_convert import (
        super_guessr_head_to_reference,
        tinyvit_to_timm,
    )

    v = to_jax_variables(model.state_dict(), num_heads=C.NUM_ATTENTION_HEADS)
    sd = super_guessr_head_to_reference(v["params"], C.NUM_ATTENTION_HEADS)
    bb = tinyvit_to_timm({"params": v["params"]["backbone"],
                          "batch_stats": v["batch_stats"]["backbone"]},
                         config)
    sd.update({f"base_model.backbone.{k}": a for k, a in bb.items()})
    torch.save({"model_state_dict": {k: torch.from_numpy(a)
                                     for k, a in sd.items()}}, path)
    return len(sd)


def _same_results(a, b):
    return all(np.array_equal(x.embedding, y.embedding)
               and (x.lat, x.lon, x.top_ids, x.top_probs)
               == (y.lat, y.lon, y.top_ids, y.top_probs)
               for x, y in zip(a, b))


def _model_logits(engine, views, mask):
    """The engine's model on (B, V, H, W, 3) views: f32 logits."""
    dev = engine.device
    pixels = _preprocess(engine, views)
    with torch.inference_mode():
        _, logits = engine.model(
            pixels, view_mask=None if mask is None
            else torch.from_numpy(mask).to(dev))
    return logits.float().cpu().numpy()


def _preprocess(engine, views):
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    return fused_preprocess(torch.from_numpy(views).to(engine.device),
                            *engine.norm, engine.image_size,
                            dtype=engine.config.dtype)


def _guess_checkpoint(tmp, paths):
    """(a) A .pt of the seeded weights, loaded into an engine of another
    seed, answers bitwise as the seeded engine does."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    cpu = ServingEngine(device="cpu", seed=SEED,
                        backbone_config=TinyViTConfig(dtype=torch.float32))
    pt = os.path.join(tmp, "model.pt")
    n = _export_reference_pt(cpu.model, cpu.config, pt)
    t0 = time.perf_counter()
    engine = ServingEngine(checkpoint=pt, seed=SEED + 1)
    load_s = time.perf_counter() - t0
    seeded = ServingEngine(seed=SEED)
    _, views = _fixture_views(engine)
    batch = np.repeat(views[None], 16, axis=0)
    mask = np.ones((16, 4), np.float32)
    mask[1::2, 2:] = 0.0
    same = (_same_results([engine.predict_images(paths)],
                          [seeded.predict_images(paths)])
            and _same_results(engine.predict_batch(batch, mask),
                              seeded.predict_batch(batch, mask)))
    log(f"(a) checkpoint: {n} tensors written by tinyvit_to_timm and "
        f"super_guessr_head_to_reference ({os.path.getsize(pt) / 1e6:.1f} "
        f"MB), ServingEngine(checkpoint=) built in {load_s:.2f} s, loaded "
        f"{engine.loaded}; fixture outputs bitwise equal to the seeded "
        f"engine's (bucket 1, and 16 with masks) {same}")
    if engine.loaded != {"head": 1, "backbone": True}:
        fail(f"checkpoint engine loaded {engine.loaded}")
    if not same:
        fail("the checkpoint engine's outputs differ from the seeded engine's")
    del seeded
    return engine, cpu, pt


def _guess_resize(engine, cpu, blobs):
    """(c) Views decoded at 640 and 384 px, resized on the device, against
    the CPU f32 engine resizing the same views; the resize's cost."""
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    for size in (640, 384):
        views = np.stack([decode_jpeg(b, size) for b in blobs])[None]
        got = engine.predict_batch(views)[0]
        ref = cpu.predict_batch(views)[0]
        cos = _view_cosines(got.embedding, ref.embedding)
        log(f"(c) views decoded at {size} x {size}, resized to 512 on the "
            f"device: min view cosine to the CPU f32 engine {cos.min():.6f} "
            f"(>= {MIN_COSINE}), top-1 cell gpu {got.top_ids[0]} cpu "
            f"{ref.top_ids[0]}")
        if cos.min() < MIN_COSINE or got.top_ids[0] != ref.top_ids[0]:
            fail(f"resized {size} px views disagree with the CPU f32 engine")
    host = {size: np.repeat(np.stack([decode_jpeg(b, size) for b in blobs])
                            [None], 16, axis=0) for size in (640, 512)}
    dev = {size: torch.from_numpy(v).cuda() for size, v in host.items()}
    mean, std = engine.norm
    resize_ms = cuda_time_ms(lambda: fused_preprocess(dev[640], mean, std,
                                                      512))
    same_ms = cuda_time_ms(lambda: fused_preprocess(dev[512], mean, std, 512))
    p640 = _p50_ms(lambda: engine.predict_batch(host[640]), reps=10)
    p512 = _p50_ms(lambda: engine.predict_batch(host[512]), reps=10)
    log(f"(c) fused_preprocess of 16 panoramas (64 views): 640 -> 512 "
        f"{resize_ms:.4f} ms, 512 (no resize) {same_ms:.4f} ms; "
        f"predict_batch p50 at 640 px {p640:.2f} ms, at 512 px {p512:.2f} ms")
    return {"resize_ms": resize_ms, "same_size_ms": same_ms,
            "p50_640_ms": p640, "p50_512_ms": p512}


def _guess_hierarchical(paths, views, mean_engine):
    """(b) The hierarchical engine (D = 576, 16 heads) against its CPU f32
    twin, its exact K1-K3 launches and its p50s beside mean fusion."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.engine import ServingEngine

    hier = ServingEngine(seed=SEED, hierarchical=True)
    cpu = ServingEngine(device="cpu", seed=SEED, hierarchical=True,
                        backbone_config=TinyViTConfig(dtype=torch.float32))
    batch = np.repeat(views[None], 16, axis=0)
    mask16 = np.ones((16, 4), np.float32)
    mask16[1::2, 2:] = 0.0
    hier.predict_batch(batch, mask16)  # warm-up
    torch.cuda.synchronize()
    wa.reset_launches()
    one = hier.predict_images(paths)  # no mask: token 0
    sixteen = hier.predict_batch(batch, mask16)
    torch.cuda.synchronize()
    launches = {k: wa.LAUNCHES[KERNEL_META[k][0]] for k in KERNEL_META}
    want = {k: 2 * n for k, n in LAUNCHES_PER_FORWARD.items()}
    finite = all(np.isfinite(r.embedding).all() and np.isfinite(r.top_probs)
                 .all() for r in [one] + sixteen)
    log(f"(b) hierarchical engine: launches over predict_images and one "
        f"bucket-16 predict_batch {launches} (expected {want}); finite "
        f"{finite}")
    if launches != want or not finite:
        fail("hierarchical engine: wrong launches or non-finite output")
    # three fusion cases: every view, two real views, one real view; and
    # predict_images' unmasked token 0
    rows = np.repeat(views[None], 3, axis=0)
    mask3 = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    t0 = time.perf_counter()
    cases = [(rows, mask3), (views[None], None)]
    worst, same_top1 = 1.0, True
    for v, m in cases:
        g, c = _model_logits(hier, v, m), _model_logits(cpu, v, m)
        for gi, ci in zip(g, c):
            worst = min(worst, float(_view_cosines(gi[None], ci[None])[0]))
            same_top1 &= int(gi.argmax()) == int(ci.argmax())
    same_top1 &= one.top_ids[0] == int(c[0].argmax())
    log(f"(b) hierarchical gpu bf16 vs cpu f32 logits: min cosine "
        f"{worst:.6f} (>= {MIN_COSINE}) over 4 views, 2 views, 1 view and "
        f"unmasked token 0; same top-1 {same_top1} "
        f"({time.perf_counter() - t0:.1f} s)")
    if worst < MIN_COSINE or not same_top1:
        fail("the hierarchical engine disagrees with its CPU f32 twin")
    p50 = {}
    for bucket in (1, 16):
        b = np.repeat(views[None], bucket, axis=0)
        for label, eng in (("hierarchical", hier), ("mean", mean_engine)):
            p50[(label, bucket)] = _p50_ms(lambda: eng.predict_batch(b),
                                           reps=10)
        log(f"(b) bucket {bucket}: p50 hierarchical "
            f"{p50[('hierarchical', bucket)]:.2f} ms, mean fusion "
            f"{p50[('mean', bucket)]:.2f} ms")
    del hier, cpu
    return launches, p50


def _guess_refine():
    """(d) ProtoRefiner at full scale, B = 16, with and without the member
    bank, on the card and on the CPU: equal cells and choices; times."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.models import proto_refiner as pr

    cells = CentroidTable.load(C.CENTROID_TABLE_PATH).num_cells
    D, P, M, R, B = 576, BANK_PROTOS, BANK_MEMBERS, BANK_REDUCED, REFINE_BATCH
    rng = np.random.default_rng(SEED + 16)
    t0 = time.perf_counter()
    emb = rng.standard_normal((cells, P, D), np.float32)
    centre = rng.uniform((-170.0, -55.0), (170.0, 70.0), (cells, 1, 2))
    coords = (centre + rng.uniform(-1, 1, (cells, P, 2))).astype(np.float32)
    mask = (rng.random((cells, P)) > 0.25).astype(np.float32)
    proj = pr.make_projection(D, R, seed=SEED)
    members = rng.standard_normal((cells, P, M, R), np.float32).astype(
        np.float16)
    mcoords = (coords[:, :, None] + rng.uniform(-0.3, 0.3, (cells, P, M, 2))
               ).astype(np.float32)
    mmask = (rng.random((cells, P, M)) > 0.2).astype(np.float32)
    ids = np.stack([rng.choice(cells, 5, replace=False) for _ in range(B)])
    probs = rng.dirichlet(np.ones(5), B).astype(np.float32)
    query = (emb[ids[:, 1], 0] + rng.normal(0, 0.3, (B, D))).astype(np.float32)
    # the guess sits near the candidate the query resembles: the
    # refinement moves it there unless candidate 1 was already top-1
    init = (centre[ids[:, 1], 0] + rng.uniform(-2, 2, (B, 2))).astype(
        np.float32)
    # how far apart the nearest and second nearest members are, in the
    # projected f32 distances of each candidate's best prototype
    d = np.linalg.norm(emb[ids] - query[:, None, None], axis=-1)
    best_p = np.where(mask[ids] > 0, d, np.inf).argmin(-1)
    q = query.astype(np.float64) @ proj
    gaps = []
    for b in range(B):
        for k in range(5):
            sel = mmask[ids[b, k], best_p[b, k]] > 0
            md2 = np.sort(((members[ids[b, k], best_p[b, k]].astype(
                np.float64) - q[b]) ** 2).sum(-1)[sel])
            if len(md2) > 1:
                gaps.append((md2[1] - md2[0]) / md2[1])
    bank = pr.PrototypeBank(emb, coords, mask)
    mbank = pr.MemberBank(members, mcoords, mmask, proj)
    mb = (emb.nbytes + coords.nbytes + mask.nbytes) / 1e6
    mmb = (members.nbytes + mcoords.nbytes + mmask.nbytes) / 1e6
    log(f"(d) bank {cells} cells x {P} prototypes x {D} f32 ({mb:.0f} MB), "
        f"members {M} x {R} f16 ({mmb:.0f} MB), made in "
        f"{time.perf_counter() - t0:.1f} s; nearest members ahead of the "
        f"second by at least {min(gaps):.3g} of the squared distance")
    out = {}
    for label, members_ in (("prototypes", None), ("members", mbank)):
        gpu = pr.ProtoRefiner(bank, member_bank=members_)
        cpu = pr.ProtoRefiner(bank, member_bank=members_, device="cpu")
        g = gpu(query, ids, probs, init)
        c = cpu(query, ids, probs, init)
        equal = (np.array_equal(g[1], c[1]) and np.array_equal(g[2], c[2]))
        dc = float(np.abs(g[0] - c[0]).max())
        args = [torch.as_tensor(a, device="cuda") for a in (
            query, ids.astype(np.int64), probs, init)]

        def call(gpu=gpu, args=args):
            return pr.refine(gpu._emb, gpu._coords, gpu._mask, *args,
                             **gpu._members)

        ms = cuda_time_ms(call, iters=20)
        p50 = _p50_ms(lambda gpu=gpu: gpu(query, ids, probs, init), reps=20)
        log(f"(d) refine B={B} with {label}: cells and choices equal to the "
            f"CPU {equal} ({int(g[2].sum())} of {B} changed), max |coords "
            f"gpu - cpu| {dc:.3g} deg; refine {ms:.4f} ms on the device, "
            f"ProtoRefiner call p50 {p50:.3f} ms (numpy in and out)")
        if not equal or dc > 1e-3 or not g[2].any():
            fail(f"refine with {label}: the card and the CPU disagree, or "
                 "no guess changed")
        out[label] = {"refine_ms": ms, "call_p50_ms": p50,
                      "changed": int(g[2].sum())}
        del gpu, cpu
    return out


def _guess_benchmark(tmp, blobs, pt):
    """(e) run_benchmark on a fixture SQLite with the checkpoint."""
    from geoguessr_ai_torch.run_benchmark import run_benchmark

    src = os.path.join(tmp, "raw.sqlite")
    _write_fixture_sqlite(src, blobs, EMBED_ROWS)
    out = os.path.join(tmp, "bench.json")
    t0 = time.perf_counter()
    summary = run_benchmark(num_samples=BENCH_SAMPLES, sqlite_path=src,
                            output_path=out, checkpoint=pt)
    wall = time.perf_counter() - t0
    with open(out) as f:
        records = json.load(f)
    log(f"(e) run_benchmark: {summary} in {wall:.2f} s (engine build and "
        f"{len(records) - 1} records included)")
    if summary["num_samples"] != BENCH_SAMPLES or not all(
            np.isfinite(summary[k]) for k in (
                "avg_distance_km", "median_distance_km", "avg_score",
                "avg_top1_prob")):
        fail(f"run_benchmark summary {summary}")
    return wall


def _guess_api(engine, blobs, paths):
    """(f) The HTTP handlers: API_SUBMISSIONS concurrent submissions of the
    fixture panorama through the MicroBatcher on the card."""
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.api import GuessApi

    api = GuessApi(engine=engine)
    batcher = api.get_batcher()
    api.warmup_thread.join()
    before = dict(batcher.batch_sizes)
    sids = [api.submit_image(list(blobs))["submission_id"]
            for _ in range(API_SUBMISSIONS)]
    torch.cuda.synchronize()
    wa.reset_launches()
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(API_SUBMISSIONS) as pool:
        preds = list(pool.map(api.prediction, sids))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: wa.LAUNCHES[KERNEL_META[k][0]] for k in KERNEL_META}
    batches = sum(batcher.batch_sizes.values()) - sum(before.values())
    want = engine.predict_images(paths)
    cached = all(api.prediction(s) is p for s, p in zip(sids, preds))
    same = all(p["top"][0]["geocell_index"] == want.top_ids[0]
               for p in preds)
    finite = all(np.isfinite([p["lat"], p["lon"]]).all() for p in preds)
    log(f"(f) API: {API_SUBMISSIONS} concurrent submissions answered in "
        f"{wall:.3f} s in {batches} batches ({batcher.batch_sizes}); "
        f"launches {launches}; top-1 as predict_images {same}; cached on a "
        f"second poll {cached}; finite {finite}")
    if not (same and cached and finite and batches >= 1):
        fail("the HTTP handlers' predictions are wrong")
    for k, per in LAUNCHES_PER_FORWARD.items():
        if launches[k] != per * batches:
            fail(f"API path: {k} launched {launches[k]} times, expected "
                 f"{per} per forward x {batches}")
    return launches


def phase_guess_path(paths):
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        engine, cpu, pt = _guess_checkpoint(tmp, paths)
        _, views = _fixture_views(engine)
        resize = _guess_resize(engine, cpu, blobs)
        del cpu
        launches, p50 = _guess_hierarchical(paths, views, engine)
        gc.collect()
        torch.cuda.empty_cache()
        refine = _guess_refine()
        gc.collect()
        _guess_benchmark(tmp, blobs, pt)
        for k, n in _guess_api(engine, blobs, paths).items():
            launches[k] += n
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 28 in {time.perf_counter() - t0:.1f} s")
    return launches, {"resize": resize, "p50": p50, "refine": refine}


# ---------------------------------------------------------------------------
# Phase 29: training up to the coordinator's surface, and the native decoder
# ---------------------------------------------------------------------------

#: Phase 29's train runs: batches of 16 fixture panoramas, 2 steps an
#: epoch, 3 epochs (resume after 2), keep_last_n 2 so that pruning runs.
SURFACE_BATCH = 16
SURFACE_EPOCHS = 3
SURFACE_STEPS = 2
#: The JAX gate of native against PIL decode (tests/test_data_pipeline.py).
DECODE_MAX_MEAN_DIFF = 4.0
#: The resumed third epoch against the uninterrupted one: step losses to a
#: relative 1e-5, every parameter at cosine >= 0.99999 (cuBLAS and cuDNN
#: need not sum in the same order twice; the CPU is bitwise).
RESUME_LOSS_RTOL = 1e-5
RESUME_MIN_COSINE = 0.99999
#: Embedding-only steps.
EMBED_TRAIN_STEPS = 20
#: The device kernels of (g)'s traced window (the first epoch's validation
#: forward and the third train step), by family, and their launches there:
#: the LN + GEMM core (K1's qkv and out-projection GEMMs, K2's qkv GEMM: 10
#: a forward), the forward core (K1, K2, K3: 10 a forward, 12 a train
#: step) and the backward core (K4, K5: four launches each of their 10
#: calls a step).
TRACE_KERNELS = {"ln_gemm_sm90": 20, "attention_fwd_sm90": 22,
                 "attn_bwd_sm90": 40}


class _TrainRecorder:
    """A metrics logger keeping every row with its host time (logging reads
    the device scalars, so a train row marks the end of its step); calls
    ``on_step`` after each train row."""

    def __init__(self, on_step=None):
        self.rows = []
        self.on_step = on_step

    def log(self, metrics, step):
        row = {k: float(v) for k, v in metrics.items()}
        self.rows.append((time.perf_counter(), step, row))
        if self.on_step is not None and "train/loss" in row:
            self.on_step()

    def summary(self, key, value):
        pass

    def finish(self):
        pass

    def losses(self):
        return [m["train/loss"] for _, _, m in self.rows if "train/loss" in m]

    def loop_p50_ms(self):
        t = [t for t, _, m in self.rows if "train/loss" in m]
        gaps = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        return float(np.median(gaps)) if gaps else float("nan")


def _surface_cfg(**changes):
    from geoguessr_ai_torch.config import TrainConfig

    return TrainConfig(**{"batch_size": SURFACE_BATCH,
                          "num_epochs": SURFACE_EPOCHS, "log_every_steps": 1,
                          "keep_last_n": 2, "seed": SEED, **changes})


def _surface_records(n_train):
    from geoguessr_ai_torch.train.fixtures import fixture_records

    records = fixture_records(n_train + SURFACE_BATCH, seed=SEED)
    return records[:n_train], records[n_train:]


def _expect_launches(label, steps, val_forwards, want_zero=False):
    """Fails unless K1-K5 launched exactly phase 8's counts for ``steps``
    train steps and ``val_forwards`` validation forwards since the last
    reset; returns the counts."""
    from geoguessr_ai_torch.ops import window_attention as wa

    launches = {k: wa.LAUNCHES[m[0]] for k, m in ALL_META.items()}
    want = {k: per * steps + LAUNCHES_PER_FORWARD.get(k, 0) * val_forwards
            for k, per in LAUNCHES_PER_TRAIN_STEP.items()}
    log(f"  {label}: launches {launches} (expected {want}: {steps} steps, "
        f"{val_forwards} validation forwards)")
    if launches != want:
        fail(f"{label}: K1-K5 launched {launches}, expected {want}")
    return launches


def _surface_decode(paths):
    """(a) The decoder that runs, native against PIL."""
    from geoguessr_ai_torch.data import pipeline
    from geoguessr_ai_torch.data.native import jpeg
    from geoguessr_ai_torch.data.pipeline import PanoramaBatchIterator
    from geoguessr_ai_torch.train.fixtures import fixture_records

    blobs = [open(p, "rb").read() for p in paths]
    native = jpeg.available()
    if native:
        log(f"(a) decoder: native ({jpeg.SO_PATH})")
        diffs = [float(np.abs(jpeg.decode_resize(b, 512).astype(np.int16)
                              - pipeline._pil_decode(b, 512)).mean())
                 for b in blobs]
        log(f"  native vs PIL at 512 from the 640 px views: mean |diff| "
            f"{', '.join(f'{d:.4f}' for d in diffs)} (gate < "
            f"{DECODE_MAX_MEAN_DIFF})")
        if max(diffs) >= DECODE_MAX_MEAN_DIFF:
            fail(f"native decode differs from PIL by {max(diffs)} levels")
        batch = jpeg.decode_batch(blobs + [b"corrupt" * 64], 512)
        if batch[-1].any() or not all(batch[i].any() for i in range(4)):
            fail("decode_batch: the corrupt blob is not zeros, or a view is")
        log("  decode_batch: the corrupt blob decodes to zeros")
    else:
        lines = (jpeg.build_error() or "").strip().splitlines()
        why = [x for x in lines if "error" in x][-1:] or lines[-1:]
        log(f"(a) decoder: pil ({' '.join(why).strip()}); PIL's rates alone")
    reps = 10
    ms = {}
    decoders = ((("native", jpeg.decode_resize),) if native else ()) + (
        ("pil", pipeline._pil_decode),)
    for name, fn in decoders:
        fn(blobs[0], 512)
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in blobs:
                fn(b, 512)
        ms[name] = (time.perf_counter() - t0) * 1e3 / (reps * len(blobs))
    log("  ms a view, 640 -> 512, one thread: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))
    records = fixture_records(4 * SURFACE_BATCH, seed=SEED)
    rate = {"native": [], "pil": []}
    native_decode = pipeline.decode_jpeg
    # a warm-up pass, then the two decoders in turns
    for name in (("native", "native", "pil", "pil", "native") if native
                 else ("pil", "pil", "pil")):
        pipeline.decode_jpeg = (native_decode if name == "native"
                                else pipeline._pil_decode)
        try:
            it = PanoramaBatchIterator(records, SURFACE_BATCH, 512,
                                       decode_threads=8)
            t0 = time.perf_counter()
            n = sum(b["num_real"] for b in it)
            rate[name].append(n / (time.perf_counter() - t0))
        finally:
            pipeline.decode_jpeg = native_decode
    rate["native" if native else "pil"].pop(0)  # the warm-up pass
    log(f"  PanoramaBatchIterator B={SURFACE_BATCH}, decode_threads=8, "
        f"{len(records)} panoramas a pass, panos/s: " + "; ".join(
            f"{k} {', '.join(f'{r:.2f}' for r in v)}"
            for k, v in rate.items() if v) + f" ({os.cpu_count()} host cores)")


def _param_cosines(a, b):
    """Every parameter of two model state dicts: (min cosine, name,
    bitwise equal)."""
    worst, name, same = 1.0, None, True
    for k, x in a.items():
        y = b[k]
        same &= torch.equal(x, y)
        if not torch.is_floating_point(x) or torch.equal(x, y):
            continue
        x, y = x.double().flatten(), y.double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()))
        if cos < worst:
            worst, name = cos, k
    return worst, name, same


def _surface_resume(tmp):
    """(b) 3 epochs straight, then 2 and a resume for the third, at full
    width; the save's cost."""
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train import checkpoints as ck
    from geoguessr_ai_torch.train.coordinator import train
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch import config as C

    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    train_recs, val_recs = _surface_records(SURFACE_BATCH * SURFACE_STEPS)
    snapshots, saves, live = {}, [], {}
    real_save = ck.CheckpointStore.save_epoch

    def spy(store, state, epoch, *args, **kw):
        # the uninterrupted run's weights in memory at each epoch's save
        # (for (c)), and the sync save's wall time
        if store.cfg.directory == straight_dir:
            snapshots[epoch] = {k: v.detach().to("cpu", copy=True)
                                for k, v in state.model.state_dict().items()}
        live["state"] = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(store, state, epoch, *args, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    straight_dir = os.path.join(tmp, "straight")
    resumed_dir = os.path.join(tmp, "resumed")
    ck.CheckpointStore.save_epoch = spy
    try:
        wa.reset_launches()
        straight = _TrainRecorder()
        train(_surface_cfg(), train_recs, val_recs, table,
              checkpoint_dir=straight_dir, metrics_logger=straight)
        torch.cuda.synchronize()
        launches = _expect_launches(
            "(b) uninterrupted", SURFACE_EPOCHS * SURFACE_STEPS,
            SURFACE_EPOCHS)
        first = _TrainRecorder()
        train(_surface_cfg(num_epochs=SURFACE_EPOCHS - 1), train_recs,
              val_recs, table, checkpoint_dir=resumed_dir,
              metrics_logger=first)
        resumed = _TrainRecorder()
        train(_surface_cfg(), train_recs, val_recs, table,
              checkpoint_dir=resumed_dir, metrics_logger=resumed)
    finally:
        ck.CheckpointStore.save_epoch = real_save
    state = live.pop("state")
    want = straight.losses()[-SURFACE_STEPS:]
    got = resumed.losses()
    log(f"(b) train() {SURFACE_EPOCHS} epochs x {SURFACE_STEPS} steps of "
        f"{SURFACE_BATCH}: losses {', '.join(f'{x:.6f}' for x in straight.losses())}")
    log(f"  resumed third epoch: {', '.join(f'{x:.6f}' for x in got)} "
        f"(first run: {', '.join(f'{x:.6f}' for x in first.losses())})")
    if len(got) != SURFACE_STEPS or not np.allclose(got, want,
                                                    rtol=RESUME_LOSS_RTOL,
                                                    atol=0.0):
        fail(f"the resumed epoch's losses {got} differ from the "
             f"uninterrupted run's {want} beyond {RESUME_LOSS_RTOL}")
    a = ck.read_checkpoint(os.path.join(straight_dir, "last"))
    b = ck.read_checkpoint(os.path.join(resumed_dir, "last"))
    cos, name, same = _param_cosines(a["state"]["model"], b["state"]["model"])
    moments = all(torch.equal(a["state"]["optimizer"][m][k],
                              b["state"]["optimizer"][m][k])
                  for m in ("mu", "nu") for k in a["state"]["optimizer"][m])
    log(f"  resumed vs uninterrupted last: parameters min cosine {cos:.9f}"
        f"{f' ({name})' if name else ''}, bitwise equal: parameters {same}, "
        f"moments {moments}, losses {got == want}; meta {b['meta']}")
    if cos < RESUME_MIN_COSINE:
        fail(f"resumed parameter {name} at cosine {cos} < {RESUME_MIN_COSINE}")
    for d in (straight_dir, resumed_dir):
        names = sorted(os.listdir(d))
        epochs = [n for n in names if n.startswith("epoch_")]
        if "last" not in names or "best" not in names or len(epochs) != 2:
            fail(f"{d} holds {names}: expected last, best and 2 epochs")
    log(f"  store: {sorted(os.listdir(straight_dir))}")
    size = os.path.getsize(os.path.join(straight_dir, "last", ck.STATE_FILE))
    per_step = {k: n // (SURFACE_EPOCHS * SURFACE_STEPS)
                for k, n in launches.items()}
    timed = {}
    for mode in ("sync", "async"):
        store = ck.CheckpointStore(ck.CheckpointConfig(
            os.path.join(tmp, f"timed_{mode}"), async_save=mode == "async"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save_epoch(state, 0, 1.0, None, extra={"global_step": 0})
        returned = time.perf_counter() - t0
        store.wait_until_finished()
        timed[mode] = (returned, time.perf_counter() - t0)
    log(f"  checkpoint {size / 1e6:.1f} MB on disk; save_epoch in train(): "
        f"{', '.join(f'{s:.3f}' for s in saves)} s (sync); timed alone: sync "
        f"{timed['sync'][1]:.3f} s, async returns in {timed['async'][0]:.3f} "
        f"s and commits in {timed['async'][1]:.3f} s; launches a step "
        f"{per_step}")
    best_epoch = int(ck.read_checkpoint(os.path.join(straight_dir, "best"))
                     ["meta"]["epoch"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "best": os.path.join(straight_dir, "best"),
            "best_weights": snapshots[best_epoch], "best_epoch": best_epoch}


def _surface_serve(resume, paths):
    """(c) The engine on the store's best against the weights it held in
    memory."""
    from geoguessr_ai_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    served = ServingEngine(checkpoint=resume["best"], seed=SEED + 1)
    load_s = time.perf_counter() - t0
    in_memory = ServingEngine(state_dict=resume["best_weights"])
    same = _same_results([served.predict_images(paths)],
                         [in_memory.predict_images(paths)])
    log(f"(c) ServingEngine(checkpoint=<run>/best) (epoch "
        f"{resume['best_epoch']}) built in {load_s:.2f} s, loaded "
        f"{served.loaded}; fixture panorama bitwise equal to the engine on "
        f"the same weights in memory: {same}")
    if not same:
        fail("the engine on <run>/best answers otherwise than the weights "
             "in memory")
    del served, in_memory
    gc.collect()
    torch.cuda.empty_cache()


def _surface_qat(loop_p50_ms):
    """(d) qat_storage at full width: one calibration, the kernels as in
    phase 8."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import BackboneConfig, ModelConfig
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train import coordinator

    steps = 4
    calls = []
    real = coordinator.calibrate_qat_

    def spy(model, *args):
        t0 = time.perf_counter()
        real(model, *args)
        calls.append((model, time.perf_counter() - t0))

    coordinator.calibrate_qat_ = spy
    try:
        table = CentroidTable.load(C.CENTROID_TABLE_PATH)
        train_recs, _ = _surface_records(SURFACE_BATCH * steps)
        rec = _TrainRecorder()
        cfg = _surface_cfg(num_epochs=1, model=ModelConfig(
            backbone=BackboneConfig(qat_storage=True)))
        wa.reset_launches()
        coordinator.train(cfg, train_recs, [], table, metrics_logger=rec)
        torch.cuda.synchronize()
    finally:
        coordinator.calibrate_qat_ = real
    if len(calls) != 1:
        fail(f"qat_storage calibrated {len(calls)} times, expected once")
    model, cal_s = calls[0]
    amax = torch.stack([v.float().cpu() for v in
                        model.backbone.act_scales.values()])
    log(f"(d) qat_storage: {len(amax)} sites calibrated once in {cal_s:.2f} s "
        f"(CPU, f32), amax {float(amax.min()):.4f} - {float(amax.max()):.4f}; "
        f"sites {model.backbone.config.quant_sites}")
    if not (torch.isfinite(amax).all() and (amax > 0).all()):
        fail("a QAT amax is not finite and positive")
    losses = rec.losses()
    log(f"  losses {', '.join(f'{x:.6f}' for x in losses)}; train() loop p50 "
        f"{rec.loop_p50_ms():.2f} ms (steps 2-{steps}) against phase 8's "
        f"{loop_p50_ms:.2f}")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"qat_storage train() logged {losses}")
    launches = _expect_launches("(d) qat_storage", steps, 0)
    del model, calls
    p50 = _qat_step_p50(cfg, table)
    log(f"  train_step p50 on one fixed batch of {SURFACE_BATCH}, in turns: "
        f"qat_storage {p50['qat']:.2f} ms, default {p50['default']:.2f} ms "
        f"({p50['qat'] / p50['default'] - 1:+.1%})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _qat_step_p50(cfg, table):
    """train_step p50 of a qat_storage state and of the default one on the
    same fixed device batch: a warm-up step each, then blocks of 3 steps in
    turns (default, qat, qat, default)."""
    from geoguessr_ai_torch.train.coordinator import create_state
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    states = {}
    states["default"], batch, centroids = fixture_train_setup(SURFACE_BATCH,
                                                              seed=SEED)
    states["qat"] = create_state(cfg, table.num_cells, 1)[0]
    times = {k: [] for k in states}
    # a warm-up step each, then blocks of 3 in turns
    order = ("default", "qat", "default", "qat", "qat", "default")
    for i, name in enumerate(order):
        for _ in range(1 if i < 2 else 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(states[name], batch, centroids)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def _surface_embedding(tmp, paths):
    """(e) The head alone on an embedding SQLite the builder wrote."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        EmbedBuildConfig,
        ModelConfig,
        OptimizerConfig,
    )
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
    )
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.train.coordinator import train

    blobs = [open(p, "rb").read() for p in paths]
    src = os.path.join(tmp, "raw.sqlite")
    out = os.path.join(tmp, "emb.sqlite")
    _write_fixture_sqlite(src, blobs, EMBED_ROWS)
    emb = Embedder(BackboneConfig.tinyvit(), model_config=bulk_embed_config(),
                   seed=SEED)
    build_embedding_sqlite(src, out, EmbedBuildConfig(quant_mode="none"),
                           embedder=emb, predecoded=True)
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    panos = load_sqlite_panorama_dataset(out)
    n_train = len(panos) - SURFACE_BATCH
    cfg = _surface_cfg(num_epochs=-(-EMBED_TRAIN_STEPS * SURFACE_BATCH
                                    // n_train),
                       optimizer=OptimizerConfig(learning_rate=1e-3),
                       model=ModelConfig(backbone=BackboneConfig(name="none")))
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    rec = _TrainRecorder()
    _reset_all_launches()
    summary = train(cfg, panos[:n_train], panos[n_train:], table,
                    metrics_logger=rec, max_steps=EMBED_TRAIN_STEPS)
    torch.cuda.synchronize()
    tinyvit = _tinyvit_launches()
    losses = rec.losses()
    log(f"(e) embedding-only: {len(panos)} panoramas of {EMBED_ROWS} rows "
        f"written by build_embedding_sqlite; {len(losses)} steps of "
        f"{SURFACE_BATCH}, loss {losses[0]:.6f} -> {losses[-1]:.6f}, val_loss "
        f"{summary.get('val_loss', float('nan')):.6f}; train() loop p50 "
        f"{rec.loop_p50_ms():.3f} ms; TinyViT launches {tinyvit}")
    if len(losses) != EMBED_TRAIN_STEPS or not losses[-1] < losses[0]:
        fail(f"embedding-only train() losses {losses}: expected "
             f"{EMBED_TRAIN_STEPS} falling")
    if any(tinyvit.values()):
        fail(f"embedding-only train() launched TinyViT kernels: {tinyvit}")


def _surface_hierarchical():
    """(f) Hierarchical fusion trained at full width."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import ModelConfig
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train import state as tstate
    from geoguessr_ai_torch.train.coordinator import train

    steps = 2
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    train_recs, _ = _surface_records(SURFACE_BATCH * steps)
    grads = []
    real_step = tstate.AdamW.step

    def spy(opt, params, g):
        grads.append({n: float(t.float().norm()) for n, t in g.items()
                      if n.startswith(("self_attn.", "backbone.stage3"))})
        return real_step(opt, params, g)

    tstate.AdamW.step = spy
    try:
        rec = _TrainRecorder()
        wa.reset_launches()
        train(_surface_cfg(num_epochs=1,
                           model=ModelConfig(hierarchical=True)),
              train_recs, [], table, metrics_logger=rec)
        torch.cuda.synchronize()
    finally:
        tstate.AdamW.step = real_step
    losses = rec.losses()
    attn = {n: v for n, v in grads[-1].items() if n.startswith("self_attn.")}
    stage3 = sum(v for n, v in grads[-1].items() if n.startswith("backbone."))
    log(f"(f) hierarchical: losses {', '.join(f'{x:.6f}' for x in losses)}; "
        f"self_attn gradient norms "
        f"{', '.join(f'{n[10:]} {v:.3e}' for n, v in attn.items())}; the "
        f"positional encoder holds no parameters (a fixed sinusoidal table, "
        f"as in the JAX package): the gradient through it reaches the "
        f"backbone's stage 3, norm {stage3:.3e}; single-image training is "
        f"refused (the JAX train() fails on it)")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"hierarchical train() logged {losses}")
    if len(attn) != 8 or not all(v > 0 for v in attn.values()) \
            or not stage3 > 0:
        fail(f"hierarchical gradients are zero: {attn}, stage 3 {stage3}")
    return _expect_launches("(f) hierarchical", steps, 0)


#: Run in a fresh process (phase 29 (g)): ``main()`` on a fixture SQLite,
#: then phase (b)'s train() for 3 steps under a StepProfiler whose trace
#: spans the third step.  torch.profiler traces taken late in the long
#: smoke process have come back empty (phase 10), hence the process.
_SURFACE_MAIN = """
import glob, json, os, sys
import chip_smoke as cs
from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.train.coordinator import main, train
from geoguessr_ai_torch.utils.profiling import ProfileSchedule, StepProfiler

summary = main(cs._surface_cfg(num_epochs=1, val_fraction=0.25))
trace_dir = sys.argv[1]
prof = StepProfiler(trace_dir, ProfileSchedule(wait=0, warmup=1, active=2,
                                               repeat=1))
train_recs, val_recs = cs._surface_records(cs.SURFACE_BATCH * cs.SURFACE_STEPS)
train(cs._surface_cfg(), train_recs, val_recs,
      CentroidTable.load(C.CENTROID_TABLE_PATH), max_steps=3,
      metrics_logger=cs._TrainRecorder(on_step=prof.step))
prof.close()
print(json.dumps({"epoch": summary["epoch"],
                  "global_step": summary["global_step"],
                  "val_loss": summary.get("val_loss"),
                  "traces": glob.glob(os.path.join(trace_dir, "*.json"))}))
"""


def _surface_main(tmp, paths):
    """(g) main() and the profiler's trace, in a fresh process."""
    blobs = [open(p, "rb").read() for p in paths]
    db = os.path.join(tmp, "dataset_sqlite_surface.sqlite")
    _write_fixture_sqlite(db, blobs, 4 * 4 * SURFACE_BATCH)
    ckpt = os.path.join(tmp, "main_ckpt")
    trace_dir = os.path.join(tmp, "trace")
    env = dict(os.environ, DATASET_SQLITE_PATH=db, GEO_TPU_CKPT_DIR=ckpt)
    # the fresh process trains at full width (phase 8's ~42 GB peak):
    # hand back what this one's allocator keeps cached
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _SURFACE_MAIN, trace_dir],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=600)
    wall_s = time.perf_counter() - t0
    if out.returncode:
        fail(f"main() failed:\n{out.stderr[-3000:]}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    names = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    log(f"(g) main() in a fresh process ({wall_s:.1f} s): epoch "
        f"{result['epoch']}, {result['global_step']} steps, val_loss "
        f"{result['val_loss']}; {ckpt}: {names}")
    if (result["epoch"] != 0 or result["val_loss"] is None
            or not {"last", "best"} <= set(names)):
        fail(f"main() did not run its epoch to the end: {result}, {names}")
    if len(result["traces"]) != 1:
        fail(f"the StepProfiler wrote {result['traces']}, expected one trace")
    with open(result["traces"][0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for family in TRACE_KERNELS:
                if family in e.get("name", ""):
                    kernels[family] = kernels.get(family, 0) + 1
    log(f"  StepProfiler trace ({os.path.getsize(result['traces'][0]) / 1e6:.1f}"
        f" MB) device kernels by family: {kernels} (a validation forward and "
        f"a train step launch {TRACE_KERNELS}: K1/K2 LN + GEMM core, "
        f"K1/K2/K3 forward core, K4/K5 backward core)")
    if set(kernels) != set(TRACE_KERNELS):
        fail(f"the profiler's trace lacks {set(TRACE_KERNELS) - set(kernels)}")


def phase_train_surface(paths, loop_p50_ms):
    """Phase 29; returns K1-K5's launches over its train runs."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _surface_decode(paths)
        resume = _surface_resume(tmp)
        _surface_serve(resume, paths)
        parts = [resume.pop("launches"), _surface_qat(loop_p50_ms)]
        del resume
        _surface_embedding(tmp, paths)
        parts.append(_surface_hierarchical())
        _surface_main(tmp, paths)
    log(f"phase 29 in {time.perf_counter() - t0:.1f} s")
    return {k: sum(p[k] for p in parts) for k in LAUNCHES_PER_TRAIN_STEP}


# ---------------------------------------------------------------------------
# Phase 30: CLIP training and contrastive pretraining
# ---------------------------------------------------------------------------

#: (a), (c): train() on the CLIP ViT-L/14-336 backbone over batches of 16
#: fixture panoramas (64 images a step), 2 steps an epoch, a validation
#: forward of 16 at each epoch's end; (a) 2 epochs, (c) 1.
CLIP_TRAIN_BATCH = 16
CLIP_TRAIN_STEPS = 2
CLIP_TRAIN_EPOCHS = 2
#: (b): the card's bf16 step against the CPU f32 step, full width at this
#: depth, CPU_TRAIN_BATCH panoramas.
CLIP_STEP_LAYERS = 2
#: (e): pretrain() over 64 captioned fixture rows, batches of 16, the
#: mean of two micro-batches an update: 4 micro-steps, 2 updates (the
#: first at the warm-up's rate of 0), checkpoints every 2 micro-steps.
PRETRAIN_ROWS = 64
PRETRAIN_BATCH = 16
PRETRAIN_ACCUM = 2
#: (f): ids of the JAX package's CLIPBPETokenizer (``encode``, unpadded)
#: over data/clip_bpe/, recorded where the ``regex`` package is installed;
#: non-ASCII letters, digits, "²", "½", "٣" and an upper-case contraction
#: show that the port's stdlib scanner splits words as that pattern does.
BPE_GOLDEN = (
    ("A Street View photo close to the town of Tromsø in the region of "
     "Troms og Finnmark in Norway. The photo was taken in March.",
     [2604, 320, 527, 525, 519, 66, 533, 1022, 517, 528, 783, 86, 333, 536,
      636, 76, 802, 372, 513, 528, 546, 536, 636, 76, 338, 1582, 69, 572,
      77, 887, 513, 1160, 269, 528, 519, 573, 543, 513, 833, 269, 2605]),
    ("Côte d'Ivoire, İstanbul, São Paulo: x² ½ ٣ 12,345 — ǅemal'S 東京!!",
     [2604, 66, 926, 966, 323, 262, 72, 1922, 793, 324, 267, 328, 136, 485,
      1526, 681, 331, 267, 910, 2173, 281, 343, 126, 366, 126, 377, 149,
      352, 272, 273, 267, 274, 275, 276, 158, 222, 498, 131, 228, 588, 598,
      2603, 162, 251, 365, 160, 118, 361, 0, 256, 2605]),
    ("IT'S 1970 ÅÄÖ naïve café Zürich (really)...",
     [2604, 72, 339, 2603, 272, 280, 278, 271, 1456, 797, 127, 370, 690, 127,
      107, 85, 324, 668, 69, 839, 89, 901, 2122, 263, 512, 576, 680, 8, 13,
      1251, 2605]),
)
#: The CLIP backbone's top-level modules that train under the default
#: freeze rule at ViT-L/14's depth.
CLIP_TRAINABLE = ("layer23", "post_layernorm")


def _clip_launches():
    """K6's and K11's launches since the last reset, and the sum of the
    TinyViT kernels'."""
    from geoguessr_ai_torch.ops import clip_attention as ca

    out = {k: ca.LAUNCHES[m[0]] for k, m in CLIP_META.items()}
    return out, sum(_tinyvit_launches().values())


def _expect_clip_launches(label, forwards, kernel):
    """Fails unless ``kernel`` launched exactly 24 times for each of
    ``forwards`` CLIP forwards since the last reset and no other kernel
    did; returns the K6 / K11 counts."""
    got, tinyvit = _clip_launches()
    want = {k: 0 for k in CLIP_META}
    want[kernel] = CLIP_LAUNCHES_PER_FORWARD * forwards
    log(f"  {label}: launches {got}, TinyViT kernels {tinyvit} (expected "
        f"{want}: {CLIP_LAUNCHES_PER_FORWARD} {kernel} in each of {forwards} "
        "forwards, none in a backward)")
    if got != want or tinyvit:
        fail(f"{label}: CLIP launches {got} (TinyViT {tinyvit}), expected "
             f"{want}")
    return got


def _clip_train_cfg(epochs):
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        ModelConfig,
        TrainConfig,
    )

    return TrainConfig(batch_size=CLIP_TRAIN_BATCH, num_epochs=epochs,
                       log_every_steps=1, keep_last_n=1, seed=SEED,
                       model=ModelConfig(backbone=BackboneConfig.clip()))


def _clip_trainable(name):
    parts = name.split(".")
    return parts[0] != "backbone" or parts[1] in CLIP_TRAINABLE


def _clip_train(tmp, table):
    """(a) train() at full width: exact K6 launches, frozen leaves
    bitwise, every trainable leaf moved; the weights at each epoch's save
    for (d)."""
    from geoguessr_ai_torch.train import checkpoints as ck
    from geoguessr_ai_torch.train import coordinator

    records = _surface_records(CLIP_TRAIN_BATCH * CLIP_TRAIN_STEPS)
    init, snapshots = {}, {}
    real_create, real_save = coordinator.create_state, \
        ck.CheckpointStore.save_epoch

    def spy_create(*args, **kw):
        out = real_create(*args, **kw)
        init.update({k: v.detach().to("cpu", copy=True)
                     for k, v in out[0].model.state_dict().items()})
        return out

    def spy_save(store, state, epoch, *args, **kw):
        snapshots[epoch] = {k: v.detach().to("cpu", copy=True)
                            for k, v in state.model.state_dict().items()}
        return real_save(store, state, epoch, *args, **kw)

    step_ms = []
    real_step = coordinator.train_step

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    run_dir = os.path.join(tmp, "clip_run")
    coordinator.create_state = spy_create
    coordinator.train_step = timed_step
    ck.CheckpointStore.save_epoch = spy_save
    try:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        rec = _TrainRecorder()
        t0 = time.perf_counter()
        summary = coordinator.train(_clip_train_cfg(CLIP_TRAIN_EPOCHS),
                                    *records, table, checkpoint_dir=run_dir,
                                    metrics_logger=rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        coordinator.create_state = real_create
        coordinator.train_step = real_step
        ck.CheckpointStore.save_epoch = real_save
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = CLIP_TRAIN_EPOCHS * CLIP_TRAIN_STEPS
    launches = _expect_clip_launches(
        "(a) train()", steps + CLIP_TRAIN_EPOCHS, "K6")
    losses = rec.losses()
    log(f"(a) train() CLIP ViT-L/14-336, {CLIP_TRAIN_EPOCHS} epochs x "
        f"{CLIP_TRAIN_STEPS} steps of {CLIP_TRAIN_BATCH} panoramas "
        f"({4 * CLIP_TRAIN_BATCH} images), {table.num_cells} cells: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; val_loss "
        f"{summary.get('val_loss', float('nan')):.6f}; loop p50 "
        f"{rec.loop_p50_ms():.2f} ms; train_step ms "
        f"{', '.join(f'{x:.2f}' for x in step_ms)} (p50 after the first "
        f"{float(np.median(step_ms[1:])):.2f}); peak memory {peak:.2f} GB; "
        f"wall {wall:.1f} s")
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"(a) losses {losses}")
    final = snapshots[CLIP_TRAIN_EPOCHS - 1]
    changed = [n for n in final if not _clip_trainable(n)
               and not torch.equal(final[n], init[n])]
    still = [n for n in final if _clip_trainable(n)
             and torch.equal(final[n], init[n])]
    trained = sorted({_top_module(n) for n in final if _clip_trainable(n)})
    log(f"  frozen leaves changed: {len(changed)} of "
        f"{sum(not _clip_trainable(n) for n in final)}; trainable modules "
        f"{trained}, leaves unmoved: {still}")
    if changed or still:
        fail(f"(a) frozen leaves changed {changed[:4]}, trainable leaves "
             f"unmoved {still[:4]}")
    best_epoch = int(ck.read_checkpoint(os.path.join(run_dir, "best"))
                     ["meta"]["epoch"])
    init.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec.loop_p50_ms(), {
        "best": os.path.join(run_dir, "best"), "epoch": best_epoch,
        "weights": snapshots[best_epoch]}


def _clip_step_vs_cpu():
    """(b) One train step at full width and CLIP_STEP_LAYERS layers, B=2:
    the card in bf16 against the CPU in f32."""
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    out = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        config = CLIPVisionConfig.vit_l_14_336(
            num_layers=CLIP_STEP_LAYERS, dtype=getattr(torch, dtype))
        state, batch, centroids = fixture_train_setup(
            CPU_TRAIN_BATCH, device=device, seed=SEED, dtype=dtype,
            model_config=config, backbone="clip")
        grads = {}
        step = state.optimizer.step

        def capture(params, g, step=step, grads=grads):
            grads.update({n: t.detach().float().cpu() for n, t in g.items()})
            return step(params, g)

        state.optimizer.step = capture
        _reset_all_launches()
        t0 = time.perf_counter()
        _, metrics = train_step(state, batch, centroids)
        loss = float(metrics["loss"])
        log(f"(b) CLIP train step {device} {dtype}: {CPU_TRAIN_BATCH} "
            f"panoramas, {CLIP_STEP_LAYERS} layers, loss {loss:.6f}, "
            f"{time.perf_counter() - t0:.2f} s, K6/K11 launches "
            f"{_clip_launches()[0]}")
        out[device] = (loss, grads, list(state.optimizer.names))
        del state, batch
    (gl, gg, gn), (cl, cg, cn) = out["cuda"], out["cpu"]
    rel = abs(gl - cl) / abs(cl)
    names = sorted(cg)
    cos = _cosine(torch.cat([gg[n].flatten() for n in names]),
                  torch.cat([cg[n].flatten() for n in names]))
    by_module = {}
    for mod in sorted({_top_module(n) for n in names}):
        sub = [n for n in names if _top_module(n) == mod]
        by_module[mod] = round(_cosine(
            torch.cat([gg[n].flatten() for n in sub]),
            torch.cat([cg[n].flatten() for n in sub])), 6)
    trainable = sorted({_top_module(n) for n in gn})
    log(f"  loss rel {rel:.3g} (<= {TRAIN_LOSS_RTOL}); whole gradient cosine "
        f"{cos:.6f} (>= {TRAIN_GRAD_MIN_COSINE}); by module {by_module}; "
        f"trainable {trainable}, same set on both: {gn == cn}")
    want = sorted({"cell_layer", f"layer{CLIP_STEP_LAYERS - 1}",
                   "post_layernorm"})
    if rel > TRAIN_LOSS_RTOL or cos < TRAIN_GRAD_MIN_COSINE or gn != cn \
            or trainable != want:
        fail(f"(b) the card's CLIP step disagrees with the CPU's: loss rel "
             f"{rel}, gradient cosine {cos}, trainable {trainable}")
    gc.collect()
    torch.cuda.empty_cache()


def _clip_train_fused_proj(table):
    """(c) train() with pallas_fuse_proj: K11 in every forward, K6 none."""
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.train import coordinator

    records = _surface_records(CLIP_TRAIN_BATCH * CLIP_TRAIN_STEPS)
    _reset_all_launches()
    rec = _TrainRecorder()
    coordinator.train(_clip_train_cfg(1), *records, table,
                      metrics_logger=rec,
                      model_config=CLIPVisionConfig.vit_l_14_336(
                          pallas_fuse_proj=True))
    torch.cuda.synchronize()
    launches = _expect_clip_launches("(c) train() pallas_fuse_proj",
                                     CLIP_TRAIN_STEPS + 1, "K11")
    losses = rec.losses()
    log(f"(c) losses {', '.join(f'{x:.6f}' for x in losses)}; loop p50 "
        f"{rec.loop_p50_ms():.2f} ms")
    if len(losses) != CLIP_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"(c) losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _clip_serve_best(best, paths):
    """(d) ServingEngine(backbone="clip", checkpoint=<run>/best) against
    the engine on the weights the run held at that epoch."""
    from geoguessr_ai_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    served = ServingEngine(backbone="clip", checkpoint=best["best"],
                           seed=SEED + 1)
    load_s = time.perf_counter() - t0
    in_memory = ServingEngine(backbone="clip", state_dict=best["weights"])
    same = _same_results([served.predict_images(paths)],
                         [in_memory.predict_images(paths)])
    log(f"(d) ServingEngine(backbone='clip', checkpoint=<run>/best) (epoch "
        f"{best['epoch']}) built in {load_s:.2f} s, loaded {served.loaded}; "
        f"bitwise equal to the engine on the run's weights: {same}")
    if not same:
        fail("(d) the CLIP engine on <run>/best answers otherwise than the "
             "weights the run held")
    del served, in_memory
    gc.collect()
    torch.cuda.empty_cache()


def _pretrain_rows():
    from geoguessr_ai_torch.inference import fixture_panorama
    from geoguessr_ai_torch.train.captions import enrich_rows

    blobs = []
    for path in fixture_panorama():
        with open(path, "rb") as f:
            blobs.append(f.read())
    rng = np.random.default_rng(SEED)
    countries = ("Norway", "Japan", "Netherlands", "United States Of America")
    return enrich_rows({
        "image": blobs[i % 4], "lat": float(rng.uniform(-60, 70)),
        "lon": float(rng.uniform(-180, 180)),
        "country": countries[i % 4], "region": f"region {i % 7}",
        "capture_date": f"20{10 + i % 14}-{1 + i % 12:02d}-01",
        "drive_right": countries[i % 4] != "Japan",
    } for i in range(PRETRAIN_ROWS))


def _clip_pretrain(tmp):
    """(e) pretrain() at full width with the vendored BPE."""
    from geoguessr_ai_torch.config import PretrainConfig
    from geoguessr_ai_torch.models.clip_text import CLIPModel, CLIPTextConfig
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.train import pretrain_clip as pc
    from geoguessr_ai_torch.train.clip_bpe import load_default_tokenizer

    cfg = PretrainConfig(batch_size=PRETRAIN_BATCH,
                         grad_accum_steps=PRETRAIN_ACCUM, num_epochs=1,
                         save_every_steps=2, seed=SEED)
    steps = PRETRAIN_ROWS // PRETRAIN_BATCH
    times = []
    real_step = pc.pretrain_step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    ckpt = os.path.join(tmp, "pretrain")
    pc.pretrain_step = timed
    try:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pc.pretrain(_pretrain_rows(), load_default_tokenizer(), cfg,
                          checkpoint_dir=ckpt)
        wall = time.perf_counter() - t0
    finally:
        pc.pretrain_step = real_step
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = _expect_clip_launches("(e) pretrain()", steps, "K6")
    losses = out["losses"]
    log(f"(e) pretrain() CLIP-L/14-336 + text tower, {steps} micro-steps of "
        f"{PRETRAIN_BATCH}, {PRETRAIN_ACCUM} a update: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; pretrain_step ms "
        f"{', '.join(f'{x:.2f}' for x in times)} (p50 after the first "
        f"{float(np.median(times[1:])):.2f}); peak memory {peak:.2f} GB; "
        f"wall {wall:.1f} s")
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"(e) losses {losses}")
    init = CLIPModel(CLIPVisionConfig.vit_l_14_336(),
                     CLIPTextConfig.vit_l_text())
    pc.init_clip_model_(init, cfg.seed)
    init = init.state_dict()
    params = out["params"]
    moved = sorted(n for n in params if not torch.equal(params[n], init[n]))
    want = sorted(n for n in params if n.startswith(pc.TRAINABLE_SUBTREES))
    names = sorted(os.listdir(ckpt))
    step2 = pc.read_pretrain_checkpoint(os.path.join(ckpt, "step_0000002"))
    last = pc.read_pretrain_checkpoint(os.path.join(ckpt, "last"))
    last_same = all(torch.equal(last[n], params[n]) for n in params)
    step2_init = all(torch.equal(step2[n], init[n]) for n in params)
    log(f"  moved: {moved} (expected {want}); logit_scale "
        f"{float(init['logit_scale']):.9f} -> "
        f"{float(params['logit_scale']):.9f}; checkpoints {names}: "
        f"last reloads bitwise {last_same}, step_0000002 (after the update "
        f"at rate 0) equals the initial weights {step2_init}")
    if moved != want or not last_same or not step2_init or \
            not {"step_0000002", "last"} <= set(names):
        fail(f"(e) pretraining moved {moved}, checkpoints {names}")
    del out, init, params, step2, last
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _clip_tokenizer():
    """(f) The port's tokenizer against the JAX tokenizer's recorded ids."""
    from geoguessr_ai_torch.train.clip_bpe import load_default_tokenizer

    tok = load_default_tokenizer()
    bad = [text for text, ids in BPE_GOLDEN if tok.encode(text) != ids]
    log(f"(f) BPE tokenizer ({tok.vocab_size} tokens, stdlib word scanner): "
        f"{len(BPE_GOLDEN) - len(bad)} of {len(BPE_GOLDEN)} captions give "
        "the recorded ids")
    if bad:
        fail(f"(f) the tokenizer's ids differ for {bad}")


def phase_clip_train(paths):
    """Phase 30; returns K6's and K11's launches over its runs."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.geocells.manager import CentroidTable

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    with tempfile.TemporaryDirectory() as tmp:
        parts = []
        launches, _, best = _clip_train(tmp, table)
        parts.append(launches)
        _clip_step_vs_cpu()
        parts.append(_clip_train_fused_proj(table))
        _clip_serve_best(best, paths)
        del best
        parts.append(_clip_pretrain(tmp))
        _clip_tokenizer()
    log(f"phase 30 in {time.perf_counter() - t0:.1f} s")
    return {k: sum(p[k] for p in parts) for k in CLIP_META}


# ---------------------------------------------------------------------------
# Phase 31: the TinyViT country finetune at TinyViT-5M-224
# ---------------------------------------------------------------------------

#: The synthetic world: (country, admin areas, rows) with 20 % of each
#: country's rows to validation: 64 validation rows (one batch of
#: FT_BATCH) and 256 train rows (4 steps).
FT_COUNTRIES = (("Arland", 2, 100), ("Borland", 3, 110), ("Corland", 2, 110))
FT_VAL_FRACTION = 0.2
FT_BATCH = 64
#: K4 launches of one finetune train step: the backward of each of
#: TinyViT-5M-224's ten attention blocks (2 + 6 + 2); none in an eval
#: forward, and no other kernel.
FT_K4_PER_STEP = 10
#: (label, W, N, H) of K4 in a B=64 step at 224 px; hd=32, N padded to 64
#: or 256 inside the wrapper.
FT_K4_CASES = (("stage1", 1024, 49, 4), ("stage2", 64, 196, 5),
               ("stage3", 64, 49, 10))
#: Batch of the card-against-CPU step, and rows embedded in (f).
FT_CPU_BATCH = 4
FT_EMBED_ROWS = 16
#: Embeddings on the card (bf16) against the CPU (f32), per row.
FT_EMBED_MIN_COSINE = 0.999
#: The phase's time limit (s).
FT_PHASE_S = 90.0


def _ft_world(tmp):
    """(a) Seeded geocell pickles of FT_COUNTRIES (cells as
    SimpleNamespace records: id, admin_1, points, clusters with hashes,
    geom_centroid) loaded by the port's GeocellManager, and the port's
    build_centroid_table tool run on them.  Returns (manager, the points
    by country)."""
    import pickle
    import types

    from geoguessr_ai_torch.geocells.manager import (
        CentroidTable,
        GeocellManager,
    )
    from geoguessr_ai_torch.tools import build_centroid_table

    rng = np.random.default_rng(SEED)
    geo = os.path.join(tmp, "geocells")
    os.makedirs(geo)
    points = {}
    for c, (country, areas, _) in enumerate(FT_COUNTRIES):
        inner, points[country] = {}, []
        for a in range(areas):
            lng0, lat0 = -60.0 + 40 * c + 8 * a, -20.0 + 10 * a
            pts = [{"latitude": float(lat0 + rng.uniform(0, 5)),
                    "longitude": float(lng0 + rng.uniform(0, 5))}
                   for _ in range(24)]
            clusters = {k: {"points": pts[k::2], "hashes": {
                hash((p["latitude"], p["longitude"])) for p in pts[k::2]}}
                for k in range(2)}
            inner[f"{country}_admin{a}"] = [types.SimpleNamespace(
                id=f"{country}_{a}", admin_1=f"admin{a}", points=pts,
                clusters=clusters, geom_centroid=[lng0 + 2.5, lat0 + 2.5])]
            points[country] += pts
        with open(os.path.join(geo, f"geocells_{country}.pickle"), "wb") as f:
            pickle.dump(inner, f)
    mgr = GeocellManager(geo)
    npz = os.path.join(tmp, "centroid_table.npz")
    build_centroid_table.main(["--geocell-dir", geo, "--out-npz", npz,
                               "--out-csv", os.path.join(tmp, "proto.csv")])
    table = CentroidTable.load(npz)
    cells = sum(areas for _, areas, _ in FT_COUNTRIES)
    log(f"(a) geocells: {mgr.num_cells} cells, {len(mgr.point_info)} points; "
        f"centroid table {table.centroids.shape}")
    if mgr.num_cells != cells or table.num_cells != cells:
        fail(f"the geocell manager or the centroid table holds "
             f"{mgr.num_cells} / {table.num_cells} cells, expected {cells}")
    return mgr, points


def _ft_rows(mgr, points, paths):
    """(b) FT_COUNTRIES' rows at points of their cells, images cycling the
    fixture JPEGs, labelled and split by prepare_country_dataset."""
    from geoguessr_ai_torch.train.finetune_tinyvit import (
        prepare_country_dataset,
    )

    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    rows = []
    for country, _, n in FT_COUNTRIES:
        pts = points[country]
        rows += [{"location_id": f"{country}{i}",
                  "lat": pts[i % len(pts)]["latitude"],
                  "lon": pts[i % len(pts)]["longitude"],
                  "image": blobs[len(rows) % len(blobs)]} for i in range(n)]
    rows.append({"location_id": "nowhere", "lat": 80.0, "lon": 170.0,
                 "image": blobs[0]})
    train, val, class_map = prepare_country_dataset(
        rows, mgr, val_fraction=FT_VAL_FRACTION, seed=SEED)
    log(f"(b) {len(rows)} rows -> {len(train)} train, {len(val)} validation,"
        f" classes {class_map}")
    if len(val) != FT_BATCH or len(train) != 4 * FT_BATCH or \
            len(class_map) != len(FT_COUNTRIES):
        fail("prepare_country_dataset gave another split than expected")
    return train, val, class_map


def _ft_kernel_total():
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    return sum(sum(m.LAUNCHES.values()) for m in (wa, mbconv, ca))


def _ft_finetune(tmp, train, val, class_map):
    """(c) finetune() at TinyViT-5M-224 full width (bf16 compute, f32
    master weights) for one epoch of 4 steps of FT_BATCH, every launch
    counter at 0 first; returns (K4 launches, the summary)."""
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.train import finetune_tinyvit as ft

    records = {"train": [], "eval": []}
    step, evaluate = ft.finetune_train_step, ft.finetune_eval_step

    def timed_step(model, optimizer, images, labels, generator=None):
        k4, total = wa.LAUNCHES[BWD_META["K4"][0]], _ft_kernel_total()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, logits = step(model, optimizer, images, labels, generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        records["train"].append(dict(
            t0=t0, t1=t1, loss=float(loss),
            k4=wa.LAUNCHES[BWD_META["K4"][0]] - k4,
            total=_ft_kernel_total() - total))
        return loss, logits

    def counted_eval(model, images, labels, num_classes):
        total = _ft_kernel_total()
        out = evaluate(model, images, labels, num_classes)
        records["eval"].append(dict(model=model, images=images,
                                    launches=_ft_kernel_total() - total))
        return out

    cfg = ft.FinetuneConfig(seed=SEED, batch_size=FT_BATCH, num_epochs=1,
                            warmup_steps=2, image_size=224)
    ckpt = os.path.join(tmp, "finetune")
    os.makedirs(ckpt)
    ft.finetune_train_step, ft.finetune_eval_step = timed_step, counted_eval
    _reset_all_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        summary = ft.finetune(train, val, len(class_map), cfg,
                              checkpoint_dir=ckpt, class_map=class_map)
    finally:
        ft.finetune_train_step, ft.finetune_eval_step = step, evaluate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = records["train"]
    k4 = wa.LAUNCHES[BWD_META["K4"][0]]
    log(f"(c) finetune(): TinyViT-5M-224 bf16 compute, f32 master weights, "
        f"{len(class_map)} classes, batch {FT_BATCH}, {len(steps)} steps + "
        f"{len(records['eval'])} validation forwards in {wall:.2f} s")
    for i, r in enumerate(steps):
        log(f"  step {i + 1}: loss {r['loss']:.6f}, K4 {r['k4']} launches, "
            f"{r['total']} kernel launches in all")
    if len(steps) != 4 or not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"finetune ran {len(steps)} steps, losses "
             f"{[r['loss'] for r in steps]}")
    if any(r["k4"] != FT_K4_PER_STEP or r["total"] != FT_K4_PER_STEP
           for r in steps):
        fail(f"a finetune step launched other than K4 exactly "
             f"{FT_K4_PER_STEP} times and no other kernel")
    if [r["launches"] for r in records["eval"]] != [0]:
        fail(f"the validation forwards launched "
             f"{[r['launches'] for r in records['eval']]} kernels, expected "
             f"one forward and none")
    if k4 != FT_K4_PER_STEP * len(steps) or _ft_kernel_total() != k4:
        fail(f"finetune launched K4 {k4} times and "
             f"{_ft_kernel_total()} kernels in all")
    log(f"  top1 {summary['top1']:.4f} top5 {summary['top5']:.4f} (k = "
        f"{min(5, len(class_map))}) after step {summary['step']}")
    if not (math.isfinite(summary["top1"]) and math.isfinite(summary["top5"])):
        fail(f"finetune gave no finite top-1 / top-5: {summary}")
    step_ms = [(r["t1"] - r["t0"]) * 1e3 for r in steps[1:]]
    loop_ms = [(b["t1"] - a["t1"]) * 1e3 for a, b in zip(steps, steps[1:])]
    log(f"  finetune_train_step p50 {float(np.median(step_ms)):.2f} ms "
        f"(synchronised around each call; steps 2-{len(steps)}: "
        f"{', '.join(f'{t:.2f}' for t in step_ms)}), "
        f"{FT_BATCH / float(np.median(step_ms)) * 1e3:.1f} img/s")
    log(f"  loop p50 {float(np.median(loop_ms)):.2f} ms per step (host "
        f"decode, flips and upload included)")
    log(f"  peak device memory {peak_gb:.3f} GB (torch.cuda.max_memory_"
        f"allocated)")
    best = summary["best_checkpoint"]
    with open(os.path.join(ckpt, "class_map.json")) as f:
        if json.load(f) != class_map:
            fail("class_map.json holds another map")
    if best != os.path.join(ckpt, "best"):
        fail(f"finetune saved no best checkpoint: {best}")
    saved = ft.read_finetune_checkpoint(best)
    live, images = records["eval"][0]["model"], records["eval"][0]["images"]
    model = ft.Classifier(live.backbone.config, len(class_map))
    model.load_state_dict({**saved["params"], **saved["batch_stats"]},
                          strict=True)
    model.to("cuda")
    with torch.no_grad():
        same = torch.equal(model(images), live(images))
    mb = sum(os.path.getsize(os.path.join(best, n))
             for n in os.listdir(best)) / 1e6
    log(f"  best/ ({mb:.1f} MB) reloaded: eval logits bitwise equal to the "
        f"in-memory model's {same}")
    if not same:
        fail("the reloaded best checkpoint gives other eval logits")
    del model, live, images, records
    return k4, summary


def _ft_step_grads(device, dtype, state, batch):
    """One finetune train step of ``state`` on ``batch`` (uint8 images,
    labels) at TinyViT-5M-224 in ``dtype``: (loss, the gradients handed to
    the optimizer), on the host in f32."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.train import finetune_tinyvit as ft
    from geoguessr_ai_torch.train.state import AdamW, warmup_cosine_decay

    config = TinyViTConfig.tiny_vit_5m_224(dtype=getattr(torch, dtype))
    model = ft.Classifier(config, len(FT_COUNTRIES))
    model.load_state_dict(state, strict=True)
    model.to(device)
    params = dict(model.named_parameters())
    opt = AdamW(params, OptimizerConfig(max_grad_norm=None),
                warmup_cosine_decay(1e-4, 1, 10))
    grads = {}
    inner = opt.step

    def capture(p, g):
        grads.update({n: t.detach().float().cpu() for n, t in g.items()})
        return inner(p, g)

    opt.step = capture
    imgs, labels = batch
    px = ft.pixels(imgs, config, device)
    t0 = time.perf_counter()
    loss, _ = ft.finetune_train_step(model, opt, px,
                                     torch.from_numpy(labels).to(device))
    loss = float(loss)
    log(f"finetune step {device} {dtype}: batch {FT_CPU_BATCH}, loss "
        f"{loss:.6f}, {time.perf_counter() - t0:.2f} s")
    return loss, grads


def _ft_step_vs_cpu(train):
    """(d) One finetune train step of seeded weights on FT_CPU_BATCH train
    rows: the card in bf16 against the port on the CPU in f32 and in bf16,
    under phase 9's gates; then the card in f32 against the CPU in f32,
    under phase 26's f32 gates, with K4 (the backward core's f32 kind)
    exactly FT_K4_PER_STEP launches and no other kernel.  Returns the f32
    step's K4 launches."""
    from geoguessr_ai_torch.models.super_guessr import init_parameters_
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.train import finetune_tinyvit as ft

    model = ft.Classifier(TinyViTConfig.tiny_vit_5m_224(), len(FT_COUNTRIES))
    init_parameters_(model, SEED + 19)
    state = model.state_dict()
    rows = train[:FT_CPU_BATCH]
    batch = (ft._decode(rows, 224),
             np.array([r["label"] for r in rows], np.int64))
    gl, gg = _ft_step_grads("cuda", "bfloat16", state, batch)
    cl, cg = _ft_step_grads("cpu", "float32", state, batch)
    bl, bg = _ft_step_grads("cpu", "bfloat16", state, batch)
    log("(d) finetune step, card bf16 against CPU f32 and bf16:")
    bad = _step_disagreements(gl, gg, cl, cg, bl, bg)
    if bad:
        fail(f"the finetune step on the card disagrees with the CPU: {bad}")
    _reset_all_launches()
    fl, fg = _ft_step_grads("cuda", "float32", state, batch)
    torch.cuda.synchronize()
    launches = _all_launches()
    _f32_step_gates("(d) finetune step in f32", fl, fg, cl, cg, launches,
                    {**{k: 0 for k in launches}, "K4": FT_K4_PER_STEP})
    return launches["K4"]


def _ft_k4_cases():
    """(e) K4 at the finetune's three shapes against its plain version,
    with its times beside SDPA's backward and the bounds of the real
    (unpadded) and the padded work."""
    from geoguessr_ai_torch.ops import window_attention as wa

    rows = {}
    gen = torch.Generator().manual_seed(SEED + 19)
    for label, W, N, H in FT_K4_CASES:
        D = H * 32
        scale = 32 ** -0.5
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda",
                                                         torch.bfloat16)
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        g = torch.randn(W, N, D, generator=gen).to("cuda", torch.bfloat16)
        args = (qkv, bias, g, scale, H)
        got = wa._attention_qkv_bwd_cuda(*args)
        want = wa._attention_qkv_bwd_plain(*args)
        torch.cuda.synchronize()
        Np = -(-N // 64) * 64
        log(f"(e) K4 {label} W={W} N={N} (padded {Np}) H={H}")
        log(f"  {_bwd_plan('K4', W, N, H)}")
        errs = {}
        for out, a, b in (("d_qkv", got[0], want[0]),
                          ("d_bias", got[1], want[1])):
            abs_err, rel = _rel_err(a, b)
            finite = bool(torch.isfinite(a).all())
            log(f"  {out} max_abs_err {abs_err:.6g} max_rel_err {rel:.6g} "
                f"(tolerance {KERNEL_REL_TOL}) finite {finite}")
            if a.shape != b.shape or not finite or rel > KERNEL_REL_TOL:
                fail(f"K4 {label}: {out} disagrees with the plain version "
                     f"(rel {rel:.3g}, finite {finite})")
            errs[out] = abs_err
        del got, want
        ms = kernel_ms(lambda: wa._attention_qkv_bwd_cuda(*args))
        plain_ms = cuda_time_ms(lambda: wa._attention_qkv_bwd_plain(*args),
                                iters=3)
        lib_ms, lib_note = _sdpa_bwd_ms(qkv, bias, g, scale, H)
        bound, bound_by = _bwd_bound_ms("K4", W, N, H)
        padded, padded_by = _bwd_bound_ms("K4", W, Np, H)
        log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} ({lib_note})")
        log(f"  bound_ms {bound:.4f} ({bound_by}, N={N}); padded "
            f"{padded:.4f} ({padded_by}, N={Np}); kernel at "
            f"{bound / ms:.1%} of the unpadded bound")
        rows[label] = dict(W=W, N=N, H=H, max_abs_err=errs["d_qkv"],
                           max_abs_err_dbias=errs["d_bias"], ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by=bound_by,
                           bound_ms_padded=padded)
        del qkv, bias, g, args
    torch.cuda.empty_cache()
    return rows


def _ft_embeddings(tmp, mgr, train, summary):
    """(f) extract_embeddings from the finetuned backbone on the card
    against the CPU in f32, the build_prototype_bank tool's bank functions on
    them, and the Parquet writer's ImportError without pandas."""
    import importlib.util
    import types

    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.tools import build_prototype_bank as tool
    from geoguessr_ai_torch.train import finetune_tinyvit as ft

    rows = train[:FT_EMBED_ROWS]
    params, stats = summary["params"], summary["batch_stats"]
    t0 = time.perf_counter()
    gpu = ft.extract_embeddings(rows, params=params, batch_stats=stats)
    t1 = time.perf_counter()
    cpu = ft.extract_embeddings(
        rows, TinyViTConfig.tiny_vit_5m_224(dtype=torch.float32),
        {k: v.cpu() for k, v in params.items()},
        {k: v.cpu() for k, v in stats.items()}, device="cpu")
    cos = [_cosine(torch.from_numpy(a), torch.from_numpy(b))
           for a, b in zip(gpu, cpu)]
    log(f"(f) extract_embeddings: {gpu.shape} on the card in {t1 - t0:.2f} "
        f"s; cosine to the CPU f32 forward, lowest row {min(cos):.6f} "
        f"(>= {FT_EMBED_MIN_COSINE})")
    dim = TinyViTConfig.tiny_vit_5m_224().embed_dim
    if gpu.shape != (len(rows), dim) or not np.isfinite(gpu).all() or \
            min(cos) < FT_EMBED_MIN_COSINE:
        fail("extract_embeddings on the card disagrees with the CPU")
    emb_rows = [types.SimpleNamespace(lat=r["lat"], lon=r["lon"],
                                      embedding=e) for r, e in zip(rows, gpu)]
    bank = tool.build_bank_from_manager(mgr, emb_rows, max_protos=2)
    members = tool.build_member_bank_from_manager(mgr, emb_rows, max_protos=2,
                                                  max_members=4, reduce_dim=64)
    log(f"  prototype bank {bank.embeddings.shape}, {int(bank.mask.sum())} "
        f"prototypes; member bank {members.embeddings.shape} "
        f"({int(members.mask.sum())} members, projection "
        f"{members.projection.shape})")
    if bank.mask.sum() < 1 or members.mask.sum() < 1 or \
            not np.isfinite(bank.embeddings).all():
        fail("the bank functions joined no embedding to a cluster")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("pandas", "pyarrow", "fsspec")}
    # pandas absent (hidden from the import system where it is installed)
    hidden = sys.modules.get("pandas")
    sys.modules["pandas"] = None
    try:
        ft.extract_embeddings_parquet(rows, os.path.join(tmp, "e.parquet"),
                                      params=params, batch_stats=stats)
    except ImportError as e:
        log(f"  extract_embeddings_parquet without pandas: ImportError "
            f"({e}); installed here: {found}")
    else:
        fail("extract_embeddings_parquet ran without pandas")
    finally:
        if hidden is None:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = hidden


def phase_finetune(paths):
    """Phase 31; returns (K4's launches in the finetune, K4's rows at the
    finetune's shapes, K4's launches in the f32 step of (d))."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mgr, points = _ft_world(tmp)
        train, val, class_map = _ft_rows(mgr, points, paths)
        launches, summary = _ft_finetune(tmp, train, val, class_map)
        f32_launches = _ft_step_vs_cpu(train)
        rows = _ft_k4_cases()
        _ft_embeddings(tmp, mgr, train, summary)
        del summary
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    log(f"phase 31 in {took:.1f} s (limit {FT_PHASE_S:.0f} s)")
    if took > FT_PHASE_S:
        fail(f"phase 31 took {took:.1f} s, over its {FT_PHASE_S:.0f} s")
    return launches, rows, f32_launches


# ---------------------------------------------------------------------------
# Phase 32: training off the object store
# ---------------------------------------------------------------------------

#: Phase 32's store: 48 collected training panoramas (one epoch of 3 steps
#: of SURFACE_BATCH) and 16 ingested holdout panoramas (one validation
#: forward), every one inside two small (lon, lat) polygons.
STORE_STEPS = 3
STORE_HOLDOUT = 16
STORE_POLYGONS = (((10.0, 59.0), (11.5, 59.0), (11.5, 60.2), (10.0, 60.2)),
                  ((5.0, 60.0), (6.0, 60.0), (5.5, 61.0)))
#: The phase's limit, the object store's path with its two full-width
#: train runs included.
STORE_PHASE_S = 60.0


def _store_collect(tmp, paths):
    """(a) Seeded points in two polygons; ``collect_points`` with a fetch
    function that answers the four fixture JPEGs, into a ledger; 16
    holdout panoramas (each view re-encoded at the panorama's own JPEG
    quality, so no two are alike) ingested from a folder; both snapshots
    merged; the same points collected again give none."""
    import io

    from PIL import Image

    from geoguessr_ai_torch.acquisition.collect import collect_points
    from geoguessr_ai_torch.acquisition.sampling import (
        CollectionLedger,
        sample_points_in_polygons,
    )
    from geoguessr_ai_torch.data.s3 import ObjectStore

    blobs = [open(p, "rb").read() for p in paths]
    store = ObjectStore()
    n_train = SURFACE_BATCH * STORE_STEPS
    pts = sample_points_in_polygons([np.array(p) for p in STORE_POLYGONS],
                                    n_train + STORE_HOLDOUT,
                                    rng=np.random.default_rng(SEED))

    def fetch(lat, lon, api_key, secret=None, yaw_seed=0.0, session=None):
        return {"status": "OK"}, [((yaw_seed + 90.0 * k) % 360.0, blobs[k])
                                  for k in range(4)]

    ledger = CollectionLedger(os.path.join(tmp, "collected.txt"),
                              os.path.join(tmp, "failed.txt"))
    kw = dict(ledger=ledger, batch_size=n_train, seed=SEED, fetch_fn=fetch)
    got = collect_points(pts[:n_train], store, "offline", **kw)
    folder = os.path.join(tmp, "holdout_images")
    os.makedirs(folder)
    views = [Image.open(p).convert("RGB") for p in paths]
    for i, (lon, lat) in enumerate(pts[n_train:]):
        for h, im in zip((0, 90, 180, 270), views):
            buf = io.BytesIO()
            im.save(buf, "JPEG", quality=60 + 2 * i)
            name = f"streetview_{lat:.6f}_{lon:.6f}_heading_{h}.jpg"
            with open(os.path.join(folder, name), "wb") as f:
                f.write(buf.getvalue())
    ingested = store.ingest_local_folder(folder, holdout=True)
    store.merge_snapshot()
    store.merge_snapshot(holdout=True)
    again = collect_points(pts[:n_train], store, "offline", **kw)
    train_rows = store.load_latest_snapshot()
    hold_rows = store.load_latest_snapshot(holdout=True)
    log(f"(a) collect_points: {got}; ingest_local_folder(holdout=True): "
        f"{ingested} images; snapshots: {len(train_rows)} training rows, "
        f"{len(hold_rows)} holdout rows; the same points again: {again}")
    if (got != {"collected": n_train, "failed": 0, "batches": 1}
            or ingested != 4 * STORE_HOLDOUT
            or len(train_rows) != 4 * n_train
            or len(hold_rows) != 4 * STORE_HOLDOUT
            or again != {"collected": 0, "failed": 0, "batches": 0}):
        fail("the collection did not fill the store as expected")
    return store, folder


def _store_sqlite(tmp, store):
    """(b) build_sqlite_from_snapshot of both snapshots: the snapshot's
    keys, with the store's bytes."""
    from geoguessr_ai_torch.data.s3 import image_key
    from geoguessr_ai_torch.data.sqlite_dataset import load_sqlite_dataset

    dbs = []
    for holdout in (False, True):
        db = os.path.join(tmp, f"store_{'holdout' if holdout else 'train'}"
                          ".sqlite")
        t0 = time.perf_counter()
        n = store.build_sqlite_from_snapshot(db, holdout=holdout,
                                             fetch_threads=16)
        took = time.perf_counter() - t0
        rows = {(r.location_id, r.heading): r.image
                for r in load_sqlite_dataset(db)}
        snap = store.load_latest_snapshot(holdout)
        same = (n == len(snap) == len(rows)
                and set(rows) == {(r["location_id"], r["heading"])
                                  for r in snap}
                and all(blob == store.read_bytes(image_key(*key))
                        for key, blob in rows.items()))
        log(f"(b) build_sqlite_from_snapshot(holdout={holdout}): {n} rows "
            f"in {took:.2f} s; keys and bytes equal to the snapshot's and "
            f"the store's: {same}")
        if not same:
            fail(f"the SQLite built from the {'holdout' if holdout else 'training'}"
                 " snapshot differs from it")
        dbs.append(db)
    return dbs


def _store_run(label, run):
    """Runs ``run()`` (a train() call) with each train_step timed
    (synchronised) and the metrics kept; every launch counter at 0 first;
    fails unless K1-K5 launched exactly STORE_STEPS steps' and one
    validation forward's counts and no other kernel ran.  Returns
    (summary, recorder, step ms, wall s, peak GB, K1-K5 launches)."""
    from geoguessr_ai_torch.train import coordinator

    times, recorders = [], []
    real_step, real_logger = coordinator.train_step, coordinator.MetricsLogger

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    coordinator.train_step = timed_step
    coordinator.MetricsLogger = lambda **kw: (
        recorders.append(_TrainRecorder()) or recorders[-1])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    try:
        t0 = time.perf_counter()
        summary = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        coordinator.train_step = real_step
        coordinator.MetricsLogger = real_logger
    launches = _expect_launches(label, STORE_STEPS, 1)
    total = _ft_kernel_total()
    if total != sum(launches.values()):
        fail(f"{label}: {total - sum(launches.values())} launches of kernels "
             "other than K1-K5")
    # prefetch_to_device asks for batch k + 2 before step k, so with
    # three batches every fetch and decode falls before the first step:
    # the time to it holds the data path, the loop p50 none of it
    first = next(t for t, _, m in recorders[0].rows if "train/loss" in m)
    return (summary, recorders[0], times, (wall, first - t0),
            torch.cuda.max_memory_allocated() / 1e9, launches)


def _store_train(tmp, store, dbs, loop_p50_ms):
    """(c) main_streaming at full width against train() on (b)'s SQLites."""
    import hashlib

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data.s3 import image_key
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
    )
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.train.coordinator import main_streaming, train

    cfg = _surface_cfg(num_epochs=1)
    ckpt = os.environ["GEO_TPU_CKPT_DIR"]
    cwd = os.getcwd()
    os.chdir(tmp)  # the fetch cache: ./.s3cache
    try:
        streamed = _store_run("(c) main_streaming",
                              lambda: main_streaming(cfg))
    finally:
        os.chdir(cwd)
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    direct = _store_run("(c) train() on the SQLites", lambda: train(
        cfg, load_sqlite_panorama_dataset(dbs[0]),
        load_sqlite_panorama_dataset(dbs[1]), table))
    for label, (summary, rec, times, (wall, first), peak, _) in (
            ("main_streaming", streamed), ("train() on (b)'s SQLite", direct)):
        log(f"  {label}: losses {', '.join(f'{x:.6f}' for x in rec.losses())}"
            f", val_loss {summary.get('val_loss', float('nan')):.6f}; "
            f"train_step (synchronised) {', '.join(f'{t:.2f}' for t in times)}"
            f" ms, p50 {float(np.median(times)):.2f}; loop p50 "
            f"{rec.loop_p50_ms():.2f} ms; to the end of the first step "
            f"{first:.2f} s (the state built, the table read, all "
            f"{STORE_STEPS} batches fetched and decoded); {wall:.2f} s in "
            f"all; peak device memory {peak:.3f} GB")
    log(f"  phase 8's train() loop p50 {loop_p50_ms:.2f} ms (SQLite-free "
        "fixture records)")
    got, want = streamed[1].losses(), direct[1].losses()
    vals = [s[0].get("val_loss", float("nan")) for s in (streamed, direct)]
    if (len(got) != STORE_STEPS or not np.allclose(
            got + vals[:1], want + vals[1:], rtol=RESUME_LOSS_RTOL, atol=0.0)):
        fail(f"main_streaming's losses {got} (val {vals[0]}) differ from "
             f"train()'s on the SQLites {want} (val {vals[1]}) beyond "
             f"{RESUME_LOSS_RTOL}")
    keys = {image_key(r["location_id"], r["heading"])
            for h in (False, True) for r in store.load_latest_snapshot(h)}
    cache = os.path.join(tmp, ".s3cache")
    files = sorted(os.listdir(cache))
    want_files = sorted(hashlib.sha1(k.encode()).hexdigest() for k in keys)
    names = sorted(os.listdir(ckpt))
    log(f"  fetch cache: {len(files)} files for the {len(keys)} image keys "
        f"of the training and holdout snapshots (one a key: "
        f"{files == want_files}); {ckpt}: {names}")
    if files != want_files:
        fail("the fetch cache does not hold exactly one file a snapshot key")
    if not {"last", "best"} <= set(names):
        fail(f"main_streaming left {names} in GEO_TPU_CKPT_DIR")
    return ckpt, streamed[0], {k: streamed[5][k] + direct[5][k]
                               for k in streamed[5]}


def _store_registry(tmp, store, ckpt, db, summary):
    """(d) the registry: run_benchmark on the N-th newest checkpoint
    against run_benchmark on the directory; index 1 the older upload."""
    from geoguessr_ai_torch.data.s3 import download_nth_model_checkpoint
    from geoguessr_ai_torch.run_benchmark import run_benchmark

    best = os.path.join(ckpt, "best")
    first = store.upload_model_checkpoint(best)
    records = []
    for kw in (dict(clip_checkpoint_index=0), dict(checkpoint=best)):
        out = os.path.join(tmp, f"bench_{len(records)}.json")
        t0 = time.perf_counter()
        run_benchmark(num_samples=BENCH_SAMPLES, sqlite_path=db,
                      output_path=out, **kw)
        log(f"(d) run_benchmark({', '.join(kw)}) in "
            f"{time.perf_counter() - t0:.2f} s")
        with open(out) as f:
            records.append(json.load(f))
    same = records[0] == records[1]
    log(f"  registry checkpoint {first}: {len(records[0]) - 1} guesses equal "
        f"to those of the directory bit for bit: {same}")
    if not same or len(records[0]) < 2:
        fail("run_benchmark on the registry's checkpoint differs from "
             "run_benchmark on the checkpoint directory")
    while time.strftime("%Y%m%dT%H%M%S") == first.split("=")[-1]:
        time.sleep(0.05)  # a new second: a new registry prefix
    note = os.path.join(tmp, "run_summary.json")
    with open(note, "w") as f:
        json.dump({k: v for k, v in summary.items()
                   if isinstance(v, (int, float, str))}, f)
    second = store.upload_model_checkpoint(note)
    runs = store.list_model_checkpoints()
    newest = download_nth_model_checkpoint(0, os.path.join(tmp, "nth0"))
    older = download_nth_model_checkpoint(1, os.path.join(tmp, "nth1"))
    ok = (runs == [second.split("/")[-1], first.split("/")[-1]]
          and os.listdir(newest) == ["run_summary.json"]
          and os.listdir(older) == ["state.pt"]
          and open(os.path.join(older, "state.pt"), "rb").read()
          == open(os.path.join(best, "state.pt"), "rb").read())
    log(f"  two uploads: {runs}; index 0 {os.listdir(newest)}, index 1 "
        f"{os.listdir(older)} (best's state.pt bit for bit): {ok}")
    if not ok:
        fail("the registry does not give the older upload at index 1")


def _store_streams(tmp, store, hold_db):
    """(e) PanoramaStream over the holdout snapshot against
    PanoramaBatchIterator over the same rows, and the host rates."""
    from geoguessr_ai_torch.data.pipeline import PanoramaBatchIterator
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
    )
    from geoguessr_ai_torch.data.streaming import PanoramaStream

    cache = os.path.join(tmp, "stream_cache")
    passes, rates = {}, {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        passes[name] = list(PanoramaStream(store, 512, holdout=True,
                                           cache_dir=cache))
        rates[f"stream, cache {name}"] = (len(passes[name])
                                          / (time.perf_counter() - t0))
    rows = load_sqlite_panorama_dataset(hold_db)
    t0 = time.perf_counter()
    batches = list(PanoramaBatchIterator(rows, SURFACE_BATCH, 512,
                                         decode_threads=8))
    rates[f"SQLite iterator B={SURFACE_BATCH}, 8 threads"] = (
        sum(b["num_real"] for b in batches) / (time.perf_counter() - t0))
    views = np.concatenate([b["pixel_values"][:b["num_real"]]
                            for b in batches])
    ids = [i for b in batches for i in b["location_id"][:b["num_real"]]]
    same = (len(passes["cold"]) == len(views) == STORE_HOLDOUT
            and ids == [t["location_id"] for _, t in passes["cold"]]
            and all(np.array_equal(v, w) and np.array_equal(v, u)
                    for (v, _), (u, _), w in zip(passes["cold"],
                                                 passes["warm"], views)))
    log(f"(e) PanoramaStream over the holdout snapshot against "
        f"PanoramaBatchIterator over its SQLite rows: {len(views)} "
        f"panoramas bitwise equal: {same}; host panos/s at 512 px: "
        + "; ".join(f"{k} {v:.2f}" for k, v in rates.items())
        + f" ({os.cpu_count()} host cores)")
    if not same:
        fail("PanoramaStream differs from PanoramaBatchIterator")


def _store_random_panorama(tmp, store, folder):
    """(f) A random holdout panorama, downloaded by seed and by the
    inference entry point's fallback, served by the TinyViT engine."""
    import contextlib
    import io

    from geoguessr_ai_torch import inference
    from geoguessr_ai_torch.serving.engine import ServingEngine

    engine = ServingEngine(seed=SEED)

    def sources(lat, lon):
        return [os.path.join(folder, f"streetview_{lat:.6f}_{lon:.6f}_"
                             f"heading_{h}.jpg") for h in (0, 90, 180, 270)]

    paths, lat, lon = store.download_random_panorama(
        os.path.join(tmp, "random_pano"), seed=SEED)
    same = _same_results([engine.predict_images(paths)],
                         [engine.predict_images(sources(lat, lon))])
    log(f"(f) download_random_panorama(seed={SEED}): ({lat}, {lon}); the "
        f"engine's guess bitwise that of the ingested files: {same}")
    if not same:
        fail("the downloaded panorama is guessed otherwise than its files")
    real_fixture, real_engine = inference.fixture_panorama, inference._get_engine
    inference.fixture_panorama = lambda: []
    inference._get_engine = lambda *a, **k: engine
    served, predict = [], engine.predict_images
    engine.predict_images = lambda p: served.append(predict(p)) or served[-1]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            inference.main([])
    finally:
        inference.fixture_panorama = real_fixture
        inference._get_engine = real_engine
        engine.predict_images = predict
    printed = out.getvalue().split()
    got = sorted(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "geo_tpu_pano", "heading=*.jpg")))
    blobs = [open(p, "rb").read() for p in got]
    match = [sources(r["lat"], r["lon"])
             for r in store.load_latest_snapshot(holdout=True)
             if r["heading"] == 0]
    match = [s for s in match if [open(p, "rb").read() for p in s] == blobs]
    r = engine.predict_images(match[0]) if len(match) == 1 else None
    ok = (r is not None and _same_results(served, [r]) and len(served) == 1
          and printed == [f"{r.lat:.6f}", f"{r.lon:.6f}"])
    log(f"  inference with no images and no fixture: printed {printed}; its "
        f"guess (embedding included) bitwise that of the ingested files of "
        f"the one panorama whose bytes it downloaded: {ok}")
    if not ok:
        fail("the inference fallback's guess is not that of the panorama it "
             "downloaded")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def phase_store(paths, loop_p50_ms):
    """Phase 32; returns K1-K5's launches in its two train runs."""
    from geoguessr_ai_torch import config as C

    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in ("GEO_TPU_STORE_URL",
                                            "GEO_TPU_CKPT_DIR")}
    saved_ckpt, saved_tmp = C.CHECKPOINT_DIR, tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["GEO_TPU_STORE_URL"] = f"file://{tmp}/bucket"
        os.environ["GEO_TPU_CKPT_DIR"] = C.CHECKPOINT_DIR = os.path.join(
            tmp, "ckpt")
        tempfile.tempdir = os.path.join(tmp, "tmp")
        os.makedirs(tempfile.tempdir)
        try:
            store, folder = _store_collect(tmp, paths)
            dbs = _store_sqlite(tmp, store)
            ckpt, summary, launches = _store_train(tmp, store, dbs,
                                                   loop_p50_ms)
            _store_registry(tmp, store, ckpt, dbs[0], summary)
            _store_streams(tmp, store, dbs[1])
            _store_random_panorama(tmp, store, folder)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            C.CHECKPOINT_DIR, tempfile.tempdir = saved_ckpt, saved_tmp
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    log(f"phase 32 in {took:.1f} s (limit {STORE_PHASE_S:.0f} s)")
    if took > STORE_PHASE_S:
        fail(f"phase 32 took {took:.1f} s, over its {STORE_PHASE_S:.0f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 33: two ranks on one card (parallel/mesh.py over gloo)
# ---------------------------------------------------------------------------

#: The global batch of the data-axis steps (8 panoramas a rank) and of the
#: one-process reference; the model-axis step's batch (every rank the
#: whole of it: two full-width ranks of B=16 would not fit on one card),
#: which runs in f32 (K1-K5's f32 twins): its split GEMMs round in another
#: order, and a bf16 step's gradient moves by that through the batch
#: statistics (below phase 9's 0.99 in a CPU rehearsal at narrow widths),
#: while in f32 it is held to phase 26's gates.
MESH_BATCH = 16
MESH_STEPS = 3
MESH_MP_BATCH = 4
MESH_EMBED_IMAGES = 128
MESH_EMBED_MIN_COSINE = 0.999
MESH_PHASE_S = 60.0


def _mesh_launches():
    """K1-K5's launches since the last reset, and every other launch of
    the TinyViT, CLIP and MBConv kernels."""
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa

    k1_5 = {k: wa.LAUNCHES[m[0]] for k, m in ALL_META.items()}
    total = sum(sum(mod.LAUNCHES.values()) for mod in (wa, mbconv, ca))
    return k1_5, total - sum(k1_5.values())


def _mesh_embed_images():
    return np.random.default_rng(SEED).integers(
        0, 256, (MESH_EMBED_IMAGES, 512, 512, 3), dtype=np.uint8)


def _mesh_steps(state, batch, centroids, steps, mesh=None):
    """``steps`` train_steps on ``batch``: (losses, grad norms, the first
    step's gradients on the host, each step's synchronised ms)."""
    from geoguessr_ai_torch.train.steps import train_step

    first = {}
    real = state.optimizer.step

    def capture(params, g, **kw):
        if not first:
            first.update({n: t.detach().float().cpu() for n, t in g.items()})
        return real(params, g, **kw)

    state.optimizer.step = capture
    losses, norms, ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = train_step(state, batch, centroids, mesh=mesh)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    state.optimizer.step = real
    return losses, norms, first, ms


def _mesh_rank(out):
    """One rank of phase 33, started by ``parallel.mesh.spawn_ranks`` on
    cuda:0 over gloo: its data-axis state, its model-axis state (f32) and its
    ``Embedder`` built, then (once ``out/go`` exists) MESH_STEPS data-axis
    train_steps of its half of the fixture batch at full width with the
    launch counters at 0 first, the gradient all-reduce timed alone, a
    dp=2 ``Embedder`` call and one model-axis step; writes what it saw to
    ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from geoguessr_ai_torch.config import BackboneConfig, MeshConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.parallel.mesh import batch_slice, create_mesh
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rank = dist.get_rank()
    res = {}
    dp = create_mesh(MeshConfig(data_parallel=2), device=dev)
    mp = create_mesh(MeshConfig(data_parallel=1, model_parallel=2),
                     device=dev)
    state, batch, centroids = fixture_train_setup(MESH_BATCH, device=dev,
                                                  seed=SEED, mesh=dp)
    local = batch_slice(batch, dp)
    mp_state, mp_batch, _ = fixture_train_setup(
        MESH_MP_BATCH, device=dev, seed=SEED, dtype="float32", mesh=mp)
    emb = Embedder(BackboneConfig.tinyvit(), device=dev,
                   model_config=bulk_embed_config(), seed=SEED, mesh=dp)
    images = _mesh_embed_images()
    go = os.path.join(out, "go")
    deadline = time.monotonic() + 2 * MESH_PHASE_S
    while not os.path.exists(go):  # the one-process references are done
        if time.monotonic() > deadline:
            raise TimeoutError("phase 33's one-process references never ended")
        time.sleep(0.05)

    _reset_all_launches()
    res["losses"], res["grad_norms"], grads, res["step_ms"] = _mesh_steps(
        state, local, centroids, MESH_STEPS, dp)
    res["launches"], res["other_launches"] = _mesh_launches()
    res["bn"] = {n: b.detach().cpu().clone()
                 for n, b in state.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
    if rank == 0:
        res["grads"] = grads
    # what each step all-reduces: one f32 gradient a parameter
    flat = [torch.zeros_like(p) for p in state.model.parameters()]
    res["allreduce_numel"] = sum(t.numel() for t in flat)
    res["allreduce_ms"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.average_gradients(flat)
        torch.cuda.synchronize()
        res["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    del state, batch, local, grads, flat
    gc.collect()
    torch.cuda.empty_cache()

    res["embed"] = emb(images)
    del emb
    gc.collect()
    torch.cuda.empty_cache()

    res["mp_cell_layer"] = tuple(mp_state.model.cell_layer.weight.shape)
    _reset_all_launches()
    res["mp_losses"], _, mp_grads, res["mp_step_ms"] = _mesh_steps(
        mp_state, mp_batch, centroids, 1, mp)
    res["mp_launches"], res["mp_other_launches"] = _mesh_launches()
    mp_grads = mp.unshard(mp_grads)  # a collective: both ranks
    if rank == 0:
        res["mp_grads"] = mp_grads
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _mesh_gates(label, got_loss, want_loss, got, want,
                loss_rtol=TRAIN_LOSS_RTOL, min_cos=TRAIN_GRAD_MIN_COSINE):
    """A card step against another card step (by default phase 9's gates):
    the loss within ``loss_rtol``, every top-level module's gradient at
    cosine >= ``min_cos``; returns what fails."""
    rel = abs(got_loss - want_loss) / abs(want_loss)
    log(f"  {label}: loss {got_loss:.8f} vs one process {want_loss:.8f} "
        f"(rel {rel:.3g}, <= {loss_rtol})")
    bad = [] if rel <= loss_rtol else [f"{label} loss"]
    worst = (1.0, "")
    for mod in sorted({_top_module(n) for n in want}):
        names = [n for n in want if _top_module(n) == mod]
        cos = _cosine(torch.cat([got[n].flatten() for n in names]),
                      torch.cat([want[n].flatten() for n in names]))
        worst = min(worst, (cos, mod))
        if cos < min_cos:
            bad.append(f"{label} grad {mod} cosine {cos:.8f}")
    log(f"  {label}: lowest module gradient cosine {worst[0]:.8f} "
        f"({worst[1]}; >= {min_cos})")
    return bad


def _mesh_references():
    """One process's side of phase 33 on the card, on the ranks' seeded
    inputs: (the MESH_STEPS losses, the first step's gradients and the
    steps' ms at MESH_BATCH; the f32 step's loss and gradients at
    MESH_MP_BATCH with the cell count; the Embedder's rows)."""
    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup

    state, batch, centroids = fixture_train_setup(MESH_BATCH, seed=SEED)
    dp = _mesh_steps(state, batch, centroids, MESH_STEPS)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    state, batch, centroids = fixture_train_setup(MESH_MP_BATCH, seed=SEED,
                                                  dtype="float32")
    mp = _mesh_steps(state, batch, centroids, 1)
    cells = state.model.cell_layer.weight.shape[0]
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    emb = Embedder(BackboneConfig.tinyvit(), model_config=bulk_embed_config(),
                   seed=SEED)
    rows = torch.from_numpy(emb(_mesh_embed_images()))
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    return dp, mp, cells, rows


def phase_mesh():
    """Phase 33: two ranks sharing the card over gloo (the card's machine
    has one card; NCCL refuses two ranks on one device).  The ranks start
    and build their states while this process computes the one-process
    references on the card; they run their steps once it has freed the
    card (the ``go`` file).  The numbers are two ranks on one card, not a
    multi-card measurement."""
    import threading

    from geoguessr_ai_torch.parallel.mesh import spawn_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        failed = []

        def run_ranks():
            try:
                spawn_ranks(_mesh_rank, 2,
                            f"file://{os.path.join(tmp, 'rendezvous')}",
                            [tmp], timeout=3 * MESH_PHASE_S)
            except Exception as e:  # a rank's error, reported below
                failed.append(e)

        ranks_thread = threading.Thread(target=run_ranks)
        ranks_thread.start()
        try:
            (losses, _, grads, ms), (mp_losses, _, mp_grads, _), cells, \
                want_rows = _mesh_references()
        finally:
            with open(os.path.join(tmp, "go"), "w"):
                pass
        t_go = time.perf_counter()
        ranks_thread.join()
        if failed:
            fail(f"phase 33: the ranks failed: {failed[0]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    refs_s, ranks_s = t_go - t0, time.perf_counter() - t_go
    bad = []
    per = LAUNCHES_PER_TRAIN_STEP
    for r, res in enumerate(ranks):
        want = {k: n * MESH_STEPS for k, n in per.items()}
        log(f"  rank {r}: launches over {MESH_STEPS} dp=2 steps "
            f"{res['launches']} (expected {want}), other kernels "
            f"{res['other_launches']}; model-axis step {res['mp_launches']}"
            f" (expected {per}), other {res['mp_other_launches']}")
        if (res["launches"] != want or res["other_launches"]
                or res["mp_launches"] != per or res["mp_other_launches"]):
            bad.append(f"rank {r} launches")
    bn0, bn1 = ranks[0]["bn"], ranks[1]["bn"]
    equal = all(torch.equal(bn0[n], bn1[n]) for n in bn0)
    log(f"  BatchNorm running statistics bitwise equal across the ranks: "
        f"{equal} ({len(bn0)} buffers)")
    if not equal:
        bad.append("running statistics differ between the ranks")
    for i, (a, b) in enumerate(zip(ranks[0]["losses"], losses)):
        rel = abs(a - b) / abs(b)
        log(f"  dp=2 step {i + 1}: loss {a:.6f} (rank 1 "
            f"{ranks[1]['losses'][i]:.6f}) vs one process {b:.6f}, rel "
            f"{rel:.3g}")
        if rel > TRAIN_LOSS_RTOL or ranks[1]["losses"][i] != a:
            bad.append(f"dp=2 step {i + 1} loss")
    bad += _mesh_gates("dp=2 step 1", ranks[0]["losses"][0], losses[0],
                       ranks[0]["grads"], grads)
    log(f"  model axis: the cell layer's local weight "
        f"{ranks[0]['mp_cell_layer']} of {cells} cells (ceil(n / 2) rows, "
        f"rank 1's last padded)")
    if ranks[0]["mp_cell_layer"][0] != -(-cells // 2):
        bad.append("the cell layer is not sharded")
    bad += _mesh_gates(f"mp=2 f32 step (B={MESH_MP_BATCH})",
                       ranks[0]["mp_losses"][0], mp_losses[0],
                       ranks[0]["mp_grads"], mp_grads,
                       F32_TRAIN_LOSS_RTOL, F32_TRAIN_GRAD_MIN_COSINE)
    worst = min(_cosine(torch.from_numpy(res["embed"][i]), want_rows[i])
                for res in ranks for i in range(MESH_EMBED_IMAGES))
    log(f"  dp=2 Embedder over 2 x {MESH_EMBED_IMAGES // 2} images: lowest "
        f"row cosine to one process {worst:.6f} (>= {MESH_EMBED_MIN_COSINE})")
    if worst < MESH_EMBED_MIN_COSINE:
        bad.append("dp=2 Embedder")

    numel = ranks[0]["allreduce_numel"]
    ar = [float(np.median(res["allreduce_ms"])) for res in ranks]
    dp_ms = [float(np.median(res["step_ms"][1:])) for res in ranks]
    took = time.perf_counter() - t0
    log(f"  two ranks sharing one card over gloo (not a multi-card figure): "
        f"gradient all-reduce of {numel} f32 ({numel * 4 / 1e6:.1f} MB) "
        f"p50 {ar[0]:.2f} / {ar[1]:.2f} ms a step (ranks 0 / 1); dp=2 "
        f"train_step p50 {dp_ms[0]:.2f} / {dp_ms[1]:.2f} ms (8 panoramas a "
        f"rank) beside one process's {float(np.median(ms[1:])):.2f} ms "
        f"(16); model-axis f32 step {ranks[0]['mp_step_ms'][0]:.2f} ms")
    log(f"phase 33 in {took:.1f} s (references {refs_s:.1f} s while the "
        f"ranks start, then the ranks {ranks_s:.1f} s; limit "
        f"{MESH_PHASE_S:.0f} s)")
    if bad:
        fail(f"phase 33: {bad}")
    if took > MESH_PHASE_S:
        fail(f"phase 33 took {took:.1f} s, over its {MESH_PHASE_S:.0f} s")


# ---------------------------------------------------------------------------
# Phase 34: the kernels line
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 34: the window-attention tile knobs
# ---------------------------------------------------------------------------

#: The forward kernels at their production shapes: K1 (stage 1) and K2
#: (stage 2) of a serving bucket of 16, K3 at stage 3 ((W, N, C, H)), K8a
#: (stage 2) and K8b (stage 1) of the head-major bucket 16 ((W, H, N)), K9
#: at 64 images.
KNOB_FWD_CASES = (
    ("K1", "stage1", (1024, 256, 192, 6)),
    ("K2", "stage2", (64, 1024, 384, 12)),
    ("K3", "stage3", (64, 256, 576, 18)),
    ("K8a", "stage2_bucket16", (64, 12, 1024)),
    ("K8b", "stage1_bucket16", (1024, 6, 256)),
    ("K9", "bucket16", (64,)),
)
#: The backward kernels ((W, N, H)): K4 at the B=16 train shapes of
#: TinyViT-21M-512 and at the finetune's three TinyViT-5M-224 shapes, K5
#: and K7 at stage 2.
KNOB_BWD_CASES = (
    ("K4", "stage1", (1024, 256, 6)),
    ("K4", "stage3", (64, 256, 18)),
    ("K4", "5m224_stage1", (1024, 49, 4)),
    ("K4", "5m224_stage2", (64, 196, 5)),
    ("K4", "5m224_stage3", (64, 49, 10)),
    ("K5", "stage2", (64, 1024, 12)),
    ("K7", "stage2", (64, 1024, 12)),
)
_K4_LABELS = tuple(label for k, label, _ in KNOB_BWD_CASES if k == "K4")
#: (c): each non-default value (label, the knobs it sets) and the cases it
#: runs.
KNOB_VALUE_CASES = (
    ("BWD_Q_ROWS=64", {"BWD_Q_ROWS": 64},
     tuple(("K4", label) for label in _K4_LABELS)
     + (("K5", "stage2"), ("K7", "stage2"))),
    ("FWD_Q_ROWS=128", {"FWD_Q_ROWS": 128},
     (("K2", "stage2"), ("K3", "stage3"), ("K8b", "stage1_bucket16"),
      ("K8a", "stage2_bucket16"), ("K1", "stage1"), ("K9", "bucket16"))),
    ("FUSED_BLOCK_WB=8", {"FUSED_BLOCK_WB": 8,
                          "FUSED_BLOCK_SCORE_BYTES": 32 * 1024 * 1024},
     (("K1", "stage1"), ("K9", "bucket16"))),
    ("BWD_PARTIAL_BYTES=4MiB", {"BWD_PARTIAL_BYTES": 4 * 1024 * 1024},
     (("K4", "stage3"),)),
)
#: (c): the case of each other kind whose launches are traced (the core's
#: template arguments and each launch's device time), at the kind and at
#: the defaults.
KNOB_TRACED = {"BWD_Q_ROWS=64": ("K4", "5m224_stage1"),
               "FWD_Q_ROWS=128": ("K2", "stage2")}
#: (d): the cases of ``tools.exp_r4_vmem`` run in subprocesses, one embed
#: and one train case.
KNOB_TOOL_CASES = ("s2bq1024_v64", "train_both_v64")
KNOB_PHASE_S = 90.0


def _knob_case(kernel, shape, gen):
    """One phase-34 case in bf16: a dict of the wrapper (``fn``) and its
    plain version, their arguments, the LAUNCHES key, a function timing
    the library call ((ms or None, what)) and the core's geometry (W, N,
    H, the windows of a map row for K9; N padded to 64 for K4)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    if kernel in ("K4", "K5", "K7"):
        W, N, H = shape
        D = H * 32
        qkv = randn(W, N, 3 * D).to(bf)
        bias = randn(H, N, N, std=0.5)
        g = randn(W, N, D).to(bf)
        name = {"K4": BWD_META["K4"][0], "K5": BWD_META["K5"][0],
                "K7": K7_META[0]}[kernel]
        plain = {"K4": wa._attention_qkv_bwd_plain,
                 "K5": wa._attention_bwd_merged_plain,
                 "K7": wa._attention_bwd_qtiled_plain}[kernel]
        return dict(fn=getattr(wa, name), plain=plain, name=name,
                    args=(qkv, bias, g, 32 ** -0.5, H),
                    library=lambda: _sdpa_bwd_ms(qkv, bias, g, 32 ** -0.5, H),
                    geometry=(W, -(-N // 64) * 64, H, None))
    if kernel in ("K8a", "K8b"):
        W, H, N = shape
        q, k, v = (randn(W, H, N, 32).to(bf) for _ in range(3))
        bias = randn(H, N, N, std=0.5)
        name = HEADMAJOR_META[kernel][0]
        return dict(fn=getattr(wa, name), plain=wa._attention_plain,
                    name=name, args=(q, k, v, bias, 32 ** -0.5),
                    library=lambda: _headmajor_sdpa_ms(q, k, v, bias,
                                                       32 ** -0.5),
                    geometry=(W, N, H, None))
    if kernel == "K9":
        images = shape[0]
        kern, plain, args, _, _, lib_ms, what = _embed_kernel_case(
            "K9", images, gen)
        rw = STAGE1_MAP // STAGE1_WINDOW
        return dict(fn=kern, plain=plain, name=EMBED_META["K9"][0],
                    args=args, library=lambda: (lib_ms, what),
                    geometry=(images * rw * rw, STAGE1_WINDOW ** 2,
                              STAGE1_HEADS, rw))
    W, N, C, H = shape
    a = _case_inputs(W, N, C, H, gen)
    scale = (C // H) ** -0.5
    qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                           a["b_qkv"], 1e-5)
    lib = (lambda: (_sdpa_ms(qkv, a["bias"], scale, H),
                    "scaled_dot_product_attention on its q, k, v and bias"))
    if kernel == "K3":
        args = (qkv, a["bias"], scale, H)
        fn, plain = wa._attention_qkv_fused_cuda, wa._attention_qkv_fused_plain
    elif kernel == "K2":
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                a["b_qkv"], a["bias"], scale, H, 1e-5)
        fn, plain = wa._fb_s2_cuda, wa._fb_s2_plain
    else:
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                a["b_qkv"], a["w_proj"], a["b_proj"], a["bias"], scale,
                H, 1e-5)
        fn, plain = wa._fused_block_cuda, wa._fused_block_plain
    return dict(fn=fn, plain=plain, name=KERNEL_META[kernel][0], args=args,
                library=lib, geometry=(W, N, H, None))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _core_kernels(fn):
    """The template arguments of each Hopper attention core kernel one
    fn() call launches, from a torch.profiler trace (empty when the trace
    holds no device kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.name.split("<", 1)[1].split(">", 1)[0]
                   for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and ("attn_bwd_sm90<" in evt.name
                        or "attention_fwd_sm90<" in evt.name)})


def _cuda_plan(lib, entry, *args, n):
    """The ``n`` ints a library's plan query fills, or fails."""
    import ctypes

    from geoguessr_ai_torch.ops import _build

    out = (ctypes.c_int * n)()
    err = _build.entry(lib, entry)(*args, ctypes.addressof(out))
    if err:
        fail(f"{entry}{args}: the plan query returned {err}")
    return list(out)


def _knob_plan_check(kernel, geometry, knobs, elem=2):
    """(a): the wrapper's plan mirror of one call against the CUDA plan's
    query at the same (W, N, H, hd 32, G, rows); returns a log line.
    ``elem`` 4: the backward core's f32 kind (``<lib>_plan_f32``)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    W, N, H, rw = geometry
    if kernel in ("K4", "K5", "K7"):
        plan = wa._bwd_call_plan(kernel, W, N, H, 32, knobs, elem)
        lib = {"K4": "attention_qkv_bwd", "K5": "attention_bwd_merged",
               "K7": "attention_bwd_qtiled"}[kernel]
        query = f"{lib}_plan" if elem == 2 else f"{lib}_plan_f32"
        got = _cuda_plan(lib, query, W, N, H, 32, plan["G"], plan["rows"],
                         n=12)
        modes = wa._BWD_LAUNCHES
        want = ([plan["smem"][m] for m in modes]
                + [plan["items"][m] for m in modes]
                + [plan["stages"][m] for m in modes])
        what = (f"rows {plan['rows']} G {plan['G']} smem "
                f"{dict(zip(modes, want[:4]))} items "
                f"{dict(zip(modes, want[4:8]))} slots {want[8:]}")
    else:
        plan = wa._fwd_call_plan(kernel, W, H, N, 32, knobs, rw)
        _, _, lib, fn = wa._FWD_KERNELS[kernel]
        got = _cuda_plan(lib, f"{fn}_plan", W, N, H, 32, plan["groups"],
                         plan["rows"], n=8)
        keys = ("smem", "items", "G", "NT", "NB", "QB", "S", "stream")
        want = [plan[k] for k in keys]
        what = ", ".join(f"{k} {v}" for k, v in zip(keys, want))
    if got != want:
        fail(f"{kernel} {geometry} {knobs}: the plan mirror {want} differs "
             f"from the CUDA plan {got}")
    return what


def _set_knobs(values):
    from geoguessr_ai_torch.ops import window_attention as wa

    for name, value in values.items():
        setattr(wa, name, value)
    return wa.tile_knobs()


def phase_tile_knobs():
    """Phase 34: the window-attention tile knobs.  (a) At every call the
    phase makes, the wrapper's plan mirror equals the CUDA plan's query;
    with SMEM_LIMIT_BYTES at 48 KiB every bf16 core call raises ValueError
    and no launch is counted.  (b) K1-K5, K7-K9 with every knob set to its
    default equal the run with the knobs untouched, bit for bit.  (c) Each
    non-default value against the kernel's plain version (max |err| / max
    |ref| <= KERNEL_REL_TOL), one launch a call, bitwise over two calls,
    timed beside the default (both device time) and the library call.  (d)
    One embed and one train case of ``tools.exp_r4_vmem`` in subprocesses,
    one timed call or step each: result "ok", the embed case's first 8
    embeddings at cosine >= MIN_COSINE to this process's default-knob run
    of the same forward on the batch's first 8 images.  Under
    KNOB_PHASE_S."""
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.tools import exp_r4_vmem as tv

    t0 = time.perf_counter()
    defaults = {name: d for name, (d, _) in wa.TILE_KNOBS.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    cases = {(k, label): _knob_case(k, shape, gen)
             for k, label, shape in KNOB_FWD_CASES + KNOB_BWD_CASES}
    torch.cuda.synchronize()
    log(f"(set-up) {len(cases)} cases in {time.perf_counter() - t0:.1f} s")

    # (a) the plan mirrors, and the shared-memory limit
    knobs = wa.tile_knobs()
    for (k, label), c in cases.items():
        what = _knob_plan_check(k, c["geometry"], knobs)
        log(f"(a) {k} {label} default: {what}")
    for value, over, which in KNOB_VALUE_CASES:
        knobs = _set_knobs(over)
        for k, label in which:
            log(f"(a) {k} {label} {value}: "
                f"{_knob_plan_check(k, cases[(k, label)]['geometry'], knobs)}")
        _set_knobs(defaults)
    wa.SMEM_LIMIT_BYTES = 48 * 1024
    _reset_all_launches()
    for (k, label), c in cases.items():
        try:
            c["fn"](*c["args"])
        except ValueError as e:
            if "SMEM_LIMIT_BYTES" not in str(e):
                fail(f"{k} {label}: SMEM_LIMIT_BYTES=48 KiB raised another "
                     f"ValueError: {e}")
            continue
        fail(f"{k} {label}: SMEM_LIMIT_BYTES=48 KiB did not refuse the call")
    wa.SMEM_LIMIT_BYTES = None
    moved = {k: n for k, n in _all_launches().items() if n}
    log(f"(a) SMEM_LIMIT_BYTES=48 KiB: all {len(cases)} calls refused with "
        f"ValueError; launches counted {moved or 0}")
    if moved:
        fail(f"SMEM_LIMIT_BYTES=48 KiB: launches were counted {moved}")

    # (b) every knob set to its default: the bits of the knobs untouched
    for (k, label), c in cases.items():
        c["default"] = _outputs(c["fn"](*c["args"]))
        _set_knobs(defaults)
        same = all(torch.equal(a, b) for a, b in
                   zip(c["default"], _outputs(c["fn"](*c["args"]))))
        log(f"(b) {k} {label}: every knob at its default, bitwise equal to "
            f"the knobs untouched {same}")
        if not same:
            fail(f"{k} {label}: the knobs at their defaults changed the bits")
    torch.cuda.synchronize()
    log(f"(a), (b) at {time.perf_counter() - t0:.1f} s")

    # (c) each non-default value against the plain version, timed
    rows = {}
    for value, over, which in KNOB_VALUE_CASES:
        if value in KNOB_TRACED:
            k, label = KNOB_TRACED[value]
            c = cases[(k, label)]
            for at, knobs in ((value, over), ("the defaults", defaults)):
                _set_knobs(knobs)
                names = _core_kernels(lambda: c["fn"](*c["args"]))
                log(f"(c) {k} {label} at {at}: the core kernels <"
                    + ">, <".join(names) + "> (torch.profiler; the item's "
                    "rows are the last template argument)")
                _log_launch_ms(_launch_ms(lambda: c["fn"](*c["args"])))
            _set_knobs(defaults)
        for k, label in which:
            c = cases[(k, label)]
            if "want" not in c:
                c["want"] = _outputs(c["plain"](*c["args"]))
                c["ms"] = device_time_ms(lambda: c["fn"](*c["args"]),
                                         iters=10, reps=3)
                c["library_ms"], c["library_what"] = c["library"]()
            _set_knobs(over)
            _reset_all_launches()
            got = _outputs(c["fn"](*c["args"]))
            again = _outputs(c["fn"](*c["args"]))
            torch.cuda.synchronize()
            launches = {n: v for n, v in wa.LAUNCHES.items() if v}
            stable = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [(*_rel_err(a, b), bool(torch.isfinite(a).all()))
                    for a, b in zip(got, c["want"])]
            same_bits = all(torch.equal(a, b)
                            for a, b in zip(got, c["default"]))
            ms = device_time_ms(lambda: c["fn"](*c["args"]), iters=10,
                                reps=3)
            _set_knobs(defaults)
            lib = c["library_ms"]
            log(f"(c) {k} {label} {value}: max_rel_err "
                + ", ".join(f"{e[1]:.6g}" for e in errs)
                + f" (tolerance {KERNEL_REL_TOL}), finite "
                f"{all(e[2] for e in errs)}, launches {launches}, bitwise "
                f"over two calls {stable}, equal to the default's bits "
                f"{same_bits}")
            log(f"  ms {ms:.4f} beside the default's {c['ms']:.4f} (device "
                f"time) and the library's "
                f"{'null' if lib is None else f'{lib:.4f}'} "
                f"({c['library_what']})")
            if launches != {c["name"]: 2}:
                fail(f"{k} {label} {value}: launches {launches}, expected "
                     f"{c['name']} 2")
            if not stable:
                fail(f"{k} {label} {value}: two calls gave different bits")
            if not all(fin and rel <= KERNEL_REL_TOL for _, rel, fin in errs):
                fail(f"{k} {label} {value}: disagrees with the plain version "
                     f"({errs})")
            rows.setdefault(k, {})[f"{label} {value}"] = dict(
                ms=ms, default_ms=c["ms"], library_ms=lib,
                max_abs_err=errs[0][0], max_rel_err=max(e[1] for e in errs))
    del cases, c
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(c) at {time.perf_counter() - t0:.1f} s")

    # (d) the tool's cases, each in a process of its own and one timed call
    # or step: the train case beside this process's default-knob embed of
    # the batch's first 8 images, then the embed case against it (one
    # full-width run on the card at a time)
    t1 = time.perf_counter()
    ref = os.path.join(tv.OUT_DIR, "phase34_default_emb.npy")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def tool(case, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "geoguessr_ai_torch.tools.exp_r4_vmem",
             "--case", case, "--iters", "1", *extra], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    (embed_case,) = [c for c in KNOB_TOOL_CASES
                     if tv.KNOB_CASES[c]["run"] == "embed"]
    procs = {c: tool(c) for c in KNOB_TOOL_CASES if c != embed_case}
    ref_rec, _ = tv.embed_run(save=ref, iters=0, images=8)
    torch.cuda.empty_cache()
    log(f"(d) default-knob embed here: {ref_rec} "
        f"({time.perf_counter() - t1:.1f} s)")
    outputs = {c: p.communicate(timeout=3 * KNOB_PHASE_S)
               for c, p in procs.items()}
    procs[embed_case] = tool(embed_case, "--ref", ref)
    outputs[embed_case] = procs[embed_case].communicate(
        timeout=3 * KNOB_PHASE_S)
    for case in KNOB_TOOL_CASES:
        out, err = outputs[case]
        recs = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
        for rec in recs:
            log(f"(d) {case}: {json.dumps(rec)}")
        oks = [r for r in recs if r.get("result") == "ok"]
        if procs[case].returncode or not oks:
            fail(f"(d) {case}: rc {procs[case].returncode}, records {recs}, "
                 f"stderr {err[-500:]}")
        if case == embed_case:
            cos = oks[0].get("min_cosine")
            log(f"(d) {case}: min cosine to the default-knob embed {cos} "
                f"(>= {MIN_COSINE})")
            if cos is None or not cos >= MIN_COSINE:
                fail(f"(d) {case}: min cosine {cos} < {MIN_COSINE}")
    took = time.perf_counter() - t0
    log(f"phase 34 took {took:.1f} s ((d) {time.perf_counter() - t1:.1f} s; "
        f"under {KNOB_PHASE_S:.0f} s)")
    if took > KNOB_PHASE_S:
        fail(f"phase 34 took {took:.1f} s, over its {KNOB_PHASE_S:.0f} s")
    _reset_all_launches()
    return rows


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
    train_launches, train_loop_p50 = phase_train()
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
    guess_launches, _ = phase_guess_path(paths)
    gc.collect()
    torch.cuda.empty_cache()
    surface_launches = phase_train_surface(paths, train_loop_p50)
    clip_train_launches = phase_clip_train(paths)
    finetune_launches, finetune_rows, ft_f32_launches = phase_finetune(paths)
    f32_launches["K4"] += ft_f32_launches
    store_launches = phase_store(paths, train_loop_p50)
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh()
    knob_rows = phase_tile_knobs()

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
                         + static_launches.get(k, 0)
                         + guess_launches.get(k, 0)
                         + surface_launches.get(k, 0)
                         + store_launches.get(k, 0)
                         + (finetune_launches if k == "K4" else 0)),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": library,
        }
        if k in ("K1", "K2"):
            entry["sdpa_attention_ms"] = row["sdpa_ms"]
        if k in ("K1", "K2"):
            entry["launch_ms"] = row["launch_ms"]
        if k in BWD_META:
            entry["max_abs_err_dbias"] = row["max_abs_err_dbias"]
            entry["launch_ms"] = row["launch_ms"]
        if k == "K4":
            stage3 = rows[("K4", "stage3")]
            entry["stage3"] = {key: stage3[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "launch_ms")}
            # phase 31: TinyViT-5M-224's ragged windows at B=64
            entry["finetune_224"] = finetune_rows
            entry["finetune_launches"] = finetune_launches
        kernels.append(entry)
    for k, (name, source, replaces) in CLIP_META.items():
        row = clip_rows[(k, "vit_l14_bucket16")]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (clip_launches[k] + clip_train_launches[k]
                         + (clip_int8_launches if k == "K6" else 0)),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # SDPA computes K6's function; K11 adds the out-projection
            "library_ms": row["sdpa_ms"] if k == "K6" else None,
            "vit_b32_ms": clip_rows[(k, "vit_b32")]["ms"],
        }
        if k == "K11":
            entry["sdpa_matmul_ms"] = row["sdpa_mm_ms"]
            entry["matmul_ms"] = row["matmul_ms"]
            entry["launch_ms"] = row["launch_ms"]
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
            **({"launch_ms": row["launch_ms"]} if k == "K9" else {}),
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
    for kind in ("int8", "bf16"):
        row = exp_rows[("K13", kind, main_shape)]
        kernels.append({
            "name": name if kind == "int8" else f"{name}[bf16]",
            "route": "cuda", "source": source, "replaces": replaces,
            # the tool's launches of this type (the wrapper's count is
            # exp_launches["K13"], both types)
            "launches": exp_launches[f"K13 {kind}"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["lib_ms"],
            "library": row["lib_what"], "tops": row["tops"],
            "from_kn_b_ms": row["kn_ms"],
            "main_case": f"{kind} {main_shape}",
            "other_cases": {f"{key[2]}": {
                "ms": r["ms"], "tops": r["tops"], "bound_ms": r["bound_ms"],
                "library_ms": r["lib_ms"]}
                for key, r in exp_rows.items()
                if key[0] == "K13" and key[1] == kind and key[2] != main_shape},
        })
    # the f32 entries: launches over the f32 main paths (phases 25-26, and
    # phase 31's f32 finetune step for K4)
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
    # phase 34's readings of each kernel's non-default tile knobs
    ids = {m[0]: k for k, m in {**ALL_META, **HEADMAJOR_META, "K7": K7_META,
                                "K9": EMBED_META["K9"]}.items()}
    for entry in kernels:
        if ids.get(entry["name"]) in knob_rows:
            entry["tile_knobs"] = knob_rows[ids[entry["name"]]]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

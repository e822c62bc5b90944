"""Where the device time of the guess path, or of a train step, goes.

    python -m geoguessr_ai_torch.profile_forward [--bucket 16] [--steps 5] [--trace PATH]
    python -m geoguessr_ai_torch.profile_forward --backbone clip [--bucket 16]
    python -m geoguessr_ai_torch.profile_forward --train [--bucket 16] [--steps 3]
    python -m geoguessr_ai_torch.profile_forward --embed [--bucket 512] [--no-knobs | --static]
    python -m geoguessr_ai_torch.profile_forward --head-major [--bucket 16]
    python -m geoguessr_ai_torch.profile_forward --bwd-two-kernel [--bucket 16]

Builds the full-width model (TinyViT-21M-512, or CLIP ViT-L/14-336 with
``--backbone clip``; bf16, 12647 cells, seeded random weights) on the GPU.
By default it serves the fixture panorama at one bucket size through the
ServingEngine; with ``--train`` (TinyViT only) it runs
``train_step`` on a fixed batch of ``--bucket`` fixture panoramas (f32
master weights, the default freeze and optimizer); with ``--embed`` it runs
the bulk-embedding ``Embedder`` on a fixed host batch of ``--bucket``
decoded fixture images (default 512) in the embed configuration
(``data.embed_builder.bulk_embed_config``: K1 at stage 3, K10 at stage 0
and K9 at stage 1; ``--no-knobs`` turns K10 and K9 off; ``--static`` runs
the default bulk-embedding configuration instead, the static-int8 TinyViT
of ``embed_builder.static_config``, calibrated in the warm-up).  ``--head-major``
serves the head-major configuration (``HEAD_MAJOR``: every attention stage
a ``pallas_attention_stages`` stage, no fused-block stage, and
``QKV_KERNEL_MIN_N`` raised above every N, so K8a/K8b run where K1-K3
did); ``--bwd-two-kernel`` is ``--train`` with ``BWD_MERGED`` False (K7 in
place of K5).  Under
``torch.profiler`` it prints per forward or step: the host wall time, the
device's busy time and idle share, device time by group and the kernels by
device time.  The last line is the same as one JSON object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

#: Kernel-name substrings -> the port's layer they belong to, first match.
GROUPS = (
    # the first design, which only the f32 twins of K1, K2, K3 and K9 run
    # (in bf16 their attention runs the forward core, which _group tells
    # apart by its template arguments)
    ("window_attention_kernel", "attention (f32 K1/K2/K3/K9 CUDA)"),
    ("ln_gemm_kernel", "LN+GEMM (f32 K1/K2/K9 CUDA)"),
    ("mbconv_kernel", "fused MBConv (K10 CUDA)"),
    # the bf16 Hopper kernels: the LayerNorm + GEMM core (K1's and K9's qkv
    # GEMM and out-projection, K2's qkv GEMM) and K10's
    ("ln_gemm_sm90", "LN+GEMM (K1/K2/K9 CUDA)"),
    ("mbconv_sm90", "fused MBConv (K10 CUDA)"),
    # the GEMM core with A streamed along K (K11's out-projection, K13)
    ("gemm_sm90", "GEMM core (K11/K13 CUDA)"),
    # torch._int_mm's kernels (cutlass_80_tensorop_i16832gemm_s8_... on
    # the H100 with torch 2.11)
    ("gemm_s8", "int8 GEMM (torch._int_mm)"),
    ("imma", "int8 GEMM (torch._int_mm)"),
    # the sum of the d_bias partials of the backward core (K4, K7), whose
    # bf16 launches _group tells apart by their bias type; the core's f32
    # kind (attn_bwd_f32_sm90), which K4, K5 and K7 share in f32
    ("dbias_reduce", "attention backward (K4/K7 CUDA)"),
    ("attn_bwd_", "attention backward (f32 K4/K5/K7 CUDA)"),
    # the f32 twins (in bf16 both run the forward core)
    ("attention_qtiled_kernel", "head-major attention (K8a CUDA)"),
    ("attention_batched", "head-major attention (K8b CUDA)"),
    ("clip_flash", "CLIP attention (K6/K11 CUDA)"),
    ("conv", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("implicit_gemm", "convolution (cuDNN)"),
    ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"),
    ("gemm", "GEMM (cuBLAS)"),
    ("nvjet", "GEMM (cuBLAS)"),  # cuBLAS's own Hopper GEMM kernels
    ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"),
)


#: The head-major configuration's TinyViTConfig fields (with
#: ops.window_attention.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N).
HEAD_MAJOR = dict(pallas_attention_stages=(1, 2, 3), fused_block_stages=(),
                  fused_block_noproj_stages=())
#: Above every TinyViT-21M-512 window (N <= 1024).
HEAD_MAJOR_MIN_N = 2048


def _group(name: str) -> str:
    low = name.lower()
    if "attn_bwd_sm90<" in low:
        # attn_bwd_sm90<HD, MODE, bias type>: bf16 in K4; f32 in K5 and K7,
        # which run the same launches (BWD_MERGED picks which)
        bias = low.split("<", 1)[1].split(">", 1)[0]
        return ("attention backward (K4 CUDA)" if "bfloat16" in bias
                else "attention backward (K5/K7 CUDA)")
    if "attention_fwd_sm90<" in low:
        # attention_fwd_sm90<layout, bias type, HD, NT, streamed>: the
        # interleaved qkv in K1, K2, K3 and K9 (the same instances);
        # head-major with the bias streamed in K8a where its tile does not
        # fit, resident in K8b and in K8a below
        args = low.split("<", 1)[1].split(">", 1)[0].split(",")
        if args[0].strip() == "1":
            return "attention (K1/K2/K3/K9 CUDA)"
        return ("head-major attention (K8a CUDA)" if args[-1].strip() == "true"
                else "head-major attention (K8b, K8a resident; CUDA)")
    for key, group in GROUPS:
        if key in low:
            return group
    return "elementwise, copies and reductions"


def _serve_runner(bucket: int, backbone: str, head_major: bool = False):
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.inference import fixture_panorama
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.engine import ServingEngine

    config = None
    if head_major:
        wa.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N
        config = TinyViTConfig(**HEAD_MAJOR)
    # the GPU; raises without one
    engine = ServingEngine(backbone=backbone, seed=0, backbone_config=config)
    views = []
    for p in fixture_panorama():
        with open(p, "rb") as f:
            views.append(decode_jpeg(f.read(), engine.image_size))
    batch = np.repeat(np.stack(views)[None], bucket, axis=0)
    return lambda: engine.predict_batch(batch)  # ends with results on the host


def _train_runner(bucket: int):
    from geoguessr_ai_torch.train.fixtures import fixture_train_setup
    from geoguessr_ai_torch.train.steps import train_step

    state, batch, centroids = fixture_train_setup(bucket)

    def run():
        train_step(state, batch, centroids)
        torch.cuda.synchronize()

    return run


def _embed_runner(batch: int, knobs: bool, static: bool = False):
    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        bulk_embed_config,
    )
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.inference import fixture_panorama

    if static:
        emb = Embedder(BackboneConfig.tinyvit(), quant_mode="static")
    else:
        emb = Embedder(BackboneConfig.tinyvit(),
                       model_config=bulk_embed_config(knobs))  # the GPU
    views = []
    for p in fixture_panorama():
        with open(p, "rb") as f:
            views.append(decode_jpeg(f.read(), emb.image_size))
    images = np.stack(views)[np.arange(batch) % len(views)]
    return lambda: emb(images)  # ends with the embeddings on the host


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bucket", type=int, default=None,
                    help="panoramas per forward or train step (16), or "
                         "images per batch with --embed (512)")
    ap.add_argument("--steps", type=int, default=None,
                    help="forwards or steps profiled (5, or 3 with --train)")
    ap.add_argument("--backbone", default="tinyvit",
                    choices=("tinyvit", "clip"),
                    help="the served backbone (--train: tinyvit only)")
    ap.add_argument("--train", action="store_true",
                    help="profile train_step instead of the guess path")
    ap.add_argument("--embed", action="store_true",
                    help="profile the bulk-embedding Embedder instead")
    ap.add_argument("--no-knobs", action="store_true",
                    help="with --embed: fused_mbconv and fused_block_4d off")
    ap.add_argument("--static", action="store_true",
                    help="with --embed: the static-int8 Embedder (the "
                         "default EmbedBuildConfig's)")
    ap.add_argument("--head-major", action="store_true",
                    help="serve the head-major configuration (K8a/K8b)")
    ap.add_argument("--bwd-two-kernel", action="store_true",
                    help="--train with BWD_MERGED=False (K7, not K5)")
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace to this path")
    args = ap.parse_args(argv)
    if args.bwd_two_kernel:
        from geoguessr_ai_torch.ops import window_attention as wa

        wa.BWD_MERGED = False
        args.train = True
    steps = args.steps or (3 if args.train else 5)
    unit = "step" if args.train else "forward"
    mode = "train" if args.train else "embed" if args.embed else "serve"
    if args.bucket is None:
        args.bucket = 512 if args.embed else 16

    if (args.train or args.embed) and args.backbone != "tinyvit":
        ap.error("--train and --embed profile TinyViT only")
    if args.train and args.embed:
        ap.error("--train and --embed exclude each other")
    if args.head_major and (mode != "serve" or args.backbone != "tinyvit"):
        ap.error("--head-major serves TinyViT only")
    if args.static and (mode != "embed" or args.no_knobs):
        ap.error("--static goes with --embed, without --no-knobs")
    if mode == "train":
        run = _train_runner(args.bucket)
    elif mode == "embed":
        run = _embed_runner(args.bucket, knobs=not args.no_knobs,
                            static=args.static)
    else:
        run = _serve_runner(args.bucket, args.backbone, args.head_major)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = collections.defaultdict(lambda: [0, 0.0])  # name -> count, us
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    per_run = {n: (c / steps, us / steps / 1e3)
               for n, (c, us) in kernels.items()}
    busy_ms = sum(ms for _, ms in per_run.values())
    groups = collections.defaultdict(float)
    for n, (_, ms) in per_run.items():
        groups[_group(n)] += ms

    card = torch.cuda.get_device_name(0)
    what = "train steps" if args.train else "forwards"
    if mode == "embed":
        what += (", static-int8 embed config" if args.static else
                 ", embed config, knobs " + ("off" if args.no_knobs else "on"))
    if args.head_major:
        what += ", head-major config"
    if args.bwd_two_kernel:
        what += ", BWD_MERGED=False"
    print(f"{card}: {args.backbone}, bucket {args.bucket}, {steps} {what} "
          "profiled")
    print(f"wall_ms_per_{unit} {wall_ms:.3f}")
    print(f"device_busy_ms_per_{unit} {busy_ms:.3f}")
    print(f"device_idle_share {1 - busy_ms / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {ms / busy_ms:6.1%}  {g}")
    print(f"top kernels per {unit} (launches, ms):")
    top = sorted(per_run.items(), key=lambda kv: -kv[1][1])[:20]
    for n, (c, ms) in top:
        print(f"  {ms:9.3f} ms  x{c:5.1f}  {n[:110]}")
    print(json.dumps({
        "device": card, "mode": mode,
        "knobs": None if mode != "embed" or args.static
        else not args.no_knobs,
        "static": args.static,
        "head_major": args.head_major, "bwd_two_kernel": args.bwd_two_kernel,
        "backbone": args.backbone,
        "bucket": args.bucket, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": dict(groups),
    }))


if __name__ == "__main__":
    main()

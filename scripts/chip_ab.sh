#!/bin/bash
# Times the bf16 kernels, the TinyViT engines and the CLIP engine of two
# trees on one GPU, in turns PARENT, THIS, THIS, PARENT, through
# chip_smoke.py's own phases (kernels vs plain versions with their times;
# the default B=16 train_step p50 of phase 8 and the K5 and K7 step p50s
# of phase 18; the guess paths' p50s, the head-major engine's too), and
# by one timer for both trees (below) K6 and K11 at CLIP ViT-L/14-336's
# bucket 16, K5 at the B=16 train shape of stage 2, K8b at the head-major
# serving shapes of stages 1 and 3 at bucket 16, K8a at stage 2 of bucket
# 16 and stage 3 of bucket 1, and K3 at stage 3 of bucket 16, each K8a and
# K3 shape with its exponentials' floor on a line of its own (one
# exponential a score at 16 a clock an SM, at the card's clocks.max.sm),
# and a hash of K8b's output on seeded inputs (equal in both trees when
# its bits did not change); K10 (the fused stage-0 MBConv) at 64 and 512
# images by events with a hash of its output at each on a fixed seed, its
# f32 entry at 64 and 512 images by events, K12a and K12b (the
# experimental fused MBConv) at 64 and 256 images by events beside the
# cuDNN chain of the same function (their outputs hashed at 64, 256 and
# 512 images), and K2 (the stage-2
# no-proj fused block) at bucket 16 as
# device time (each launch's device time: phase 3's launch_ms lines, K1's
# too; K9's in phase 13's); K13 (the int8 / bf16 tiled GEMM) at the JAX
# tool's four shapes as device time with its int8 / bf16 rate; and
# the embed phase (Embedder p50 at B=512 with both knobs on and off) and
# the knob-serve phase (bucket-16 p50 of the engine with fused_mbconv and
# fused_block_4d):
#
#     git archive <parent-commit> | (mkdir -p build/ab_parent && tar -x -C build/ab_parent)
#     bash scripts/chip_ab.sh build/ab_parent
#
# PARENT must be a directory that .gitignore lists (build/ does).  Each
# run's whole output goes to $AB_OUT/ab_<run>.log (default build/ab_logs);
# the kernel times and p50s of each are printed.  AB_PHASES=serve runs
# only the two engines' serving phases (their p50s, which the host's noise
# moves most), in the same turns; AB_PHASES=mbconv only the K10 and K12
# lines; AB_PHASES=fusion only the hierarchical engine's fusion beside
# mean fusion (fusion_ab below); AB_PHASES=bwd_f32 only K4, K5 and K7 in
# f32 at PERF.md's seven f32 backward rows as device time, beside SDPA's
# f32 backward, with each launch's device time and hashes of the bf16
# entries' outputs at the train shapes (bwd_f32_ab below); AB_PHASES=
# f32_serve only the p50s of the f32 paths that launch K2, K9 and K10
# (f32_serve_ab below); AB_PHASES=fwd_f32 K2 and K9 in f32 at their main
# shapes as device time with their largest error against the plain f32
# version, hashes of every bf16 forward entry's output, then the f32
# serving p50s (fwd_f32_ab below), and after the four runs whether the
# forward core's and the LN + GEMM core's bf16 kernels compiled to the
# same SASS in both trees; AB_PHASES=clip_f32 K6 and K11 in f32 at CLIP-L's
# bucket 16 and at ViT-B/32's N = 50 as device time with each launch's
# device time and their largest error against the plain f32 version,
# hashes of K6's, K11's and K13's bf16 (and K13's int8) outputs, the f32
# CLIP engines' bucket-16 p50s (clip_f32_ab below), and after the four runs
# whether K6's bf16 kernel and the GEMM core's bf16 and int8 kinds
# compiled to the same SASS in both trees; AB_PHASES=fwd_f32_k1_k8a K1 in
# f32 at stage 1 of a serving bucket of 16 and the embed configuration's
# stage 3 and K8a in f32 at stage 2 of a bucket of 16 and stage 3 of a
# bucket of 1 as device time with each launch's device time and their
# largest error against the plain f32 version, hashes of every bf16
# forward entry's output and of K2-f32's and K9-f32's, the f32 default and
# head-major engines' bucket-16 p50s (fwd_f32_k1_k8a_ab below), and after
# the four runs whether the cores' bf16 kernels and K2's and K9's f32
# kernels compiled to the same SASS in both trees; AB_PHASES=fwd_f32_k3_k8b
# K8b in f32 at stages 1 and 3 of a bucket of 16 and K3 in f32 at stage 3
# of buckets of 16 and 1 the same way, hashes of every bf16 forward entry's
# output and of K1-f32's, K2-f32's, K8a-f32's and K9-f32's, the same two
# p50s (fwd_f32_k3_k8b_ab below), and after the four runs whether the
# cores' bf16 kernels, K1's, K2's, K8a's and K9's f32 kernels and K8a's
# split pass compiled to the same SASS in both trees; AB_PHASES=f32_kernels
# chip_smoke.py's phase 24 alone (every f32 entry against its plain
# version) with its wall seconds, and the same SASS comparison.
set -u
parent=${1:?usage: chip_ab.sh PARENT_DIR}
out=$(pwd)/${AB_OUT:-build/ab_logs}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  (cd "$1" && python - <<'PY'
import os
import sys

import torch

import chip_smoke as cs



def sha(t):
    import hashlib
    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def mbconv_ab():
    """K10 at 64 and 512 images by events, with a hash of its output at
    each on a fixed seed (equal in both trees when its bits did not
    change); K10's f32 entry at 64 and 512 images by events, with its
    largest error against the plain f32 version; K12a and K12b at 64 and
    256 images of the JAX benchmark's inputs by events, with the cuDNN
    chain of the same function, and hashes of their outputs at 64, 256 and
    512 images."""
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm

    gen = torch.Generator().manual_seed(5)
    for images in (64, 512):
        margs = cs._mbconv_inputs(images, gen)
        fn = lambda: mbconv._mbconv_cuda(*margs, False)
        print(f"AB K10 {images} images events_ms {cs.cuda_time_ms(fn):.4f}")
        out = fn()
        torch.cuda.synchronize()
        print(f"AB K10 bits {images} images {sha(out)}")
        del out, margs
    gen = torch.Generator().manual_seed(24)
    for images in (64, 512):
        margs = cs._mbconv_inputs(images, gen, torch.float32)
        fn = lambda: mbconv._mbconv_cuda(*margs, False)
        ms = cs.cuda_time_ms(fn)
        out = fn()
        want = cs._sliced(lambda *a: mbconv._mbconv_plain(*a, False), margs,
                          images)
        _, rel = cs._rel_err(out, want)
        print(f"AB K10 f32 {images} images events_ms {ms:.4f} max_rel_err "
              f"{rel:.3g}")
        del out, want, margs
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(6)
    for images in (64, 256, 512):
        args = cs._exp_mbconv_inputs(images, gen)
        with torch.inference_mode():
            if images != 512:
                ms = {k: cs.cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args, v2=v2))
                      for k, v2 in (("K12a", False), ("K12b", True))}
                ms["K12 cuDNN chain"] = cs._exp_chain_ms(args)
                for k, t in ms.items():
                    print(f"AB {k} {images} images events_ms {t:.4f}")
            for k, v2 in (("K12a", False), ("K12b", True)):
                out = fm._fused_mbconv_cuda(*args, v2=v2)
                torch.cuda.synchronize()
                print(f"AB {k} bits {images} images {sha(out)}")
                del out
        del args
        torch.cuda.empty_cache()


def f32_serve_ab(clip=False):
    """The f32 paths that launch K2, K9 and K10 (chip_smoke.py phase 25):
    the default f32 TinyViT engine and the one with fused_mbconv and
    fused_block_4d at bucket 16 (predict_batch p50 over 11 calls after a
    warm-up) and the f32 Embedder of bulk_embed_config() at 64 images (p50
    over 11 calls), each with K2's, K9's and K10's launches in one call;
    with ``clip`` instead phase 25's two f32 CLIP ViT-L/14-336 engines at
    bucket 16, K6's and K11's (pallas_fuse_proj=True), each with K6's and
    K11's launches a call."""
    import gc

    import numpy as np

    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import Embedder, bulk_embed_config
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.serving.engine import ServingEngine

    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.ops import clip_attention as ca

    f32 = torch.float32

    def read(label, fn):
        fn()
        torch.cuda.synchronize()
        mbconv.reset_launches()
        wa.reset_launches()
        ca.reset_launches()
        fn()
        torch.cuda.synchronize()
        k10 = mbconv.LAUNCHES["_mbconv_cuda"]
        k2, k9 = wa.LAUNCHES["_fb_s2_cuda"], wa.LAUNCHES["_fb4d_cuda"]
        k6, k11 = ca.LAUNCHES["_flash_cuda"], ca.LAUNCHES["_flash_proj_cuda"]
        p50 = cs._p50_ms(fn, reps=11)
        print(f"AB f32 {label} p50 {p50:.2f} ms (K2 {k2}, K9 {k9}, K10 "
              f"{k10}, K6 {k6}, K11 {k11} a call)")

    if clip:
        for fuse in (False, True):
            engine = ServingEngine(
                backbone="clip", seed=cs.SEED,
                backbone_config=CLIPVisionConfig.vit_l_14_336(
                    dtype=f32, pallas_fuse_proj=fuse))
            _, views = cs._fixture_views(engine)
            batch = np.repeat(views[None], 16, axis=0)
            read(f"CLIP {'K11' if fuse else 'K6'} engine bucket 16",
                 lambda: engine.predict_batch(batch))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        return

    for label, knobs in (("default engine", {}),
                         ("knobs engine", dict(fused_mbconv=True,
                                               fused_block_4d=True))):
        engine = ServingEngine(seed=cs.SEED, backbone_config=TinyViTConfig(
            dtype=f32, **knobs))
        _, views = cs._fixture_views(engine)
        batch = np.repeat(views[None], 16, axis=0)
        read(f"{label} bucket 16", lambda: engine.predict_batch(batch))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    emb = Embedder(BackboneConfig.tinyvit(), seed=cs.SEED,
                   model_config=bulk_embed_config(dtype=f32))
    _, images = cs._fixture_views(emb)
    images = images[np.arange(64) % 4]
    read("Embedder B=64", lambda: emb(images))


def fwd_f32_ab():
    """K2 in f32 at stage 2 of a serving bucket of 16 and K9 in f32 at 64
    and 512 images of stage 1 (chip_smoke's shapes) as device time
    (cs.kernel_ms) with each one's largest error against its plain f32
    version and each launch's device time; hashes of every bf16 forward
    entry's output on seeded inputs (K1 at stage 1 and the embed stage 3,
    K2, K3, K8a at stage 2 and stage 3 of bucket 1, K8b at stages 1 and 3,
    K9 at 64 images, and the 128-row kinds of K2 and K9: equal in both
    trees when their bits did not change); then f32_serve_ab."""
    from geoguessr_ai_torch.ops import window_attention as wa

    f32, bf = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(25)
    a = cs._case_inputs(64, 1024, 384, 12, gen, f32)
    k2 = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
          a["bias"], 32 ** -0.5, 12, 1e-5)
    cases = [("K2 (64, 1024, 384) H=12", lambda: wa._fb_s2_cuda(*k2),
              lambda: wa._fb_s2_plain(*k2))]
    for images in (64, 512):
        kern, plain, args, *_ = cs._embed_kernel_case("K9", images, gen, f32)
        cases.append((f"K9 ({images}, 64, 64, 192) H=6",
                      lambda kern=kern, args=args: kern(*args),
                      lambda plain=plain, args=args, images=images:
                      cs._sliced(plain, args, images)))
    for label, fn, plain in cases:
        ms = cs.kernel_ms(fn)
        out = fn()
        torch.cuda.synchronize()
        _, rel = cs._rel_err(out, plain())
        print(f"AB f32 {label} device_ms {ms:.4f} max_rel_err {rel:.3g}")
        launch = cs._launch_ms(fn)
        print(f"AB f32 {label} launch_ms " + (
            ", ".join(f"{n} {t:.4f}" for n, t in launch.items())
            if launch else "not measured"))
        del out
        torch.cuda.empty_cache()
    del a, k2, cases
    bf16_forward_bits()
    f32_serve_ab()


def bits(label, fn):
    out = fn()
    torch.cuda.synchronize()
    print(f"AB bf16 bits {label} {sha(out)}")


def bf16_forward_bits():
    """Hashes of every bf16 forward entry's output on seeded inputs (K1 at
    stage 1 and the embed stage 3, K2, K3, K8a at stage 2 and stage 3 of
    bucket 1, K8b at stages 1 and 3, K9 at 64 images, and the 128-row kinds
    of K2 and K9): equal in both trees when their bits did not change."""
    from geoguessr_ai_torch.ops import window_attention as wa

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(26)
    for kernel, W, N, C, H in (("K1", 1024, 256, 192, 6),
                               ("K1", 64, 256, 576, 18),
                               ("K2", 64, 1024, 384, 12),
                               ("K3", 64, 256, 576, 18)):
        a = cs._case_inputs(W, N, C, H, gen)
        scale = (C // H) ** -0.5
        if kernel == "K1":
            fn = lambda: wa._fused_block_cuda(
                a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["w_proj"], a["b_proj"], a["bias"], scale, H, 1e-5)
        elif kernel == "K2":
            fn = lambda: wa._fb_s2_cuda(
                a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["bias"], scale, H, 1e-5)
        else:
            qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"],
                                   a["w_qkv"], a["b_qkv"], 1e-5)
            fn = lambda: wa._attention_qkv_fused_cuda(qkv, a["bias"], scale, H)
        bits(f"{kernel} ({W}, {N}, {C}) H={H}", fn)
        if kernel == "K2":
            wa.FWD_Q_ROWS = 128
            bits(f"{kernel} q128 ({W}, {N}, {C}) H={H}", fn)
            wa.FWD_Q_ROWS = 64
    for kernel, W, H, N in (("K8a", 64, 12, 1024), ("K8a", 4, 18, 256),
                            ("K8b", 1024, 6, 256), ("K8b", 64, 18, 256)):
        q, k, v = (torch.randn(W, H, N, 32, generator=gen).to("cuda", bf)
                   for _ in range(3))
        hb = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        fn = (wa._attention_qtiled_cuda if kernel == "K8a"
              else wa._attention_batched_cuda)
        bits(f"{kernel} ({W}, {H}, {N})",
             lambda: fn(q, k, v, hb, 32 ** -0.5))
    kern, _, args, *_ = cs._embed_kernel_case("K9", 64, gen)
    bits("K9 (64, 64, 64, 192) H=6", lambda: kern(*args))
    wa.FWD_Q_ROWS = 128
    bits("K9 q128 (64, 64, 64, 192) H=6", lambda: kern(*args))
    wa.FWD_Q_ROWS = 64
    del args
    torch.cuda.empty_cache()


def f32_rows_ab(rows, seed):
    """Each (kernel, label, shape) of ``rows`` (chip_smoke's F32_CASES) in
    f32 as device time (cs.kernel_ms) with its largest error against its
    plain f32 version and each launch's device time (torch.profiler)."""
    gen = torch.Generator().manual_seed(seed)
    for kernel, label, shape in rows:
        kern, plain, args, *_ = cs._f32_case(kernel, shape, gen)
        fn = lambda: kern(*args)
        ms = cs.kernel_ms(fn)
        out = fn()
        torch.cuda.synchronize()
        _, rel = cs._rel_err(out, plain(*args))
        print(f"AB f32 {kernel} {label} {shape} device_ms {ms:.4f} "
              f"max_rel_err {rel:.3g}")
        launch = cs._launch_ms(fn)
        print(f"AB f32 {kernel} {label} launch_ms " + (
            ", ".join(f"{n} {t:.4f}" for n, t in launch.items())
            if launch else "not measured"))
        del out, args
        torch.cuda.empty_cache()


def f32_engines_ab(kernels):
    """The f32 default and head-major TinyViT engines' bucket-16 p50s (11
    calls after a warm-up) with ``kernels``' launches (names of
    chip_smoke.F32_META) in one call."""
    import gc

    import numpy as np

    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import window_attention as wa
    from geoguessr_ai_torch.profile_forward import HEAD_MAJOR, HEAD_MAJOR_MIN_N
    from geoguessr_ai_torch.serving.engine import ServingEngine

    for label, fields in (("default", {}), ("head-major", HEAD_MAJOR)):
        saved = wa.QKV_KERNEL_MIN_N
        if fields:
            wa.QKV_KERNEL_MIN_N = HEAD_MAJOR_MIN_N
        try:
            engine = ServingEngine(seed=cs.SEED, backbone_config=TinyViTConfig(
                dtype=torch.float32, **fields))
            _, views = cs._fixture_views(engine)
            batch = np.repeat(views[None], 16, axis=0)
            fn = lambda: engine.predict_batch(batch)
            fn()
            torch.cuda.synchronize()
            wa.reset_launches()
            fn()
            torch.cuda.synchronize()
            n = {k: wa.LAUNCHES[cs.F32_META[k][0]] for k in kernels}
            p50 = cs._p50_ms(fn, reps=11)
            print(f"AB f32 {label} engine bucket 16 p50 {p50:.2f} ms "
                  f"(launches a call {n})")
            del engine
        finally:
            wa.QKV_KERNEL_MIN_N = saved
        gc.collect()
        torch.cuda.empty_cache()


def fwd_f32_k1_k8a_ab():
    """K1 in f32 at stage 1 of a serving bucket of 16 and the embed
    configuration's stage 3, and K8a in f32 at stage 2 of a bucket of 16
    and stage 3 of a bucket of 1 (f32_rows_ab); hashes of every bf16
    forward entry's output (bf16_forward_bits) and of K2-f32's and
    K9-f32's on seeded inputs; then the f32 default and head-major TinyViT
    engines' p50s with K1's, K8a's and K8b's launches (f32_engines_ab)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    f32_rows_ab((("K1", "stage1", (1024, 256, 192, 6)),
                 ("K1", "embed_stage3", (64, 256, 576, 18)),
                 ("K8a", "stage2_bucket16", (64, 12, 1024)),
                 ("K8a", "stage3_bucket1", (4, 18, 256))), 27)
    bf16_forward_bits()
    f32_fwd_bits(("K2", "K9"))
    f32_engines_ab(("K1", "K8a", "K8b"))


def f32_fwd_bits(kernels):
    """Hashes of the f32 outputs of ``kernels`` (of K1 at stage 1 of a
    serving bucket of 16, K2 at stage 2, K8a at stage 2 and K9 at 64
    images) on seeded inputs: equal in both trees when their bits did not
    change."""
    from geoguessr_ai_torch.ops import window_attention as wa

    f32 = torch.float32
    gen = torch.Generator().manual_seed(28)
    for kernel in kernels:
        if kernel == "K2":
            a = cs._case_inputs(64, 1024, 384, 12, gen, f32)
            out = wa._fb_s2_cuda(a["x"], a["ln_scale"], a["ln_bias"],
                                 a["w_qkv"], a["b_qkv"], a["bias"],
                                 32 ** -0.5, 12, 1e-5)
            label = "K2 (64, 1024, 384) H=12"
            del a
        elif kernel == "K9":
            kern, _, args, *_ = cs._embed_kernel_case("K9", 64, gen, f32)
            out = kern(*args)
            label = "K9 (64, 64, 64, 192) H=6"
            del args
        else:
            shape = {"K1": (1024, 256, 192, 6), "K8a": (64, 12, 1024)}[kernel]
            kern, _, args, *_ = cs._f32_case(kernel, shape, gen)
            out = kern(*args)
            label = f"{kernel} {shape}"
            del args
        torch.cuda.synchronize()
        print(f"AB f32 bits {label} {sha(out)}")
        del out
        torch.cuda.empty_cache()


def fwd_f32_k3_k8b_ab():
    """K8b in f32 at stages 1 and 3 of a serving bucket of 16 and K3 in f32
    at stage 3 of buckets of 16 and 1 (f32_rows_ab: device time, the split
    pass and the attention apart); hashes of every bf16 forward entry's
    output (bf16_forward_bits) and of K1-f32's, K2-f32's, K8a-f32's and
    K9-f32's on seeded inputs; then the f32 default and head-major TinyViT
    engines' p50s with K1's, K3's, K8a's and K8b's launches."""
    f32_rows_ab((("K8b", "stage1_bucket16", (1024, 6, 256)),
                 ("K8b", "stage3_bucket16", (64, 18, 256)),
                 ("K3", "stage3", (64, 256, 576, 18)),
                 ("K3", "stage3_bucket1", (4, 256, 576, 18))), 28)
    bf16_forward_bits()
    f32_fwd_bits(("K1", "K2", "K8a", "K9"))
    f32_engines_ab(("K1", "K3", "K8a", "K8b"))


def clip_f32_ab():
    """K6 and K11 in f32 at CLIP-L's bucket 16 (64, 577, 3072), H=16, and at
    ViT-B/32's (64, 50, 2304), H=12, as device time (cs.kernel_ms) with
    their largest error against the plain f32 version and each launch's
    device time (torch.profiler: the k/v split, the attention and K11's
    projection apart); hashes of K6's and K11's bf16 outputs and K13's
    bf16 and int8 outputs at (4096, 4096, 4096) on seeded inputs (equal in
    both trees when their bits did not change); then the f32 CLIP engines'
    p50s (f32_serve_ab)."""
    from geoguessr_ai_torch.ops import clip_attention as ca
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    f32, bf = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(26)
    for B, N, D, H in ((64, 577, 1024, 16), (64, 50, 768, 12)):
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda")
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to("cuda")
        scale = (D // H) ** -0.5
        for k, fn, plain in (
                ("K6", lambda: ca._flash_cuda(qkv, scale, H),
                 lambda: ca._flash_plain(qkv, scale, H)),
                ("K11", lambda: ca._flash_proj_cuda(qkv, w, scale, H),
                 lambda: ca._flash_proj_plain(qkv, w, scale, H))):
            label = f"{k} ({B}, {N}, {3 * D}) H={H}"
            ms = cs.kernel_ms(fn)
            out = fn()
            torch.cuda.synchronize()
            _, rel = cs._rel_err(out, plain())
            print(f"AB f32 {label} device_ms {ms:.4f} max_rel_err {rel:.3g}")
            launch = cs._launch_ms(fn)
            print(f"AB f32 {label} launch_ms " + (
                ", ".join(f"{n} {t:.4f}" for n, t in launch.items())
                if launch else "not measured"))
            del out
        del qkv, w
        torch.cuda.empty_cache()

    def bits(label, fn):
        out = fn()
        torch.cuda.synchronize()
        print(f"AB bits {label} {sha(out)}")

    gen = torch.Generator().manual_seed(27)
    for B, N, D, H in ((64, 577, 1024, 16), (64, 50, 768, 12)):
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", bf)
        w = (torch.randn(D, D, generator=gen) * D ** -0.5).to("cuda", bf)
        scale = (D // H) ** -0.5
        bits(f"K6 bf16 ({B}, {N}, {3 * D})",
             lambda: ca._flash_cuda(qkv, scale, H))
        bits(f"K11 bf16 ({B}, {N}, {3 * D})",
             lambda: ca._flash_proj_cuda(qkv, w, scale, H))
        del qkv, w
    M = K = N = 4096
    a8 = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).cuda()
    b8 = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).cuda()
    a = torch.randn(M, K, generator=gen).to("cuda", bf)
    b = torch.randn(K, N, generator=gen).to("cuda", bf)
    bits("K13 int8 (4096, 4096, 4096)",
         lambda: tg._tiled_matmul_cuda(a8, b8, torch.int32))
    bits("K13 bf16 (4096, 4096, 4096)",
         lambda: tg._tiled_matmul_cuda(a, b, f32))
    del a8, b8, a, b
    torch.cuda.empty_cache()
    f32_serve_ab(clip=True)


def fusion_ab():
    """The hierarchical engine (D = 576, 16 heads) beside the mean-fusion
    engine at full width: predict_batch p50s at buckets 1 and 16, the two
    engines in turns (40 calls each after a warm-up); the fusion alone
    (pos_encoder + self_attn on (16, 4, 576) f32 with a mask) as host ms
    a call to its end and as events; and how long the fusion takes to
    return to the host behind a queued 50 ms kernel (about 50 when it
    waits for the card, under 1 when it only queues its launches)."""
    import time

    import numpy as np

    from geoguessr_ai_torch.serving.engine import ServingEngine

    hier = ServingEngine(seed=cs.SEED, hierarchical=True)
    mean = ServingEngine(seed=cs.SEED)
    views = np.random.default_rng(0).integers(0, 256, (4, 512, 512, 3),
                                              dtype=np.uint8)
    for bucket in (1, 16):
        b = np.repeat(views[None], bucket, axis=0)
        times = {"hierarchical": [], "mean": []}
        for eng in (hier, mean):
            eng.predict_batch(b)
        for _ in range(40):
            for label, eng in (("hierarchical", hier), ("mean", mean)):
                t0 = time.perf_counter()
                eng.predict_batch(b)
                times[label].append((time.perf_counter() - t0) * 1e3)
        h, m = (float(np.median(times[k])) for k in ("hierarchical", "mean"))
        print(f"AB fusion bucket {bucket} p50 hierarchical {h:.4f} mean "
              f"{m:.4f} difference {h - m:.4f} ms")
    model = hier.model
    x = torch.randn(16, 4, 576,
                    generator=torch.Generator().manual_seed(1)).cuda()
    mask = torch.ones(16, 4, dtype=torch.bool, device="cuda")
    mask[1::2, 2:] = False
    fuse = lambda: model.self_attn(model.pos_encoder(x), mask)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    cycles_50ms = int(10 ** 7 * 50 / start.elapsed_time(end))
    with torch.inference_mode():
        fuse()
        torch.cuda.synchronize()
        host = []
        for _ in range(50):
            t0 = time.perf_counter()
            fuse()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        events = cs.cuda_time_ms(fuse, iters=50)
        torch.cuda._sleep(cycles_50ms)
        t0 = time.perf_counter()
        fuse()
        behind = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"AB fusion alone (16, 4, 576) host_ms {np.median(host):.4f} "
          f"events_ms {events:.4f}; returns behind a queued 50 ms kernel "
          f"in {behind:.3f} ms")


def bwd_f32_ab():
    """K4, K5 and K7 with f32 operands at the seven shapes of PERF.md's f32
    backward rows (TinyViT-21M-512 at B=16, TinyViT-5M-224 at B=64) as
    device time (cs.device_time_ms: 20 calls in one CUDA graph, replayed 5
    times) beside SDPA's f32 backward on the same inputs and with each
    launch's device time (torch.profiler); then hashes of K4's, K5's and
    K7's bf16 d_qkv and d_bias on seeded inputs at the train shapes (equal
    in both trees when the bf16 entries' bits did not change)."""
    from geoguessr_ai_torch.ops import window_attention as wa

    fns = {"K4": wa._attention_qkv_bwd_cuda,
           "K5": wa._attention_bwd_merged_cuda,
           "K7": wa._attention_bwd_qtiled_cuda}

    def inputs(W, N, H, dtype):
        gen = torch.Generator().manual_seed(23)
        D = H * 32
        return (torch.randn(W, N, 3 * D, generator=gen).to("cuda", dtype),
                (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda"),
                torch.randn(W, N, D, generator=gen).to("cuda", dtype))

    for k, W, N, H in (("K4", 1024, 256, 6), ("K4", 64, 256, 18),
                       ("K4", 1024, 49, 4), ("K4", 64, 196, 5),
                       ("K4", 64, 49, 10), ("K5", 64, 1024, 12),
                       ("K7", 64, 1024, 12)):
        qkv, bias, g = inputs(W, N, H, torch.float32)
        fn = lambda: fns[k](qkv, bias, g, 32 ** -0.5, H)
        lib, _ = cs._sdpa_bwd_ms(qkv, bias, g, 32 ** -0.5, H)
        print(f"AB f32 {k} ({W}, {N}, {H}) graph_ms "
              f"{cs.device_time_ms(fn):.4f} sdpa_f32_bwd_ms "
              f"{'null' if lib is None else f'{lib:.4f}'}")
        launch = cs._launch_ms(fn)
        print(f"AB f32 {k} ({W}, {N}, {H}) launch_ms " + (
            ", ".join(f"{n} {t:.4f}" for n, t in launch.items())
            if launch else "not measured"))
        del qkv, bias, g
        torch.cuda.empty_cache()
    for k, W, N, H in (("K4", 1024, 256, 6), ("K4", 64, 256, 18),
                       ("K4", 1024, 49, 4), ("K5", 64, 1024, 12),
                       ("K7", 64, 1024, 12)):
        dqkv, dbias = fns[k](*inputs(W, N, H, torch.bfloat16), 32 ** -0.5, H)
        torch.cuda.synchronize()
        print(f"AB bf16 bits {k} ({W}, {N}, {H}) d_qkv {sha(dqkv)} d_bias "
              f"{sha(dbias)}")
        del dqkv, dbias
        torch.cuda.empty_cache()


cs.phase_device(); cs.phase_build()
if os.environ.get("AB_PHASES") == "bwd_f32":
    bwd_f32_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "fusion":
    fusion_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "mbconv":
    mbconv_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "f32_serve":
    f32_serve_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "fwd_f32":
    fwd_f32_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "clip_f32":
    clip_f32_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "fwd_f32_k1_k8a":
    fwd_f32_k1_k8a_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "fwd_f32_k3_k8b":
    fwd_f32_k3_k8b_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "f32_kernels":
    import time
    t0 = time.time()
    cs.phase_f32_kernels()
    print(f"AB phase 24 wall {time.time() - t0:.1f} s")
    sys.exit(0)
if os.environ.get("AB_PHASES") == "serve":
    _, paths, result, _ = cs.phase_serve()
    cs.phase_headmajor_serve(paths, result); cs.phase_clip_serve()
    sys.exit(0)
cs.phase_kernels(); cs.phase_backward_kernels(); cs.phase_clip_kernels()
cs.phase_embed_kernels(); cs.phase_headmajor_kernels()
cs.phase_train(); cs.phase_k7_train()
_, paths, result, _ = cs.phase_serve()
cs.phase_headmajor_serve(paths, result)
cs.phase_clip_serve()
cs.phase_embed(paths)
cs.phase_knob_serve(paths, result)

# K6 and K11 at CLIP-L bucket 16, K5 and K8b at their main shapes, by
# the same two timers in either tree: 20 launches between two events, and
# 20 launches captured in one CUDA graph replayed 5 times (device time
# only).
from geoguessr_ai_torch.ops import clip_attention as ca
from geoguessr_ai_torch.ops import window_attention as wa


def graph_ms(fn, iters=20, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
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
    return start.elapsed_time(end) / (reps * iters)


gen = torch.Generator().manual_seed(3)
qkv = torch.randn(64, 577, 3072, generator=gen).to("cuda", torch.bfloat16)
w = (torch.randn(1024, 1024, generator=gen) / 32).to("cuda", torch.bfloat16)
for name, fn in (("K6", lambda: ca._flash_cuda(qkv, 0.125, 16)),
                 ("K11", lambda: ca._flash_proj_cuda(qkv, w, 0.125, 16))):
    print(f"AB {name} (64, 577, 3072) H=16 events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
del qkv, w
# K13 at the JAX tool's four (M, K, N), b handed over K-major as the
# kernel reads it (so neither tree's time holds the wrapper's transpose copy
# of a (K, N) b), as device time; its int8 / bf16 rate at each
from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg
for M, K, N in ((4096, 2048, 4096), (4096, 4096, 4096), (131072, 384, 1536),
                (131072, 1536, 384)):
    rates = {}
    for kind in ("int8", "bf16"):
        if kind == "int8":
            a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).cuda()
            b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).cuda()
            out = torch.int32
        else:
            a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
            b = torch.randn(K, N, generator=gen).to("cuda", torch.bfloat16)
            out = torch.float32
        bk = b.t().contiguous().t()
        fn = lambda: tg._tiled_matmul_cuda(a, bk, out)
        ms = graph_ms(fn)
        rates[kind] = 2 * M * K * N / ms / 1e9
        print(f"AB K13 {kind} ({M}, {K}, {N}) graph_ms {ms:.4f} "
              f"({rates[kind]:.1f} TOPS); from a (K, N) b events_ms "
              f"{cs.cuda_time_ms(lambda: tg._tiled_matmul_cuda(a, b, out), iters=20):.4f}")
        del a, b, bk
        torch.cuda.empty_cache()
    print(f"AB K13 int8 / bf16 rate ({M}, {K}, {N}) "
          f"{rates['int8'] / rates['bf16']:.3f}")
bq = torch.randn(64, 1024, 1152, generator=gen).to("cuda", torch.bfloat16)
bb = (torch.randn(12, 1024, 1024, generator=gen) * 0.5).to("cuda")
bg = torch.randn(64, 1024, 384, generator=gen).to("cuda", torch.bfloat16)
fn = lambda: wa._attention_bwd_merged_cuda(bq, bb, bg, 32 ** -0.5, 12)
print(f"AB K5 (64, 1024) H=12 events_ms {cs.cuda_time_ms(fn, iters=20):.4f} "
      f"graph_ms {graph_ms(fn):.4f}")
del bq, bb, bg
for W, H in ((1024, 6), (64, 18)):
    q, k, v = (torch.randn(W, H, 256, 32, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    hb = (torch.randn(H, 256, 256, generator=gen) * 0.5).to("cuda")
    fn = lambda: wa._attention_batched_cuda(q, k, v, hb, 32 ** -0.5)
    print(f"AB K8b ({W}, {H}, 256) events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
    out = fn()
    torch.cuda.synchronize()
    del q, k, v, hb, out

mbconv_ab()
gen = torch.Generator().manual_seed(5)
a = cs._case_inputs(64, 1024, 384, 12, gen)
k2 = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"], a["bias"],
      32 ** -0.5, 12, 1e-5)
fn = lambda: wa._fb_s2_cuda(*k2)
# each launch's device time: phase 3's "K2 stage2 launch_ms" line (a trace
# taken this late in the process held one of its three calls)
print(f"AB K2 (64, 1024, 384) H=12 graph_ms {graph_ms(fn):.4f}")
del a, k2

import subprocess

import numpy as np

mhz = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
    capture_output=True, text=True).stdout.split()[0])
sms = torch.cuda.get_device_properties(0).multi_processor_count


def floor_line(name, shape, scores):
    print(f"AB exp_floor {name} {shape} {scores / (16 * sms * mhz * 1e6) * 1e3:.4f} ms "
          f"({scores:.3g} exponentials, 16 a clock an SM at {mhz:.0f} MHz)")


for W, H, N in ((64, 12, 1024), (4, 18, 256)):
    q, k, v = (torch.randn(W, H, N, 32, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    hb = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
    fn = lambda: wa._attention_qtiled_cuda(q, k, v, hb, 32 ** -0.5)
    print(f"AB K8a ({W}, {H}, {N}) events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
    floor_line("K8a", (W, H, N), W * H * N * N)
    del q, k, v, hb
qkv = torch.randn(64, 256, 1728, generator=gen).to("cuda", torch.bfloat16)
b3 = (torch.randn(18, 256, 256, generator=gen) * 0.5).to("cuda", torch.bfloat16)
fn = lambda: wa._attention_qkv_fused_cuda(qkv, b3, 32 ** -0.5, 18)
print(f"AB K3 (64, 256, 1728) H=18 events_ms "
      f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
floor_line("K3", (64, 256, 1728), 64 * 18 * 256 * 256)
for W, H, N in ((1024, 6, 256), (64, 18, 256)):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((W, H, N, 32), dtype=np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    hb = torch.from_numpy(rng.standard_normal((H, N, N), dtype=np.float32) * 0.5).to("cuda")
    out = wa._attention_batched_cuda(q, k, v, hb, 32 ** -0.5)
    torch.cuda.synchronize()
    print(f"AB K8b bits ({W}, {H}, {N}) {sha(out)}")
PY
  ) > "$out/ab_$2.log" 2>&1
  echo "== $2 rc=$?"
  grep -E "^K[0-9]+[ab]? |kernel_ms|library_ms|launch_ms|train_step p50|^bucket|^head-major engine bucket|^CLIP bucket|^CLIP pallas|^AB |^Embedder|^knob engine bucket|FAIL" \
    "$out/ab_$2.log"
}
run "$parent" parent1
run . change1
run . change2
run "$parent" parent2
# K10's bf16 kernels (mbconv_sm90<C, EXACT, PLAIN = false> in the mbconv
# library) and K12a's / K12b's (mbconv_sm90<C, false, PLAIN = true> in
# fused_mbconv_exp), and with AB_PHASES=fwd_f32 the bf16 kernels of the
# forward core (attention_fwd_sm90), the LN + GEMM core (ln_gemm_sm90) and
# the streamed-K GEMM core (gemm_sm90) in every library that builds them,
# with AB_PHASES=clip_f32 K6's bf16 kernel (clip_flash_sm90) and the GEMM
# core's three earlier kinds (gemm_sm90<0, 1, 2, ...>) in the CLIP and K13
# libraries, in both trees' libraries,
# instruction by instruction (cuobjdump's SASS without the addresses):
# "identical True" when the change compiled them to the same code; the
# lines go to $AB_OUT/sass.log too
python3 - "$parent" "${AB_PHASES:-}" <<'PY' | tee "$out/sass.log"
import glob
import re
import subprocess
import sys


def kernels(tree, lib, pattern):
    path = glob.glob(f"{tree}/build/kernels/{lib}-*.so")[0]
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", path],
                          capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        # the forward core's f32 kind gained a last template argument, its
        # out layout (1: the interleaved out K2 and K9 store)
        name = name.replace("Li1EEEv14CUtensorMap_stS3_Pf", "EEv14CUtensorMap_stS3_Pf")
        # and the split pass its source layout (0: K8a's and K8b's head-major
        # q, k, v)
        name = re.sub(r"split_planesILi(\d+)ELi0EE", r"split_planesILi\1EE", name)
        m = re.search(pattern, name)
        if m:
            out[m.groups()] = [re.sub(r"/\*[0-9a-f]+\*/", "", l).split(";")[0].strip()
                               for l in body.splitlines() if re.match(r"\s*/\*[0-9a-f]+\*/", l)]
    return out


mb = r"mbconv_sm90ILi(\d+)ELb([01])ELb([01])EE"
checks = [("mbconv", "K10", mb), ("fused_mbconv_exp", "K12", mb)]
if sys.argv[2] in ("fwd_f32", "fwd_f32_k1_k8a", "fwd_f32_k3_k8b", "f32_kernels"):
    cores = r"((?:attention_fwd|ln_gemm|gemm)_sm90I\w+)"
    checks += [(lib, lib, cores) for lib in (
        "fb_s2", "fb4d", "fused_block", "attention_qkv", "attention_headmajor",
        "tiled_gemm", "clip_flash_proj")]
if sys.argv[2] in ("fwd_f32_k1_k8a", "f32_kernels"):
    f32 = r"((?:attention_fwd|ln_gemm)_f32_sm90I\w+)"
    checks += [(lib, f"{lib} f32", f32) for lib in ("fb_s2", "fb4d")]
if sys.argv[2] == "fwd_f32_k3_k8b":
    # K1's, K2's, K8a's and K9's f32 kernels (K8a's split pass too)
    f32 = r"((?:attention_fwd|ln_gemm)_f32_sm90I\w+|split_planesI\w+)"
    checks += [(lib, f"{lib} f32", f32) for lib in (
        "fb_s2", "fb4d", "fused_block", "attention_headmajor")]
if sys.argv[2] == "clip_f32":
    clip = r"((?:clip_flash_sm90ILi\d+E|gemm_sm90ILi[012]E)\w*)"
    checks += [(lib, lib, clip) for lib in ("clip_flash", "clip_flash_proj",
                                            "tiled_gemm")]
for lib, label, pattern in checks:
    old, new = kernels(sys.argv[1], lib, pattern), kernels(".", lib, pattern)
    for key in sorted(old):
        print(f"AB {label} SASS {' '.join(key)}: "
              f"{len(old[key])} / {len(new.get(key, []))} instructions, "
              f"identical {old[key] == new.get(key)}")
PY

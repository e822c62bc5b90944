"""Ablations and alternative designs of K10's bf16 Hopper kernel
(``csrc/mbconv_sm90.cuh``), timed against the kernel as it stands, on one
GPU.

Each variant is a copy of ``csrc/`` under ``build/variants/<name>/`` with
one edit of ``mbconv_sm90.cuh``, built with ``nvcc`` (all at once) into its
own library and called through ``mbconv._mbconv_cuda`` at 512 and 64
images of TinyViT-21M's stage 0 (events over 10 calls).  The ablations
(``no_*``) remove one piece of work and give wrong results: they only say
what that piece costs.  The alternative designs must give the kernel's
bits, and the script checks that they do.

    python3 scripts/mbconv_fbs2_variants.py [--f32]

``--f32`` runs the ablations of the kernel's f32 kind (``F32_VARIANTS``,
K10's f32 entry on f32 inputs) instead.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build, mbconv  # noqa: E402

_PROJECT = """#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        depthwise_ks<EXACT, PLAIN>(hg, w2, sb2, oy, ox, ks, cc, a[ks]);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) wgmma_rs_k<C>(acc[mt], a[ks][mt], w3d + 2 * ks);
        wgmma_commit();
      }"""
_EXPAND = """      float d0[32], d1[32];
      zero(d0);
      zero(d1);
      fence_regs(d0);
      fence_regs(d1);
      group_sync(c);  // the group's reads of the last chunk are done
      wgmma_fence();
      issue(d0, 0);
      issue(d1, 1);
      wgmma_wait<1>();
      fence_regs(d0);
      expand_epilogue<EXACT, PLAIN>(d0, hbuf, 16 * warp + g, in[0], sb1, cc);
      zero(d0);
      fence_regs(d0);
      wgmma_fence();
      issue(d0, 2);
      wgmma_wait<1>();
      fence_regs(d1);
      expand_epilogue<EXACT, PLAIN>(d1, hbuf, 64 + 16 * warp + g, in[1], sb1, cc);
      wgmma_wait<0>();
      fence_regs(d0);
      expand_epilogue<EXACT, PLAIN>(d0, hbuf, 128 + 16 * warp + g, in[2], sb1, cc);"""

#: name -> (edits of mbconv_sm90.cuh as (old, new), whether the variant
#: must give the kernel's bits).
VARIANTS = {
    "no_mufu": ([('asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(u));',
                  "t = u;")], False),
    "no_depthwise_fma": ([("""            s0 = fmaf(h.x, tap[di * 3 + dj].x, s0);
            s1 = fmaf(h.y, tap[di * 3 + dj].y, s1);""",
                           """            if (di == 1 && dj == 1) {
              s0 = h.x * tap[4].x;
              s1 = h.y * tap[4].y;
            }""")], False),
    "no_expand_bn_gelu": ([(
        "const uint32_t v = bn_gelu2<EXACT, PLAIN>(d[4 * t + 2 * j], d[4 * t + 2 * j + 1], s, b);",
        "const uint32_t v = pack_bf16(d[4 * t + 2 * j] * s.x, d[4 * t + 2 * j + 1] + b.y);")],
        False),
    "no_project_wgmma": ([(
        "for (int mt = 0; mt < 2; ++mt) wgmma_rs_k<C>(acc[mt], a[ks][mt], w3d + 2 * ks);",
        "for (int mt = 0; mt < 2; ++mt) acc[mt][ks] += __uint_as_float(a[ks][mt][0] ^ a[ks][mt][3]);")],
        False),
    "no_chunk_barrier": ([(
        "      group_sync(c);  // the group's reads of the last chunk are done\n", "")], False),
    "project_once": ([(_PROJECT, """#pragma unroll
      for (int ks = 0; ks < 4; ++ks) depthwise_ks<EXACT, PLAIN>(hg, w2, sb2, oy, ox, ks, cc, a[ks]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) wgmma_rs_k<C>(acc[mt], a[ks][mt], w3d + 2 * ks);
      wgmma_commit();""")], True),
    "expand_three": ([(_EXPAND, """      float d0[32], d1[32], d2[32];
      zero(d0);
      zero(d1);
      zero(d2);
      fence_regs(d0);
      fence_regs(d1);
      fence_regs(d2);
      group_sync(c);  // the group's reads of the last chunk are done
      wgmma_fence();
      issue(d0, 0);
      issue(d1, 1);
      issue(d2, 2);
      wgmma_wait<2>();
      fence_regs(d0);
      expand_epilogue<EXACT, PLAIN>(d0, hbuf, 16 * warp + g, in[0], sb1, cc);
      wgmma_wait<1>();
      fence_regs(d1);
      expand_epilogue<EXACT, PLAIN>(d1, hbuf, 64 + 16 * warp + g, in[1], sb1, cc);
      wgmma_wait<0>();
      fence_regs(d2);
      expand_epilogue<EXACT, PLAIN>(d2, hbuf, 128 + 16 * warp + g, in[2], sb1, cc);""")], True),
}


#: The f32 kind's ablations (each gives wrong results and says only what
#: its piece costs): the GELUs' two MUFU operations, the depthwise FMAs
#: (with the h loads only they feed), the expand's and the project's split
#: products on the tensor cores, the producer warps' in-place halo split,
#: BN and GELU of the expand's and of the depthwise's outputs.
F32_VARIANTS = {
    "f32_no_mufu": ([('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));', "e = t;"),
                     ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));',
                      "r = 1.f + e;")], False),
    "f32_no_depthwise_fma": ([("""            s0 = fmaf(v.x, tap[di * 3 + dj].x, s0);
            s1 = fmaf(v.y, tap[di * 3 + dj].y, s1);""",
                               """            if (di == 1 && dj == 1) {
              s0 = v.x * tap[4].x;
              s1 = v.y * tap[4].y;
            }""")], False),
    "f32_no_expand_wgmma": ([("""    wgmma_m64n32k16_ss(d, al, bh);
    wgmma_m64n32k16_ss(d, ah, bl);
    wgmma_m64n32k16_ss(d, ah, bh);""",
                              "    d[ks % 16] += __uint_as_float((uint32_t)(ah ^ bl ^ al));")], False),
    "f32_no_project_wgmma": ([("""          wgmma_rs_k<C>(acc[mt], pal[ks][mt], w3h + 2 * ks);
          wgmma_rs_k<C>(acc[mt], pah[ks][mt], w3l + 2 * ks);
          wgmma_rs_k<C>(acc[mt], pah[ks][mt], w3h + 2 * ks);""",
                               "          acc[mt][ks] += __uint_as_float(pah[ks][mt][0] ^ pal[ks][mt][3]);")],
                             False),
    "f32_no_halo_split": ([("        split_halo<C>(gbase, threadIdx.x - kConsumers - 64);\n", "")], False),
    "f32_no_expand_bn_gelu": ([("""        v = make_float2(gelu_f32<EXACT>(fmaf(d[4 * t + 2 * j], s.x, b.x)),
                        gelu_f32<EXACT>(fmaf(d[4 * t + 2 * j + 1], s.y, b.y)));""",
                                "        v = make_float2(d[4 * t + 2 * j] * s.x, d[4 * t + 2 * j + 1] + b.y);")],
                              False),
    "f32_no_depthwise_bn_gelu": ([(
        "const Frag<float> f = split_pair(gelu_f32<EXACT>(fmaf(s0, s.x, b.x)), gelu_f32<EXACT>(fmaf(s1, s.y, b.y)));",
        "const Frag<float> f = split_pair(s0 * s.x, s1 + b.y);")], False),
}


def build_variants(out_dir, variants=VARIANTS):
    """Every variant's library, built at once; returns {name: (path, the
    ptxas lines that report spills)}."""
    procs = {}
    for name, (edits, _) in variants.items():
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        header = os.path.join(src, "mbconv_sm90.cuh")
        text = open(header).read()
        for old, new in edits:
            if old not in text:
                sys.exit(f"{name}: the edit's anchor is not in mbconv_sm90.cuh")
            text = text.replace(old, new)
        open(header, "w").write(text)
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(src, "mbconv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed\n{log[-3000:]}")
        built[name] = (lib, [line.strip() for line in log.splitlines()
                             if "spill" in line and " 0 bytes spill stores" not in line])
    return built


def _use(path):
    """Points ``_build.library`` at the library at path (None: the kernel's
    own)."""
    if path is None:
        _build.library = _REAL_LIBRARY
        return
    lib = ctypes.CDLL(path)
    for fn, argtypes in _build.SIGNATURES["mbconv"].items():
        entry = getattr(lib, fn)
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
    _build.library = lambda name: lib


_REAL_LIBRARY = _build.library


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    f32 = "--f32" in sys.argv
    variants = F32_VARIANTS if f32 else VARIANTS
    built = build_variants(os.path.join(ROOT, "build", "variants"), variants)
    gen = torch.Generator().manual_seed(0)
    args = cs._mbconv_inputs(512, gen, torch.float32 if f32 else torch.bfloat16)
    small = (args[0][:64], *args[1:])
    want = mbconv._mbconv_cuda(*args, False)
    ok = True
    for name, (lib, spills) in [("kernel", (None, []))] + list(built.items()):
        _use(lib)
        got = mbconv._mbconv_cuda(*args, False)
        torch.cuda.synchronize()
        ms = cs.cuda_time_ms(lambda: mbconv._mbconv_cuda(*args, False))
        ms64 = cs.cuda_time_ms(lambda: mbconv._mbconv_cuda(*small, False))
        same = torch.equal(got, want)
        must = name == "kernel" or variants[name][1]
        print(f"K10{' f32' if f32 else ''} variant {name}: 512 images {ms:.4f} ms, "
              f"64 images {ms64:.4f} ms, "
              f"bits {'equal' if same else 'differ'}{' (must be equal)' if must else ''}"
              + (f"; {'; '.join(spills)}" if spills else ""), flush=True)
        ok = ok and (same or not must)
    _use(None)
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

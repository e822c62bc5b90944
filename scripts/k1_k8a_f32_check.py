"""Quick probe of K1's and K8a's f32 entries (``csrc/fused_block.cu``,
``csrc/attention_headmajor.cu``) on one GPU: K1-f32 runs the f32 kinds of
the LayerNorm + GEMM core (``ln_gemm_sm90.cuh``) and the forward core
(``attention_fwd_sm90.cuh``) as K9's f32 entry does, without the window
map; K8a-f32 runs the forward core's split pass (``split_planes``: its
head-major f32 q, k, v into bf16 hi / lo planes) and then the f32 kind
with the head-major store.

Builds ``fused_block``, ``attention_headmajor`` and ``fb4d`` and prints
what ``ptxas`` reports for the f32 kinds' kernels and the split pass
(registers, spills, serialised wgmma: C75xx), holds each entry's attention
plan query against ``window_attention._fwd_plan_f32``, then at each shape
below holds the entry against its plain f32 version (max |err| / max |ref|
within chip_smoke.F32_REL_TOL) and checks two calls bitwise, and holds
K9-f32 at 64 images equal to K1-f32 on the partitioned map bit for bit.
At the main shapes (K1 at stage 1 of a serving bucket of 16 and the embed
configuration's stage 3; K8a at stage 2 of a bucket of 16 and stage 3 of a
bucket of 1) it prints the entry's device time, each launch's
(torch.profiler), the f32 bound and SDPA's f32 time:

    python3 scripts/k1_k8a_f32_check.py
"""

import ctypes
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

F32 = torch.float32
#: K1 (W, N, C, H, timed): stage 1 of a serving bucket of 16 and the embed
#: configuration's stage 3 (both GEMMs at K = 576) first, then N = 1024
#: (the streamed bias), head dims 16 and 64, N = 64 and 192 (chunks of one
#: key tile).
K1_CASES = (
    (1024, 256, 192, 6, True), (64, 256, 576, 18, True),
    (2, 1024, 64, 2, False), (3, 256, 128, 8, False), (2, 256, 384, 6, False),
    (5, 64, 128, 4, False), (3, 192, 192, 6, False),
)
#: K8a (W, H, N, hd, timed): stage 2 of a serving bucket of 16 and stage 3
#: of a bucket of 1 first, then the streamed bias at N = 1024 and 2048
#: (hd 16 and 64), the largest resident tile at hd 32 (N = 704), N = 64 and
#: 192 (chunks of one key tile), a W that leaves one consumer group idle.
K8A_CASES = (
    (64, 12, 1024, 32, True), (4, 18, 256, 32, True),
    (2, 1, 1024, 32, False), (3, 2, 2048, 64, False), (3, 4, 2048, 16, False),
    (7, 5, 704, 32, False), (2, 2, 64, 16, False), (5, 3, 192, 32, False),
    (1, 1, 128, 64, False),
)


def _ptxas(names=("fused_block", "attention_headmajor")):
    """ptxas's registers and spills of each f32-kind kernel and of the
    split pass (by mangled name) in the libraries ``names`` and any
    warning that it serialised wgmma (C75xx)."""
    for name in names:
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if (("f32_sm90" in line or "split_planes" in line)
                    and "Compiling entry" in line):
                kernel = re.search(r"'(\w+)'", line).group(1)
                for follow in lines[i:i + 5]:
                    if "registers" in follow or "spill" in follow:
                        cs.log(f"ptxas {name} {kernel}: "
                               f"{follow.split(':', 1)[-1].strip()}")
            if "C75" in line:
                cs.log(f"ptxas {name}: {line.strip()}")


def _plan_check(lib, fn, W, N, H, hd):
    out = (ctypes.c_int * 8)()
    G = wa._headmajor_groups(W, H, N)
    err = _build.entry(lib, f"{fn}_plan_f32")(W, N, H, hd, G, 64, out)
    want = wa._fwd_plan_f32(W, H, N, G, hd)
    got = dict(zip(("smem", "items", "G", "NT", "NB", "QB", "S", "stream"),
                   list(out)))
    if err or any(got[k] != want[k] for k in got):
        cs.fail(f"{fn} f32 plan at W={W} N={N} H={H} hd={hd}: the core's "
                f"{got} (error {err}) != the mirror's {want}")
    return got


def _check(label, kern, plain, args, timed, bound=None, extra=()):
    got = kern(*args)
    torch.cuda.synchronize()
    again = kern(*args)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    want = plain(*args)
    err, rel = cs._rel_err(got, want)
    ok = rel <= cs.F32_REL_TOL and bool(torch.isfinite(got).all())
    cs.log(f"{label}: max_abs_err {err:.6g} max_rel_err {rel:.6g} "
           f"bitwise over two calls {same}")
    if not (ok and same):
        cs.fail(f"{label}: f32 entry disagrees with its plain version or "
                f"between calls")
    del got, again, want
    if timed:
        ms = cs.kernel_ms(lambda: kern(*args))
        cs.log(f"  ms {ms:.4f} (device time under {cs.SHORT_MS}), bound_ms "
               f"{bound[0]:.4f} ({bound[1]})" + "".join(extra))
        cs._log_launch_ms(cs._launch_ms(lambda: kern(*args)))


def main():
    cs.phase_device()
    secs = _build.build(("fused_block", "attention_headmajor", "fb4d"))
    cs.log(f"build_seconds {secs:.2f}")
    _ptxas()
    gen = torch.Generator().manual_seed(cs.SEED + 27)
    for W, N, C, H, timed in K1_CASES:
        plan = _plan_check("fused_block", "fused_block", W, N, H, C // H)
        a = cs._case_inputs(W, N, C, H, gen, F32)
        scale = (C // H) ** -0.5
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["w_proj"], a["b_proj"], a["bias"], scale, H, 1e-5)
        extra, bound = (), None
        if timed:
            bound = cs._bound_ms("K1", W, N, C, H, 4)
            qkv = wa._ln_qkv_plain(*args[:5], 1e-5)
            extra = (f", SDPA f32 on its qkv (the attention alone) "
                     f"{cs._sdpa_ms(qkv, a['bias'], scale, H):.4f}",)
            del qkv
        _check(f"K1 f32 {(W, N, C, H)} plan {plan}", wa._fused_block_cuda,
               wa._fused_block_plain, args, timed, bound, extra)
        del a, args
        torch.cuda.empty_cache()
    kern, _, args, *_ = cs._embed_kernel_case("K9", 64, gen, F32)
    scale = (cs.STAGE1_C // cs.STAGE1_HEADS) ** -0.5
    cs._k9_equals_k1(kern(*args), (*args, scale, cs.STAGE1_HEADS,
                                   cs.STAGE1_WINDOW, 1e-5), " f32")
    del args
    torch.cuda.empty_cache()
    for W, H, N, hd, timed in K8A_CASES:
        plan = _plan_check("attention_headmajor", "attention_qtiled", W, N,
                           H, hd)
        q, k, v = (torch.randn(W, H, N, hd, generator=gen).to("cuda")
                   for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        args = (q, k, v, bias, hd ** -0.5)
        extra, bound = (), None
        if timed:
            bound = cs._headmajor_bound_ms(W, H, N, 4)
            sdpa, what = cs._headmajor_sdpa_ms(*args)
            extra = (f", SDPA f32 {sdpa:.4f} ({what})",)
        _check(f"K8a f32 {(W, H, N, hd)} plan {plan}",
               wa._attention_qtiled_cuda, wa._attention_plain, args, timed,
               bound, extra)
        del q, k, v, bias, args
        torch.cuda.empty_cache()
    cs.log("k1_k8a_f32_check: ok")


if __name__ == "__main__":
    main()

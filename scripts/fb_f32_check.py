"""Quick probe of K2's and K9's f32 entries (``csrc/fb_s2.cu``,
``csrc/fb4d.cu``) on one GPU: the f32 kinds of the LayerNorm + GEMM core
(``ln_gemm_sm90.cuh``) and the forward core (``attention_fwd_sm90.cuh``).

Builds ``fb_s2`` and ``fb4d`` and prints what ``ptxas`` reports for the
f32 kinds' kernels (registers, spills, serialised wgmma: C75xx), holds the
attention's plan query against ``window_attention._fwd_plan_f32``, then at
each shape below holds the entry against its plain f32 version (max |err|
/ max |ref| within chip_smoke.F32_REL_TOL) and checks two calls bitwise.
At the main shapes (K2 at stage 2 of a serving bucket of 16; K9 at 64 and
512 images of stage 1) it prints the entry's device time, each launch's
(torch.profiler), the f32 bound and SDPA's f32 time on the same q, k, v
and bias:

    python3 scripts/fb_f32_check.py

Faster than chip_smoke.py, which runs the main shapes among all the
others.
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
#: K2 (W, N, C, H, timed): stage 2 of a serving bucket of 16 first, then
#: head dims 16 and 64 at N = 1024 (the streamed bias) and 256, N = 64 and
#: 192 (chunks of one key tile), the widest C the f32 entry takes (576:
#: 64-row x tiles) and 448.
K2_CASES = (
    (64, 1024, 384, 12, True), (2, 1024, 64, 4, False),
    (2, 1024, 128, 2, False), (4, 256, 128, 2, False), (7, 64, 192, 6, False),
    (3, 192, 128, 4, False), (3, 256, 576, 18, False), (2, 128, 448, 14, False),
)
#: K9 (images, map side, C, H, window, timed): stage 1 at a serving bucket
#: of 16 (64 images) and at the embed batch (512), a narrow map, 32 x 32
#: windows (N = 1024: the streamed bias), head dims 16 and 64 (C = 384:
#: 64-row x tiles through the window map).
K9_CASES = (
    (64, 64, 192, 6, 16, True), (512, 64, 192, 6, 16, True),
    (2, 32, 64, 2, 16, False), (2, 64, 64, 2, 32, False),
    (1, 128, 128, 8, 16, False), (1, 128, 384, 6, 16, False),
)


def _ptxas():
    """ptxas's registers and spills of each f32-kind kernel (by its mangled
    name) and any warning that it serialised wgmma (C75xx)."""
    for name in ("fb_s2", "fb4d"):
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "f32_sm90" in line and "Compiling entry" in line:
                kernel = re.search(r"'(\w+)'", line).group(1)
                for follow in lines[i:i + 5]:
                    if "registers" in follow or "spill" in follow:
                        cs.log(f"ptxas {name} {kernel}: "
                               f"{follow.split(':', 1)[-1].strip()}")
            if "C75" in line:
                cs.log(f"ptxas {name}: {line.strip()}")


def _plan_check(lib, W, N, H, hd):
    out = (ctypes.c_int * 8)()
    G = wa._headmajor_groups(W, H, N)
    err = _build.entry(lib, f"{lib}_plan_f32")(W, N, H, hd, G, 64, out)
    want = wa._fwd_plan_f32(W, H, N, G, hd)
    got = dict(zip(("smem", "items", "G", "NT", "NB", "QB", "S", "stream"),
                   list(out)))
    if err or any(got[k] != want[k] for k in got):
        cs.fail(f"{lib} f32 plan at W={W} N={N} H={H} hd={hd}: the core's "
                f"{got} (error {err}) != the mirror's {want}")
    return got


def _check(label, kern, plain, args, timed, bound=None, qkv=None, extra=()):
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
        cs.log(f"  ms {ms:.4f} (device time), bound_ms {bound[0]:.4f} "
               f"({bound[1]})" + "".join(extra))
        cs._log_launch_ms(cs._launch_ms(lambda: kern(*args)))


def main():
    cs.phase_device()
    secs = _build.build(("fb_s2", "fb4d"))
    cs.log(f"build_seconds {secs:.2f}")
    _ptxas()
    gen = torch.Generator().manual_seed(cs.SEED + 25)
    for W, N, C, H, timed in K2_CASES:
        plan = _plan_check("fb_s2", W, N, H, C // H)
        a = cs._case_inputs(W, N, C, H, gen, F32)
        scale = (C // H) ** -0.5
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["bias"], scale, H, 1e-5)
        extra = ()
        bound = None
        if timed:
            bound = cs._bound_ms("K2", W, N, C, H, 4)
            qkv = wa._ln_qkv_plain(*args[:5], 1e-5)
            extra = (f", SDPA f32 on its qkv {cs._sdpa_ms(qkv, a['bias'], scale, H):.4f}",)
            del qkv
        _check(f"K2 f32 {(W, N, C, H)} plan {plan}", wa._fb_s2_cuda,
               wa._fb_s2_plain, args, timed, bound, extra=extra)
        del a, args
        torch.cuda.empty_cache()
    for B, side, C, H, ws, timed in K9_CASES:
        N = ws * ws
        W = B * (side // ws) ** 2
        plan = _plan_check("fb4d", W, N, H, C // H)
        a = cs._case_inputs(W, N, C, H, gen, F32)
        x4 = a["x"].reshape(B, side, side, C)
        scale = (C // H) ** -0.5
        args = (x4, a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["w_proj"], a["b_proj"], a["bias"], scale, H, ws, 1e-5)
        bound = cs._bound_ms("K1", W, N, C, H, 4) if timed else None
        _check(f"K9 f32 {(B, side, side, C)} H={H} ws={ws} plan {plan}",
               wa._fb4d_cuda, lambda *t: cs._sliced(wa._fb4d_plain, t, B)
               if B > 64 else wa._fb4d_plain(*t), args, timed, bound)
        del a, args, x4
        torch.cuda.empty_cache()
    cs.log("fb_f32_check: ok")


if __name__ == "__main__":
    main()

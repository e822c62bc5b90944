"""Quick probe of K3's and K8b's f32 entries (``csrc/attention_qkv.cu``,
``csrc/attention_headmajor.cu``) on one GPU: K8b-f32 makes K8a-f32's two
launches (the forward core's split pass ``split_planes`` of its head-major
f32 q, k, v into bf16 hi / lo planes, then the core's f32 kind with the
head-major store); K3-f32 splits its f32 qkv in order (the pass's
in-order source) and runs the f32 kind's interleaved instance that K1, K2
and K9 run.

Builds ``attention_qkv`` and ``attention_headmajor`` and prints what
``ptxas`` reports for the f32 kinds' kernels and both split instances,
holds each entry's attention plan query against
``window_attention._fwd_plan_f32``, then at each shape below holds the
entry against its plain f32 version (max |err| / max |ref| within
chip_smoke.F32_REL_TOL), checks two calls bitwise, and holds K8b-f32 equal
to K8a-f32 on the same inputs and K3-f32 equal to K8a-f32 on its qkv's
head-major copies, bit for bit.  At the main shapes (K8b at stages 1 and 3
of a serving bucket of 16, K3 at stage 3 of buckets of 16 and 1) it prints
the entry's device time, each launch's (torch.profiler), the f32 bound and
SDPA's f32 time:

    python3 scripts/k3_k8b_f32_check.py
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import k1_k8a_f32_check as k18  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

F32 = torch.float32
#: K8b (W, H, N, hd, timed): stages 1 and 3 of a serving bucket of 16
#: first, then head dims 16 and 64, N = 64 and 448 (K8b's largest), N = 192
#: (chunks of one key tile).
K8B_CASES = (
    (1024, 6, 256, 32, True), (64, 18, 256, 32, True),
    (8, 2, 64, 16, False), (16, 3, 448, 64, False), (8, 5, 192, 32, False),
    (8, 1, 384, 16, False),
)
#: K3 (W, N, H, hd, timed): stage 3 of buckets of 16 and 1 first, then the
#: largest resident tile at hd 32 (N = 704), the streamed bias at N = 768,
#: 1024 and 2048, N = 64 and 192 (chunks of one key tile), an odd W.
K3_CASES = (
    (64, 256, 18, 32, True), (4, 256, 18, 32, True),
    (3, 704, 2, 32, False), (2, 768, 3, 32, False), (3, 1024, 2, 16, False),
    (2, 2048, 1, 64, False), (5, 64, 4, 16, False), (3, 192, 6, 32, False),
    (7, 128, 2, 64, False),
)


def _heads(qkv, H):
    W, N, D3 = qkv.shape
    return tuple(t.contiguous() for t in qkv.view(
        W, N, H, 3, D3 // (3 * H)).permute(3, 0, 2, 1, 4))


def _equal_k8a(label, got, other):
    same = torch.equal(got, other)
    cs.log(f"  {label} {same}")
    if not same:
        cs.fail(f"{label}: max |diff| {float((got - other).abs().max()):.3g}")


def main():
    cs.phase_device()
    secs = _build.build(("attention_qkv", "attention_headmajor"))
    cs.log(f"build_seconds {secs:.2f}")
    k18._ptxas(("attention_qkv", "attention_headmajor"))
    gen = torch.Generator().manual_seed(cs.SEED + 28)
    for W, H, N, hd, timed in K8B_CASES:
        plan = k18._plan_check("attention_headmajor", "attention_batched", W,
                               N, H, hd)
        q, k, v = (torch.randn(W, H, N, hd, generator=gen).to("cuda")
                   for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        args = (q, k, v, bias, hd ** -0.5)
        extra, bound = (), None
        if timed:
            bound = cs._headmajor_bound_ms(W, H, N, 4)
            sdpa, what = cs._headmajor_sdpa_ms(*args)
            extra = (f", SDPA f32 {sdpa:.4f} ({what})",)
        k18._check(f"K8b f32 {(W, H, N, hd)} plan {plan}",
                   wa._attention_batched_cuda, wa._attention_plain, args,
                   timed, bound, extra)
        _equal_k8a("K8b-f32 = K8a-f32 on the same inputs, bitwise",
                   wa._attention_batched_cuda(*args),
                   wa._attention_qtiled_cuda(*args))
        del q, k, v, bias, args
        torch.cuda.empty_cache()
    for W, N, H, hd, timed in K3_CASES:
        plan = k18._plan_check("attention_qkv", "attention_qkv", W, N, H, hd)
        qkv = torch.randn(W, N, 3 * H * hd, generator=gen).to("cuda")
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        args = (qkv, bias, hd ** -0.5, H)
        extra, bound = (), None
        if timed:
            bound = cs._bound_ms("K3", W, N, H * hd, H, 4)
            extra = (f", SDPA f32 {cs._sdpa_ms(qkv, bias, hd ** -0.5, H):.4f}",)
        k18._check(f"K3 f32 {(W, N, H, hd)} plan {plan}",
                   wa._attention_qkv_fused_cuda,
                   wa._attention_qkv_fused_plain, args, timed, bound, extra)
        k8a = wa._attention_qtiled_cuda(*_heads(qkv, H), bias, hd ** -0.5)
        _equal_k8a("K3-f32 = K8a-f32 on its head-major copies, bitwise",
                   wa._attention_qkv_fused_cuda(*args),
                   k8a.permute(0, 2, 1, 3).reshape(W, N, H * hd))
        del qkv, bias, args, k8a
        torch.cuda.empty_cache()
    cs.log("k3_k8b_f32_check: ok")


if __name__ == "__main__":
    main()

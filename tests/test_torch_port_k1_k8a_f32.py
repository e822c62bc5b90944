"""K1's and K8a's f32 entries on the CPU.

K1-f32 (``csrc/fused_block.cu``) runs K9's three f32 launches without the
window map: the LayerNorm + GEMM core's f32 qkv kind into qkv's bf16 hi /
lo planes, the forward core's f32 kind over ``_headmajor_groups``, the
core's f32 projection kind.  K8a-f32 (``csrc/attention_headmajor.cu``) runs
the forward core's split pass (``split_planes``: the head-major f32 q, k, v
as the interleaved bf16 planes K2's qkv GEMM stores) and then the same f32
kind with the head-major store.

Here: a torch emulation of both against the plain f32 versions, the JAX
XLA functions and the JAX kernels in interpret mode; a plain mirror of the
split pass and of its kernel's index arithmetic; the attention's plan
mirrored at every shape the entries take (the GEMM plans beside K1's);
routing and the refusals before any launch.  The kernels themselves are
held against the plain versions on the card by chip_smoke.py (phase 24)
and scripts/k1_k8a_f32_check.py.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

from test_torch_port_fwd_f32 import (F32_REL_TOL, FWD90, SMEM_MAX, _case,
                                     _emulate_attention_f32, _emulate_gemm_f32,
                                     _gemm_plan_f32, _int, _rel)
from test_torch_port_fused_block_sm90 import _k1_args
from test_torch_port_fwd_sm90 import _c_body, _fake_card


# ---------------------------------------------------------------------------
# The split pass
# ---------------------------------------------------------------------------


def _split_planes(q, k, v):
    """The split pass's plain mirror: head-major (W, H, N, hd) f32 q, k, v
    -> the (2, W, N, 3 H hd) bf16 planes of the interleaved qkv, head h's
    q|k|v at columns [3 h hd, 3 (h + 1) hd), hi = bf16(x), lo = bf16(x -
    hi)."""
    W, H, N, hd = q.shape
    qkv = torch.stack((q, k, v), dim=3).permute(0, 2, 1, 3, 4)
    qkv = qkv.reshape(W, N, 3 * H * hd)
    return wa._split_bf16(qkv).reshape(2, W, N, 3 * H * hd)


def _split_pass_sources(W, H, N, hd):
    """The kernel's index arithmetic (``split_planes``), uint2 by uint2 of
    one plane: (tensor, window, head, row, float4 of the row) that each
    uint2 f of window w's rows reads, as block (z, w) and thread t compute
    it."""
    threads, per = (_int(FWD90, "kSplitThreads"), _int(FWD90, "kSplitPer"))
    vec = hd // 4
    row4 = 3 * H * vec
    end = N * row4
    out = {}
    for w in range(W):
        for z in range(-(-end // (threads * per))):
            for t in range(threads):
                for u in range(per):
                    f = z * threads * per + t + u * threads
                    if f >= end:
                        continue
                    n, col = divmod(f, row4)
                    h = col // (3 * vec)
                    slot = (col - h * 3 * vec) // vec
                    assert (w, f) not in out
                    out[(w, f)] = (slot, w, h, n, col % vec)
    return out


@pytest.mark.parametrize("W,H,N,hd", [(2, 3, 64, 16), (1, 2, 128, 32),
                                      (3, 1, 64, 64)])
def test_split_pass_mirror_is_the_split_rule_in_the_interleaved_layout(
        W, H, N, hd):
    """The mirror's planes are ``_split_bf16`` of the interleaved qkv that
    ``_qkv_layout`` reads (head h's q, k, v at columns (3 h + slot) hd), so
    hi + lo is x to about 2^-17; and the kernel's index arithmetic sends
    every uint2 of a window's plane rows to the float4 of q, k or v that
    the mirror puts there, each exactly once."""
    g = torch.Generator().manual_seed(W * 100 + N + hd)
    q, k, v = (torch.randn(W, H, N, hd, generator=g) for _ in range(3))
    planes = _split_planes(q, k, v)
    assert planes.shape == (2, W, N, 3 * H * hd)
    assert planes.dtype == torch.bfloat16
    hi, lo = planes[0].float(), planes[1].float()
    assert wa._qkv_layout(*((t.shape, t.stride(), 0, 2) for t in (
        planes[0].contiguous(), torch.zeros(H, N, N, dtype=torch.bfloat16))),
        H) == (W, N, H * hd, hd)
    for slot, t in enumerate((q, k, v)):
        got_hi = hi.reshape(W, N, H, 3, hd)[:, :, :, slot].permute(0, 2, 1, 3)
        got_lo = lo.reshape(W, N, H, 3, hd)[:, :, :, slot].permute(0, 2, 1, 3)
        assert torch.equal(got_hi, t.to(torch.bfloat16).float())
        assert torch.equal(got_lo, (t - got_hi).to(torch.bfloat16).float())
        assert float((got_hi + got_lo - t).abs().max()) <= float(
            t.abs().max()) * 2.0 ** -16
    src = _split_pass_sources(W, H, N, hd)
    assert len(src) == W * N * 3 * H * hd // 4
    flat = hi.reshape(W, -1, 4)
    tensors = (q, k, v)
    for (w, f), (slot, sw, h, n, j) in src.items():
        assert sw == w
        want = tensors[slot][w, h, n, 4 * j:4 * j + 4]
        assert torch.equal(flat[w, f], want.to(torch.bfloat16).float())


def test_the_split_pass_is_hopper_code_beside_the_f32_kind():
    """``split_planes`` reads float4 and writes uint2 of each plane with
    ``split_pair`` (round to nearest), in the forward core's unnamed
    namespace; K8a's f32 entry runs it and then the f32 kind's head-major
    instance, which stores out through ``store_rows_f32<LAYOUT, HD>``.
    The first design's kernels of K1 and K8a are gone, and with K3's and
    K8b's f32 entries on the f32 kind, so are theirs."""
    fwd = FWD90.read_text()
    f32 = fwd[fwd.index("// The f32 kind"):]
    body = f32[f32.index("split_planes(const float4*"):]
    body = body[:body.index("\n}\n")]
    assert "split_pair(a[u].x, a[u].y)" in body
    assert "hi[plane4 + f] = make_uint2(" in body
    assert "template <int HD, int NT, bool STREAM, int LAYOUT>" in f32
    assert "store_rows_f32<LAYOUT, HD>(out, p, w, h" in f32
    assert "template <int HD, int LAYOUT = kQkv>" in f32
    entry = _c_body("attention_headmajor", "attention_qtiled_f32")
    assert entry.index("split_headmajor<HD>(") < entry.index(
        "run_f32<HD, kHeadMajor>(")
    head = (_build.CSRC / "attention_headmajor.cu").read_text()
    for gone in ("attention_qtiled_kernel", "qtiled<", "GlobalBias"):
        assert gone not in head
    common = (_build.CSRC / "common.cuh").read_text()
    for gone in ("ln_gemm_kernel", "launch_ln_gemm"):
        assert gone not in common
    # K3's and K8b's f32 entries left the first design
    for gone in ("launch_window_attention", "window_attention_kernel",
                 "mma_bf16_16816"):
        assert gone not in common
    for gone in ("attention_batched_kernel", "attend_tile", "batched<"):
        assert gone not in head


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("C", [192, 384, 576])
@pytest.mark.parametrize("D", [192, 384, 576])
def test_k1_f32_plans_fit_at_every_width_the_cores_take(C, D, N):
    """K1-f32 at C, D up to LN_GEMM_MAX_K and N up to FB_S2_MAX_N: the qkv
    kind (K = C, 3D columns, stored as planes) and the projection kind (K =
    D, C columns) plan within 232,448 bytes, and the attention's f32 plan
    fits over ``_headmajor_groups`` (streamed at N = 1024)."""
    W, hd = 64, 32
    H = D // hd
    for staged, K, Nout in ((True, C, 3 * D), (False, D, C)):
        p = _gemm_plan_f32(W * N, K, Nout, staged)
        assert p is not None and p["bytes"] <= SMEM_MAX
    a = wa._fwd_plan_f32(W, H, N, wa._headmajor_groups(W, H, N), hd)
    assert a is not None and a["smem"] <= SMEM_MAX
    assert a["stream"] == (N == 1024)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N", range(64, 2049, 64))
def test_k8a_f32_plan_fits_at_every_n_up_to_2048(N, hd):
    """K8a-f32 takes every N a multiple of 64: its attention plan fits
    232,448 bytes with a ring of a chunk's NT tiles, resident where the 64
    x N f32 bias tile leaves a ring and streamed in chunks of two key tiles
    over items of two windows above."""
    W, H = 5, 3
    G = wa._headmajor_groups(W, H, N)
    p = wa._fwd_plan_f32(W, H, N, G, hd)
    assert p is not None and p["smem"] <= SMEM_MAX
    assert p["S"] >= p["NT"] == (2 if N // 64 % 2 == 0 else 1)
    if p["stream"]:
        assert p["G"] == -(-W // 2) and N >= {16: 832, 32: 768, 64: 512}[hd]
    else:
        assert p["G"] == G


def test_the_f32_plan_queries_are_the_cores():
    """``fused_block_plan_f32`` and ``attention_qtiled_plan_f32`` answer
    with ``fwd90::plan_f32`` (64-row items only), the plan the mirror
    ``_fwd_plan_f32`` copies; both are in their libraries' signatures."""
    for lib, fn in (("fused_block", "fused_block_plan_f32"),
                    ("attention_headmajor", "attention_qtiled_plan_f32")):
        body = _c_body(lib, fn)
        assert "gg::fwd90::plan_f32(W, H, N, G, hd, out)" in body
        assert "rows != gg::fwd90::kRows" in body
        assert _build.SIGNATURES[lib][fn] == _build._PLAN


# ---------------------------------------------------------------------------
# Routing and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,N,C,D,H", [(1, 1088, 64, 64, 2),
                                       (2, 256, 640, 64, 2),
                                       (2, 256, 64, 640, 10),
                                       (1, 2048, 192, 192, 6)])
def test_k1_f32_refuses_above_the_cores_limits_before_any_launch(
        monkeypatch, W, N, C, D, H):
    """An f32 K1 call with N above FB_S2_MAX_N or C or D above
    LN_GEMM_MAX_K raises ValueError and launches nothing: the f32 entry
    runs the cores' f32 kinds, which take what the bf16 kinds take (the
    first design took any C and N that were multiples of 64)."""
    calls = _fake_card(monkeypatch)
    wa.reset_launches()
    with pytest.raises(ValueError, match="K1 takes N up to"):
        wa._fused_block_cuda(*_k1_args(W, N, C, D, H, torch.float32), 0.25,
                             H, 1e-5)
    assert calls == [] and sum(wa.LAUNCHES.values()) == 0


def test_k8a_f32_refuses_where_the_core_has_no_plan(monkeypatch):
    """Where ``_fwd_plan_f32`` has no plan an f32 K8a call raises before
    any launch (no multiple of 64 up to 2048 reaches it at hd 16-64)."""
    calls = _fake_card(monkeypatch)
    monkeypatch.setattr(wa, "_fwd_plan_f32", lambda *a: None)
    q = torch.zeros(2, 1, 1024, 32)
    with pytest.raises(ValueError, match="K8a's f32 attention has no plan"):
        wa._attention_qtiled_cuda(q, q, q, torch.zeros(1, 1024, 1024), 0.25)
    assert calls == []


# ---------------------------------------------------------------------------
# The arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _emulate_k1_f32(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                    scale, H, eps):
    """K1's three f32 launches: K9's (``_emulate_k9_f32``) on the window
    rows as they are."""
    qkv = _emulate_gemm_f32(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    o = _emulate_attention_f32(qkv, bias, scale, H)
    return _emulate_gemm_f32(o, None, None, w_proj, b_proj, eps,
                             layer_norm=False)


def _emulate_k8a_f32(q, k, v, bias, scale):
    """K8a's two f32 launches: the split pass's planes (hi + lo, what the
    f32 kind's products read) as the interleaved qkv, the f32 kind's
    arithmetic on it (chunks of two key tiles, one where N / 64 is odd),
    the output stored head-major."""
    W, H, N, hd = q.shape
    planes = _split_planes(q, k, v).float()
    o = _emulate_attention_f32(planes[0] + planes[1], bias, scale, H,
                               nt=2 if N // 64 % 2 == 0 else 1)
    return o.reshape(W, N, H, hd).permute(0, 2, 1, 3)


@pytest.mark.parametrize("W,N,C,H", [(2, 256, 64, 2), (1, 256, 128, 4)])
def test_k1_f32_emulation_matches_plain_and_the_jax_kernels(W, N, C, H):
    """On seeded f32 inputs (N = 256: two softmax chunks a row) the
    emulation of K1's three f32 launches against ``_fused_block_plain`` in
    f32, the JAX ``_fused_block_xla`` and ``_fused_block_pallas`` in
    interpret mode on the same f32 inputs, within F32_REL_TOL."""
    case = _case(27 + C, (W, N), C, H, N, proj=True)
    scale = (C // H) ** -0.5
    targs = list(map(torch.from_numpy, case))
    got = _emulate_k1_f32(*targs, scale, H, 1e-5)
    plain = wa._fused_block_plain(*targs, scale, H, 1e-5)
    jargs = list(map(jnp.asarray, case))
    xla = np.asarray(jwa._fused_block_xla(*jargs, scale, H, 1e-5))
    pallas = np.asarray(jwa._fused_block_pallas(*jargs, scale, H, 1e-5,
                                                block_w=W, interpret=True))
    assert got.shape == plain.shape == xla.shape == pallas.shape == (W, N, C)
    assert plain.dtype == torch.float32
    for want in (plain, xla, pallas):
        assert _rel(got, want) < F32_REL_TOL


@pytest.mark.parametrize("W,H,N,hd", [(2, 2, 256, 32), (1, 1, 1024, 32),
                                      (2, 3, 192, 16)])
def test_k8a_f32_emulation_matches_plain_and_the_jax_attention(W, H, N, hd):
    """On seeded f32 inputs the emulation of K8a's split pass and f32 kind
    against ``_attention_plain`` in f32 and the JAX ``_attention_xla`` on
    the same inputs, within F32_REL_TOL: two windows of N = 256 (two
    softmax chunks), one of N = 1024 (the streamed plan's eight), and N =
    192 at hd 16 (chunks of one key tile)."""
    rng = np.random.default_rng(W * 1000 + N + hd)
    q, k, v = (rng.normal(0, 1, (W, H, N, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(0, 0.5, (H, N, N)).astype(np.float32)
    scale = hd ** -0.5
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    got = _emulate_k8a_f32(tq, tk, tv, tb, scale)
    plain = wa._attention_plain(tq, tk, tv, tb, scale)
    xla = np.asarray(jwa._attention_xla(*map(jnp.asarray, (q, k, v, bias)),
                                        scale))
    assert got.shape == plain.shape == xla.shape == (W, H, N, hd)
    assert plain.dtype == torch.float32
    for want in (plain, xla):
        assert _rel(got, want) < F32_REL_TOL


def test_the_k1_and_k8a_f32_entries_are_their_launches():
    """fused_block_f32's body makes each of K9's three f32 launches once;
    K8a's entries all take the `planes` scratch, which only the f32 one
    reads (its split pass writes it)."""
    k1 = _c_body("fused_block", "fused_block_f32")
    k9 = _c_body("fb4d", "fb4d_f32")
    for call in ("gg::lng90::run_f32<kQkvGemm, ", "gg::fwd90::run_f32<HD>(",
                 "gg::lng90::run_f32<kProjGemm, "):
        assert k1.count(call) == k9.count(call) == 1
    k8a = _c_body("attention_headmajor", "attention_qtiled_f32")
    assert "void* planes" in k8a
    assert "split_headmajor<HD>(q, k, v, planes, W, H, N, stream)" in k8a
    for entry in ("attention_qtiled_bf16", "attention_qtiled_q128_bf16"):
        assert "void* /*planes*/" in _c_body("attention_headmajor", entry)
    assert re.search(r"constexpr int kSplitPer = \d+;", FWD90.read_text())

"""K3's and K8b's f32 entries on the CPU.

K8b-f32 (``csrc/attention_headmajor.cu``) makes K8a-f32's two launches: the
forward core's split pass (``split_planes``, head-major source) of its f32
q, k, v into the interleaved bf16 hi / lo planes, then the core's f32 kind
with the head-major store, over the same ``_headmajor_groups``.  K3-f32
(``csrc/attention_qkv.cu``) splits its f32 qkv in order (the pass's
in-order source: qkv is the planes' layout already) and runs the same f32
kind with the interleaved store that K1, K2 and K9 run.

Here: the in-order split's mirror against the head-major one, emulations
of both entries against the plain f32 versions and the JAX XLA functions
(the CPU branches of ``window_attention_qkv`` and ``window_attention``),
the equality of K3-f32 and K8a-f32 on the head-major copies of one qkv, the
attention plan at every shape the entries take, the C entries' launches
and the refusals before any launch.  The kernels themselves are held
against the plain versions on the card by chip_smoke.py (phase 24).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

from test_torch_port_fwd_f32 import (F32_REL_TOL, FWD90, SMEM_MAX,
                                     _emulate_attention_f32, _int, _rel)
from test_torch_port_fwd_sm90 import _c_body, _fake_card
from test_torch_port_k1_k8a_f32 import _emulate_k8a_f32, _split_planes


def _split_qkv(qkv):
    """The in-order split's plain mirror: the (W, N, 3D) f32 qkv -> its
    (2, W, N, 3D) bf16 planes, element i of qkv in element i of each."""
    return wa._split_bf16(qkv).reshape(2, *qkv.shape)


def _heads(qkv, H):
    """The head-major (W, H, N, hd) copies of qkv's q, k and v."""
    W, N, D3 = qkv.shape
    hd = D3 // (3 * H)
    return tuple(t.contiguous() for t in
                 qkv.view(W, N, H, 3, hd).permute(3, 0, 2, 1, 4))


def _nt(N):
    return 2 if N // 64 % 2 == 0 else 1


def _emulate_k3_f32(qkv, bias, scale, H):
    """K3's two f32 launches: the in-order split's planes (hi + lo, what
    the f32 kind's products read), then the f32 kind's arithmetic on them
    (chunks of two key tiles, one where N / 64 is odd), out interleaved."""
    planes = _split_qkv(qkv).float()
    return _emulate_attention_f32(planes[0] + planes[1], bias, scale, H,
                                  nt=_nt(qkv.shape[1]))


def _qkv_case(W, N, H, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (W, N, 3 * H * hd)).astype(np.float32)
    bias = rng.normal(0, 0.5, (H, N, N)).astype(np.float32)
    return qkv, bias


# ---------------------------------------------------------------------------
# The in-order split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,N,H,hd", [(2, 64, 3, 16), (1, 128, 2, 32),
                                      (3, 64, 1, 64)])
def test_in_order_split_is_the_head_major_split_of_the_same_values(W, N, H,
                                                                   hd):
    """Element for element, the in-order split of qkv holds the bf16
    planes the head-major pass writes from qkv's head-major q, k, v: the
    same f32 values at the same plane positions, hi = bf16(x), lo =
    bf16(x - hi)."""
    qkv, _ = _qkv_case(W, N, H, hd, W * 100 + N + hd)
    qkv = torch.from_numpy(qkv)
    got = _split_qkv(qkv)
    assert got.shape == (2, W, N, 3 * H * hd) and got.dtype == torch.bfloat16
    assert torch.equal(got, _split_planes(*_heads(qkv, H)))
    assert torch.equal(got[0], qkv.to(torch.bfloat16))
    assert torch.equal(got[1], (qkv - got[0].float()).to(torch.bfloat16))


def _split_source():
    body = FWD90.read_text()
    body = body[body.index("split_planes(const float4*"):]
    return body[:body.index("\n}\n")]


def test_the_split_pass_takes_either_source_in_one_kernel():
    """``split_planes`` has one body for both sources: the in-order source
    reads float4 f of window w's qkv rows for uint2 f of its plane rows,
    the head-major source keeps its gather; both write through the same
    ``split_pair`` stores.  K3's launcher hands qkv as q, k and v."""
    src = FWD90.read_text()
    assert "template <int HD, int SRC>\n__global__" in src
    body = _split_source()
    inorder = body[body.index("if constexpr (SRC == kQkv) {"):
                   body.index("} else {")]
    assert "a[u] = q[(long)w * end + f];" in inorder
    assert "a[u] = x[((long)(w * H + h) * N + n) * kVec + j];" in body
    assert body.count("split_pair(") == 2
    assert "split_planes<HD, SRC><<<" in src
    assert "return split_to_planes<HD, kQkv>(qkv, qkv, qkv, planes" in src
    assert "return split_to_planes<HD, kHeadMajor>(q, k, v, planes" in src
    # one split kernel in the core: K3's source is a template argument, not
    # a fourth pass beside split_planes and clip_flash_sm90.cuh's split_kv
    assert len(re.findall(
        r"__global__ void __launch_bounds__\(kSplitThreads\)", src)) == 1


# ---------------------------------------------------------------------------
# The arithmetic, emulated in torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,N,H,hd", [(2, 256, 2, 32), (1, 192, 3, 16),
                                      (2, 128, 1, 64)])
def test_k3_f32_emulation_matches_plain_and_the_jax_attention(W, N, H, hd):
    """On seeded f32 inputs the emulation of K3's split and f32 kind
    against ``_attention_qkv_fused_plain`` in f32 and the JAX
    ``_attention_qkv_fused_xla`` (the CPU branch of
    ``window_attention_qkv``) on the same inputs, within F32_REL_TOL: N =
    256 (two softmax chunks), N = 192 at hd 16 (chunks of one key tile),
    N = 128 at hd 64."""
    qkv, bias = _qkv_case(W, N, H, hd, 2800 + N + hd)
    scale = hd ** -0.5
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    got = _emulate_k3_f32(tq, tb, scale, H)
    plain = wa._attention_qkv_fused_plain(tq, tb, scale, H)
    xla = np.asarray(jwa._attention_qkv_fused_xla(jnp.asarray(qkv),
                                                  jnp.asarray(bias), scale, H))
    assert got.shape == plain.shape == xla.shape == (W, N, H * hd)
    assert plain.dtype == torch.float32
    for want in (plain, xla):
        assert _rel(got, want) < F32_REL_TOL


@pytest.mark.parametrize("N", [128, 192])
def test_k8b_f32_emulation_matches_plain_and_the_jax_attention(N):
    """K8b-f32 is K8a-f32's launches: its emulation against
    ``_attention_plain`` in f32 and the JAX ``_attention_xla`` (the CPU
    branch of ``window_attention``) at a shape K8b takes (W a multiple of
    BLOCK_W, N below 512), within F32_REL_TOL."""
    W, H, hd = 8, 1, 32
    assert W % wa.BLOCK_W == 0 and N < 512
    rng = np.random.default_rng(2800 + N)
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
    for want in (plain, xla):
        assert _rel(got, want) < F32_REL_TOL


def test_k3_f32_equals_k8a_f32_on_the_head_major_copies():
    """The in-order split of qkv holds the head-major split's bf16 values
    and the f32 kind's sums do not depend on out's layout, so K3-f32 on
    qkv is K8a-f32 on qkv's head-major copies, permuted back to (W, N, D),
    bit for bit (as chip_smoke.py holds the kernels on the card)."""
    W, N, H, hd = 2, 256, 3, 32
    qkv, bias = _qkv_case(W, N, H, hd, 28)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    k3 = _emulate_k3_f32(tq, tb, hd ** -0.5, H)
    k8a = _emulate_k8a_f32(*_heads(tq, H), tb, hd ** -0.5)
    assert torch.equal(k3, k8a.permute(0, 2, 1, 3).reshape(W, N, H * hd))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N", range(64, 512, 64))
def test_k8b_f32_plan_is_resident_at_every_n_it_takes(N, hd):
    """K8b takes N below 512: at every such N the f32 attention plan over
    ``_headmajor_groups`` keeps the 64 x N f32 bias tile resident within
    232,448 bytes (at stage 1's and stage 3's window counts of a serving
    bucket of 16), with a ring of a chunk's NT tiles."""
    for W, H in ((1024, 6), (64, 18), (8, 1)):
        G = wa._headmajor_groups(W, H, N)
        p = wa._fwd_plan_f32(W, H, N, G, hd)
        assert p is not None and p["smem"] <= SMEM_MAX
        assert p["stream"] == 0 and p["G"] == G
        assert p["S"] >= p["NT"] == (2 if N // 64 % 2 == 0 else 1)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N", range(64, 2049, 64))
def test_k3_f32_plan_fits_at_every_n_up_to_2048(N, hd):
    """K3-f32 takes every N a multiple of 64 up to 2048 (the first design
    took any; K3's bf16 entry stops at 1024): the f32 attention plan fits
    the header's kSmemMax with a ring of a chunk's NT tiles, resident where
    the 64 x N f32 bias tile leaves a ring, streamed in chunks of two key
    tiles over items of two windows above."""
    smem_max = _int(FWD90, "kSmemMax")
    assert smem_max == SMEM_MAX
    W, H = 64, 18
    G = wa._headmajor_groups(W, H, N)
    p = wa._fwd_plan_f32(W, H, N, G, hd)
    assert p is not None and p["smem"] <= smem_max
    assert p["S"] >= p["NT"] == (2 if N // 64 % 2 == 0 else 1)
    if p["stream"]:
        assert p["G"] == -(-W // 2) and N >= {16: 832, 32: 768, 64: 512}[hd]
    else:
        assert p["G"] == G


def test_the_k3_and_k8b_f32_plan_queries_are_the_cores():
    """``attention_qkv_plan_f32`` and ``attention_batched_plan_f32`` answer
    with ``fwd90::plan_f32`` (64-row items only), the plan the mirror
    ``_fwd_plan_f32`` copies; both are in their libraries' signatures."""
    body = _c_body("attention_qkv", "attention_qkv_plan_f32")
    assert "gg::fwd90::plan_f32(W, H, N, G, hd, out)" in body
    assert "rows != gg::fwd90::kRows" in body
    # K8b's is K8a's (the same launches, so the same plan)
    assert "return attention_qtiled_plan_f32(W, N, H, hd, G, rows, out);" in (
        _c_body("attention_headmajor", "attention_batched_plan_f32"))
    for lib, fn in (("attention_qkv", "attention_qkv_plan_f32"),
                    ("attention_headmajor", "attention_batched_plan_f32")):
        assert _build.SIGNATURES[lib][fn] == _build._PLAN


# ---------------------------------------------------------------------------
# The entries, and the refusals
# ---------------------------------------------------------------------------


def test_the_k3_and_k8b_f32_entries_are_their_launches():
    """K8b-f32's body calls K8a-f32's (its two launches); K3-f32's body is
    the in-order split and the f32 kind's interleaved instance (K1's, K2's
    and K9's); every entry of both takes the `planes` scratch after the
    bias, which only the f32 ones read."""
    k8b = _c_body("attention_headmajor", "attention_batched_f32")
    assert ("return attention_qtiled_f32(q, k, v, bias, planes, out, W, H, N, "
            "hd, groups, scale, stream);") in k8b
    k3 = _c_body("attention_qkv", "attention_qkv_f32")
    assert k3.index("split_qkv<HD>(qkv, planes") < k3.index("run_f32<HD>(")
    assert "kHeadMajor" not in k3
    for lib, entry in (("attention_headmajor", "attention_batched_bf16"),
                       ("attention_headmajor", "attention_batched_q128_bf16"),
                       ("attention_qkv", "attention_qkv_bf16"),
                       ("attention_qkv", "attention_qkv_q128_bf16")):
        assert "void* /*planes*/" in _c_body(lib, entry)
        assert (_build.SIGNATURES[lib][entry]
                == _build.SIGNATURES[lib][entry.replace("_q128", "")])
    for lib, entry in (("attention_headmajor", "attention_batched_f32"),
                       ("attention_qkv", "attention_qkv_f32")):
        assert "void* planes" in _c_body(lib, entry)


def test_no_f32_entry_runs_mma_sync():
    """Every first-design attention kernel is gone: no source of the port
    holds an mma.sync instruction, and the helpers only they used left
    common.cuh."""
    for path in _build.CSRC.glob("*.cu*"):
        text = path.read_text()
        assert "mma.sync.aligned" not in text, path.name
        for gone in ("window_attention_kernel", "launch_window_attention",
                     "attention_batched_kernel", "attend_tile",
                     "batched_smem_bytes", "pack_frag", "struct Vec8",
                     "struct HeadDim"):
            assert gone not in text, (path.name, gone)


@pytest.mark.parametrize("kernel", ["K3", "K8b"])
def test_k3_and_k8b_f32_refuse_where_the_core_has_no_plan(monkeypatch,
                                                          kernel):
    """Where ``_fwd_plan_f32`` has no plan an f32 K3 or K8b call raises
    before any launch (no multiple of 64 up to 2048 reaches it at hd
    16-64, nor any N below 512)."""
    calls = _fake_card(monkeypatch)
    monkeypatch.setattr(wa, "_fwd_plan_f32", lambda *a: None)
    wa.reset_launches()
    with pytest.raises(ValueError, match=f"{kernel}'s f32 attention has no "
                                         "plan"):
        if kernel == "K3":
            wa._attention_qkv_fused_cuda(torch.zeros(8, 256, 192),
                                         torch.zeros(2, 256, 256), 0.25, 2)
        else:
            q = torch.zeros(8, 2, 256, 32)
            wa._attention_batched_cuda(q, q, q, torch.zeros(2, 256, 256),
                                       0.25)
    assert calls == [] and sum(wa.LAUNCHES.values()) == 0

"""K1's and K9's bf16 Hopper entries on the CPU: the LayerNorm + GEMM
core's plan at the shapes they give it (mirrored from the ``constexpr``s of
``csrc/ln_gemm_sm90.cuh``), K9's window map (the 5D tensor map over the
raw map, whose box coordinates are mirrored here and held against
``window_partition`` / ``window_unpartition``), which entry each call
reaches, and a torch emulation of the three launches' rounding order
against the plain versions and the JAX kernels in interpret mode.

In bf16 ``_fused_block_cuda`` (K1) and ``_fb4d_cuda`` (K9) run three
launches: the GEMM core's qkv kind (LayerNorm, ROUND_FIRST), the forward
core in its interleaved layout over ``_headmajor_groups`` window groups,
and the GEMM core's projection kind (no LayerNorm, ROUND_LAST); K9's two
GEMMs read x and write out through the window map.  The f32 twins keep the
first design.  The kernels themselves are held against the plain versions
on the card by tests/test_torch_port_cuda.py (``-k fused_block_sm90``) and
chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

from test_torch_port_mbconv_sm90 import (LNG90, SMEM_MAX, _c_body, _fake_card,
                                         _gemm_plan, _int)

#: bf16 outputs: max |got - want| over max |want|, as the card tests hold
#: the kernels (a few bf16 ulps of the output's range).
KERNEL_REL_TOL = 2e-2
#: The widths K1 and K9 give the core: C and D of TinyViT-21M's stages 1
#: (192) and 3 of the embed configuration (576), and of chip_smoke's head
#: dims 16 (128) and 64 (384).
WIDTHS = (128, 192, 384, 576)


# ---------------------------------------------------------------------------
# The GEMM core's plan
# ---------------------------------------------------------------------------


def test_the_core_takes_k_up_to_the_wrappers_limit():
    """kMaxKB 64-column boxes are LN_GEMM_MAX_K, and ``run`` has an
    instance for every box count up to it, of each kind and map."""
    src = LNG90.read_text()
    max_kb = _int(LNG90, "kMaxKB")
    assert max_kb * _int(LNG90, "kBoxK") == wa.LN_GEMM_MAX_K == 576
    cases = re.findall(r"case (\d+): return launch_kb<(\d+), KIND, MAP>", src)
    assert [(int(a), int(b)) for a, b in cases] == [(k, k) for k in range(1, max_kb)]
    assert f"default: return launch_kb<{max_kb}, KIND, MAP>" in src


@pytest.mark.parametrize("KB", range(1, 10))
def test_layer_norm_threads_cover_every_chunk_of_the_groups_rows_once(KB):
    """``layer_norm_group<KB>``: thread gt of group c takes row 64 c + gt /
    2 and the half (gt % 2) of its 8 KB 16-byte chunks; every chunk of the
    group's 64 rows once, and a warp's 32 loads of one pass step hit each
    16-byte bank column at most four times (four wavefronts, the least for
    512 bytes)."""
    half = 4 * KB
    for c in range(2):
        taken = sorted((64 * c + gt // 2, (gt % 2) * half + k)
                       for gt in range(128) for k in range(half))
        assert taken == [(64 * c + r, j) for r in range(64) for j in range(8 * KB)]
        for warp in range(4):
            for k in range(half):
                cols = [(((gt % 2) * half + k) % 8 ^ (64 * c + gt // 2)) % 8
                        for gt in range(32 * warp, 32 * warp + 32)]
                assert max(cols.count(x) for x in set(cols)) <= 4


@pytest.mark.parametrize("kind", ["qkv", "proj"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("rows", [
    (1024 * 256, None),    # K1 at stage 1 of a serving bucket of 16
    (512 * 256, None),     # K1 at stage 3 of the B=512 embed
    (5 * 64, None),        # a row count that is no multiple of 128
    (512 * 4096, (16, 64)),  # K9 at 512 images: (B, 64, 64, C), 16 x 16 windows
    (2 * 32 * 48, (16, 48)),
], ids=["k1_stage1", "k1_embed_stage3", "ragged", "k9_512", "k9_small"])
def test_gemm_plan_fits_at_every_shape_k1_and_k9_give(kind, C, D, rows):
    """The qkv GEMM (K = C, Nout = 3D, LayerNorm) and the out-projection (K
    = D, Nout = C, none) have one plan, the same for both kinds: it fits
    232,448 bytes with a ring of at least kMinSlots boxes, and takes two x
    buffers exactly where K <= 320 (five boxes)."""
    M, win = rows
    K, Nout = (C, 3 * D) if kind == "qkv" else (D, C)
    ws, Wm = win or (0, 0)
    p = _gemm_plan(M, K, Nout, ws, Wm)
    assert p is not None
    assert p["bytes"] <= SMEM_MAX and p["S"] >= _int(LNG90, "kMinSlots")
    assert p["AB"] == (2 if K <= 320 else 1)
    if K == 576:
        assert p["S"] == 6  # (232448 - 1024 - 272 - 9 x 16384 - 32768) / 8192


def test_gemm_plan_refuses_what_the_core_cannot_take():
    """K above 576 or off 64, Nout off 64, and window maps whose 128-row
    tile would straddle two windows or whose map is not whole windows."""
    assert _gemm_plan(4096, 640, 192) is None
    assert _gemm_plan(4096, 200, 192) is None
    assert _gemm_plan(4096, 192, 100) is None
    assert _gemm_plan(64 * 64, 192, 576, 8, 64) is None     # N = 64 < 128
    assert _gemm_plan(48 * 48, 192, 576, 24, 48) is None    # 24 divides no 64
    assert _gemm_plan(32 * 40, 192, 576, 16, 40) is None    # 40 / 16 not whole
    assert _gemm_plan(64 * 64, 192, 576, 32, 64) is not None
    assert _gemm_plan(64 * 64, 192, 576, 64, 64) is not None


# ---------------------------------------------------------------------------
# K9's window map
# ---------------------------------------------------------------------------


def _map5(x, ws):
    """The (B, Hm, Wm, C) map as the window map's 5D tensor, torch's order
    (outermost first): (B Hm / ws, ws rows, Wm / ws, ws columns, C)."""
    B, Hm, Wm, C = x.shape
    return x.view(B * Hm // ws, ws, Wm // ws, ws, C)


def _coords(r0, ws, nww):
    """A mirror of ``WinCoords``: the window map's (c1, c2, c3, c4) of the
    box whose first row is window-ordered row r0."""
    N = ws * ws
    w = r0 // N
    return 0, w % nww, (r0 - w * N) // ws, w // nww


def _box(x5, c0, coords, box_rows):
    """The box at (c0, coords) of boxes (64, ws, 1, box_rows / ws, 1): its
    rows in shared memory, box_rows x 64."""
    _, c2, c3, c4 = coords
    ws = x5.shape[3]
    return x5[c4, c3:c3 + box_rows // ws, c2, :, c0:c0 + 64].reshape(box_rows, 64)


@pytest.mark.parametrize("shape,ws", [((2, 32, 48, 64), 16),
                                      ((1, 64, 96, 128), 32),
                                      ((2, 64, 64, 192), 16)])
def test_window_map_boxes_read_and_write_window_order(shape, ws):
    """The qkv GEMM's 128-row boxes of x, k-box by k-box, are the rows of
    ``window_partition``; the out-projection's 64-row boxes, stored at the
    same coordinates, make ``window_unpartition`` of the window-ordered
    rows.  The view's strides are the map's (C, ws C, Wm C, ws Wm C)."""
    B, Hm, Wm, C = shape
    x = torch.arange(B * Hm * Wm * C, dtype=torch.float64).reshape(shape)
    x5 = _map5(x, ws)
    assert x5.stride()[::-1] == (1, C, ws * C, Wm * C, ws * Wm * C)
    M, nww = B * Hm * Wm, Wm // ws
    rows = torch.cat([
        torch.cat([_box(x5, c0, _coords(t * 128, ws, nww), 128)
                   for c0 in range(0, C, 64)], dim=1)
        for t in range(M // 128)])
    want = wa.window_partition(x, ws).reshape(M, C)
    assert torch.equal(rows, want)

    y = torch.randn(M, C, dtype=torch.float64)
    out = torch.full(shape, float("nan"), dtype=torch.float64)
    out5 = _map5(out, ws)
    for r0 in range(0, M, 64):
        _, c2, c3, c4 = _coords(r0, ws, nww)
        for c0 in range(0, C, 64):
            out5[c4, c3:c3 + 64 // ws, c2, :, c0:c0 + 64] = \
                y[r0:r0 + 64, c0:c0 + 64].reshape(64 // ws, ws, 64)
    assert torch.equal(out, wa.window_unpartition(
        y.reshape(-1, ws * ws, C), ws, (Hm, Wm)))


def test_window_map_encoding_matches_the_mirror():
    """``encode_window_map`` names the dims, strides (bytes of bf16) and
    box the mirror above uses, with the 128-byte swizzle of a 2D box."""
    src = LNG90.read_text()
    body = re.search(r"cudaError_t encode_window_map\(.*?\n\}", src, re.S).group(0)
    squashed = re.sub(r"\s+", " ", body)
    for piece in ("(cuuint64_t)C, (cuuint64_t)ws, (cuuint64_t)(Wm / ws), "
                  "(cuuint64_t)ws, (cuuint64_t)(M / (ws * Wm))",
                  "(cuuint64_t)(C * 2), (cuuint64_t)(ws * C * 2), "
                  "(cuuint64_t)(Wm * C * 2), (cuuint64_t)(ws * Wm * C * 2)",
                  "{64, (cuuint32_t)ws, 1, (cuuint32_t)(box_rows / ws), 1}",
                  "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert piece in squashed, piece
    assert "cp.async.bulk.tensor.5d.shared::cluster.global" in src
    assert "cp.async.bulk.tensor.5d.global.shared::cta" in src


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _k1_args(W, N, C, D, H, dtype):
    return (torch.zeros(W, N, C, dtype=dtype), torch.ones(C), torch.zeros(C),
            torch.zeros(C, 3 * D), torch.zeros(3 * D), torch.zeros(D, C),
            torch.zeros(C), torch.zeros(H, N, N))


def _watch_layout(monkeypatch):
    checked = []
    real = wa._qkv_layout
    monkeypatch.setattr(wa, "_qkv_layout",
                        lambda *a: checked.append(a) or real(*a))
    return checked


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("W,N,C,H", [(1024, 256, 192, 6), (64, 256, 576, 18)],
                         ids=["stage1", "embed_stage3"])
def test_k1_routes_bf16_to_the_hopper_cores_with_the_groups(monkeypatch,
                                                             dtype, W, N, C, H):
    """A bf16 call reaches ``fused_block_bf16`` after ``_qkv_layout`` of its
    (W, N, 3D) qkv scratch, with G = ``_headmajor_groups`` (42 at stage 1
    of a serving bucket of 16, 14 at the embed stage 3 of 64 windows); its
    body runs the GEMM core's qkv kind, the forward core in its interleaved
    layout and the core's projection kind.  An f32 call reaches the twin
    (G = 1, ignored), whose body runs common.cuh's first design.  One K1
    launch either way; the arguments after the pointers are (W, N, C, H,
    hd, G, scale, eps, stream)."""
    calls = _fake_card(monkeypatch, wa)
    checked = _watch_layout(monkeypatch)
    wa.reset_launches()
    out = wa._fused_block_cuda(*_k1_args(W, N, C, C, H, dtype), 0.25, H, 1e-5)
    assert out.shape == (W, N, C) and out.dtype == dtype
    assert wa.LAUNCHES["_fused_block_cuda"] == 1 and sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    tail = tail[3:]  # _fake_card keeps what follows K2's eight pointers
    assert (lib, entry) == ("fused_block", f"fused_block_{suffix}")
    groups = wa._headmajor_groups(W, H, N) if suffix == "bf16" else 1
    assert tail[:6] == (W, N, C, H, C // H, groups) and tail[6] == 0.25
    assert len(checked) == (suffix == "bf16")
    if checked:
        assert groups == {1024: 42, 64: 14}[W]
        qkv, bias, _ = checked[0]
        assert tuple(qkv[0]) == (W, N, 3 * C) and tuple(bias[0]) == (H, N, N)
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "gg::lng90::run<kQkvGemm, false>(" in body
        assert ("run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, "
                "qkv_scratch, bias, attn_scratch") in body
        assert "gg::lng90::run<kProjGemm, false>(attn_scratch, nullptr, nullptr" in body
        assert "launch_ln_gemm" not in body and "launch_window_attention" not in body
    else:
        assert "lng90" not in body and "fwd90" not in body
        assert "launch_ln_gemm<true, true>(" in body
        assert "launch_window_attention(" in body
        assert "launch_ln_gemm<false, false>(" in body


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k9_routes_bf16_to_the_window_map_with_k1s_groups(monkeypatch, dtype):
    """A bf16 K9 call at 4 images of stage 1 (W = 64 windows) reaches
    ``fb4d_bf16`` with the same qkv scratch, layout check and G as K1 at
    the same windows; its body runs K1's three launches with the GEMMs'
    window map (MAP, the window side and the map's width).  An f32 call
    reaches the twin, whose body runs the first design over MapRows.  The
    arguments after the pointers are (B, Hm, Wm, C, H, hd, window, G,
    scale, eps, stream)."""
    calls = _fake_card(monkeypatch, wa)
    checked = _watch_layout(monkeypatch)
    B, Hm, Wm, C, H = 4, 64, 64, 192, 6
    args = list(_k1_args(B * 16, 256, C, C, H, dtype))
    args[0] = torch.zeros(B, Hm, Wm, C, dtype=dtype)
    wa.reset_launches()
    out = wa._fb4d_cuda(*args, 0.25, H, 16, 1e-5)
    assert out.shape == (B, Hm, Wm, C) and out.dtype == dtype
    assert wa.LAUNCHES["_fb4d_cuda"] == 1 and sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    tail = tail[3:]  # _fake_card keeps what follows K2's eight pointers
    assert (lib, entry) == ("fb4d", f"fb4d_{suffix}")
    groups = wa._headmajor_groups(64, H, 256) if suffix == "bf16" else 1
    assert tail[:8] == (B, Hm, Wm, C, H, 32, 16, groups) and tail[8] == 0.25
    assert len(checked) == (suffix == "bf16")
    if checked:
        assert tuple(checked[0][0][0]) == (64, 256, 3 * C)  # K1's scratch
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "gg::lng90::run<kQkvGemm, true>(" in body
        assert "gg::lng90::run<kProjGemm, true>(attn_scratch" in body
        assert body.count("window, Wm)") == 2
        assert ("run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, "
                "qkv_scratch, bias, attn_scratch") in body
        assert "MapRows" not in body and "launch_ln_gemm" not in body
    else:
        assert "lng90" not in body and "fwd90" not in body
        assert "gg::MapRows rows" in body and "launch_window_attention(" in body


@pytest.mark.parametrize("kernel,shape,match", [
    ("K1", (1, 1088, 64, 64, 2), "K1 takes N up to"),
    ("K1", (2, 256, 640, 64, 2), "K1 takes N up to"),
    ("K1", (2, 256, 64, 640, 10), "K1 takes N up to"),
    ("K9", (8, 64, 64, 64, 2), "K9 takes a window side"),
    ("K9", (24, 48, 48, 64, 2), "K9 takes a window side"),
    ("K9", (16, 32, 32, 640, 10), "K9 takes N up to"),
])
def test_k1_and_k9_refuse_what_their_bf16_entries_cannot_plan(
        monkeypatch, kernel, shape, match):
    """N above FB_S2_MAX_N, C or D above LN_GEMM_MAX_K, and for K9 a window
    side whose 128-row tiles straddle windows (8) or divides no 64 (24)
    raise ValueError in bf16 before any launch; the f32 twin takes each."""
    calls = _fake_card(monkeypatch, wa)
    for dtype in (torch.bfloat16, torch.float32):
        if kernel == "K1":
            W, N, C, D, H = shape
            args = (*_k1_args(W, N, C, D, H, dtype), 0.25, H, 1e-5)
            fn = wa._fused_block_cuda
        else:
            ws, Hm, Wm, C, H = shape
            a = list(_k1_args(1, ws * ws, C, C, H, dtype))
            a[0] = torch.zeros(1, Hm, Wm, C, dtype=dtype)
            args, fn = (*a, 0.25, H, ws, 1e-5), wa._fb4d_cuda
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match=match):
                fn(*args)
            assert not calls
        else:
            fn(*args)
    assert [c[1] for c in calls] == [
        "fused_block_f32" if kernel == "K1" else "fb4d_f32"]


# ---------------------------------------------------------------------------
# The three launches' arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate_k1(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                scale, H, eps):
    """The bf16 entry's rounding order: the LayerNorm's f32 statistics (two
    passes) and its output rounded; the qkv GEMM summed in f32, rounded,
    plus the bf16 b_qkv, rounded (ROUND_FIRST); f32 scores plus the bf16
    bias, the whole-row softmax in f32 (N <= 256), p normalised and then
    rounded, p.v in f32, rounded; the out-projection summed in f32 plus the
    f32 b_proj, rounded once (ROUND_LAST)."""
    W, N, C = x.shape
    D = w_proj.shape[0]
    hd = D // H
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    ln = _bf((xf - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias)
    qkv = _bf(_bf(ln @ _bf(w_qkv)) + _bf(b_qkv))
    q, k, v = qkv.reshape(W, N, H, 3 * hd).split(hd, dim=-1)
    s = torch.einsum("wnhd,wmhd->whnm", q, k) * scale + _bf(bias)[None]
    p = _bf(torch.softmax(s, dim=-1))
    o = _bf(torch.einsum("whnm,wmhd->wnhd", p, v).reshape(W, N, D))
    return _bf(o @ _bf(w_proj) + b_proj)


def _case(seed, W, N, C, H):
    rng = np.random.default_rng(seed)

    def n(*shape, mean=0.0, std=1.0):
        return rng.normal(mean, std, shape).astype(np.float32)

    return [n(W, N, C), n(C, mean=1.0, std=0.1), n(C, std=0.1),
            n(C, 3 * C, std=C ** -0.5), n(3 * C, std=0.1),
            n(C, C, std=C ** -0.5), n(C, std=0.1), n(H, N, N, std=0.5)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _torch_args(case):
    x, *rest = map(torch.from_numpy, case)
    return [x.to(torch.bfloat16), *rest]


def _jax_args(case):
    x, *rest = map(jnp.asarray, case)
    return [x.astype(jnp.bfloat16), *rest]


@pytest.mark.parametrize("W,N,C,H", [(4, 256, 64, 2), (2, 256, 128, 8)],
                         ids=["hd32", "hd16"])
def test_k1_emulation_matches_plain_and_the_jax_kernel(W, N, C, H):
    """On seeded bf16 inputs (a few windows of N = 256, narrow widths) the
    emulation of the three launches against ``_fused_block_plain`` and the
    JAX ``_fused_block_pallas`` in interpret mode, within the card tests'
    2e-2 of the output's range (a few bf16 ulps)."""
    case = _case(3, W, N, C, H)
    scale = (C // H) ** -0.5
    targs = _torch_args(case)
    got = _emulate_k1(*targs, scale, H, 1e-5)
    plain = wa._fused_block_plain(*targs, scale, H, 1e-5).float()
    want = jwa._fused_block_pallas(*_jax_args(case), scale, H, 1e-5,
                                   block_w=2, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == plain.shape == want.shape == (W, N, C)
    assert _rel(got, plain) < KERNEL_REL_TOL
    assert _rel(got, want) < KERNEL_REL_TOL
    assert _rel(plain, want) < KERNEL_REL_TOL


def test_k9_emulation_through_the_window_map_matches_k1_and_the_jax_kernel():
    """K9's rows in, through the window map's boxes, and its output out
    through them, around K1's emulation: bitwise K1's emulation on the
    partitioned map (the rows K9's launches see are K1's), and within
    2e-2 of ``_fb4d_plain`` and the JAX ``_fb4d_pallas`` in interpret mode
    on a (1, 32, 32, 64) map of 16 x 16 windows."""
    B, Hm, Wm, C, H, ws = 1, 32, 32, 64, 2, 16
    case = _case(4, B * Hm * Wm // 256, 256, C, H)
    case[0] = case[0].reshape(B, Hm, Wm, C)
    scale = (C // H) ** -0.5
    targs = _torch_args(case)
    x = targs[0]
    M, nww = B * Hm * Wm, Wm // ws
    x5 = _map5(x, ws)
    rows = torch.cat([
        torch.cat([_box(x5, c0, _coords(t * 128, ws, nww), 128)
                   for c0 in range(0, C, 64)], dim=1)
        for t in range(M // 128)])
    y = _emulate_k1(rows.reshape(-1, 256, C), *targs[1:], scale, H, 1e-5)
    got = torch.empty(B, Hm, Wm, C)
    got5 = _map5(got, ws)
    flat = y.reshape(M, C)
    for r0 in range(0, M, 64):
        _, c2, c3, c4 = _coords(r0, ws, nww)
        got5[c4, c3:c3 + 64 // ws, c2] = flat[r0:r0 + 64].reshape(64 // ws, ws, C)
    k1 = wa.window_unpartition(
        _emulate_k1(wa.window_partition(x, ws), *targs[1:], scale, H, 1e-5),
        ws, (Hm, Wm))
    assert torch.equal(got, k1)
    plain = wa._fb4d_plain(*targs, scale, H, ws, 1e-5).float()
    want = jwa._fb4d_pallas(*_jax_args(case), scale, H, 1e-5, ws,
                            interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == plain.shape == want.shape == (B, Hm, Wm, C)
    assert _rel(got, plain) < KERNEL_REL_TOL
    assert _rel(got, want) < KERNEL_REL_TOL


def test_the_gemm_core_ablations_still_apply():
    """Every edit of scripts/ln_gemm_variants.py finds its anchor in the
    header, so the ablations the PERF numbers come from still build."""
    import importlib.util

    path = _build.CSRC.parents[2] / "scripts" / "ln_gemm_variants.py"
    spec = importlib.util.spec_from_file_location("ln_gemm_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    header = LNG90.read_text()
    assert module.VARIANTS
    for name, edits in module.VARIANTS.items():
        for old, _ in edits:
            assert old in header, name

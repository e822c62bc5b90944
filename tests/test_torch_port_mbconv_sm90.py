"""K10's and K2's bf16 Hopper entries on the CPU: the shared-memory layouts
of ``csrc/mbconv_sm90.cuh`` and ``csrc/ln_gemm_sm90.cuh`` (mirrored from
their ``constexpr``s), K10's tile schedule, which entry each call reaches,
and a torch emulation of K10's rounding order with the kernel's GELU
against the plain version and the JAX kernel in interpret mode.

In bf16 ``_mbconv_cuda`` (K10) launches a kernel of persistent blocks over
16 x 16 output tiles whose two consumer warpgroups each take 8 rows, and
``_fb_s2_cuda`` (K2) runs the LayerNorm + GEMM core and then the forward
core as K3 does.  The f32 twins keep the first designs.  The experimental
K12a / K12b run K10's kernel in its PLAIN kind (plain biases, f32 taps,
only GELU's outputs rounded): their routing, their shape checks and a
torch emulation of that rounding order against the plain version and the
JAX kernels in interpret mode are here too.  The kernels themselves are
held against the plain versions on the card by
tests/test_torch_port_cuda.py (``-k "mbconv_sm90 or fb_s2 or
fused_mbconv_exp"``) and chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import mbconv as jmb

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import mbconv as tmb
from geoguessr_ai_torch.ops import window_attention as wa
from geoguessr_ai_torch.ops.experimental import fused_mbconv as tfm

MB90 = _build.CSRC / "mbconv_sm90.cuh"
LNG90 = _build.CSRC / "ln_gemm_sm90.cuh"
SMEM_MAX = 232448
#: bf16 outputs: max |got - want| over max |want|, as the card tests hold
#: the kernels (a few bf16 ulps of the output's range).
KERNEL_REL_TOL = 2e-2


def _int(path, name):
    m = re.search(r"constexpr int " + name + r" = (\d+);", path.read_text())
    assert m, name
    return int(m.group(1))


def _mb_layout(C):
    """A mirror of ``mbconv_sm90.cuh``'s Layout<C>: the halo (its rows of C
    channels: a 64-channel box, then one of 32), the ring of E-chunks (w1
    rows, w3 columns, taps, BN pairs, each slot rounded up to 1024 bytes),
    the two groups' expanded chunks and the mbarriers, from a 1024-aligned
    base."""
    rows = _int(MB90, "kGroupRows") * (_int(MB90, "kTile") + 2) + _int(MB90, "kExpandRows")
    ec, pitch, max_slots = _int(MB90, "kEc"), _int(MB90, "kHPitch"), _int(MB90, "kMaxSlots")
    group_halo = (_int(MB90, "kGroupRows") + 2) * (_int(MB90, "kTile") + 2)
    halo = rows * 2 * C
    slot_tx = ec * 2 * C + C * 128 + 9 * ec * 4 + 2 * 2 * ec * 4
    slot = -(-slot_tx // 1024) * 1024
    fixed = halo + 2 * group_halo * pitch * 2
    S = min((_int(MB90, "kSmemMax") - 1024 - fixed - 8 * (2 + 2 * max_slots)) // slot,
            max_slots)
    return dict(S=S, slot=slot, slot_tx=slot_tx, halo_rows=rows,
                bytes=1024 + fixed + S * slot + 8 * (2 + 2 * S))


def test_the_layout_mirror_reads_the_header():
    assert _int(MB90, "kSmemMax") == SMEM_MAX
    assert (_int(MB90, "kTile"), _int(MB90, "kGroupRows"), _int(MB90, "kEc"),
            _int(MB90, "kExpandRows")) == (16, 8, 64, 192)
    # a group's 180 halo pixels in three 64-row wgmma tiles; group 1's
    # tiles start at halo pixel 144 and end inside the halo buffer
    assert _mb_layout(96)["halo_rows"] == 144 + 192
    assert tmb.E_CHUNK == _int(MB90, "kEc")


@pytest.mark.parametrize("C", [32, 64, 96])
def test_k10_shared_memory_fits_at_every_channel_count(C):
    """Layout<C> fits the 232,448 bytes a block may opt in to, with a ring
    of at least two E-chunks (four at TinyViT's C = 96); every TMA
    destination that needs it is 1024-aligned (the halo boxes and the
    slots: 128- and 64-byte swizzles)."""
    lay = _mb_layout(C)
    assert lay["bytes"] <= SMEM_MAX
    assert lay["S"] >= 2
    assert lay["slot"] % 1024 == 0 and lay["halo_rows"] * 2 * C % 1024 == 0
    assert {32: 8, 64: 6, 96: 4}[C] == lay["S"]
    assert C in tmb.KERNEL_CHANNELS


def _tiles(H, W):
    t = _int(MB90, "kTile")
    return -(-H // t), -(-W // t)


@pytest.mark.parametrize("B,H,W", [(1, 112, 112), (2, 128, 128), (3, 7, 9),
                                   (1, 17, 33)])
def test_k10_schedule_covers_every_output_pixel_once(B, H, W):
    """Tiles are image-major, the column tile fastest; group c of a tile
    takes rows [8 c, 8 c + 8), and thread (warp w, lane 4 g + cc) the 2 x 2
    pixels (2 w + mt, 2 g + j), row 16 w + g + 8 j of the project GEMM's
    m-tile mt.  Over every tile of a ragged map each pixel is written once
    (pixels past the map's edge are not stored); each thread's 4 x 4
    neighbourhood of the expanded chunk lies inside its group's 10 x 18
    halo pixels, which the group's three 64-row tiles cover."""
    ty, tx = _tiles(H, W)
    seen = np.zeros((B, H, W), np.int64)
    for t in range(B * ty * tx):
        x0, rest = (t % tx) * 16, t // tx
        y0, b = (rest % ty) * 16, rest // ty
        for c in range(2):
            for w in range(4):
                for g in range(8):
                    assert (2 * w + 3) < 10 and (2 * g + 3) < 18
                    for mt in range(2):
                        for j in range(2):
                            py, px = y0 + 8 * c + 2 * w + mt, x0 + 2 * g + j
                            if py < H and px < W:
                                seen[b, py, px] += 1
    assert (seen == 1).all()
    assert 3 * 64 >= (_int(MB90, "kGroupRows") + 2) * 18


def _fake_card(monkeypatch, module):
    """The wrappers run here up to their launch: ``_check`` keeps its
    dtype, shape, contiguity and alignment rules but not the device one,
    and each C entry is replaced by a recorder of its arguments after the
    tensor pointers."""
    calls = []

    def host_check(name, t, shape, dtype=torch.bfloat16):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
        return t

    def fake_entry(lib, name):
        def launch(*args):
            calls.append((lib, name, args[8:]))
            return 0
        return launch

    monkeypatch.setattr(module, "_check", host_check)
    monkeypatch.setattr(wa, "_check", host_check)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(module, "_stream", lambda: 0)
    return calls


def _c_body(lib, entry):
    m = re.search(r'extern "C" int ' + entry + r"\(.*?\n\}",
                  (_build.CSRC / f"{lib}.cu").read_text(), re.S)
    assert m, entry
    return m.group(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k10_routes_bf16_to_the_hopper_kernel_and_f32_to_the_twin(
        monkeypatch, dtype):
    """A bf16 call reaches ``mbconv_bf16``, whose body runs mb90::run for
    each channel count; an f32 call the twin, whose body runs the first
    design (mb::run).  One K10 launch either way; the arguments after the
    pointers are (B, H, W, C, E, exact, stream)."""
    calls = _fake_card(monkeypatch, tmb)
    B, H, W, C, E = 2, 20, 24, 32, 128
    x = torch.zeros(B, H, W, C, dtype=dtype)
    args = (x, torch.zeros(C, E), torch.ones(E), torch.zeros(E),
            torch.zeros(3, 3, E), torch.ones(E), torch.zeros(E),
            torch.zeros(E, C), torch.ones(C), torch.zeros(C))
    tmb.reset_launches()
    out = tmb._mbconv_cuda(*args, False)
    assert out.shape == x.shape and out.dtype == dtype
    assert tmb.LAUNCHES["_mbconv_cuda"] == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("mbconv", f"mbconv_{suffix}")
    assert tail == (B, H, W, C, E, 0, 0)
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert all(f"gg::mb90::run<{c}>(" in body for c in (32, 64, 96))
        assert "gg::mb::" not in body
    else:
        assert "gg::mb::run<float>(" in body and "mb90" not in body


def _entry_body(src, entry):
    """An extern "C" entry's parameters and body with its whitespace
    collapsed."""
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\n\}", src, re.S)
    assert m, entry
    return " ".join(m.group(1).split())


def test_k12_entries_run_the_plain_kind_of_the_hopper_kernel():
    """K12a and K12b include K10's Hopper kernel and not the first design;
    their two entries differ only in the grid (K12a a block a tile, K12b
    persistent blocks), each channel count running the PLAIN kind with the
    tanh GELU; the first design's header has no K12 path left and its
    pipelined kernel is gone."""
    exp = (_build.CSRC / "fused_mbconv_exp.cu").read_text()
    assert '#include "mbconv_sm90.cuh"' in exp
    assert '#include "mbconv.cuh"' not in exp
    a = _entry_body(exp, "fused_mbconv_bf16")
    b = _entry_body(exp, "fused_mbconv_v2_bf16")
    assert a.endswith("W, C, E, true, stream);")
    assert b.endswith("W, C, E, false, stream);")
    assert a[:-len("true, stream);")] == b[:-len("false, stream);")]
    for c in (32, 64, 96):
        assert re.search(r"gg::mb90::run<%d, true>\(.*?, false,\s+s, one_tile_a_block\)" % c,
                         exp, re.S), c
    old = (_build.CSRC / "mbconv.cuh").read_text()
    assert "PLAIN" not in old and "round_unless" not in old
    assert not any("mbconv_pipelined_kernel" in f.read_text()
                   for f in _build.CSRC.iterdir())
    mb90 = MB90.read_text()
    assert "template <int C, bool EXACT, bool PLAIN>\n__global__" in mb90
    assert "return launch<C, false, true>(" in mb90
    k10 = (_build.CSRC / "mbconv.cu").read_text()
    assert '#include "mbconv.cuh"' in k10 and '#include "mbconv_sm90.cuh"' in k10


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k2_routes_bf16_to_the_hopper_cores_with_the_groups(monkeypatch,
                                                             dtype):
    """A bf16 call reaches ``fb_s2_bf16`` after ``_qkv_layout`` of its qkv
    scratch with G = ``_headmajor_groups`` (stage 2 of bucket 16: W=64,
    H=12, N=1024), whose body runs the LayerNorm + GEMM core and then the
    forward core in its interleaved layout; an f32 call the twin (G = 1,
    ignored), whose body runs common.cuh's first design.  One K2 launch
    either way; the arguments after the pointers are (W, N, C, H, hd, G,
    scale, eps, stream)."""
    calls = _fake_card(monkeypatch, wa)
    checked = []
    real = wa._qkv_layout
    monkeypatch.setattr(wa, "_qkv_layout",
                        lambda *a: checked.append(a) or real(*a))
    W, N, C, H = 64, 1024, 384, 12
    x = torch.zeros(W, N, C, dtype=dtype)
    wa.reset_launches()
    out = wa._fb_s2_cuda(x, torch.ones(C), torch.zeros(C),
                         torch.zeros(C, 3 * C), torch.zeros(3 * C),
                         torch.zeros(H, N, N), 0.25, H, 1e-5)
    assert out.shape == (W, N, C) and out.dtype == dtype
    assert wa.LAUNCHES["_fb_s2_cuda"] == 1 and sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("fb_s2", f"fb_s2_{suffix}")
    groups = wa._headmajor_groups(W, H, N) if suffix == "bf16" else 1
    assert tail[:6] == (W, N, C, H, C // H, groups) and tail[6] == 0.25
    assert len(checked) == (suffix == "bf16")
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "gg::lng90::run<kQkvGemm, false>(" in body
        assert "run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, qkv_scratch" in body
    else:
        assert "lng90" not in body and "fwd90" not in body
        assert "launch_ln_gemm<true, true>(" in body and "launch_window_attention(" in body


def test_k2_refuses_what_its_bf16_entry_cannot_plan(monkeypatch):
    """N above FB_S2_MAX_N or C above FB_S2_MAX_C raises ValueError in bf16
    before any launch; the f32 twin takes both."""
    calls = _fake_card(monkeypatch, wa)
    for N, C, H in ((1088, 64, 2), (64, 512, 8)):
        for dtype, refused in ((torch.bfloat16, True), (torch.float32, False)):
            args = (torch.zeros(1, N, C, dtype=dtype), torch.ones(C),
                    torch.zeros(C), torch.zeros(C, 3 * C), torch.zeros(3 * C),
                    torch.zeros(H, N, N), 0.25, H, 1e-5)
            if refused:
                with pytest.raises(ValueError, match="K2 takes N up to"):
                    wa._fb_s2_cuda(*args)
            else:
                wa._fb_s2_cuda(*args)
    assert [c[1] for c in calls] == ["fb_s2_f32", "fb_s2_f32"]


def _gemm_plan(M, K, Nout, ws=0, Wm=0):
    """A mirror of ``ln_gemm_sm90.cuh``'s make_plan: AB 128-row x tiles
    (two where they leave a ring of kMinSlots, else one), the four 64 x 64
    output staging tiles and a ring of 64-column B boxes that holds two
    k-boxes of both tiles of a step (at least kMinSlots), K a multiple of
    64 up to the kernel's instances (kMaxKB boxes); a window map (ws > 0)
    takes ws dividing 64 with ws * ws a multiple of 128 over a map of whole
    windows."""
    rows, cols, box_k = _int(LNG90, "kRows"), _int(LNG90, "kCols"), _int(LNG90, "kBoxK")
    max_slots, smem = _int(LNG90, "kMaxSlots"), _int(LNG90, "kSmemMax")
    min_slots, max_kb = _int(LNG90, "kMinSlots"), _int(LNG90, "kMaxKB")
    if K % box_k or K > max_kb * box_k or Nout % cols or M < 1:
        return None
    if ws and (64 % ws or ws * ws % rows or Wm % ws or M % (ws * Wm)):
        return None
    KB, box_a, box_b = K // box_k, rows * 128, cols * 128
    stage = 4 * box_b

    def slots(AB):
        return min((smem - 1024 - 8 * (2 * AB + 2 * max_slots)
                    - AB * KB * box_a - stage) // box_b, max_slots)

    AB = 2 if slots(2) >= min_slots else 1
    S = slots(AB)
    if S < min_slots:
        return None
    return dict(S=S, AB=AB, tiles=-(-M // rows), ncol=Nout // cols,
                bytes=1024 + AB * KB * box_a + stage + S * box_b
                + 8 * (2 * AB + 2 * S))


@pytest.mark.parametrize("M,K,Nout", [(65536, 384, 1152), (524288, 384, 1152),
                                      (16384, 128, 384), (4096, 384, 1152),
                                      (448, 192, 576), (64, 448, 1344)])
def test_k2_gemm_plan_fits_at_the_shapes_it_is_given(M, K, Nout):
    """Stage 2 of a serving bucket of 16 and of the B=512 embed, head dims
    16 (C=128, H=8) and 64 (C=384, H=6), a row count that is no multiple of
    128, and the largest C the wrapper takes: each plan fits 232,448 bytes
    with a ring of at least four boxes."""
    p = _gemm_plan(M, K, Nout)
    assert p is not None and p["bytes"] <= SMEM_MAX and p["S"] >= 4
    assert _int(LNG90, "kSmemMax") == SMEM_MAX


def test_k2_gemm_takes_every_c_up_to_the_wrappers_limit():
    """The GEMM core plans every C (a multiple of 64) up to LN_GEMM_MAX_K
    and none above, so every C up to FB_S2_MAX_C, the limit K2's wrapper
    enforces in bf16."""
    ok = [K for K in range(64, 1025, 64) if _gemm_plan(1024, K, 3 * K)]
    assert ok == list(range(64, wa.LN_GEMM_MAX_K + 1, 64))
    assert wa.FB_S2_MAX_C in ok


@pytest.mark.parametrize("name,ns", [("mbconv_sm90.cuh", "mb90"),
                                     ("ln_gemm_sm90.cuh", "lng90")])
def test_the_new_headers_have_internal_linkage(name, ns):
    """Everything in the two headers sits in an unnamed namespace, so each
    library keeps its own launchers and opt-in flags (no GNU-unique
    symbol); both are Hopper code (TMA, wgmma, mbarriers)."""
    src = (_build.CSRC / name).read_text()
    assert f"namespace gg {{\nnamespace {ns} {{\nnamespace {{\n" in src
    assert f"}}  // namespace\n}}  // namespace {ns}\n}}  // namespace gg" in src
    for piece in ("cp.async.bulk.tensor", "wgmma", "mbar_", "tma_load"):
        assert piece in src, piece


# ---------------------------------------------------------------------------
# K10's arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _gelu_kernel(x, exact):
    """The kernel's GELU on f32 x: 0.5 x (1 + tanh(u)), u = x (0.79788 +
    0.035677 x^2) (tanh.approx on the card; torch's tanh here), or the erf
    form."""
    if exact:
        return 0.5 * x * (1 + torch.erf(x * 0.7071067811865476))
    u = x * (0.0356774081363001 * x * x + 0.7978845608028654)
    return 0.5 * x + 0.5 * x * torch.tanh(u)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate_k10(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, exact):
    """K10's rounding order on bf16 x: the expand summed in f32, BN1 in
    f32, rounded, GELU, rounded, zero where the halo pixel is padding; the
    depthwise MACs in f32 over bf16 taps in (di, dj) order, BN2, rounded,
    GELU, rounded; the project in f32, BN3, rounded; the residual rounded
    before the last GELU."""
    B, H, W, C = x.shape
    E = w1.shape[1]
    xf = x.float()
    h = _bf(_gelu_kernel(_bf(xf @ _bf(w1) * s1 + b1), exact))
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))  # the mask after the expand
    taps = _bf(w2.reshape(9, E))
    acc = torch.zeros(B, H, W, E)
    for di in range(3):
        for dj in range(3):
            acc = acc + hp[:, di:di + H, dj:dj + W] * taps[3 * di + dj]
    y = _bf(_gelu_kernel(_bf(acc * s2 + b2), exact))
    p = _bf(y @ _bf(w3) * s3 + b3)
    return _bf(_gelu_kernel(_bf(xf + p), exact))


def _k10_case(seed, B=1, H=12, W=10, C=32, E=64):
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return rng.normal(0, std, shape).astype(np.float32)

    bns = [(rng.uniform(0.5, 1.5, d).astype(np.float32), n(d, std=0.1),
            n(d, std=0.1), rng.uniform(0.5, 2.0, d).astype(np.float32))
           for d in (E, E, C)]
    return n(B, H, W, C), n(C, E, std=C ** -0.5), n(3, 3, E, std=1 / 3), \
        n(E, C, std=E ** -0.5), bns


@pytest.mark.parametrize("exact", [False, True])
def test_k10_emulation_matches_plain_and_the_jax_kernel(exact):
    """On one seeded bf16 input (a 12 x 10 map: a ragged edge, C = 32, E =
    64) the emulation of the kernel's rounding order with its GELU form
    against ``_mbconv_plain`` and the JAX ``_mbconv_pallas`` in interpret
    mode (which rounds each GEMM output to bf16 before BN), within the card
    tests' 2e-2 of the output's range (a few bf16 ulps)."""
    x, w1, w2, w3, bns = _k10_case(5)
    tfold = [tmb.fold_bn(*map(torch.from_numpy, bn)) for bn in bns]
    targs = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w1),
             *tfold[0], torch.from_numpy(w2), *tfold[1], torch.from_numpy(w3),
             *tfold[2])
    got = _emulate_k10(*targs, exact)
    plain = tmb._mbconv_plain(*targs, exact).float()
    jfold = [jmb.fold_bn(*map(jnp.asarray, bn)) for bn in bns]
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), *jfold[0],
             jnp.asarray(w2), *jfold[1], jnp.asarray(w3), *jfold[2])
    want = jmb._mbconv_pallas(*jargs, exact=exact, interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert got.shape == plain.shape == want.shape == x.shape
    assert rel(got, plain) < KERNEL_REL_TOL
    assert rel(got, want) < KERNEL_REL_TOL
    assert rel(plain, want) < KERNEL_REL_TOL


def test_k10_gelu_form_is_torchs_tanh_gelu():
    """0.5 x (1 + tanh(u)) with u folded as x (k0 + k1 x^2) is torch's tanh
    GELU in f32 (to f32 rounding): the kernel changes the instruction, not
    the function."""
    x = torch.linspace(-8, 8, 4001)
    want = torch.nn.functional.gelu(x, approximate="tanh")
    assert float((_gelu_kernel(x, False) - want).abs().max()) < 1e-5
    want = torch.nn.functional.gelu(x, approximate="none")
    assert float((_gelu_kernel(x, True) - want).abs().max()) < 1e-5


@pytest.mark.parametrize("kernel_name,group", [
    ("void gg::lng90::(anonymous namespace)::ln_gemm_sm90<6, 0, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, "
     "float const*, gg::lng90::(anonymous namespace)::Plan, float)",
     "LN+GEMM (K1/K2/K9 CUDA)"),
    # K1's and K9's: the qkv kind through the window map, the projection
    # kind at the embed stage 3's D = 576
    ("void gg::lng90::(anonymous namespace)::ln_gemm_sm90<3, 0, true>("
     "CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, "
     "float const*, gg::lng90::(anonymous namespace)::Plan, float)",
     "LN+GEMM (K1/K2/K9 CUDA)"),
    ("void gg::lng90::(anonymous namespace)::ln_gemm_sm90<9, 1, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, "
     "float const*, gg::lng90::(anonymous namespace)::Plan, float)",
     "LN+GEMM (K1/K2/K9 CUDA)"),
    # the first design's GEMM, which only the f32 twins run
    ("void gg::(anonymous namespace)::ln_gemm_kernel<float, false, false>("
     "float const*, float const*, float const*, float const*, float const*, "
     "float*, int, int, int, float)", "LN+GEMM (f32 K1/K2/K9 CUDA)"),
    ("void gg::mb90::(anonymous namespace)::mbconv_sm90<96, false, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16 const*, float "
     "const*, __nv_bfloat16*, gg::mb90::(anonymous namespace)::Tiles, int, "
     "int)", "fused MBConv (K10 CUDA)"),
])
def test_profile_groups_name_the_new_kernels(kernel_name, group):
    """``profile_forward`` puts the GEMM core (both kinds: K1's and K9's qkv
    GEMM and out-projection, K2's qkv GEMM) and K10's Hopper kernel in
    their layers (not cuBLAS's GEMM group, which "gemm" would match), and
    the first design's GEMM in the f32 twins' layer."""
    from geoguessr_ai_torch import profile_forward

    assert profile_forward._group(kernel_name) == group


# ---------------------------------------------------------------------------
# K12a / K12b: the PLAIN kind of K10's kernel
# ---------------------------------------------------------------------------


def _emulate_k12(x, w1, b1, wdw, b2, w3, b3):
    """The PLAIN kind's rounding order on bf16 x with the kernel's GELU:
    the expand summed in f32 + b1, GELU, rounded, zero where the halo pixel
    is padding; the depthwise MACs in f32 over the f32 taps in (di, dj)
    order, + b2, GELU, rounded; the project in f32 + b3, the residual
    added in f32, GELU, rounded once."""
    B, H, W, C = x.shape
    E = w1.shape[1]
    xf = x.float()
    h = _bf(_gelu_kernel(xf @ _bf(w1) + b1, False))
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    taps = wdw.reshape(9, E).float()
    acc = torch.zeros(B, H, W, E)
    for di in range(3):
        for dj in range(3):
            acc = acc + hp[:, di:di + H, dj:dj + W] * taps[3 * di + dj]
    y = _bf(_gelu_kernel(acc + b2, False))
    return _bf(_gelu_kernel(xf + (y @ _bf(w3) + b3), False))


def _k12_case(seed, C, B=1, H=16, W=10, E=64):
    """x, w1, b1, wdw, b2, w3, b3 as f32 numpy: a 16 x 10 map (a ragged
    column tile), x * 0.5, the rest scaled as the JAX benchmark's."""
    rng = np.random.default_rng(seed)

    def n(*shape, std):
        return rng.normal(0, std, shape).astype(np.float32)

    return [n(B, H, W, C, std=0.5), n(C, E, std=C ** -0.5), n(E, std=0.1),
            n(3, 3, E, std=1 / 3), n(E, std=0.1), n(E, C, std=E ** -0.5),
            n(C, std=0.1)]


def _k12_torch(arrs):
    """x and the 1x1 weights in bf16, the taps and biases f32, as the JAX
    benchmark holds them."""
    return [torch.from_numpy(a).to(torch.bfloat16 if i in (0, 1, 5)
                                   else torch.float32)
            for i, a in enumerate(arrs)]


@pytest.mark.parametrize("C", [32, 96])
def test_k12_emulation_matches_plain_and_the_jax_kernels(C):
    """On one seeded bf16 input (a 16 x 10 map, E = 64) the emulation of
    the PLAIN kind's rounding order with the kernel's GELU against
    ``_fused_mbconv_plain`` and the JAX ``fused_mbconv`` / ``fused_mbconv_v2``
    in interpret mode, within the card tests' 2e-2 of the output's range."""
    from jax.experimental.pallas import tpu as pltpu

    from geoguessr_ai_tpu.ops.experimental import fused_mbconv as jfm

    arrs = _k12_case(7, C)
    targs = _k12_torch(arrs)
    got = _emulate_k12(*targs)
    plain = tfm._fused_mbconv_plain(*targs).float()
    jargs = [jnp.asarray(a, jnp.bfloat16 if i in (0, 1, 5) else jnp.float32)
             for i, a in enumerate(arrs)]
    with pltpu.force_tpu_interpret_mode():
        wants = [np.asarray(f(*jargs).astype(jnp.float32))
                 for f in (jfm.fused_mbconv, jfm.fused_mbconv_v2)]

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert got.shape == plain.shape == wants[0].shape == arrs[0].shape
    assert rel(got, plain) < KERNEL_REL_TOL
    for want in wants:
        assert rel(got, want) < KERNEL_REL_TOL
        assert rel(plain, want) < KERNEL_REL_TOL


@pytest.mark.parametrize("v2", [False, True], ids=["K12a", "K12b"])
@pytest.mark.parametrize("C", [32, 64, 96])
def test_k12_routes_to_its_entry_with_f32_taps_and_ones(monkeypatch, C, v2):
    """A bf16 call reaches ``fused_mbconv_bf16`` (K12a) or
    ``fused_mbconv_v2_bf16`` (K12b) with (B, H, W, C, E, stream) after the
    pointers and one launch of its own; the taps go as given in f32 (not
    rounded to bf16, as K10's wrapper rounds them) and each bias as a row
    of ones over the bias."""
    calls = _fake_card(monkeypatch, tfm)
    checked = {}
    host_check = tfm._check
    monkeypatch.setattr(tfm, "_check", lambda name, t, *a: checked.setdefault(
        name, host_check(name, t, *a)))
    B, H, W, E = 2, 32, 20, 128
    targs = _k12_torch(_k12_case(3, C, B=B, H=H, W=W, E=E))
    tfm.reset_launches()
    out = tfm._fused_mbconv_cuda(*targs, v2=v2)
    assert out.shape == (B, H, W, C) and out.dtype == torch.bfloat16
    name = "_fused_mbconv_v2_cuda" if v2 else "_fused_mbconv_cuda"
    assert tfm.LAUNCHES == {**{k: 0 for k in tfm.LAUNCHES}, name: 1}
    ((lib, entry, tail),) = calls
    assert lib == "fused_mbconv_exp"
    assert entry == ("fused_mbconv_v2_bf16" if v2 else "fused_mbconv_bf16")
    assert tail == (B, H, W, C, E, 0)
    taps = targs[3].reshape(9, E)
    assert torch.equal(checked["wdw"], taps)
    assert not torch.equal(checked["wdw"], taps.to(torch.bfloat16).float())
    for key, bias in (("b1", targs[2]), ("b2", targs[4]), ("b3", targs[6])):
        assert torch.equal(checked[key], torch.stack([torch.ones_like(bias),
                                                      bias]))
    assert torch.equal(checked["w1"], targs[1].t())
    assert torch.equal(checked["w3"], targs[5].t())


@pytest.mark.parametrize("B,H,W,C,E,match", [
    (1, 16, 16, 48, 192, "C in"),      # a channel count the kernel has no box for
    (1, 16, 16, 96, 96, "E a multiple"),  # E off the 64-channel chunk
    (1, 24, 16, 96, 384, "multiple of 16"),  # H off the Pallas row strip
])
def test_k12_refuses_what_the_kernels_do_not_take(monkeypatch, B, H, W, C,
                                                  E, match):
    """``_check_kernel_shapes`` refuses C = 48, E = 96 and H = 24 without a
    card, and the wrapper raises before any launch."""
    with pytest.raises(ValueError, match=match):
        tfm._check_kernel_shapes(B, H, W, C, E)
    calls = _fake_card(monkeypatch, tfm)
    targs = _k12_torch(_k12_case(1, C, B=B, H=H, W=W, E=E))
    tfm.reset_launches()
    for v2 in (False, True):
        with pytest.raises(ValueError, match=match):
            tfm._fused_mbconv_cuda(*targs, v2=v2)
    assert not calls and not any(tfm.LAUNCHES.values())


def test_k12_takes_every_shape_of_its_contract():
    """Each C of KERNEL_CHANNELS, E from 64, ragged H (a multiple of 16)
    and W pass the shape check, up to 2^31 - 1 tiles and not beyond."""
    for C in tfm.KERNEL_CHANNELS:
        for E in (64, 128, 384):
            tfm._check_kernel_shapes(2, 32, 10, C, E)
    assert tfm.MAX_TILES == 2 ** 31 - 1
    tfm._check_kernel_shapes(tfm.MAX_TILES, 16, 16, 32, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfm._check_kernel_shapes(tfm.MAX_TILES, 16, 17, 32, 64)

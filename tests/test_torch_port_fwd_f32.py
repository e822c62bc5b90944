"""K2's and K9's f32 entries on the CPU: the f32 kinds of the LayerNorm +
GEMM core (``csrc/ln_gemm_sm90.cuh``) and of the forward core
(``csrc/attention_fwd_sm90.cuh``) that they run, their shared-memory plans
mirrored from the headers' ``constexpr``s, the GEMM's in-place split of an
f32 x tile into its bf16 hi and lo boxes, and a torch emulation of the f32
kinds' arithmetic (split products, LayerNorm unrounded, the online softmax
over chunks of two 64-key tiles) against the plain f32 versions, the JAX
XLA functions and the JAX kernels in interpret mode.

The routing of both entries is in tests/test_torch_port_mbconv_sm90.py
(K2) and tests/test_torch_port_fused_block_sm90.py (K9); the kernels
themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

LNG90 = _build.CSRC / "ln_gemm_sm90.cuh"
FWD90 = _build.CSRC / "attention_fwd_sm90.cuh"
SMEM_MAX = 232448
#: f32 kernel vs its plain f32 version, as the card tests and chip_smoke.py
#: hold the f32 entries (the split products' 2^-17 a product and f32 sums
#: in another order).
F32_REL_TOL = 1e-3


def _int(path, name):
    m = re.search(r"constexpr int " + name + r" = (\d+);", path.read_text())
    assert m, name
    return int(m.group(1))


# ---------------------------------------------------------------------------
# The GEMM core's f32 plan
# ---------------------------------------------------------------------------


def _gemm_plan_f32(M, K, Nout, staged, ws=0, Wm=0):
    """A mirror of ``make_plan_f32`` in ``ln_gemm_sm90.cuh``: f32 x tiles
    of kF32Rows (64) rows and a ring of 64 x 64 weight boxes' hi and lo, the
    first of (two x buffers, two staging tiles a group), (one, two), (one,
    one) that leaves a ring of kMinSlots; ``staged`` (the qkv kind, which
    stores its bf16 planes by TMA) takes the staging tiles, the projection
    kind none."""
    box_k, cols = _int(LNG90, "kBoxK"), _int(LNG90, "kCols")
    max_slots, smem = _int(LNG90, "kMaxSlots"), _int(LNG90, "kSmemMax")
    min_slots, max_kb = _int(LNG90, "kMinSlots"), _int(LNG90, "kMaxKB")
    if K % box_k or K > max_kb * box_k or Nout % cols or M < 1:
        return None
    if ws and (64 % ws or ws * ws % _int(LNG90, "kRows") or Wm % ws
               or M % (ws * Wm)):
        return None
    KB, R = K // box_k, _int(LNG90, "kF32Rows")
    tile, box, slot = R * KB * 2 * 128, cols * 128, 2 * cols * 128
    for AB, P in ((2, 2), (1, 2), (1, 1)):
        P = P if staged else 0
        S = min((smem - 1024 - 8 * (2 * AB + 2 * max_slots) - AB * tile
                 - 2 * P * box) // slot, max_slots)
        if S >= min_slots:
            return dict(R=R, AB=AB, P=P, S=S, tile=tile, slot=slot,
                        bytes=1024 + AB * tile + 2 * P * box + S * slot
                        + 8 * (2 * AB + 2 * S))
    return None


def test_the_f32_plan_mirrors_read_the_cores():
    """The mirrors' rules are the headers': the GEMM's 64-row tiles, its
    ring beside one or two x tiles and one or two staging tiles a group,
    its slots a box's hi and lo; the attention's resident-then-streamed fit, its q buffers and
    ring slots (a hi and a lo tile each) and two-window streamed items (the
    wrapper's constants)."""
    lng = LNG90.read_text()
    assert ("(kSmemMax - 1024 - 8 * (2 * AB + 2 * kMaxSlots) - AB * kF32Rows * "
            "KB * 256 - 2 * P * kBoxB) /") in re.sub(r"\s+", " ", lng)
    assert "const int options[3][2] = {{2, 2}, {1, 2}, {1, 1}};" in lng
    assert "p->P = staged ? o[1] : 0;" in lng
    assert "constexpr int kF32Slot = 2 * kBoxB;" in lng
    assert (_int(LNG90, "kF32BoxK"), _int(LNG90, "kF32Rows"),
            _int(LNG90, "kMinSlots")) == (32, 64, 4)
    fwd = FWD90.read_text()
    assert ("fit_ring_f32(p, 2, 2 * p->NT) || fit_ring_f32(p, 1, p->NT)"
            in fwd)
    assert "fit_ring_f32(p, 2, p->NT) || fit_ring_f32(p, 1, p->NT)" in fwd
    assert "int slots = room / (2 * p->tile) - p->QB;" in fwd
    assert "return 8 * (2 * p.NB + 4 * (p.QB + p.S));" in fwd
    assert "p->G = (W + kF32StreamWindows - 1) / kF32StreamWindows;" in fwd
    assert "p->NT = p->C % 2 == 0 ? 2 : 1;" in fwd
    assert "p->tile = kRows * hd * 4;" in fwd
    assert (_int(FWD90, "kF32QB"), _int(FWD90, "kF32StreamWindows"),
            _int(FWD90, "kSmemMax"), _int(FWD90, "kMaxSlots")) == (
        wa._FWD_F32_QB, wa._FWD_F32_STREAM_WINDOWS, wa._FWD_SMEM_MAX,
        wa._FWD_MAX_SLOTS)


@pytest.mark.parametrize("kind,M,K,Nout,ws,Wm", [
    ("qkv", 65536, 384, 1152, 0, 0),         # K2 at stage 2 of bucket 16
    ("qkv", 2, 384, 1152, 0, 0),             # a ragged last tile
    ("qkv", 65536, 128, 384, 0, 0),          # K2 at head dim 16
    ("qkv", 65536, 448, 1344, 0, 0),         # TinyViT-11M's stage 3 width
    ("qkv", 512 * 4096, 192, 576, 16, 64),   # K9 at 512 images
    ("proj", 512 * 4096, 192, 192, 16, 64),
    ("qkv", 64 * 4096, 576, 1728, 16, 64),   # C = D = 576 through the map
    ("proj", 64 * 4096, 576, 576, 16, 64),
    ("qkv", 2 * 4096, 192, 576, 32, 64),     # 32 x 32 windows
], ids=["k2_stage2", "ragged", "k2_hd16", "c448", "k9_qkv", "k9_proj",
        "c576_qkv", "d576_proj", "k9_ws32"])
def test_gemm_f32_plan_fits_at_every_shape_k2_and_k9_give(kind, M, K, Nout,
                                                          ws, Wm):
    """Each plan fits 232,448 bytes with a ring of at least kMinSlots (two
    k-boxes of a step's two column tiles), every TMA destination and
    source 1024-byte aligned (the x tiles, their 32-column boxes, the
    staging tiles, the slots' hi and lo boxes); the qkv kind keeps two
    staging tiles a group except at K = 576, where one leaves the ring its
    four slots.  K2 at stage 2: one x buffer and six slots; K9's GEMMs two
    x buffers."""
    p = _gemm_plan_f32(M, K, Nout, kind == "qkv", ws, Wm)
    assert p is not None
    assert p["bytes"] <= SMEM_MAX and p["S"] >= _int(LNG90, "kMinSlots")
    assert p["tile"] % 1024 == 0 and p["R"] * 128 % 1024 == 0
    assert p["slot"] % 1024 == 0 and p["slot"] // 2 % 1024 == 0
    assert p["P"] == (0 if kind == "proj" else 1 if K == 576 else 2)
    if (M, K) == (65536, 384):
        assert (p["AB"], p["S"]) == (1, 6)
    if (K, ws) == (192, 16):
        assert (p["AB"], p["S"]) == ((2, 6) if kind == "qkv" else (2, 8))


def test_gemm_f32_takes_every_k_up_to_the_wrappers_limit():
    """The f32 kind plans every K (a multiple of 64) up to LN_GEMM_MAX_K,
    the limit K2's and K9's f32 wrappers enforce, and none above."""
    for staged in (True, False):
        ok = [K for K in range(64, 1025, 64)
              if _gemm_plan_f32(1024, K, 3 * K, staged)]
        assert ok == list(range(64, wa.LN_GEMM_MAX_K + 1, 64))


def _f32_tasks(R, KB):
    """What ``split_tile_f32`` does, thread by thread: (thread, row, the
    f32 bytes it reads, the bytes it writes) with kF32Tpr = 256 / R threads
    a row, each over kCw = 64 / kF32Tpr columns of every 64-column chunk,
    bytes as offsets into the tile."""
    tpr = 256 // R
    cw = 64 // tpr
    chunk = 2 * R * 128
    tasks = []
    for tid in range(256):
        r, col = tid // tpr, (tid % tpr) * cw
        reads, writes = [], []
        for b in range(KB):
            for q in range(cw // 4):
                k = col + 4 * q
                reads.append(r * 128 + b * chunk + (k >> 5) * (R * 128)
                             + ((((k & 31) >> 2) ^ r) & 7) * 16)
            for u in range(cw // 8):
                at = r * 128 + b * chunk + ((((col // 8 + u) ^ r) & 7) << 4)
                writes += [at, at + R * 128]
        tasks.append((tid, r, reads, writes))
    return tasks


@pytest.mark.parametrize("KB", [1, 3, 6, 9])
def test_split_tile_f32_rewrites_each_chunk_in_place(KB):
    """Every 16-byte piece of the f32 tile is read by exactly one thread
    and every 16-byte piece of its hi and lo boxes written by exactly one;
    a thread reads and writes only its own row's 256 bytes of each chunk,
    and a row's threads sit in one warp (their __syncwarp orders the
    reads before the writes)."""
    R = _int(LNG90, "kF32Rows")
    assert _int(LNG90, "kConsumers") // R == 4  # kF32Tpr
    tasks = _f32_tasks(R, KB)
    size = R * KB * 2 * 128
    reads = sorted(o for _, _, rd, _ in tasks for o in rd)
    writes = sorted(o for _, _, _, wr in tasks for o in wr)
    assert reads == list(range(0, size, 16)) == writes
    for tid, r, rd, wr in tasks:
        rows = {(o % (2 * R * 128)) % (R * 128) // 128 for o in rd + wr}
        assert rows == {r}
    warps = {}
    for tid, r, _, _ in tasks:
        warps.setdefault(r, set()).add(tid // 32)
    assert all(len(w) == 1 for w in warps.values())


# ---------------------------------------------------------------------------
# The forward core's f32 plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", range(64, 1025, 64))
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_attention_f32_plan_fits_at_every_accepted_shape(hd, N):
    """Every N (a multiple of 64) up to FB_S2_MAX_N at every head dim has
    a plan within 232,448 bytes whose ring holds a chunk's NT tiles, with
    the bias buffers and each 64-row tile a multiple of 1024 bytes (the
    TMA destinations and the hi / lo tiles stay aligned); the resident
    tile keeps its second buffer only beside a ring of two chunks, and
    gives way to the streamed chunks where it leaves no ring."""
    W, H = 64, 12
    p = wa._fwd_plan_f32(W, H, N, wa._headmajor_groups(W, H, N), hd)
    assert p is not None and p["smem"] <= SMEM_MAX
    assert p["S"] >= p["NT"] and p["NT"] == (2 if N // 64 % 2 == 0 else 1)
    bias = 64 * (64 * p["NT"] if p["stream"] else N) * 4
    assert bias % 1024 == 0 and 64 * hd * 4 % 1024 == 0
    if not p["stream"] and p["NB"] == 2:
        assert p["S"] >= 2 * p["NT"]
    if p["stream"]:
        assert p["G"] == W // 2
    # the resident tile (N x 256 bytes) beside two q buffers and a ring of
    # NT tiles a group: streamed from N = 832, 768 and 512 at hd 16, 32 and
    # 64
    assert p["stream"] == (N >= {16: 832, 32: 768, 64: 512}[hd])


@pytest.mark.parametrize("W,H,hd", [(64, 12, 32), (512, 12, 32), (2, 2, 32),
                                     (64, 12, 16), (2, 2, 64)])
def test_k2_f32_attention_takes_the_streamed_plan_at_n_1024(W, H, hd):
    """At K2's N = 1024 the f32 bias tile (256 KB) does not fit: the
    attention streams it in 32 KB chunks of two key tiles over items of
    two windows, two bias slots and a ring of eight at hd 32 (stage 2 of
    bucket 16 and the B=512 embed), of three at hd 64.  K9's N = 256 tile
    (64 KB) stays resident, two buffers and four slots."""
    p = wa._fwd_plan_f32(W, H, 1024, wa._headmajor_groups(W, H, 1024), hd)
    assert p["stream"] == 1 and p["NT"] == 2 and p["G"] == -(-W // 2)
    assert p["items"] == 16 * p["G"] * H
    assert (p["NB"], p["S"]) == {16: (2, 16), 32: (2, 8), 64: (2, 3)}[hd]
    k9 = wa._fwd_plan_f32(8192, 6, 256, wa._headmajor_groups(8192, 6, 256),
                          32)
    assert (k9["stream"], k9["NB"], k9["S"], k9["NT"]) == (0, 2, 4, 2)


def test_the_f32_kinds_are_hopper_code_with_internal_linkage():
    """Both f32 kinds read through tensor maps into rings of mbarriers,
    give the producers' registers to the consumers and run the split
    products on wgmma, the attention's p.v with the backward core's helpers
    (now in sm90.cuh, defined once); the qkv GEMM stores qkv as the bf16
    planes the attention loads; each launcher keeps its opt-in flag in a
    function-local static in the headers' unnamed namespaces."""
    lng = LNG90.read_text()
    for feature in ("tma_load(", "tma_load_5d(", "setmaxnreg.dec",
                    "setmaxnreg.inc", "split_tile_f32<KB, KIND>(",
                    "wgmma_m64n64k16_ss(d, al + 2 * kk, bh + 2 * kk);",
                    "wait_phase(", "store_planes(d, stage, p.P, y_map",
                    "store_tile_tma(leader, y_map, lo_stage, col0, row0, 1);",
                    "static bool opted_in = false;"):
        assert feature in lng[lng.index("// The f32 kind"):], feature
    fwd = FWD90.read_text()
    f32 = fwd[fwd.index("// The f32 kind"):]
    for feature in ("split_scores_ss<HD>(", "split_k64<HD>(",
                    "softmax_chunk<HD, NT, float>(", "load_pair(",
                    "encode_rows<HD>(&maps[0], qkv2, 3L * H * HD, N, 2L * W",
                    "setmaxnreg.dec", "setmaxnreg.inc",
                    "static bool opted_in = false;"):
        assert feature in f32, feature
    sm90 = (_build.CSRC / "sm90.cuh").read_text()
    bwd = (_build.CSRC / "attention_bwd_sm90.cuh").read_text()
    for helper in ("void split_a(", "void split_k64("):
        assert helper in sm90 and helper not in bwd and helper not in fwd
    for helper in ("void row_frags(", "void split_scores(", "void split_tiles("):
        assert helper in bwd and helper not in sm90 and helper not in fwd
    for src, ns in ((lng, "lng90"), (fwd, "fwd90")):
        assert f"namespace {ns} {{\nnamespace {{\n" in src
        assert src.rstrip().endswith(
            f"}}  // namespace\n}}  // namespace {ns}\n}}  // namespace gg")


# ---------------------------------------------------------------------------
# The f32 kinds' arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _split(t):
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_mm(a, b):
    """a @ b on bf16 (hi, lo) splits of both, lo.hi + hi.lo + hi.hi summed
    in f32: the f32 kinds' products."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _emulate_gemm_f32(x, ln_scale, ln_bias, w, b, eps, layer_norm=True):
    """The GEMM core's f32 kind: LayerNorm's two-pass f32 statistics and
    its output unrounded (kQkvGemm), the split product, the f32 b added."""
    if layer_norm:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias
    return _split_mm(x, w) + b


def _emulate_attention_f32(qkv, bias, scale, H, nt=2):
    """The forward core's f32 kind: split score products plus the f32
    bias, the online softmax over chunks of nt 64-key tiles, p split into
    the p.v product, o over the row sum at the end."""
    W, N, D3 = qkv.shape
    hd = D3 // (3 * H)
    q, k, v = (t.permute(0, 2, 1, 3) for t in
               qkv.reshape(W, N, H, 3 * hd).split(hd, dim=-1))
    s = _split_mm(q, k.transpose(-1, -2)) * scale + bias[None]
    m = torch.full((W, H, N, 1), -torch.inf)
    l = torch.zeros(W, H, N, 1)
    o = torch.zeros(W, H, N, hd)
    for k0 in range(0, N, 64 * nt):
        sc = s[..., k0:k0 + 64 * nt]
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(sc - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_mm(p, v[..., k0:k0 + 64 * nt, :])
        m = mx
    return (o / l).permute(0, 2, 1, 3).reshape(W, N, H * hd)


def _emulate_k2_f32(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale, H, eps):
    qkv = _emulate_gemm_f32(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return _emulate_attention_f32(qkv, bias, scale, H)


def _emulate_k9_f32(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                    scale, H, window, eps):
    """K9's three launches over the window-ordered rows the window map
    hands them (held against window_partition by the bf16 tests)."""
    xw = wa.window_partition(x, window)
    qkv = _emulate_gemm_f32(xw, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    o = _emulate_attention_f32(qkv, bias, scale, H)
    out = _emulate_gemm_f32(o, None, None, w_proj, b_proj, eps,
                            layer_norm=False)
    return wa.window_unpartition(out, window, x.shape[1:3])


def _case(seed, shape, C, H, N, proj):
    rng = np.random.default_rng(seed)

    def n(*s, mean=0.0, std=1.0):
        return rng.normal(mean, std, s).astype(np.float32)

    out = [n(*shape, C), n(C, mean=1.0, std=0.1), n(C, std=0.1),
           n(C, 3 * C, std=C ** -0.5), n(3 * C, std=0.1)]
    if proj:
        out += [n(C, C, std=C ** -0.5), n(C, std=0.1)]
    return out + [n(H, N, N, std=0.5)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_k2_f32_emulation_matches_plain_and_the_jax_kernels():
    """On seeded f32 inputs (two windows of N = 256, so the online softmax
    takes two chunks; C = 64, H = 2) the emulation of K2's f32 kinds
    against ``_fb_s2_plain`` in f32, the JAX ``_fb_s2_xla`` and
    ``_fb_s2_pallas`` in interpret mode on the same f32 inputs, within
    F32_REL_TOL."""
    W, N, C, H = 2, 256, 64, 2
    case = _case(11, (W, N), C, H, N, proj=False)
    scale = (C // H) ** -0.5
    targs = list(map(torch.from_numpy, case))
    got = _emulate_k2_f32(*targs, scale, H, 1e-5)
    plain = wa._fb_s2_plain(*targs, scale, H, 1e-5)
    jargs = list(map(jnp.asarray, case))
    xla = np.asarray(jwa._fb_s2_xla(*jargs, scale, H, 1e-5))
    pallas = np.asarray(jwa._fb_s2_pallas(*jargs, scale, H, 1e-5,
                                          interpret=True))
    assert got.shape == plain.shape == xla.shape == pallas.shape == (W, N, C)
    assert plain.dtype == torch.float32
    for want in (plain, xla, pallas):
        assert _rel(got, want) < F32_REL_TOL


def test_k9_f32_emulation_matches_plain_and_the_jax_kernels():
    """On a seeded f32 (1, 32, 32, 64) map of 16 x 16 windows (H = 2, two
    softmax chunks a row) the emulation of K9's three f32 launches against
    ``_fb4d_plain`` in f32, the JAX ``_fb4d_xla`` and ``_fb4d_pallas`` in
    interpret mode on the same f32 inputs, within F32_REL_TOL."""
    B, Hm, Wm, C, H, ws = 1, 32, 32, 64, 2, 16
    case = _case(12, (B, Hm, Wm), C, H, ws * ws, proj=True)
    scale = (C // H) ** -0.5
    targs = list(map(torch.from_numpy, case))
    got = _emulate_k9_f32(*targs, scale, H, ws, 1e-5)
    plain = wa._fb4d_plain(*targs, scale, H, ws, 1e-5)
    jargs = list(map(jnp.asarray, case))
    xla = np.asarray(jwa._fb4d_xla(*jargs, scale, H, 1e-5, ws))
    pallas = np.asarray(jwa._fb4d_pallas(*jargs, scale, H, 1e-5, ws,
                                         interpret=True))
    assert got.shape == plain.shape == xla.shape == pallas.shape == (
        B, Hm, Wm, C)
    for want in (plain, xla, pallas):
        assert _rel(got, want) < F32_REL_TOL


def test_the_f32_variants_still_apply():
    """Every edit of scripts/fb_f32_variants.py finds its anchor in its
    header, so the variants the PERF numbers come from still build."""
    import importlib.util

    path = _build.CSRC.parents[2] / "scripts" / "fb_f32_variants.py"
    spec = importlib.util.spec_from_file_location("fb_f32_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.VARIANTS
    for name, edits in module.VARIANTS.items():
        for header, old, _ in edits:
            assert old in (_build.CSRC / header).read_text(), name

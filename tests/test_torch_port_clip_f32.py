"""K6's and K11's f32 entries on the CPU: the f32 kind of K6's Hopper
kernel (``csrc/clip_flash_sm90.cuh``) and the GEMM core's kSplitF32 kind
(``csrc/gemm_sm90.cuh``) that they run, their shared-memory plans mirrored
from the headers' ``constexpr``s, and a torch emulation of their arithmetic
(k and v split into bf16 hi / lo planes, q split in registers, split
products, the online softmax over 128-key tiles, p split in registers; for
K11 o's planes and the core's three products box by box) against the plain f32 versions, the JAX
XLA functions and the JAX kernels in interpret mode.

The routing of both entries is in tests/test_torch_port_clip_sm90.py (K6)
and tests/test_torch_port_gemm_sm90.py (K11); the kernels themselves are
held against the plain versions on the card by tests/test_torch_port_cuda.py
and chip_smoke.py (phase 24, with K11 bitwise the core's f32 kind on the
split of K6's f32 output).
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import clip_attention as jca

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import clip_attention as ca

from test_torch_port_gemm_sm90 import _plan as _core_plan

K6_HEADER = _build.CSRC / "clip_flash_sm90.cuh"
CORE = _build.CSRC / "gemm_sm90.cuh"
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
# K6's f32 plan and the core's kSplitF32 plan
# ---------------------------------------------------------------------------


def _k6_plan_f32(hd, N):
    """A mirror of ``TileF32<HD>``: kF32QBufs f32 q tiles of kRowsQ rows,
    then as many k/v stages of a k pair and a v pair as fit (at most
    kStages), each pair a (kKeys, hd) bf16 hi tile then its lo tile, from
    the 1024-aligned base, then the barriers; with the byte offset of every
    TMA destination from the base and the items and key tiles of N."""
    rows, keys = _int(K6_HEADER, "kRowsQ"), _int(K6_HEADER, "kKeys")
    max_stages, QB = _int(K6_HEADER, "kStages"), _int(K6_HEADER, "kF32QBufs")
    smem_max = _int(K6_HEADER, "kSmemMax")
    q_bytes = rows * hd * 4
    tile = keys * hd * 2
    pair = 2 * tile

    def bars(stages):
        return 8 * (2 * QB + 3 * stages)

    S = min((smem_max - 1024 - QB * q_bytes - bars(max_stages)) // (2 * pair),
            max_stages)
    dests = [i * q_bytes for i in range(QB)]
    dests += [QB * q_bytes + (2 * s + kv) * pair + half * tile
              for s in range(S) for kv in (0, 1) for half in (0, 1)]
    return dict(QB=QB, S=S, pair=pair, dests=dests, rows=rows,
                tiles=-(-N // keys), qtiles=-(-N // rows),
                bytes=1024 + QB * q_bytes + 2 * S * pair + bars(S))


@pytest.mark.parametrize("hd,N,want_stages", [
    (64, 577, 3),   # CLIP-L
    (64, 50, 3),    # ViT-B/32
    (32, 577, 5),
    (16, 129, 5),
], ids=["vit_l14", "vit_b32", "hd32", "hd16"])
def test_k6_f32_plan_fits_with_two_stages_and_aligned_tma(hd, N, want_stages):
    """The f32 kind's shared memory at the head dims it takes: within the
    232,448 bytes a block may opt in to, at least two k/v stages in flight
    (hd 64: one f32 q tile of 32 KB and three stages of 64 KB, 225 KB),
    every TMA destination (the f32 q tile, a hi or lo tile) 1024-aligned,
    as the 128-byte swizzle needs."""
    p = _k6_plan_f32(hd, N)
    assert p["S"] == want_stages >= 2
    assert p["bytes"] <= SMEM_MAX
    assert all(d % 1024 == 0 for d in p["dests"])
    assert len(set(p["dests"])) == len(p["dests"])
    # one more stage (where the cap allows one) would not fit
    if p["S"] < _int(K6_HEADER, "kStages"):
        assert p["bytes"] + 2 * p["pair"] + 24 > SMEM_MAX
    assert p["tiles"] == -(-N // 128) and p["qtiles"] == -(-N // 128)


def test_the_f32_plan_mirror_reads_the_design_the_header_ships():
    """The mirror follows ``TileF32``: the f32 q tile first, then each
    stage's k pair and v pair, the barriers last, the ring no deeper than
    the bf16 kind's, one q tile (each consumer thread splits its q rows
    into registers and releases it at once); the producer loads each
    pair's lo tile from plane image B + b of the planes' tensor map, and q
    in f32 through qkv's own, unswizzled."""
    src = K6_HEADER.read_text()
    assert _int(K6_HEADER, "kF32QBufs") == 1
    assert "static constexpr int kF32Stages = kFit < kStages ? kFit : kStages;" in src
    assert ("static constexpr int kBarOffset = kF32QBufs * kQBytes + 2 * "
            "kF32Stages * kPair;") in src
    assert "tma_load(dst + T::kBytes, &kv_map, bar, c0, row, B + b);" in src
    assert "return sk + (2 * s + 1) * F::kPair;" in src
    assert "CU_TENSOR_MAP_SWIZZLE_NONE" in src
    f32 = src[src.index("clip_flash_f32_sm90("):src.index("int run_f32(")]
    assert f32.index("q_frags<HD>(") < f32.index("release(empty_q") < \
        f32.index("split_scores<HD>(")


@pytest.mark.parametrize("B,N,D,want", [
    (64, 577, 1024, dict(KB=16, BN=256, S=2)),   # CLIP-L bucket 16
    (64, 50, 768, dict(KB=12, BN=256, S=2)),     # ViT-B/32
    (2, 577, 256, dict(KB=4, BN=256, S=2)),      # hd 32, H = 8
    (3, 129, 128, dict(KB=2, BN=128, S=3)),      # hd 16, H = 8
], ids=["vit_l14", "vit_b32", "hd32", "hd16"])
def test_core_f32_plan_at_k11s_shapes(B, N, D, want):
    """K11's f32 projection (M = B N rows of o's planes, K = Nout = D): a
    stage holds both planes of A's and bt's boxes, so 2 stages at BN = 256
    (230,432 bytes) and 3 at 128, within the 232,448 a block may opt in to;
    every TMA destination of a stage (A's hi and lo boxes, bt's hi and lo
    boxes and each CTA's half of them) 1024-aligned."""
    p = _core_plan(B * N, D, D, 2, planes=2)
    assert {k: p[k] for k in want} == want
    assert p["bytes"] <= SMEM_MAX
    stage = 2 * (128 * 128 + p["BN"] * 128)
    assert p["bytes"] + stage + 16 > SMEM_MAX  # the next stage would not fit
    half_b = p["BN"] // 2 * 128
    offsets = [s * stage + o for s in range(p["S"]) for o in (
        0, 128 * 128, 2 * 128 * 128, 2 * 128 * 128 + half_b,
        2 * 128 * 128 + p["BN"] * 128, 2 * 128 * 128 + p["BN"] * 128 + half_b)]
    assert all(o % 1024 == 0 for o in offsets)
    assert "kIn = 2, kOut = 4, kPlanes = 2;" in CORE.read_text()


# ---------------------------------------------------------------------------
# The f32 kinds' arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _split(x):
    """x f32 as its bf16 (hi, lo) pair, both widened back to f32 (exact)."""
    hi, lo = ca._split_bf16(x)
    return hi.float(), lo.float()


def _split_mm(a, b):
    """a @ b as the f32 kinds' split products: lo.hi + hi.lo + hi.hi, each
    product of bf16 values exact in f32, summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _k6_f32(qkv, scale, H, keys=128):
    """K6's f32 kind: q split in registers, k and v split (the planes),
    scores s = q k^T in split products over 128-key tiles, the online softmax in the log2 domain (the
    running max over the raw scores times scale log2 e, p = 2^(s sl2 - m)),
    p split, o += p v in split products rescaled by each tile's alpha, then
    o times 1 / l, in f32 throughout."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    q, k, v = (t.reshape(B, N, H, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    sl2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, hd)
    for k0 in range(0, N, keys):
        kt, vt = k[:, :, k0:k0 + keys], v[:, :, k0:k0 + keys]
        s = _split_mm(q, kt.transpose(-1, -2))
        n = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        alpha = torch.exp2(m - n)
        p = torch.exp2(s * sl2 - n)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_mm(p, vt)
        m = n
    o = o * (1.0 / l)
    return o.transpose(1, 2).reshape(B, N, D)


def _k11_f32(qkv, w, scale, H):
    """K11's f32 entry: K6's f32 kind into o's planes, then the core's
    kSplitF32 kind box by box (64 bf16 values of K a box), each box's
    lo.hi + hi.lo + hi.hi added into the f32 sum."""
    B, N, D = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    o = _k6_f32(qkv, scale, H).reshape(B * N, D)
    oh, ol = _split(o)
    wh, wl = _split(w.t().contiguous())
    acc = torch.zeros(B * N, D)
    for k0 in range(0, D, 64):
        ks = slice(k0, k0 + 64)
        acc += (ol[:, ks] @ wh[:, ks].t() + oh[:, ks] @ wl[:, ks].t()
                + oh[:, ks] @ wh[:, ks].t())
    return acc.reshape(B, N, D)


SHAPES = [(2, 50, 128, 2), (1, 129, 256, 8)]
SHAPE_IDS = ["n50_hd64", "n129_hd32"]


def _inputs(B, N, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * D)).astype(np.float32)
    w = (rng.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
    return qkv, w


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("B,N,D,H", SHAPES, ids=SHAPE_IDS)
def test_k6_f32_emulation_matches_plain_xla_and_the_pallas_kernel(B, N, D, H):
    """K6's f32 kind (one partial key tile at N = 50, a tile and one key at
    N = 129) against ``_flash_plain`` in f32, the JAX ``_flash_xla`` and
    ``_flash_pallas`` in interpret mode on the same f32 inputs, within
    F32_REL_TOL; nothing in it is rounded to bf16."""
    qkv, _ = _inputs(B, N, D, N)
    scale = (D // H) ** -0.5
    got = _k6_f32(torch.from_numpy(qkv), scale, H)
    plain = ca._flash_plain(torch.from_numpy(qkv), scale, H)
    assert plain.dtype == torch.float32
    xla = jca._flash_xla(jnp.asarray(qkv), scale, H)
    pallas = jca._flash_pallas(jnp.asarray(qkv), scale, H, 2, interpret=True)
    for want in (plain.numpy(), xla, pallas):
        assert _rel(got.numpy(), want) <= F32_REL_TOL
    # bf16 rounding anywhere on the way would not meet the f32 tolerance
    assert _rel(got.numpy(), ca._flash_plain(
        torch.from_numpy(qkv).bfloat16(), scale, H).float().numpy()) > \
        F32_REL_TOL


@pytest.mark.parametrize("B,N,D,H", SHAPES, ids=SHAPE_IDS)
def test_k11_f32_emulation_matches_plain_xla_and_the_pallas_kernel(B, N, D, H):
    """K11's f32 entry as its launches compute it (K6's f32 kind into o's
    planes, the core's split products box by box) against
    ``_flash_proj_plain`` in f32, the JAX ``_flash_proj_xla`` and
    ``_flash_proj_pallas`` in interpret mode, within F32_REL_TOL."""
    qkv, w = _inputs(B, N, D, N + 1)
    scale = (D // H) ** -0.5
    got = _k11_f32(torch.from_numpy(qkv), torch.from_numpy(w), scale, H)
    plain = ca._flash_proj_plain(torch.from_numpy(qkv), torch.from_numpy(w),
                                 scale, H)
    xla = jca._flash_proj_xla(jnp.asarray(qkv), jnp.asarray(w), scale, H)
    pallas = jca._flash_proj_pallas(jnp.asarray(qkv), jnp.asarray(w), scale,
                                    H, 2, interpret=True)
    for want in (plain.numpy(), xla, pallas):
        assert _rel(got.numpy(), want) <= F32_REL_TOL


def test_the_o_planes_are_the_split_of_k6s_f32_output():
    """K11's first launch stores each normalised output value's hi and lo,
    the split ``_split_bf16`` makes of K6's stored f32 output (round to
    nearest even, then the rounded difference): the planes carry the f32
    value to 2^-17, and hi + lo rebuilds it closer than hi alone."""
    qkv, _ = _inputs(1, 50, 128, 3)
    o = _k6_f32(torch.from_numpy(qkv), 64 ** -0.5, 2)
    hi, lo = ca._split_bf16(o)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, o.to(torch.bfloat16))
    assert torch.equal(lo, (o - hi.float()).to(torch.bfloat16))
    err = (hi.float() + lo.float() - o).abs().max()
    assert float(err) <= 2.0 ** -16 * float(o.abs().max())
    assert float(err) < float((hi.float() - o).abs().max())


def test_the_f32_kinds_keep_the_split_numerics():
    """The sources compute what the emulation does: k and v split by
    split_pair (hi rounded to nearest even, then the rounded difference),
    q by frag (the same split), three wgmma a k-step in both products and
    in the core, p split in registers, the output's product by 1 / l never
    contracted into the split's subtraction (__fmul_rn), and the first
    design gone."""
    k6 = K6_HEADER.read_text()
    f32 = k6[k6.index("// The f32 kind (K6's and K11's f32 entries)"):]
    assert "const Frag<float> a = split_pair(v.x, v.y), b = split_pair(v.z, v.w);" in f32
    assert f32.count("wgmma_m64n128k16_rs(sc, ") == 3
    assert "frag(r0), frag(r1), frag(r0 + 8), frag(r1 + 8)" in f32
    assert f32.count("wgmma_pv<HD>(o, ") == 3
    assert "split_p(sc, ph, pl);" in f32 and "pack_p(" not in f32
    assert f32.count("__fmul_rn(o[") == 4
    core = CORE.read_text()
    body = core[core.index("if constexpr (Kind<KIND>::kPlanes == 2) {\n    const uint64_t dal"):]
    assert body.index("mma<NW>(d, dal + 2 * kk, db + 2 * kk);") < \
        body.index("mma<NW>(d, da + 2 * kk, dbl + 2 * kk);") < \
        body.index("mma<NW>(d, da + 2 * kk, db + 2 * kk);")
    assert not (_build.CSRC / "clip_flash.cuh").exists()
    for lib in ("clip_flash", "clip_flash_proj"):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert "attend_rows" not in src and "clip_flash_proj_kernel" not in src
        assert "__global__" not in src

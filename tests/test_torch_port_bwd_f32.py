"""The f32 kind of the Hopper backward core (``attn_bwd_f32_sm90`` in
``csrc/attention_bwd_sm90.cuh``), which K4's, K5's and K7's f32 entries
run, on the CPU: its shared-memory plan (the Python mirror
``window_attention._bwd_smem_f32`` against the header's constants and at
the seven f32 production shapes), the bf16 tile layout its splitter warps
write, and a torch emulation of its rounding against the JAX package's f32
VJP.

The kind lands qkv, g and the bias in f32 by TMA and splits every product
into bf16 pairs on the chip: hi = bf16(x), lo = bf16(x - hi), summed
lo.hi + hi.lo + hi.hi in f32, p and ds split, not rounded.  The kernels
themselves are held against the plain f32 versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py (phases 24, 26 and 31).
"""

import re

import jax
import numpy as np
import pytest
import torch

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

CORE = _build.CSRC / "attention_bwd_sm90.cuh"
#: The card's opt-in shared memory a block (an H100's
#: shared_memory_per_block_optin).
SMEM_MAX = 232448
#: f32 kernels against f32 references: max |got - want| / max |want|, as
#: chip_smoke.py's F32_REL_TOL holds every f32 entry.
F32_REL_TOL = 1e-3

#: (kernel, label, W, N, H) of the f32 entries on the main paths, N before
#: the wrapper's padding to 64: TinyViT-21M-512 at B=16 panoramas (K4
#: stages 1 and 3, K5 and K7 stage 2) and TinyViT-5M-224 at B=64 (K4).
F32_SHAPES = (
    ("K4", "21m512_stage1", 1024, 256, 6),
    ("K4", "21m512_stage3", 64, 256, 18),
    ("K4", "5m224_stage1", 1024, 49, 4),
    ("K4", "5m224_stage2", 64, 196, 5),
    ("K4", "5m224_stage3", 64, 49, 10),
    ("K5", "21m512_stage2", 64, 1024, 12),
    ("K7", "21m512_stage2", 64, 1024, 12),
)


def _core_int(name):
    m = re.search(r"constexpr int " + name + r" = (\d+);", CORE.read_text())
    assert m, name
    return int(m.group(1))


def _defaults():
    return {name: default for name, (default, _) in wa.TILE_KNOBS.items()}


@pytest.mark.parametrize("kernel,label,W,N,H", F32_SHAPES,
                         ids=[f"{k}_{lab}" for k, lab, *_ in F32_SHAPES])
def test_f32_plan_fits_at_the_production_shapes(kernel, label, W, N, H):
    """Each launch of the f32 kind fits the card's opt-in with at least two
    column slots, over 128-row items, and takes G from ``_bwd_groups`` (K5:
    one group)."""
    Np = -(-N // 64) * 64
    plan = wa._bwd_call_plan(kernel, W, Np, H, 32, _defaults(), 4)
    assert plan["rows"] == 128
    assert plan["G"] == (1 if kernel == "K5" else wa._bwd_groups(W, Np, H))
    assert plan["items"] == wa._bwd_items(W, Np, H, plan["G"])
    assert max(plan["smem"].values()) <= SMEM_MAX
    assert min(plan["stages"].values()) >= 2


@pytest.mark.parametrize("hd,want", [
    (16, {"stats": (203888, 4), "dkdv": (203888, 4), "dq": (203888, 4),
          "dbias": (109728, 6)}),
    (32, {"stats": (219232, 3), "dkdv": (219232, 3), "dq": (219232, 3),
          "dbias": (208032, 6)}),
    (64, {"stats": (201808, 2), "dkdv": (201808, 2), "dq": (201808, 2),
          "dbias": (201808, 2)}),
])
def test_f32_plan_mirror_at_every_head_dim(hd, want):
    """The mirror's bytes and column slots: at hd 32 one row slot, two
    landing slots and three column slots with the 32 KB bias tile (dbias:
    two row slots, six column slots, no tile); at hd 64 the bias tile does
    not leave two column slots, so no launch keeps it."""
    assert wa._bwd_smem_f32(hd) == want


def test_the_f32_plan_mirror_reads_the_core():
    """The mirror's constants are the header's: two landing slots, three
    splitter warps beside the TMA warp, the 216 KB budget less 1 KB of
    alignment, a register split that fits 168 x 384 (a split above it
    never completes setmaxnreg)."""
    src = CORE.read_text()
    assert _core_int("kF32Lands") == wa._BWD_F32_LANDS == 2
    assert _core_int("kSplitWarps") == 3
    producer, consumer = (_core_int("kF32ProducerRegs"),
                          _core_int("kF32ConsumerRegs"))
    assert producer * 128 + consumer * 256 <= 168 * 384
    assert producer % 8 == 0 and consumer % 8 == 0
    assert "return (216 * 1024 - 1024 - row_bufs * f32_row_buf(hd)" in src
    assert "kRowBufs = MODE == kDbias && f32_fit(HD, 2, false) >= 2 ? 2 : 1" in src
    assert "kBiasTile = MODE != kDbias && f32_fit(HD, kRowBufs, true) >= 2" in src


def _split_offset(hd, lin):
    """Where ``split_tiles`` writes the bf16 byte at linear offset ``lin``
    of a 64-row tile (row r at r * 2 hd)."""
    mask = 2 * hd // 16 - 1
    return lin ^ (((lin >> 7) & mask) << 4)


def _swizzle128(row, byte):
    """sm90.cuh's swizzle128: TMA's 128-byte swizzle of 128-byte rows."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_split_tiles_write_the_tma_swizzle(hd):
    """The splitters' placement permutes each tile's 16-byte chunks within
    their 1024-byte group of rows (a bijection of the tile), keeps a
    4-element piece contiguous, and at hd 64 (128-byte rows) is exactly the
    128-byte swizzle the bias tiles take from TMA."""
    size = 64 * hd * 2
    offsets = [_split_offset(hd, lin) for lin in range(0, size, 8)]
    assert sorted(offsets) == list(range(0, size, 8))
    assert all(o // 1024 == lin // 1024 and o % 16 == lin % 16
               for o, lin in zip(offsets, range(0, size, 8)))
    if hd == 64:
        assert all(_split_offset(hd, r * 128 + b) == _swizzle128(r, b)
                   for r in range(64) for b in range(0, 128, 8))


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_mm(eq, a, b):
    """A product with each operand split into a bf16 pair, lo.hi + hi.lo +
    hi.hi in f32 (bf16 times bf16 is exact in f32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _f32_kind(qkv, bias, g, scale, H, G):
    """The f32 kind's arithmetic as the wrapper runs it: N padded to 64
    (``_pad_tokens``), every product split, the softmax and ds in f32,
    d_bias summed in order inside each of G window groups and then over
    the groups in order; the padding cut off."""
    N = qkv.shape[1]
    pad = -N % 64
    if pad:
        qkv, bias, g = wa._pad_tokens(qkv, bias, g, pad)
    W, Np, D3 = qkv.shape
    hd = D3 // (3 * H)
    q, k, v = qkv.reshape(W, Np, H, 3 * hd).split(hd, dim=-1)
    gh = g.reshape(W, Np, H, hd)
    s = _split_mm("wnhd,wmhd->whnm", q, k) * scale + bias[None]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = e * (1 / e.sum(-1, keepdim=True))
    dp = _split_mm("wnhd,wmhd->whnm", gh, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dv = _split_mm("whnm,wnhd->wmhd", p, gh)
    dq = _split_mm("whnm,wmhd->wnhd", ds, k) * scale
    dk = _split_mm("whnm,wnhd->wmhd", ds, q) * scale
    dqkv = torch.cat([dq, dk, dv], dim=-1).reshape(W, Np, D3)
    parts = []
    for i in range(G):
        acc = torch.zeros_like(ds[0])
        for w in range(i * W // G, (i + 1) * W // G):
            acc = acc + ds[w]
        parts.append(acc)
    dbias = parts[0]
    for part in parts[1:]:
        dbias = dbias + part
    return dqkv[:, :N], dbias[:, :N, :N]


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("W,N,H,hd", [(3, 49, 2, 32), (2, 64, 3, 16),
                                      (2, 100, 1, 64)],
                         ids=["n49", "n64_hd16", "n100_hd64"])
def test_f32_kind_rounding_matches_the_jax_f32_vjp(W, N, H, hd):
    """The emulated kind (K4's groups; K5's one group gives the same sums
    to f32 rounding) against ``jax.vjp`` of the JAX package's
    ``window_attention_qkv`` in f32 on the CPU (its XLA backward), within
    F32_REL_TOL of each output's range, as phase 24 holds the kernels."""
    rng = np.random.default_rng(23)
    D = H * hd
    qkv = rng.normal(0, 1, (W, N, 3 * D)).astype(np.float32)
    bias = (rng.normal(0, 0.5, (H, N, N))).astype(np.float32)
    g = rng.normal(0, 1, (W, N, D)).astype(np.float32)
    scale = hd ** -0.5
    _, vjp = jax.vjp(lambda a, b: jwa.window_attention_qkv(a, b, scale, H),
                     qkv, bias)
    want_dqkv, want_dbias = (np.array(t) for t in vjp(g))
    Np = -(-N // 64) * 64
    G = wa._bwd_groups(W, Np, H)
    got_dqkv, got_dbias = _f32_kind(torch.from_numpy(qkv),
                                    torch.from_numpy(bias),
                                    torch.from_numpy(g), scale, H, G)
    assert _rel(got_dqkv, torch.from_numpy(want_dqkv)) <= F32_REL_TOL
    assert _rel(got_dbias, torch.from_numpy(want_dbias)) <= F32_REL_TOL
    # and so does the plain f32 version the card holds the kernels against
    plain = wa._attention_qkv_bwd_plain(torch.from_numpy(qkv),
                                        torch.from_numpy(bias),
                                        torch.from_numpy(g), scale, H)
    assert _rel(got_dqkv, plain[0]) <= F32_REL_TOL
    assert _rel(got_dbias, plain[1]) <= F32_REL_TOL

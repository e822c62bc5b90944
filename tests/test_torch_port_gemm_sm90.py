"""The Hopper GEMM core (``csrc/gemm_sm90.cuh``) and its two users, K11's
entries and K13, on the CPU.

In bf16 ``clip_attention._flash_proj_cuda`` (K11) allocates a (B, N, D)
scratch and calls ``clip_flash_proj_bf16``, which launches K6's kernel
(``csrc/clip_flash_sm90.cuh``) into the scratch and then the core's bf16 ->
bf16 kind on it; in f32 it allocates one bf16 scratch for k's and v's
planes and o's planes and calls ``clip_flash_proj_f32``, which launches K6's f32 kind
into o's planes and then the core's kSplitF32 kind on them and on w_proj^T's
planes.
``tiled_gemm.tiled_matmul`` (K13) calls ``tiled_gemm_s8`` or
``tiled_gemm_bf16``, the core's int8 -> int32 and bf16 -> f32 kinds.  What
is checked here, where there is no ``nvcc`` and no card: the core's plan
(mirrored from the header's ``constexpr``s) at the shapes both kernels give
it and the shapes it refuses, the epilogue's staging boxes (every
accumulator value lands once, at the place its TMA store reads it), which
entry each call reaches and the refusals before it, the headers' linkage,
and a torch emulation of the core's box-by-box sum against the plain
versions and the JAX kernels in interpret mode.  The kernels themselves are
held against the plain versions on the card by tests/test_torch_port_cuda.py
(``-k gemm_sm90``), ``scripts/gemm_sm90_check.py`` and chip_smoke.py.
"""

import importlib.util
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from geoguessr_ai_tpu.ops import clip_attention as jca

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import clip_attention as ca
from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

from test_torch_port_experimental import _pallas_matmul

CORE = _build.CSRC / "gemm_sm90.cuh"
K6_HEADER = _build.CSRC / "clip_flash_sm90.cuh"
SMEM_MAX = 232448
KERNEL_REL_TOL = 2e-2


def _const(name, kind="int"):
    m = re.search(rf"constexpr {kind} {name} = (\w+);", CORE.read_text())
    assert m, name
    return m.group(1)


def _int(name):
    return int(_const(name))


# ---------------------------------------------------------------------------
# The core's plan
# ---------------------------------------------------------------------------


def _plan(M, K, N, in_bytes, planes=1):
    """A mirror of ``gemm_sm90.cuh``'s make_plan: K a multiple of 64 bytes
    in 128-byte k-boxes (the last one zero-filled past K), N a multiple of
    128 in tiles of 256 columns where N allows, else 128, as many
    ring stages of A's 128-row box and B's BN-row box (each in ``planes``
    planes: kSplitF32's hi and lo) as fit beside the four staging boxes, at
    most kMaxStages."""
    rows, box = _int("kRows"), _int("kBoxBytes")
    max_stages, out_bufs, out_rows = (_int("kMaxStages"), _int("kOutBufs"),
                                      _int("kOutRows"))
    if M < 1 or K < 1 or K * in_bytes % 64 or N < 128 or N % 128:
        return None
    BN = 256 if N % 256 == 0 else 128
    staging = 2 * out_bufs * out_rows * 128
    stage = planes * (rows * box + BN * box)
    S = min((_int("kSmemMax") - 1024 - staging - 16 * max_stages) // stage,
            max_stages)
    if S < 2:
        return None
    return dict(KB=-(-K * in_bytes // box), BN=BN, S=S, mtiles=-(-M // rows),
                ntiles=-(-N // BN), bytes=1024 + S * stage + staging + 16 * S)


@pytest.mark.parametrize("M,K,N,in_bytes,want", [
    (64 * 577, 1024, 1024, 2, dict(KB=16, BN=256, S=4, mtiles=289, ntiles=4)),
    (64 * 50, 768, 768, 2, dict(KB=12, BN=256, S=4, mtiles=25, ntiles=3)),
    (3 * 129, 128, 128, 2, dict(KB=2, BN=128, S=6, mtiles=4, ntiles=1)),
    (4096, 2048, 4096, 1, dict(KB=16, BN=256, S=4, mtiles=32, ntiles=16)),
    (4096, 4096, 4096, 1, dict(KB=32, BN=256, S=4, mtiles=32, ntiles=16)),
    (4096, 4096, 4096, 2, dict(KB=64, BN=256, S=4, mtiles=32, ntiles=16)),
    (131072, 384, 1536, 1, dict(KB=3, BN=256, S=4, mtiles=1024, ntiles=6)),
    (131072, 1536, 384, 2, dict(KB=24, BN=128, S=6, mtiles=1024, ntiles=3)),
    (128, 64, 128, 1, dict(KB=1, BN=128, S=6, mtiles=1, ntiles=1)),
    (128, 32, 128, 2, dict(KB=1, BN=128, S=6, mtiles=1, ntiles=1)),
    (128, 192, 128, 1, dict(KB=2, BN=128, S=6, mtiles=1, ntiles=1)),
    (128, 96, 128, 2, dict(KB=2, BN=128, S=6, mtiles=1, ntiles=1)),
    (1, 1024, 1024, 2, dict(KB=16, BN=256, S=4, mtiles=1, ntiles=4)),
], ids=["k11_vit_l14", "k11_vit_b32", "k11_hd32", "k13_k2048", "k13_int8",
        "k13_bf16", "k13_mlp1", "k13_mlp2_bf16", "one_box_int8",
        "one_box_bf16", "tail_int8", "tail_bf16", "one_row"])
def test_core_plan_at_the_shapes_k11_and_k13_give(M, K, N, in_bytes, want):
    """K11's projection (M = B N, K = Nout = D) and K13's shapes: 256-column
    tiles with a ring of four stages, or 128 columns with six, always
    within the 232,448 bytes a block may opt in to."""
    p = _plan(M, K, N, in_bytes)
    assert p is not None
    assert {k: p[k] for k in want} == want
    assert p["bytes"] <= SMEM_MAX
    # the next stage would not fit
    stage = 128 * 128 + p["BN"] * 128
    assert p["bytes"] + stage + 16 > SMEM_MAX


@pytest.mark.parametrize("M,K,N,in_bytes", [
    (0, 1024, 1024, 2),     # no rows
    (128, 0, 128, 2),       # no k
    (128, 48, 128, 2),      # 96 bytes: no multiple of 64
    (128, 100, 128, 1),     # 100 bytes
    (128, 64, 64, 2),       # N below a tile's 128
    (128, 64, 192, 2),      # N off 128
], ids=["no_rows", "no_k", "k_96_bytes", "k_100_bytes", "n_64", "n_192"])
def test_core_plan_refuses_what_the_core_cannot_take(M, K, N, in_bytes):
    assert _plan(M, K, N, in_bytes) is None


def test_the_plan_mirror_reads_the_design_the_header_ships():
    """The mirror follows the header's choices: tiles of 128 rows and
    256 (else 128) columns, clusters of two CTAs along M sharing each bt
    box by multicast, the groups splitting the rows, 40 / 232
    registers after setmaxnreg (the launch's 168 x 384).  The header
    ships that design alone: its alternatives live as patches in
    scripts/gemm_sm90_variants.py."""
    core = CORE.read_text()
    assert _int("kRows") == 128 and _int("kBoxBytes") == 128
    assert _int("kCluster") == 2
    assert "p->BN = Nout % 256 == 0 ? 256 : 128;" in core
    assert "epilogue<KIND, BN>(d, sm, &c_map, m * kRows + 64 * c, n * BN," in core
    for switch in ("kTileN", "kSplitCols", "kClusterM", "if constexpr (kCluster"):
        assert switch not in core, switch
    assert _int("kSmemMax") == SMEM_MAX
    loader, consumer = _int("kLoaderRegs"), _int("kConsumerRegs")
    assert loader % 8 == 0 and consumer % 8 == 0
    assert 128 * loader + 256 * consumer <= 168 * 384


# ---------------------------------------------------------------------------
# The epilogue's staging boxes
# ---------------------------------------------------------------------------


def _swizzle128(row, byte):
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _epilogue(out_bytes, MH, NW):
    """Where group c's epilogue puts each accumulator value: {(row of the
    group's rows, column of its columns): (staging round, box, byte of the
    box)}, as ``epilogue<KIND, MH, NW>`` writes it, and each box's TMA store
    origin (row, column) in the same frame."""
    cols = 128 // out_bytes
    per_half = NW // cols
    boxes = MH * per_half
    bufs = _int("kOutBufs")
    placed, origin = {}, {}
    for warp in range(4):
        for lane in range(32):
            g, cc = lane >> 2, lane & 3
            r = 16 * warp + g
            for q0 in range(0, boxes, bufs):
                for i in range(bufs):
                    q = q0 + i
                    h, qc = q // per_half, q % per_half
                    origin[(q0, i)] = (64 * h, qc * cols)
                    for t in range(cols // 8):
                        j = qc * (cols // 8) + t
                        byte = (8 * t + 2 * cc) * out_bytes
                        for e, (dr, dc) in enumerate(
                                ((0, 0), (0, 1), (8, 0), (8, 1))):
                            key = (64 * h + r + dr, 8 * j + 2 * cc + dc)
                            assert key not in placed
                            addr = _swizzle128(r + dr, byte + dc * out_bytes)
                            placed[key] = (q0, i, addr)
    return placed, origin


@pytest.mark.parametrize("out_bytes", [4, 2], ids=["f32_s32", "bf16"])
@pytest.mark.parametrize("BN", [128, 256])
@pytest.mark.parametrize("split_cols", [False, True], ids=["rows", "cols"])
def test_every_accumulator_value_reaches_the_box_its_store_reads(
        out_bytes, BN, split_cols):
    """Each of the group's MH x 64 rows x NW columns lands once, each
    staging box's 8 KB are written once a round, and the value at (row,
    column) sits where the box's TMA store (128-byte swizzle, origin at
    its round's row and column) reads that element."""
    MH, NW = (2, BN // 2) if split_cols else (1, BN)
    placed, origin = _epilogue(out_bytes, MH, NW)
    assert set(placed) == {(r, c) for r in range(64 * MH) for c in range(NW)}
    per_box = {}
    for (row, col), (q0, i, addr) in placed.items():
        per_box.setdefault((q0, i), []).append(addr)
        r0, c0 = origin[(q0, i)]
        rr, byte = row - r0, (col - c0) * out_bytes
        assert 0 <= rr < 64 and 0 <= byte < 128
        assert addr == _swizzle128(rr, byte)
    for addrs in per_box.values():
        assert sorted(addrs) == list(range(0, 64 * 128, out_bytes))


@pytest.mark.parametrize("out_bytes", [4, 2], ids=["f32_s32", "bf16"])
def test_a_warps_staging_stores_take_the_fewest_wavefronts(out_bytes):
    """One store instruction of a warp (one t, one row half) writes 32 x
    out_bytes x 2 bytes; the swizzle spreads its rows so that no 4-byte
    bank is hit more often than those bytes force."""
    cols = 128 // out_bytes
    for t in range(cols // 8):
        for warp in range(4):
            banks = {}
            for lane in range(32):
                g, cc = lane >> 2, lane & 3
                addr = _swizzle128(16 * warp + g, (8 * t + 2 * cc) * out_bytes)
                for w in range(out_bytes * 2 // 4):
                    bank = (addr // 4 + w) % 32
                    banks[bank] = banks.get(bank, 0) + 1
            assert max(banks.values()) == out_bytes * 2 * 32 // 128


# ---------------------------------------------------------------------------
# The core's arithmetic, emulated in torch
# ---------------------------------------------------------------------------


def _core(a, bt, out_dtype):
    """The core on CPU tensors: K zero-padded to whole 128-byte boxes, the
    sum taken box by box into an f32 (int8: int64, exact) accumulator, the
    output as the kind writes it (bf16 rounded once from the f32 sum)."""
    box = 128 // a.element_size()
    K = a.shape[1]
    KB = -(-K // box)
    pad = KB * box - K
    a = torch.nn.functional.pad(a, (0, pad))
    bt = torch.nn.functional.pad(bt, (0, pad))
    exact = a.dtype == torch.int8
    acc = torch.zeros(a.shape[0], bt.shape[0],
                      dtype=torch.int64 if exact else torch.float32)
    for b in range(KB):
        ks = slice(b * box, (b + 1) * box)
        if exact:
            acc += a[:, ks].long() @ bt[:, ks].long().t()
        else:
            acc += a[:, ks].float() @ bt[:, ks].float().t()
    return acc.to(out_dtype)


@pytest.mark.parametrize("K", [64, 192, 384], ids=["one_box", "tail", "three"])
def test_core_emulation_is_the_plain_int8_product_and_the_pallas_gemm(K):
    """int8: the box-by-box sum with a zero-filled tail is exactly
    ``_tiled_matmul_plain`` and the tool's ``pallas_matmul`` in interpret
    mode (K = 64 is one 64-byte box, 192 ends half a box in)."""
    rng = np.random.default_rng(K)
    M, N = 128, 256
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _core(ta, tb.t().contiguous(), torch.int32)
    assert torch.equal(got, tg._tiled_matmul_plain(ta, tb, torch.int32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_matmul()(jnp.asarray(a), jnp.asarray(b),
                                           128, 128, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [32, 96, 384], ids=["one_box", "tail", "six"])
def test_core_emulation_in_bf16_matches_the_plain_product_and_the_pallas_gemm(K):
    """bf16 -> f32: the box-by-box f32 sum against the plain product and
    ``pallas_matmul`` in interpret mode, within 2e-5 of the scale (f32
    sums in other orders)."""
    rng = np.random.default_rng(K)
    M, N = 128, 256
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = _core(ta, tb.t().contiguous(), torch.float32)
    plain = tg._tiled_matmul_plain(ta, tb, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_matmul()(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), 128,
            128, jnp.float32))
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 2e-5 * scale
    assert float(np.abs(got.numpy() - want).max()) <= 2e-5 * scale


@pytest.mark.parametrize("B,N,D,H", [(2, 50, 128, 2), (1, 129, 256, 8)],
                         ids=["hd64", "hd32"])
def test_k11_two_launches_match_the_plain_version_and_the_pallas_kernel(
        B, N, D, H):
    """K11 in bf16 as its two launches compute it: K6's output o rounded
    to bf16, then the core's bf16 kind on o and W_out^T (the f32 sum box by
    box, rounded once), against ``_flash_proj_plain`` and the JAX
    ``_flash_proj_pallas`` in interpret mode, within KERNEL_REL_TOL."""
    rng = np.random.default_rng(N)
    qkv = rng.normal(size=(B, N, 3 * D)).astype(np.float32)
    w = (rng.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
    tq, tw = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(w).bfloat16()
    scale = (D // H) ** -0.5
    o = ca._flash_plain(tq, scale, H).reshape(B * N, D)
    got = _core(o, tw.t().contiguous(), torch.bfloat16).reshape(B, N, D)
    plain = ca._flash_proj_plain(tq, tw, scale, H)
    want = np.asarray(jca._flash_proj_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), scale,
        H, 2, interpret=True).astype(jnp.float32))
    ref = float(plain.float().abs().max())
    assert float((got.float() - plain.float()).abs().max()) <= \
        KERNEL_REL_TOL * ref
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        KERNEL_REL_TOL * ref


# ---------------------------------------------------------------------------
# Routing, with the C entries replaced by recorders
# ---------------------------------------------------------------------------


def _c_body(lib, entry):
    m = re.search(r'extern "C" int ' + entry + r"\(.*?\n\}",
                  (_build.CSRC / f"{lib}.cu").read_text(), re.S)
    assert m, entry
    return m.group(0)


def _recorder(monkeypatch):
    """Every C entry replaced by a recorder of (library, entry, arguments);
    the stream is 0."""
    calls = []

    def fake_entry(lib, name=None):
        def launch(*args):
            calls.append((lib, name, args))
            return 0
        return launch

    monkeypatch.setattr(_build, "entry", fake_entry)
    return calls


def _host_qkv_check(monkeypatch):
    """``_check_qkv`` keeps its dtype and layout rules but not the device
    one, so the wrapper runs here up to its launch."""
    monkeypatch.setattr(ca, "_stream", lambda: 0)
    monkeypatch.setattr(ca, "_check_qkv", lambda qkv, h: (
        ca._act_dtype(qkv=qkv), ca._qkv_layout(
            tuple(qkv.shape), qkv.stride(), 0, qkv.element_size(), h))[1])


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "clip_flash_proj_bf16"),
    (torch.float32, "clip_flash_proj_f32"),
], ids=["bf16", "f32"])
def test_k11_routes_bf16_to_k6_and_the_core_and_f32_to_the_twin(
        monkeypatch, dtype, entry):
    """One call launches the entry of qkv's dtype once and counts one K11
    launch and no K6 launch.  In bf16 it hands the entry a (B, N, D)
    scratch beside out (two allocations of that shape), and the entry's
    body runs K6's kernel into it, then the core's bf16 kind over its B N
    rows; in f32 it hands the entry one bf16 scratch of 6 B N D elements
    (k's and v's planes, then o's) and w_proj^T as its (2, D, D) bf16 planes, and
    the body runs K6's f32 kind into o's planes, then the core's kSplitF32
    kind on them."""
    calls = _recorder(monkeypatch)
    _host_qkv_check(monkeypatch)
    empties = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        one = shape[0] if len(shape) == 1 else shape
        empties.append((tuple(one) if isinstance(one, (tuple, list)) else one,
                        kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    splits = []
    real_split = ca._split_bf16

    def split(w):
        splits.append(tuple(w.shape))
        return real_split(w)

    monkeypatch.setattr(ca, "_split_bf16", split)
    B, N, D, H = 3, 50, 256, 4
    qkv = torch.zeros(B, N, 3 * D, dtype=dtype)
    # a CUDA-looking weight: the wrapper checks only is_cuda and alignment
    w = torch.zeros(D, D, dtype=dtype)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    ca.reset_launches()
    out = ca._flash_proj_cuda(qkv, w, 0.125, H)
    assert out.shape == (B, N, D) and out.dtype == dtype
    assert ca.LAUNCHES == {"_flash_cuda": 0, "_flash_proj_cuda": 1}
    (lib, name, args), = calls
    assert (lib, name) == ("clip_flash_proj", entry)
    assert args[4:9] == (B, N, H, D // H, 0.125)
    scratch = [e for e in empties if e == ((B, N, D), dtype)]
    body = _c_body("clip_flash_proj", entry)
    if dtype == torch.bfloat16:
        assert isinstance(args[2], int) and args[2] != args[3]
        assert len(scratch) == 2
        assert "gg::clip::sm90::run<HD>(qkv, attn, B, N, H, scale, s)" in body
        assert ("gg::gemm90::run<gg::gemm90::kBf16Bf16>(attn, wt, out, "
                "B * N, D, D, s)") in body
    else:
        assert isinstance(args[2], int) and args[2] != args[3]
        assert len(scratch) == 1 and splits == [(D, D)]
        assert (6 * B * N * D, torch.bfloat16) in empties
        assert "void* o2 = static_cast<gg::bf16*>(attn) + 4L * B * N * D;" in body
        assert ("gg::clip::sm90::run_f32<HD, true>(qkv, attn, o2, B, N, H, "
                "scale, s)") in body
        assert ("gg::gemm90::run<gg::gemm90::kSplitF32>(o2, wt, out, "
                "B * N, D, D, s)") in body


@pytest.mark.parametrize("dtype,entry,kind,out_dtype", [
    (torch.int8, "tiled_gemm_s8", "kS8S32", torch.int32),
    (torch.bfloat16, "tiled_gemm_bf16", "kBf16F32", torch.float32),
], ids=["int8", "bf16"])
def test_k13_routes_each_type_to_its_kind_of_the_core(monkeypatch, dtype,
                                                      entry, kind, out_dtype):
    """int8 reaches ``tiled_gemm_s8``, bf16 ``tiled_gemm_bf16``; each body
    runs its kind of the core with (M, K, N) in the core's order, and b
    goes over transposed, K-major."""
    calls = _recorder(monkeypatch)
    monkeypatch.setattr(tg, "_stream", lambda: 0)
    monkeypatch.setattr(tg, "_check", lambda name, t, shape, dt: t)
    M, K, N = 256, 192, 384
    a = torch.zeros(M, K, dtype=dtype)
    b = torch.zeros(K, N, dtype=dtype)
    tg.reset_launches()
    out = tg._tiled_matmul_cuda(a, b, out_dtype)
    assert out.shape == (M, N) and out.dtype == out_dtype
    assert tg.LAUNCHES["_tiled_matmul_cuda"] == 1
    (lib, name, args), = calls
    assert (lib, name) == ("tiled_gemm", entry)
    assert args[3:6] == (M, N, K)
    body = _c_body("tiled_gemm", entry)
    assert f"gg::gemm90::run<gg::gemm90::{kind}>(a, bt, c, M, K, N," in body


@pytest.mark.parametrize("M,K,N,dtype", [
    (100, 64, 128, torch.int8),
    (128, 64, 100, torch.int8),
    (128, 48, 128, torch.int8),
    (128, 48, 128, torch.bfloat16),
    (128, 40, 128, torch.bfloat16),
], ids=["m_100", "n_100", "k_48_bytes", "k_96_bytes", "k_80_bytes"])
def test_k13_refuses_before_its_launch(monkeypatch, M, K, N, dtype):
    calls = _recorder(monkeypatch)
    tg.reset_launches()
    with pytest.raises(ValueError, match="multiples of 128"):
        tg._tiled_matmul_cuda(torch.zeros(M, K, dtype=dtype),
                              torch.zeros(K, N, dtype=dtype),
                              tg.OUT_DTYPES[dtype])
    assert calls == [] and tg.LAUNCHES["_tiled_matmul_cuda"] == 0


def test_k11_refuses_what_neither_entry_takes(monkeypatch):
    """D off 128 (in bf16 and in f32), a w_proj of another shape and
    float16 are refused before any launch; both dtypes take all D channels
    at once (the core streams K: no head chunks), and both C entries refuse
    D off 128 themselves."""
    calls = _recorder(monkeypatch)
    _host_qkv_check(monkeypatch)
    ca.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        odd = torch.zeros(2, 50, 3 * 192, dtype=dtype)
        with pytest.raises(ValueError, match="multiple of 128"):
            ca._flash_proj_cuda(odd, torch.zeros(192, 192), 0.125, 3)
    qkv = torch.zeros(2, 50, 3 * 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w_proj"):
        ca._flash_proj_cuda(qkv, torch.zeros(64, 128), 0.125, 2)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        ca._flash_proj_cuda(qkv.half(), torch.zeros(128, 128), 0.125, 2)
    assert calls == [] and ca.LAUNCHES["_flash_proj_cuda"] == 0
    for entry in ("clip_flash_proj_bf16", "clip_flash_proj_f32"):
        assert "if (D % 128) return (int)cudaErrorInvalidValue;" in _c_body(
            "clip_flash_proj", entry)
    assert not hasattr(ca, "_flash_proj_chunk")


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,ns", [("gemm_sm90.cuh", "gemm90"),
                                     ("clip_flash_sm90.cuh", "sm90")])
def test_the_new_headers_keep_everything_in_an_unnamed_namespace(name, ns):
    """Each library that includes them keeps its own launchers and opt-in
    flags (no GNU-unique symbol)."""
    src = (_build.CSRC / name).read_text()
    assert f"namespace {ns} {{\nnamespace {{\n" in src
    assert f"}}  // namespace\n}}  // namespace {ns}\n" in src


def test_one_mainloop_serves_both_kernels():
    """K13's two entries and K11's bf16 entry include the one core and
    define no kernel of their own for it; the core issues bf16 and int8
    wgmma on TMA-loaded stages and stores by TMA; K6's Hopper kernel lives
    in its header, which both CLIP libraries include."""
    core = CORE.read_text()
    for piece in ("wgmma_m64n256k16_ss(", "wgmma_m64n256k32_s8_ss(",
                  "tma_load(", "store_tile_tma(", "setmaxnreg.dec",
                  "setmaxnreg.inc", "mbar_wait(sm.empty", "wait_phase(sm.full",
                  "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert piece in core, piece
    sm90 = (_build.CSRC / "sm90.cuh").read_text()
    assert ".m64n256k32.s32.s8.s8" in sm90 and ".m64n256k16.f32.bf16.bf16" in sm90
    for lib in ("tiled_gemm", "clip_flash_proj"):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert '#include "gemm_sm90.cuh"' in src
        # no kernel of their own: K11's f32 entry runs the core's split kind
        assert src.count("__global__") == 0
    for entry in ("clip_flash_proj_bf16", "clip_flash_proj_f32",
                  "clip_flash_proj_gemm_f32"):
        assert "<<<" not in _c_body("clip_flash_proj", entry)
    for lib in ("clip_flash", "clip_flash_proj"):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert '#include "clip_flash_sm90.cuh"' in src
        assert "clip_flash_sm90(" not in src
    assert "__global__ void __launch_bounds__(kThreads, 1)\nclip_flash_sm90(" \
        in K6_HEADER.read_text()


def test_the_core_ablations_still_apply():
    """Every edit of scripts/gemm_sm90_variants.py finds its anchor in the
    header as the script applies them, in order, so the alternatives and
    ablations the PERF numbers come from still build: no cluster, 128-column
    tiles, fewer stages, the groups splitting the columns."""
    path = _build.CSRC.parents[2] / "scripts" / "gemm_sm90_variants.py"
    spec = importlib.util.spec_from_file_location("gemm_sm90_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    header = CORE.read_text()
    assert {"cluster_1", "tile_128", "stages_3", "split_cols", "no_stores",
            "no_products", "no_loads"} <= set(module.VARIANTS)
    patched = {}
    for name, edits in module.VARIANTS.items():
        text = header
        for old, new in edits:
            assert old in text, name
            text = text.replace(old, new)
        assert text != header, name
        patched[name] = text
    assert "constexpr int kCluster = 1;" in patched["cluster_1"]
    assert "tma_load_multicast(" not in patched["cluster_1"]
    assert "stage_products<BN>(" not in patched["split_cols"]
    assert patched["split_cols"].count("epilogue<KIND, BN / 2>(") == 2


@pytest.mark.parametrize("kernel_name,group", [
    ("void gg::gemm90::(anonymous namespace)::gemm_sm90<2, 256>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, gg::gemm90::(anonymous namespace)::Plan)",
     "GEMM core (K11/K13 CUDA)"),
    ("void gg::clip::sm90::(anonymous namespace)::clip_flash_sm90<64>("
     "CUtensorMap, __nv_bfloat16*, int, int, int, float)",
     "CLIP attention (K6/K11 CUDA)"),
    ("void gg::gemm90::(anonymous namespace)::gemm_sm90<3, 256>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, gg::gemm90::(anonymous namespace)::Plan)",
     "GEMM core (f32 K11 CUDA)"),
    ("void gg::clip::sm90::(anonymous namespace)::clip_flash_f32_sm90<64, "
     "true>(CUtensorMap, void*, int, int, int, float)",
     "CLIP attention (f32 K6/K11 CUDA)"),
    ("void gg::clip::sm90::(anonymous namespace)::split_kv(float4 const*, "
     "uint2*, uint2*, long, int)", "k/v split (f32 K6/K11 CUDA)"),
    ("void gg::lng90::(anonymous namespace)::ln_gemm_sm90<3, 1, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, "
     "float const*, gg::lng90::(anonymous namespace)::Plan, float)",
     "LN+GEMM (K1/K2/K9 CUDA)"),
])
def test_profile_groups_name_the_core_and_k6(kernel_name, group):
    from geoguessr_ai_torch import profile_forward

    assert profile_forward._group(kernel_name) == group

"""The window-attention tile knobs of the port (``ops/window_attention.py``
``TILE_KNOBS``) on the CPU, held against the JAX package's knobs.

The knobs pick the Hopper cores' tiles: SMEM_LIMIT_BYTES (VMEM_LIMIT_BYTES),
FUSED_BLOCK_WB and FUSED_BLOCK_SCORE_BYTES (the JAX names), BWD_PARTIAL_BYTES
(_BWD_STACK_BYTES), BWD_Q_ROWS (_BWD_BLOCK_Q) and FWD_Q_ROWS (S2_BLOCK_Q,
BLOCK_Q).  What is checked here, where there is no ``nvcc`` and no card:
the plan mirrors (items, groups, shared memory) at the production shapes,
against the constants of the CUDA headers; that FUSED_BLOCK_WB takes the
JAX package's windows a grid cell, read from the grid of the JAX kernels'
``pallas_call`` under ``jax.make_jaxpr``; the refusals; which entry each
bf16 call reaches; that the plain versions do not read the knobs; and that
the port's ``tools.exp_r4_vmem`` maps every knob of the JAX tool's cases.
The kernels themselves run on the card (``chip_smoke.py`` phase 34).
"""

import ast
import os
import re

import pytest
import torch

import jax
import jax.numpy as jnp

import geoguessr_ai_tpu.ops.window_attention as J

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa
from geoguessr_ai_torch.tools import exp_r4_vmem as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1024 * 1024


@pytest.fixture(autouse=True)
def _knobs_restored(monkeypatch):
    """Every test leaves both packages' knobs as it found them."""
    for name in wa.TILE_KNOBS:
        monkeypatch.setattr(wa, name, getattr(wa, name))
    for name in ("FUSED_BLOCK_WB", "FUSED_BLOCK_SCORE_BYTES"):
        monkeypatch.setattr(J, name, getattr(J, name))


def _knobs(**values):
    for name, value in values.items():
        setattr(wa, name, value)
    return wa.tile_knobs()


def _header(name):
    return (_build.CSRC / name).read_text()


def test_the_defaults_give_todays_plans():
    """At the defaults the groups are those of PR 9's and PR 10's cores:
    _bwd_groups 21 / 7 / 1 (K4 stages 1 and 3, K7 at stage 2) and
    _headmajor_groups 42 / 14 / 2, and every call takes its ``_bf16``
    entry."""
    knobs = wa.tile_knobs()
    assert {k: d for k, (d, _) in wa.TILE_KNOBS.items()} == knobs
    assert [wa._bwd_call_plan(k, W, N, H, 32, knobs)["G"]
            for k, W, N, H in (("K4", 1024, 256, 6), ("K4", 64, 256, 18),
                               ("K7", 64, 1024, 12))] == [21, 7, 1]
    assert wa._bwd_call_plan("K5", 64, 1024, 12, 32, knobs)["G"] == 1
    assert [wa._fwd_call_plan("K3", W, H, 256, 32, knobs)["groups"]
            for W, H in ((1024, 6), (64, 18), (4, 18))] == [42, 14, 2]
    for kernel in ("K1", "K2", "K3", "K8a", "K8b", "K9"):
        plan = wa._fwd_call_plan(kernel, 64, 12, 256, 32, knobs)
        assert plan["entry"].endswith("_bf16") and "q128" not in plan["entry"]


@pytest.mark.parametrize("W,N,H", [(1024, 256, 6), (64, 256, 18),
                                   (1024, 64, 4), (64, 256, 5), (64, 64, 10),
                                   (64, 1024, 12)])
def test_bwd_plan_mirror_at_the_production_shapes(W, N, H):
    """The backward core at 128 rows: R = ceil(N / 128) row tiles, items
    R W H of stats, dkdv and dq and (N / 64) R G H of dbias, 191616 bytes
    (216 KB less a ring of 6 slots) and 130208 in dbias with the bf16
    bias.  At 64 rows: twice the row tiles, two pipes a block each with
    its rings, 212192 and 185664 bytes; the f32 bias (K5, K7) 191648 at 64
    rows.  The groups count items of the kind's rows."""
    for rows in (128, 64):
        knobs = _knobs(BWD_Q_ROWS=rows)
        plan = wa._bwd_call_plan("K4", W, N, H, 32, knobs)
        tiles = -(-N // rows)
        G = max(1, min(W, 1024 // ((N // 64) * tiles * H)))
        assert plan["G"] == G == wa._bwd_groups(W, N, H, rows)
        assert plan["items"] == {"stats": tiles * W * H, "dkdv": tiles * W * H,
                                 "dq": tiles * W * H,
                                 "dbias": (N // 64) * tiles * G * H}
        want = {128: (191616, 130208), 64: (212192, 185664)}[rows]
        assert plan["smem"] == {"stats": want[0], "dkdv": want[0],
                                "dq": want[0], "dbias": want[1]}
        assert max(plan["smem"].values()) <= 232448
    f32 = wa._bwd_call_plan("K7", W, N, H, 32, _knobs(BWD_Q_ROWS=64))
    assert f32["smem"]["stats"] == 191648 and f32["stages"]["stats"] == 3


def test_bwd_smem_mirror_follows_the_header():
    """The mirror's budget, ring depth and row slot are the header's."""
    src = _header("attention_bwd_sm90.cuh")
    assert ("(216 * 1024 - 1024 - kPipes * kRowBufs * kRowBuf) / "
            "(kPipes * kStage)") in src
    assert "kStages = kFit < 6 ? kFit : 6" in src
    assert "kRowBuf = kRowStats + 1024 * kRowTiles" in src
    assert "kBytes = 1024 + kBarOffset + kPipes * kPipeBars" in src
    assert re.search(r"kRows64HeadDim = (\d+)", src).group(1) == str(
        wa.TILE_KIND_HEAD_DIM)
    assert wa._bwd_smem(32, 2)["stats"] == (191616, 6)  # PR 9's plan


def test_bwd_partial_bytes_sets_the_groups():
    """BWD_PARTIAL_BYTES: G = max(1, min(W, bytes // (H N^2 4))), the
    (G, H, N, N) f32 partials within it; 4 MiB at K4's stage 3 (H N^2 4 =
    4.5 MiB) is one group, no partials.  K5 keeps one group."""
    knobs = _knobs(BWD_PARTIAL_BYTES=4 * MIB)
    assert wa._bwd_call_plan("K4", 64, 256, 18, 32, knobs)["G"] == 1
    assert wa._bwd_scratch_shapes(64, 256, 18, 1)["partial"] is None
    assert wa._bwd_call_plan("K4", 1024, 256, 6, 32, knobs)["G"] == 2
    assert wa._bwd_call_plan("K7", 64, 1024, 12, 32, _knobs(
        BWD_PARTIAL_BYTES=200 * MIB))["G"] == 4
    assert wa._bwd_call_plan("K5", 64, 1024, 12, 32, knobs)["G"] == 1


@pytest.mark.parametrize("kernel,W,H,N,want", [
    # (smem, items, G, NT, NB, QB, S, stream) at 64 rows, then at 128
    ("K2", 64, 12, 1024, ((230800, 960, 5, 4, 1, 2, 10, 0),
                          (165280, 960, 10, 2, 2, 4, 16, 1))),
    ("K3", 64, 18, 256, ((214624, 1008, 14, 4, 2, 2, 16, 0),
                         (165280, 1008, 28, 2, 2, 4, 16, 1))),
    ("K8a", 64, 12, 1024, ((231072, 3072, 16, 2, 2, 4, 16, 1),
                           (230816, 960, 10, 2, 2, 4, 16, 1))),
    ("K8b", 1024, 6, 256, ((230816, 1008, 42, 4, 2, 2, 10, 0),
                           (230816, 1020, 85, 2, 2, 4, 16, 1))),
    ("K1", 1024, 6, 256, ((214624, 1008, 42, 4, 2, 2, 16, 0),
                          (165280, 1020, 85, 2, 2, 4, 16, 1))),
])
def test_fwd_plan_mirror_at_the_production_shapes(kernel, W, H, N, want):
    """The forward core's plan as make_plan builds it: at 64 rows the
    resident 64 x N bias tile (K8a's f32 tile at N = 1024 streamed over
    ceil(W / 4) groups), at 128 rows the shared ring, the bias streamed in
    128 x 128 chunks (32 KB bf16, 64 KB f32), four q buffers a group, the
    groups of 128-row items; every plan within the 227 KB a block may opt
    into."""
    keys = ("smem", "items", "G", "NT", "NB", "QB", "S", "stream")
    for rows, expect in zip((64, 128), want):
        plan = wa._fwd_call_plan(kernel, W, H, N, 32, _knobs(FWD_Q_ROWS=rows))
        assert tuple(plan[k] for k in keys) == expect
        assert plan["groups"] == wa._headmajor_groups(W, H, N, rows)
        assert plan["entry"].endswith("q128_bf16" if rows == 128 else "_bf16")


def test_fwd_plan_mirror_follows_the_header():
    """The mirror's limits and formulas are make_plan's."""
    src = _header("attention_fwd_sm90.cuh")
    assert f"kSmemMax = {wa._FWD_SMEM_MAX}" in src
    assert f"kMaxSlots = {wa._FWD_MAX_SLOTS}" in src
    assert re.search(r"kRows128HeadDim = (\d+)", src).group(1) == str(
        wa.TILE_KIND_HEAD_DIM)
    assert "return 8 * (2 * NB + 2 * (2 * QB + rings() * S));" in src
    assert ("int smem_bytes() const { return 1024 + NB * bias + "
            "(2 * QB + rings() * S) * tile + barrier_bytes(); }") in src
    assert "p->bias = rows * kRows * p->NT * bias_elem;" in src
    # the resident plan of PR 11 at the K3 stage-3 shape
    assert wa._fwd_plan(64, 18, 256, 14, 32, 2, False)["smem"] == 214624


def _jax_fused_block_wb(W, N, H, wb, score_bytes, window=None, rows=1):
    """The windows of a grid cell the JAX kernel takes under its knobs:
    from the grid of the pallas_call of ``_fused_block_pallas`` ((W //
    wb,)) or, given the ``window`` side, of ``_fb4d_pallas`` over one
    image of ``rows`` x W / rows windows ((1, rows, W / rows / wb)),
    traced by jax.make_jaxpr on abstract inputs in interpret mode."""
    J.FUSED_BLOCK_WB = wb
    J.FUSED_BLOCK_SCORE_BYTES = score_bytes
    C = H * 32
    S = jax.ShapeDtypeStruct
    f32, bf = jnp.float32, jnp.bfloat16
    weights = (S((C,), f32), S((C,), f32), S((C, 3 * C), bf),
               S((3 * C,), f32), S((C, C), bf), S((C,), f32), S((H, N, N), f32))
    if window is None:
        fn = lambda *a: J._fused_block_pallas(*a, 0.1, H, 1e-5,  # noqa: E731
                                               interpret=True)
        x = S((W, N, C), bf)
    else:
        fn = lambda *a: J._fb4d_pallas(*a, 0.1, H, 1e-5, window,  # noqa: E731
                                        interpret=True)
        x = S((1, rows * window, (W // rows) * window, C), bf)
    jaxpr = jax.make_jaxpr(fn)(x, *weights)
    (grid,) = [e.params["grid_mapping"].grid for e in jaxpr.jaxpr.eqns
               if e.primitive.name == "pallas_call"]
    return (W // grid[0]) if window is None else (W // rows) // grid[2]


@pytest.mark.parametrize("W,N,H,wb,score_bytes", [
    (64, 256, 6, 4, 8 * MIB), (64, 256, 18, 4, 8 * MIB),
    (64, 256, 6, 8, 32 * MIB), (64, 256, 18, 8, 32 * MIB),
    (24, 64, 2, 8, 32 * MIB), (12, 64, 2, 5, 8 * MIB), (7, 64, 2, 8, MIB)])
def test_fused_block_wb_takes_the_jax_rule(W, N, H, wb, score_bytes):
    """K1's windows a group under FUSED_BLOCK_WB and FUSED_BLOCK_SCORE_BYTES
    are the JAX kernel's windows a grid cell, and G = W / wb."""
    want = _jax_fused_block_wb(W, N, H, wb, score_bytes)
    knobs = _knobs(FUSED_BLOCK_WB=wb, FUSED_BLOCK_SCORE_BYTES=score_bytes)
    assert wa._fused_block_wb(W, N, H, knobs) == want
    assert wa._fwd_call_plan("K1", W, H, N, 32, knobs)["groups"] == W // want


@pytest.mark.parametrize("rows,cols,window,wb", [(2, 6, 8, 8), (1, 4, 8, 3),
                                                  (2, 3, 16, 8)])
def test_fb4d_wb_divides_a_map_row_as_the_jax_rule(rows, cols, window, wb):
    """K9 lowers wb to a divisor of the windows of a map row, as
    _fb4d_pallas does (a map of rows x cols windows, one image)."""
    N, H = window * window, 2
    W = rows * cols
    want = _jax_fused_block_wb(W, N, H, wb, 32 * MIB, window, rows)
    knobs = _knobs(FUSED_BLOCK_WB=wb, FUSED_BLOCK_SCORE_BYTES=32 * MIB)
    assert wa._fused_block_wb(W, N, H, knobs, cols) == want
    assert wa._fwd_call_plan("K9", W, H, N, 32, knobs, cols)["groups"] == (
        W // want)


@pytest.mark.parametrize("name,value", [
    ("BWD_Q_ROWS", 96), ("BWD_Q_ROWS", 256), ("FWD_Q_ROWS", 32),
    ("FWD_Q_ROWS", True), ("SMEM_LIMIT_BYTES", 0), ("FUSED_BLOCK_WB", -1),
    ("FUSED_BLOCK_SCORE_BYTES", None), ("BWD_PARTIAL_BYTES", 1.5)])
def test_out_of_range_values_raise_naming_the_knob(name, value):
    """A value the cores cannot take raises ValueError naming the knob and
    its values, here on the CPU, from the checks and from the ops."""
    setattr(wa, name, value)
    with pytest.raises(ValueError, match=name + ".*take"):
        wa.tile_knobs()
    qkv = torch.zeros(2, 64, 3 * 64)
    with pytest.raises(ValueError, match=name):
        wa.window_attention_qkv(qkv, torch.zeros(2, 64, 64), 0.25, 2)


def test_other_kinds_refuse_what_they_are_not_built_for():
    """The 64-row backward kind and the 128-row forward kind are built at
    hd 32; the forward kind takes N a multiple of 128."""
    with pytest.raises(ValueError, match="BWD_Q_ROWS=64"):
        wa._bwd_call_plan("K4", 64, 256, 4, 64, _knobs(BWD_Q_ROWS=64))
    knobs = _knobs(FWD_Q_ROWS=128)
    with pytest.raises(ValueError, match="FWD_Q_ROWS=128"):
        wa._fwd_call_plan("K3", 64, 4, 256, 16, knobs)
    with pytest.raises(ValueError, match="FWD_Q_ROWS=128"):
        wa._fwd_call_plan("K8b", 64, 6, 192, 32, knobs)


def test_smem_limit_refuses_every_plan_above_it():
    """SMEM_LIMIT_BYTES = 48 KiB refuses every bf16 core plan, forward and
    backward, of either kind; the card's 227 KB refuses none."""
    for rows_fwd, rows_bwd in ((64, 128), (128, 64)):
        knobs = _knobs(SMEM_LIMIT_BYTES=48 * 1024, FWD_Q_ROWS=rows_fwd,
                       BWD_Q_ROWS=rows_bwd)
        for kernel in ("K4", "K5", "K7"):
            with pytest.raises(ValueError, match="SMEM_LIMIT_BYTES=49152"):
                wa._bwd_call_plan(kernel, 64, 256, 6, 32, knobs)
        for kernel in ("K1", "K2", "K3", "K8a", "K8b", "K9"):
            with pytest.raises(ValueError, match="SMEM_LIMIT_BYTES=49152"):
                wa._fwd_call_plan(kernel, 64, 6, 256, 32, knobs, 4)
    knobs = _knobs(SMEM_LIMIT_BYTES=232448, FWD_Q_ROWS=64, BWD_Q_ROWS=128)
    assert wa._fwd_call_plan("K2", 64, 12, 1024, 32, knobs)
    assert wa._bwd_call_plan("K5", 64, 1024, 12, 32, knobs)


def _fake_card(monkeypatch):
    """The wrappers run here up to their launch: ``_check`` keeps all but
    the device rule, and each C entry records its name and arguments."""
    calls = []

    def host_check(name, t, shape, dtype=torch.bfloat16):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        return t

    def fake_entry(lib, name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(wa, "_check", host_check)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(wa, "_stream", lambda: 0)
    return calls


def _bwd_call(kernel, dtype, W=64, N=256, H=6):
    qkv = torch.zeros(W, N, 3 * H * 32, dtype=dtype)
    g = torch.zeros(W, N, H * 32, dtype=dtype)
    fn = {"K4": wa._attention_qkv_bwd_cuda, "K5": wa._attention_bwd_merged_cuda,
          "K7": wa._attention_bwd_qtiled_cuda}[kernel]
    return fn(qkv, torch.zeros(H, N, N), g, 0.25, H)


def _fwd_call(kernel, dtype, W=64, N=256, H=6):
    C = H * 32
    if kernel in ("K8a", "K8b"):
        q = torch.zeros(W, H, N, 32, dtype=dtype)
        fn = (wa._attention_qtiled_cuda if kernel == "K8a"
              else wa._attention_batched_cuda)
        return fn(q, q, q, torch.zeros(H, N, N), 0.25)
    x = torch.zeros(W, N, C, dtype=dtype)
    vec, w = torch.zeros(C), torch.zeros(C, 3 * C, dtype=dtype)
    bias = torch.zeros(H, N, N)
    if kernel == "K3":
        return wa._attention_qkv_fused_cuda(
            torch.zeros(W, N, 3 * C, dtype=dtype), bias, 0.25, H)
    if kernel == "K2":
        return wa._fb_s2_cuda(x, vec, vec, w, torch.zeros(3 * C), bias, 0.25,
                              H, 1e-5)
    wp = torch.zeros(C, C, dtype=dtype)
    if kernel == "K9":
        return wa._fb4d_cuda(x.reshape(4, 64, 64, C), vec, vec, w,
                             torch.zeros(3 * C), wp, vec, bias, 0.25, H, 16,
                             1e-5)
    return wa._fused_block_cuda(x, vec, vec, w, torch.zeros(3 * C), wp, vec,
                                bias, 0.25, H, 1e-5)


@pytest.mark.parametrize("kernel", ["K4", "K5", "K7"])
def test_bwd_q_rows_64_reaches_the_64_row_entry(monkeypatch, kernel):
    """In bf16, BWD_Q_ROWS = 64 reaches ``<lib>_q64_bf16`` with the groups
    of 64-row items (K5: one); one launch counted."""
    calls = _fake_card(monkeypatch)
    _knobs(BWD_Q_ROWS=64)
    wa.reset_launches()
    _bwd_call(kernel, torch.bfloat16)
    ((entry, args),) = calls
    lib = {"K4": "attention_qkv_bwd", "K5": "attention_bwd_merged",
           "K7": "attention_bwd_qtiled"}[kernel]
    assert entry == f"{lib}_q64_bf16"
    # (..., W, N, H, hd[, G], scale, stream)
    if kernel == "K5":
        assert args[-6:-2] == (64, 256, 6, 32)
    else:
        assert args[-7:-2] == (64, 256, 6, 32, wa._bwd_groups(64, 256, 6, 64))
    assert sum(wa.LAUNCHES.values()) == 1
    assert _build.SIGNATURES[lib][entry] == _build.SIGNATURES[lib][
        f"{lib}_bf16"]


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K8a", "K8b", "K9"])
def test_fwd_q_rows_128_reaches_the_128_row_entry(monkeypatch, kernel):
    """In bf16, FWD_Q_ROWS = 128 reaches ``<fn>_q128_bf16`` with the
    groups of 128-row items; one launch counted."""
    calls = _fake_card(monkeypatch)
    _knobs(FWD_Q_ROWS=128)
    wa.reset_launches()
    _fwd_call(kernel, torch.bfloat16)
    ((entry, args),) = calls
    _, _, lib, fn = wa._FWD_KERNELS[kernel]
    assert entry == f"{fn}_q128_bf16"
    # (..., hd, groups, scale[, eps], stream)
    groups = args[-3] if kernel in ("K3", "K8a", "K8b") else args[-4]
    assert groups == wa._headmajor_groups(64, 6, 256, 128) == 32
    assert sum(wa.LAUNCHES.values()) == 1
    assert _build.SIGNATURES[lib][entry] == _build.SIGNATURES[lib][
        f"{fn}_bf16"]


def test_fused_block_wb_reaches_k1_and_k9(monkeypatch):
    """FUSED_BLOCK_WB = 8 under a 32 MiB budget hands K1 G = W / 8 and K9,
    whose map rows hold 4 windows, G = W / 4, through their default
    entries."""
    calls = _fake_card(monkeypatch)
    _knobs(FUSED_BLOCK_WB=8, FUSED_BLOCK_SCORE_BYTES=32 * MIB)
    for kernel in ("K1", "K9"):
        _fwd_call(kernel, torch.bfloat16)
    assert [c[0] for c in calls] == ["fused_block_bf16", "fb4d_bf16"]
    assert [args[-4] for _, args in calls] == [64 // 8, 64 // 4]


@pytest.mark.parametrize("name,value", [
    ("BWD_Q_ROWS", 64), ("FWD_Q_ROWS", 128), ("SMEM_LIMIT_BYTES", 100000),
    ("FUSED_BLOCK_WB", 8), ("BWD_PARTIAL_BYTES", MIB)])
def test_non_default_values_refuse_f32_calls(monkeypatch, name, value):
    """An f32 twin keeps its first design's tiles: each kernel that reads
    a knob refuses a non-default value of it in f32, naming it, before a
    launch; those that do not read it launch."""
    calls = _fake_card(monkeypatch)
    _knobs(**{name: value})
    for kernel in ("K1", "K2", "K3", "K4", "K5", "K7", "K8a", "K8b", "K9"):
        call = _bwd_call if kernel in ("K4", "K5", "K7") else _fwd_call
        if name in wa.KERNEL_KNOBS[kernel]:
            with pytest.raises(ValueError, match=f"{name}=.*f32"):
                call(kernel, torch.float32)
        else:
            call(kernel, torch.float32)
    assert all(entry.endswith("_f32") for entry, _ in calls)
    assert len(calls) == sum(name not in knobs
                             for knobs in wa.KERNEL_KNOBS.values())


def test_score_bytes_alone_is_refused(monkeypatch):
    """FUSED_BLOCK_SCORE_BYTES bounds an int FUSED_BLOCK_WB; beside None it
    would change nothing, so K1 and K9 refuse it."""
    _fake_card(monkeypatch)
    _knobs(FUSED_BLOCK_SCORE_BYTES=32 * MIB)
    with pytest.raises(ValueError, match="FUSED_BLOCK_SCORE_BYTES"):
        _fwd_call("K1", torch.bfloat16)


def test_the_plain_path_does_not_read_the_knobs():
    """On CPU tensors every op runs its plain version whatever valid
    values the knobs hold: the same outputs and gradients."""
    g = torch.Generator().manual_seed(0)
    W, N, H = 3, 64, 2
    qkv = torch.randn(W, N, 3 * H * 32, generator=g)
    bias = torch.randn(H, N, N, generator=g)
    q, k, v = (torch.randn(W, H, N, 32, generator=g) for _ in range(3))

    def run():
        a = qkv.clone().requires_grad_()
        b = bias.clone().requires_grad_()
        out = wa.window_attention_qkv(a, b, 0.2, H)
        out.square().sum().backward()
        return out.detach(), a.grad, b.grad, wa.window_attention(q, k, v,
                                                                 bias, 0.2)

    want = run()
    _knobs(SMEM_LIMIT_BYTES=48 * 1024, FUSED_BLOCK_WB=8,
           FUSED_BLOCK_SCORE_BYTES=MIB, BWD_PARTIAL_BYTES=MIB, BWD_Q_ROWS=64,
           FWD_Q_ROWS=128)
    for got, ref in zip(run(), want):
        assert torch.equal(got, ref)


def _jax_tool_cases():
    """The JAX tool's cases that set knobs, read from its syntax tree:
    name -> (embed or train, the knobs the case's call sets)."""
    path = os.path.join(REPO, "tools", "exp_r4_vmem.py")
    tree = ast.parse(open(path).read())
    (node,) = [n.value for n in tree.body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "CASES"]
    out = {}
    for key, lam in zip(node.keys, node.values):
        call = lam.body
        if call.func.id in ("embed_case", "train_case"):
            knobs = eval(compile(ast.Expression(call.args[0]), path, "eval"),
                         {"V64": 64 * MIB})
            out[key.value] = (call.func.id.split("_")[0], knobs)
    return out


#: Each JAX knob of the tool's cases and its port counterpart (None: no
#: counterpart).
JAX_TO_PORT = {"VMEM_LIMIT_BYTES": "SMEM_LIMIT_BYTES",
               "FUSED_BLOCK_WB": "FUSED_BLOCK_WB",
               "FUSED_BLOCK_SCORE_BYTES": "FUSED_BLOCK_SCORE_BYTES",
               "_BWD_STACK_BYTES": "BWD_PARTIAL_BYTES",
               "_BWD_BLOCK_Q": "BWD_Q_ROWS", "S2_BLOCK_Q": "FWD_Q_ROWS",
               "S2_HEAD_BATCHED": None, "S2_HEAD_BLOCK": None}


def test_every_knob_of_every_jax_case_has_a_port_counterpart_or_none():
    """KNOB_CASES holds each JAX case's knobs as the JAX tool sets them,
    what it runs, and maps every knob either to a port knob or to
    ``no_counterpart``, by the stated rule: the raised VMEM limit is the
    card's largest, a q tile above its JAX default the larger kind, the
    byte and window knobs as they are."""
    jax_cases = _jax_tool_cases()
    assert set(TV.KNOB_CASES) == set(jax_cases)
    for name, (run, knobs) in jax_cases.items():
        case = TV.KNOB_CASES[name]
        assert case["run"] == run and case["jax"] == knobs, name
        mapped = {JAX_TO_PORT[k] for k in knobs} - {None}
        assert set(case["port"]) == mapped, name
        assert set(case["no_counterpart"]) == {
            k for k in knobs if JAX_TO_PORT[k] is None}, name
        for jk, value in knobs.items():
            pk = JAX_TO_PORT[jk]
            if pk is None:
                continue
            got = case["port"][pk]
            if jk == "VMEM_LIMIT_BYTES":
                assert got is None
            elif jk == "S2_BLOCK_Q":
                assert got == (128 if value > TV.JAX_S2_BLOCK_Q else 64)
            elif jk == "_BWD_BLOCK_Q":
                assert got == (128 if value > TV.JAX_BWD_BLOCK_Q else 64)
            else:
                assert got == value
        _knobs(**case["port"])  # every value a valid one
    assert TV.JAX_S2_BLOCK_Q == J.S2_BLOCK_Q
    assert TV.JAX_BWD_BLOCK_Q == J._BWD_BLOCK_Q

"""The bf16 Hopper forward core (``csrc/attention_fwd_sm90.cuh``) of K3, K8a
and K8b on the CPU: its shared-memory plans, the streamed bias's schedule,
K3's layout rules, which entry each call reaches, the linkage of the
headers' host code, and a torch emulation of the kernels' softmax against
the plain versions and the JAX kernels in interpret mode.

In bf16 ``_attention_qkv_fused_cuda`` (K3) and ``_attention_qtiled_cuda``
(K8a) launch entries that run the core K8b runs: K3 reads the interleaved
(W, N, 3D) qkv through one tensor map with a bf16 bias tile resident over a
window group; K8a keeps its f32 bias tile resident where it fits, else
streams it in chunks of two 64-key tiles, each serving the four windows of
an item.  The f32 twins keep the first design.  The kernels themselves are
held against the plain versions on the card by tests/test_torch_port_cuda.py
(``-k fwd_sm90``) and chip_smoke.py.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

CORE = _build.CSRC / "attention_fwd_sm90.cuh"
SMEM_MAX = 232448
#: bf16 outputs: max |got - want| over max |want|, as the card tests hold
#: the kernels (a few bf16 ulps of the output's range).
KERNEL_REL_TOL = 2e-2


def _core_int(name):
    m = re.search(r"constexpr int " + name + r" = (\d+);", CORE.read_text())
    assert m, name
    return int(m.group(1))


def _chunk_tiles(C):
    return next(t for t in (4, 3, 2, 1) if C % t == 0)


def _plan(W, N, hd, bias_elem, may_stream):
    """A mirror of the core's ``make_plan``: a dict of the plan, or None
    where nothing fits.  Resident: the item's 64 x N bias tile, two buffers
    when they fit beside a ring of two chunks; streamed: chunks of
    kStreamTiles tiles (one when C is odd), groups of four windows, a ring
    that holds both windows' k and v tiles of a chunk."""
    max_slots = _core_int("kMaxSlots")
    C, tile = N // 64, 64 * hd * 2

    def fit(p, nb, need):
        bars = 8 * (2 * nb + 2 * (2 * p["QB"] + 2 * max_slots))
        slots = min((SMEM_MAX - 1024 - bars - nb * p["bias"]) // (2 * tile)
                    - p["QB"], max_slots)
        if slots < need:
            return None
        used = 1024 + nb * p["bias"] + 2 * (p["QB"] + slots) * tile + 8 * (
            2 * nb + 2 * (2 * p["QB"] + 2 * slots))
        return dict(p, NB=nb, S=slots, smem=used)

    p = dict(stream=False, QB=2, NT=_chunk_tiles(C), bias=64 * N * bias_elem,
             G=None)
    plan = fit(p, 2, 2 * p["NT"]) or fit(p, 1, p["NT"])
    if plan or not may_stream:
        return plan
    windows = 2 * _core_int("kStreamWindows")
    nt = _core_int("kStreamTiles") if C % _core_int("kStreamTiles") == 0 else 1
    p = dict(stream=True, QB=windows, NT=nt, bias=64 * 64 * nt * bias_elem,
             G=-(-W // windows))
    need = windows * nt  # two windows' k and v tiles
    return fit(p, 2, need) or fit(p, 1, need)


def test_the_plan_mirror_reads_the_core():
    src = CORE.read_text()
    assert "C % 4 == 0 ? 4 : C % 3 == 0 ? 3 : C % 2 == 0 ? 2 : 1" in src
    assert "fit_ring(p, 2, 2 * p->NT) || fit_ring(p, 1, p->NT)" in src
    assert "const int need = 2 * kStreamWindows * p->NT;" in src
    assert "fit_ring(p, 2, need) || fit_ring(p, 1, need)" in src
    assert "p->QB = 2 * kStreamWindows;" in src
    assert (_core_int("kSmemMax"), _core_int("kStreamWindows"),
            _core_int("kStreamTiles")) == (SMEM_MAX, 2, 2)


@pytest.mark.parametrize("N", range(64, 1025, 64))
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("kernel", ["K3", "K8a"])
def test_every_accepted_shape_has_a_shared_memory_plan(kernel, hd, N):
    """Every N (a multiple of 64) up to 1024 at every head dim fits one
    block's 227 KB.  K3's bf16 tile is always resident (128 KB at N =
    1024); K8a's f32 tile is resident up to N = 704 at hd 32 and streamed
    above, with two bias slots and a full ring at the stage-2 shape."""
    bias_elem = 2 if kernel == "K3" else 4
    plan = _plan(64, N, hd, bias_elem, may_stream=kernel == "K8a")
    assert plan is not None
    assert plan["smem"] <= SMEM_MAX and plan["S"] >= plan["NT"]
    if plan["stream"]:
        assert plan["S"] >= 4 * plan["NT"]
    if kernel == "K3":
        assert not plan["stream"]
    if not plan["stream"]:
        assert plan["S"] >= (2 if plan["NB"] == 2 else 1) * plan["NT"]
    if kernel == "K8a" and hd == 32:
        assert plan["stream"] == (N > 704)
    if (kernel, N, hd) == ("K8a", 1024, 32):
        assert (plan["stream"], plan["NT"], plan["NB"], plan["S"],
                plan["G"]) == (True, 2, 2, 16, 16)
    if (kernel, N, hd) == ("K3", 256, 32):
        assert (plan["NB"], plan["S"], plan["NT"]) == (2, 16, 4)


@pytest.mark.parametrize("hd,W,H", [(16, 16, 8), (32, 64, 12), (64, 16, 6),
                                     (32, 512, 12)])
def test_k2_attention_has_a_resident_plan_at_n_1024(hd, W, H):
    """K2's bf16 attention is the core as K3 runs it (no streaming) at its
    stage-2 N = 1024 with the bf16 bias: a resident 128 KB tile, one bias
    buffer and a ring of at least one four-tile chunk at head dims 16, 32
    and 64 (chip_smoke.py's HEAD_DIM_CASES, serving bucket 16 and the B=512
    embed), over ``_headmajor_groups`` window groups; any N above 1024 the
    wrapper refuses (FB_S2_MAX_N)."""
    plan = _plan(W, 1024, hd, 2, may_stream=False)
    assert plan is not None and not plan["stream"]
    assert plan["smem"] <= SMEM_MAX
    assert (plan["NB"], plan["NT"]) == (1, 4) and plan["S"] >= plan["NT"]
    assert wa.FB_S2_MAX_N == 1024
    G = wa._headmajor_groups(W, H, 1024)
    assert 1 <= G <= W and wa._headmajor_items(W, H, 1024, G) >= 16 * H


def test_k3_refuses_only_where_no_ring_fits_beside_its_tile():
    """Where K3's resident bf16 tile leaves no room for a ring (the entry
    returns an error and the wrapper raises): first at N = 1280 with hd 64,
    as the entry's comment and the wrapper's docstring say."""
    fails = [(N, hd) for hd in (16, 32, 64) for N in range(64, 2049, 64)
             if _plan(64, N, hd, 2, may_stream=False) is None]
    assert min(fails) == (1280, 64)
    assert all(N > 1024 for N, _ in fails)
    assert "first at N = 1280 with hd 64" in (
        _build.CSRC / "attention_qkv.cu").read_text()
    assert "first at N = 1280 with hd 64" in wa._attention_qkv_fused_cuda.__doc__


def _streamed_items(W, H, N):
    """The streamed plan's work, as the kernel's ``Plan::decode`` and its
    producers walk it: for each item (q-tile fastest, then the window group
    of at most four, then the head) the bias chunks the first producer
    loads, and for each consumer group c its two windows w0 + c, w0 + c +
    2 (a window past the group's end repeats its last window, unstored)
    with their key chunks in order."""
    C = N // 64
    NT = 2 if C % 2 == 0 else 1
    G = -(-W // 4)
    out = []
    for it in range(C * G * H):
        qt, rest = it % C, it // C
        grp, h = rest % G, rest // G
        w0, w1 = grp * W // G, (grp + 1) * W // G
        chunks = list(range(0, C, NT))
        groups = []
        for c in (0, 1):
            wins = [min(w0 + c + 2 * i, w1 - 1) for i in (0, 1)]
            stored = [w0 + c + 2 * i < w1 for i in (0, 1)]
            groups.append((wins, stored))
        out.append(dict(h=h, qt=qt, w=(w0, w1), chunks=chunks, NT=NT,
                        groups=groups))
    return out


@pytest.mark.parametrize("W", [1, 3, 4, 5, 7, 64, 65])
@pytest.mark.parametrize("H,N", [(12, 1024), (2, 832), (1, 768)])
def test_the_streamed_schedule_covers_every_chunk_and_window_once(W, H, N):
    """Every (window, head, q-tile) is stored by exactly one consumer
    group of one item, after all of its key chunks in order; each item
    loads each of its bias chunks once (in order, covering all N keys), and
    that chunk serves every window the item holds (at most four)."""
    stored = {}
    for item in _streamed_items(W, H, N):
        w0, w1 = item["w"]
        assert 1 <= w1 - w0 <= 4
        cols = [k for k0 in item["chunks"] for k in range(k0, k0 + item["NT"])]
        assert cols == list(range(N // 64))
        for wins, keep in item["groups"]:
            for w, s in zip(wins, keep):
                assert w0 <= w < w1
                if s:
                    key = (w, item["h"], item["qt"])
                    assert key not in stored
                    stored[key] = list(item["chunks"])
        served = {w for wins, keep in item["groups"]
                  for w, s in zip(wins, keep) if s}
        assert served == set(range(w0, w1))
    assert len(stored) == W * H * (N // 64)
    assert all(c == list(range(0, N // 64, 2 if N % 128 == 0 else 1))
               for c in stored.values())


def _layout(shape, elem, ptr, strides=None):
    dense = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return (shape, strides or dense, ptr, elem)


@pytest.mark.parametrize("W,N,H,hd", [(64, 256, 18, 32), (4, 256, 18, 32),
                                      (8, 64, 2, 16), (3, 1024, 2, 64),
                                      (65535, 128, 1, 32)],
                         ids=["stage3", "bucket1", "hd16_n64", "hd64_n1024",
                              "max_windows"])
def test_qkv_layout_accepts_what_the_tensor_maps_read(W, N, H, hd):
    D3 = 3 * H * hd
    got = wa._qkv_layout(_layout((W, N, D3), 2, 0x7f0000000000),
                         _layout((H, N, N), 2, 0x7f0000100010), H)
    assert got == (W, N, H * hd, hd)


QKV = (8, 64, 3 * 2 * 32)


@pytest.mark.parametrize("qkv,bias,match", [
    (_layout(QKV, 2, 0x7f0000000008), None, "qkv must have a 16-byte aligned"),
    (None, _layout((2, 64, 64), 2, 0x7f0000000002),
     "bias must have a 16-byte aligned"),
    (_layout(QKV, 2, 0x10, (64 * 200, 200, 1)), None, "qkv must be contiguous"),
    (_layout(QKV, 2, 0x10, (64 * 196, 196, 1)), None,
     "qkv rows must be a multiple of 16 bytes apart"),
    (None, _layout((2, 64, 64), 2, 0x10, (64 * 68, 68, 1)),
     "bias rows must be a multiple of 16 bytes apart"),
    (None, _layout((2, 64, 64), 2, 0x10, (64 * 64 + 8, 64, 1)),
     "bias must be contiguous"),
    (_layout(QKV, 2, 0x10, (64 * 192, 1, 64)), None,
     "qkv rows must be a multiple of 16 bytes apart"),
    (_layout(QKV, 4, 0x10), None, "qkv must have 2-byte elements"),
    (None, _layout((2, 64, 64), 4, 0x10), "bias must have 2-byte elements"),
    (None, _layout((3, 64, 64), 2, 0x10), r"bias must be \(2, 64, 64\)"),
    (_layout((8, 64, 3 * 2 * 24), 2, 0x10), None, "head dim"),
    (_layout((8, 96, 192), 2, 0x10), None, "N a multiple of 64"),
    (_layout((0, 64, 192), 2, 0x10), None, "1 <= W <= 65535"),
    (_layout((65536, 64, 192), 2, 0x10), None, "1 <= W <= 65535"),
    (_layout((8, 64, 193), 2, 0x10), None, r"qkv must be \(W, N, 3D\)"),
    (_layout((8, 64, 2, 96), 2, 0x10), None, r"qkv must be \(W, N, 3D\)"),
], ids=["qkv_base_8", "bias_base_2", "qkv_wide_rows", "qkv_pitch",
        "bias_pitch", "bias_head_gap", "qkv_transposed", "qkv_f32",
        "bias_f32", "bias_shape", "hd24", "ragged_n", "no_windows",
        "too_many_windows", "not_3d_channels", "qkv_4d"])
def test_qkv_layout_refuses_what_the_tensor_maps_cannot_read(qkv, bias, match):
    """qkv (8, 64, 192) bf16 (H = 2, hd = 32) and the bias (2, 64, 64)
    bf16, one rule broken."""
    qkv = qkv or _layout(QKV, 2, 0x7f0000000000)
    bias = bias or _layout((2, 64, 64), 2, 0x7f0000100000)
    with pytest.raises(ValueError, match=match):
        wa._qkv_layout(qkv, bias, 2)


def _fake_card(monkeypatch):
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
            ptrs = 3 if lib == "attention_qkv" else 5
            calls.append((lib, name, args[ptrs:]))
            return 0
        return launch

    monkeypatch.setattr(wa, "_check", host_check)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(wa, "_stream", lambda: 0)
    return calls


def _c_body(lib, entry):
    m = re.search(r'extern "C" int ' + entry + r"\(.*?\n\}",
                  (_build.CSRC / f"{lib}.cu").read_text(), re.S)
    assert m, entry
    return m.group(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_routes_bf16_to_the_core_and_f32_to_the_twin(monkeypatch, dtype):
    """A bf16 call reaches ``attention_qkv_bf16`` after ``_qkv_layout``
    with G = ``_headmajor_groups`` (14 at stage 3), whose body runs the core
    in its interleaved layout with a bf16 bias; an f32 call the twin, whose
    body runs common.cuh's first design.  One K3 launch either way."""
    calls = _fake_card(monkeypatch)
    checked = []
    real = wa._qkv_layout
    monkeypatch.setattr(wa, "_qkv_layout",
                        lambda *a: checked.append(a) or real(*a))
    W, N, H, hd = 64, 256, 18, 32
    qkv = torch.zeros(W, N, 3 * H * hd, dtype=dtype)
    wa.reset_launches()
    out = wa._attention_qkv_fused_cuda(qkv, torch.zeros(H, N, N), 0.25, H)
    assert out.shape == (W, N, H * hd) and out.dtype == dtype
    assert wa.LAUNCHES["_attention_qkv_fused_cuda"] == 1
    assert sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("attention_qkv", f"attention_qkv_{suffix}")
    groups = 14 if suffix == "bf16" else 1
    assert tail == (W, N, H, hd, groups, 0.25, 0)
    assert len(checked) == (suffix == "bf16")
    assert [wa._headmajor_groups(W, H, N) for W in (64, 4)] == [14, 2]
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "run<kQkv, gg::bf16, HD, false>(qkv, qkv, qkv, bias" in body
    else:
        assert "fwd90" not in body and "launch_window_attention(" in body


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k8a_routes_bf16_to_the_core_and_f32_to_the_twin(monkeypatch, dtype):
    """Through ``window_attention``'s dispatch at stage 2 (N >= 512), a
    bf16 call reaches ``attention_qtiled_bf16`` after ``_headmajor_layout``
    (no N limit) with G = ``_headmajor_groups``, whose body runs the core
    with the streamed plan allowed; an f32 call the first design."""
    calls = _fake_card(monkeypatch)
    checked = []
    real = wa._headmajor_layout
    monkeypatch.setattr(wa, "_headmajor_layout", lambda *a, **kw: (
        checked.append(kw) or real(*a, **kw)))
    W, H, N, hd = 64, 12, 1024, 32
    q, k, v = (torch.zeros(W, H, N, hd, dtype=dtype) for _ in range(3))
    wa.reset_launches()
    out = wa._attention_headmajor_cuda(q, k, v, torch.zeros(H, N, N), 0.25)
    assert out.shape == q.shape and out.dtype == dtype
    assert wa.LAUNCHES["_attention_qtiled_cuda"] == 1
    assert sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("attention_headmajor", f"attention_qtiled_{suffix}")
    groups = wa._headmajor_groups(W, H, N) if suffix == "bf16" else 1
    assert tail == (W, H, N, hd, groups, 0.25, 0)
    assert checked == ([{"max_n": None}] if suffix == "bf16" else [])
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "run<kHeadMajor, float, HD, true>(" in body
    else:
        assert "fwd90" not in body and "qtiled<float>(" in body


def test_the_core_is_hopper_code_shared_by_both_libraries():
    """One header holds the core: TMA tensor maps (the interleaved qkv read
    at column (3 h + slot) HD, the bias with the 128-byte swizzle),
    mbarrier pipelines, warp specialisation, wgmma for both products, the
    streamed bias ring beside the resident tile; no atomics.  Both
    libraries include it, and neither keeps a kernel of its own for bf16."""
    core = CORE.read_text()
    for feature in ("encode_rows<HD>(&maps[0], q, 3L * H * HD, N, W, kRows)",
                    "(3 * h + slot) * HD", "CU_TENSOR_MAP_SWIZZLE_128B",
                    "tma_load(", "swizzle128(", "setmaxnreg.dec",
                    "setmaxnreg.inc", "mbar_wait(", "mbar_expect_tx(",
                    "wgmma_m64n64k16_ss(", "wgmma_k64_rs<HD>(",
                    "wgmma_wait<0>()", "if constexpr (STREAM)",
                    "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16",
                    "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"):
        assert feature in core, feature
    atomics = re.compile(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.")
    for name in ("attention_fwd_sm90.cuh", "attention_headmajor.cu",
                 "attention_qkv.cu"):
        assert not atomics.search((_build.CSRC / name).read_text()), name
    for lib in ("attention_headmajor", "attention_qkv"):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert '#include "attention_fwd_sm90.cuh"' in src
        assert "hm90" not in src and "__global__" not in _c_body(
            lib, lib.replace("attention_headmajor", "attention_batched")
            + "_bf16")


def _function_local_statics(text):
    """(line, enclosing definition, inside an unnamed namespace) of every
    function-local static variable in a C++ source."""
    out = []
    lines = text.splitlines()
    depth_anon = []  # brace depth at which each open unnamed namespace began
    depth = 0
    header = ""
    for i, line in enumerate(lines):
        stripped = line.strip()
        if re.match(r"namespace\s*\{", stripped):
            depth_anon.append(depth)
        if line and not line[0].isspace() and "(" in line \
                and not stripped.startswith(("//", "#")):
            header = (lines[i - 1] + " " + line) if i else line
        if re.match(r"static (bool|int|long|EncodeTiled|cudaError_t)\s+\w+\s*=",
                    stripped) and line[0].isspace():
            out.append((stripped, header, bool(depth_anon)))
        for ch in line.split("//")[0]:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth_anon and depth == depth_anon[-1]:
                    depth_anon.pop()
    return out


@pytest.mark.parametrize("name", sorted(p.name for p in _build.CSRC.glob("*.cu*")))
def test_every_function_local_static_has_internal_linkage(name):
    """A function-local static of an inline or template function with
    external linkage is one GNU-unique object across the libraries a
    process loads (K5's library once launched without its shared-memory
    opt-in because K7's had set the flag).  So every such static sits in a
    function that is ``static``, or inside an unnamed namespace, or in a
    plain (neither inline nor template) function, whose static is the
    library's own; chip_smoke.py's build phase checks the built libraries
    for GNU-unique symbols."""
    for stmt, header, anon in _function_local_statics(
            (_build.CSRC / name).read_text()):
        vague = re.search(r"(^|\s)(inline|template)\b", header)
        assert anon or re.search(r"(^|\s)static\s", header) or not vague, (
            name, stmt, header)


def test_the_headers_host_code_has_internal_linkage():
    """The forward core, the GEMM core and sm90.cuh put everything in an
    unnamed namespace; K6's kernel (clip_flash_sm90.cuh, which K6's and
    K11's libraries include) takes its tensor map and SM count from
    sm90.cuh and sits in an unnamed namespace too."""
    for name, ns in (("attention_fwd_sm90.cuh", "fwd90"), ("sm90.cuh", "sm90"),
                     ("gemm_sm90.cuh", "gemm90")):
        src = (_build.CSRC / name).read_text()
        assert f"namespace gg {{\nnamespace {ns} {{\nnamespace {{\n" in src
        assert f"}}  // namespace\n}}  // namespace {ns}\n}}  // namespace gg" in src
    clip = (_build.CSRC / "clip_flash_sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in clip
    assert "::gg::sm90::encode_3d(" in clip and "::gg::sm90::sm_count(" in clip
    assert "typedef CUresult" not in clip
    assert "namespace gg {\nnamespace clip {\nnamespace sm90 {\nnamespace {\n" in clip
    assert "int run(" in clip
    for lib in ("clip_flash", "clip_flash_proj"):
        assert '#include "clip_flash_sm90.cuh"' in (
            _build.CSRC / f"{lib}.cu").read_text()


@pytest.mark.parametrize("kernel_name,group", [
    ("void gg::fwd90::(anonymous namespace)::attention_fwd_sm90<1, "
     "__nv_bfloat16, 32, 4, false>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "CUtensorMap, __nv_bfloat16*, gg::fwd90::(anonymous namespace)::Plan, "
     "float)", "attention (K1/K2/K3/K9 CUDA)"),
    ("void gg::fwd90::(anonymous namespace)::attention_fwd_sm90<0, float, "
     "32, 2, true>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
     "__nv_bfloat16*, gg::fwd90::(anonymous namespace)::Plan, float)",
     "head-major attention (K8a CUDA)"),
    ("void gg::fwd90::(anonymous namespace)::attention_fwd_sm90<0, float, "
     "32, 4, false>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
     "__nv_bfloat16*, gg::fwd90::(anonymous namespace)::Plan, float)",
     "head-major attention (K8b, K8a resident; CUDA)"),
    ("void gg::(anonymous namespace)::window_attention_kernel<float, 32, "
     "gg::WindowRows>(float const*, float const*, float*, int, int, float, "
     "gg::WindowRows)", "attention (f32 K1/K2/K3/K9 CUDA)"),
])
def test_profile_groups_name_the_forward_core_by_its_kernels(kernel_name,
                                                             group):
    """``profile_forward`` tells the core's launches apart by its template
    arguments (layout, bias type, head dim, chunk, streamed)."""
    from geoguessr_ai_torch import profile_forward

    assert profile_forward._group(kernel_name) == group


# ---------------------------------------------------------------------------
# The kernels' softmax, emulated in torch
# ---------------------------------------------------------------------------


def _emulate(q, k, v, bias, scale, chunk):
    """The core's arithmetic on (W, H, N, hd) bf16 q, k, v and a (H, N, N)
    bias of either dtype, in f32: chunks of ``chunk`` keys; s * scale +
    bias (upcast) in f32; the running max and the row sum rescaled by
    exp(m_old - m_new); p normalised before it is rounded to bf16 when one
    chunk is the whole row, else rounded relative to the running max and o
    divided by the sum at the end."""
    W, H, N, hd = q.shape
    x_all = torch.einsum("whnd,whmd->whnm", q.float(), k.float()) * scale \
        + bias[None].float()
    m = torch.full((W, H, N, 1), -float("inf"))
    l = torch.zeros(W, H, N, 1)
    o = torch.zeros(W, H, N, hd)
    whole = chunk == N
    for c0 in range(0, N, chunk):
        x = x_all[..., c0:c0 + chunk]
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        e = torch.exp(x - mx)
        l = l * alpha + e.sum(-1, keepdim=True)
        m = mx
        p = e / l if whole else e
        o = o * alpha + torch.einsum("whnm,whmd->whnd",
                                     p.to(torch.bfloat16).float(),
                                     v[:, :, c0:c0 + chunk].float())
    return (o if whole else o / l).to(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_k8a_streamed_softmax_matches_plain_and_the_jax_kernel():
    """K8a at N = 1024 in 128-key chunks (the streamed plan at stage 2),
    W = 2 and H = 2: the emulation against ``_attention_plain`` and
    against the JAX ``_attention_qtiled`` (its whole-row softmax, run in
    interpret mode) within the card tests' 2e-2 of the output's range
    (the online rounding of p relative to the running max costs a few bf16
    ulps)."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(11)
    W, H, N, hd = 2, 2, 1024, 32
    q, k, v = (rng.normal(0, 1, (W, H, N, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(0, 0.5, (H, N, N)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _emulate(tq, tk, tv, torch.from_numpy(bias), hd ** -0.5, 128)
    plain = wa._attention_plain(tq, tk, tv, torch.from_numpy(bias), hd ** -0.5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = jwa._attention_qtiled(jq, jk, jv, jnp.asarray(bias), hd ** -0.5)
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got.float(), plain.float()) < KERNEL_REL_TOL
    assert _rel(got.float(), want) < KERNEL_REL_TOL
    assert _rel(plain.float(), want) < 1e-2


def test_k3_whole_row_softmax_matches_plain_and_the_jax_kernel():
    """K3 at N = 256 (one chunk: the whole row) with the bf16 bias, q, k, v
    cut from the interleaved qkv as the tensor map reads them (head h at
    columns (3 h + slot) hd): the emulation against
    ``_attention_qkv_fused_plain`` and the JAX ``_attention_qkv_fused_pallas``
    in interpret mode.  The rounding is the JAX kernel's (max over the
    row, p normalised in f32 before the bf16 rounding), so the three agree
    within 1e-2 of the output's range."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(12)
    W, N, H, hd = 2, 256, 4, 32
    D = H * hd
    qkv = rng.normal(0, 1, (W, N, 3 * D)).astype(np.float32)
    bias = rng.normal(0, 0.5, (H, N, N)).astype(np.float32)
    tqkv = torch.from_numpy(qkv).to(torch.bfloat16)
    tbias = torch.from_numpy(bias).to(torch.bfloat16)
    cols = tqkv.reshape(W, N, H, 3, hd)
    q, k, v = (cols[:, :, :, s].permute(0, 2, 1, 3) for s in range(3))
    got = _emulate(q, k, v, tbias, hd ** -0.5, N)
    got = got.permute(0, 2, 1, 3).reshape(W, N, D)
    plain = wa._attention_qkv_fused_plain(tqkv, tbias, hd ** -0.5, H)
    with pltpu.force_tpu_interpret_mode():
        want = jwa._attention_qkv_fused_pallas(
            jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias), hd ** -0.5, H)
    want = np.asarray(want.astype(jnp.float32))
    for a, b in ((got, plain), (got, want), (plain, want)):
        assert _rel(a.float() if torch.is_tensor(a) else a,
                    b.float() if torch.is_tensor(b) else b) < 1e-2

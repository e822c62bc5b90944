"""K8b's bf16 entry, the Hopper head-major kernel, on the CPU: its window
groups and items, its layout rules, its routing, its shared-memory plan
and a Python mirror of its chunked softmax.

In bf16 ``_attention_batched_cuda`` launches ``attention_batched_bf16``,
whose kernel (the forward core ``csrc/attention_fwd_sm90.cuh``, which K3 and
K8a share; tests/test_torch_port_fwd_sm90.py holds what they add) reads q, k,
v and the bias through TMA tensor maps (so all four must be contiguous
with a 16-byte aligned base and rows a multiple of 16 bytes apart,
``_headmajor_layout``), walks items of (64-query tile, window group, head)
with the bias tile resident over the group's windows
(``_headmajor_groups``), and computes s and p v with wgmma.  The f32 twin
keeps the first design with BLOCK_W windows a block.  What is checked here,
where there is no ``nvcc`` and no card: the schedule, every layout rule,
which entry each call reaches with which arguments, that every accepted
shape fits the kernel's shared memory, and that the softmax the kernel
takes chunk by chunk agrees with the plain version.  The kernel itself is
held against the plain version by tests/test_torch_port_cuda.py on the
card (``-k headmajor_sm90``).
"""

import math
import re

import numpy as np
import pytest
import torch

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

#: (W, H, N) of the head-major serving path at a bucket of 16: stage 1 and
#: stage 3.
SERVING_SHAPES = ((1024, 6, 256), (64, 18, 256))
SOURCE = _build.CSRC / "attention_headmajor.cu"
CORE = _build.CSRC / "attention_fwd_sm90.cuh"


def _decode(it, W, H, N, G):
    """Item ``it`` -> (head, q-tile, first window, end window), as the
    kernel's ``Plan::decode``: the q-tile fastest, then the group."""
    R = N // 64
    qt, it = it % R, it // R
    grp, h = it % G, it // G
    return h, qt, grp * W // G, (grp + 1) * W // G


@pytest.mark.parametrize("W", [8, 16, 64, 1024, 4096])
@pytest.mark.parametrize("H,N", [(1, 64), (6, 256), (18, 256), (2, 448),
                                 (3, 192)])
def test_the_schedule_covers_every_window_once_in_order(W, H, N):
    """Every (head, q-tile) walks all W windows once, in window order,
    over its G items; inside an item the two consumer groups take the
    windows in turns (w0, w0 + 2, ... and w0 + 1, ...), so each window is
    one group's, and each group has one when W > 1.  About
    _HEADMAJOR_ITEMS items unless W caps G at one group a pair of
    windows."""
    G = wa._headmajor_groups(W, H, N)
    assert 1 <= G <= W
    items = wa._headmajor_items(W, H, N, G)
    assert items == (N // 64) * G * H
    walked = {}
    for it in range(items):
        h, qt, w0, w1 = _decode(it, W, H, N, G)
        assert w0 < w1
        turns = [list(range(w0 + c, w1, 2)) for c in (0, 1)]
        assert sorted(turns[0] + turns[1]) == list(range(w0, w1))
        walked.setdefault((h, qt), []).extend(range(w0, w1))
    assert len(walked) == H * (N // 64)
    assert all(ws == list(range(W)) for ws in walked.values())
    tiles = (N // 64) * H
    assert items <= max(wa._HEADMAJOR_ITEMS, tiles)
    assert G == -(-W // 2) or items + tiles > wa._HEADMAJOR_ITEMS
    assert W == 1 or all(w1 - w0 >= 2 for _, _, w0, w1 in
                         (_decode(it, W, H, N, G) for it in range(items)))


def test_the_groups_at_the_serving_shapes_and_only_from_the_shape(
        monkeypatch):
    """G is 42 at stage 1 and 14 at stage 3 (1008 items each), and is a
    function of (W, H, N) alone: it reads no card and no other state."""
    def no_card(*args, **kwargs):
        raise AssertionError("the group count must not read the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    assert [wa._headmajor_groups(*s) for s in SERVING_SHAPES] == [42, 14]
    assert [wa._headmajor_items(*s, G) for s, G in
            zip(SERVING_SHAPES, (42, 14))] == [1008, 1008]


def _layout(shape, elem, ptr, strides=None):
    dense = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return (shape, strides or dense, ptr, elem)


def _operands(W, H, N, hd, **change):
    """(q, k, v, bias) layouts of contiguous tensors at aligned bases, with
    ``change`` replacing one of them."""
    ops = {"q": _layout((W, H, N, hd), 2, 0x7f0000000000),
           "k": _layout((W, H, N, hd), 2, 0x7f0000100000),
           "v": _layout((W, H, N, hd), 2, 0x7f0000200010),
           "bias": _layout((H, N, N), 4, 0x7f0000300020)}
    ops.update(change)
    return ops["q"], ops["k"], ops["v"], ops["bias"]


@pytest.mark.parametrize("W,H,N,hd", [(1024, 6, 256, 32), (64, 18, 256, 32),
                                      (8, 2, 64, 16), (8, 3, 448, 64),
                                      (65535, 2, 192, 32)],
                         ids=["stage1", "stage3", "hd16_n64", "hd64_n448",
                              "max_windows"])
def test_headmajor_layout_accepts_what_the_tensor_maps_read(W, H, N, hd):
    assert wa._headmajor_layout(*_operands(W, H, N, hd)) == (W, H, N, hd)


Q = (8, 2, 64, 32)


@pytest.mark.parametrize("change,match", [
    (dict(q=_layout(Q, 2, 0x7f0000000008)), "q must have a 16-byte aligned"),
    (dict(k=_layout(Q, 2, 0x7f0000000002)), "k must have a 16-byte aligned"),
    (dict(bias=_layout((2, 64, 64), 4, 0x7f0000000004)),
     "bias must have a 16-byte aligned"),
    (dict(v=_layout(Q, 2, 0x10, (2 * 64 * 40, 64 * 40, 40, 1))),
     "v must be contiguous"),
    (dict(v=_layout(Q, 2, 0x10, (2 * 64 * 36, 64 * 36, 36, 1))),
     "v rows must be a multiple of 16 bytes apart"),
    (dict(bias=_layout((2, 64, 64), 4, 0x10, (64 * 66, 66, 1))),
     "bias rows must be a multiple of 16 bytes apart"),
    (dict(bias=_layout((2, 64, 64), 4, 0x10, (64 * 64 + 4, 64, 1))),
     "bias must be contiguous"),
    (dict(k=_layout(Q, 2, 0x10, (2 * 64 * 32, 32, 2 * 32, 1))),
     "k must be contiguous"),
    (dict(q=_layout(Q, 2, 0x10, (1, 8, 16, 1024))),
     "q rows must be a multiple of 16 bytes apart"),
    (dict(q=_layout(Q, 4, 0x10)), "q must have 2-byte elements"),
    (dict(bias=_layout((2, 64, 64), 2, 0x10)),
     "bias must have 4-byte elements"),
    (dict(k=_layout((8, 2, 64, 16), 2, 0x10)), r"k must be \(8, 2, 64, 32\)"),
    (dict(bias=_layout((3, 64, 64), 4, 0x10)),
     r"bias must be \(2, 64, 64\)"),
    (dict(q=_layout((8, 2, 64, 24), 2, 0x10)), "head dim"),
    (dict(q=_layout((8, 2, 96, 32), 2, 0x10)), "N a multiple of 64"),
    (dict(q=_layout((8, 2, 512, 32), 2, 0x10)), "below 512"),
    (dict(q=_layout((0, 2, 64, 32), 2, 0x10)), "1 <= W H"),
    (dict(q=_layout((2 ** 16, 2 ** 15, 64, 32), 2, 0x10)), "W H < 2"),
    (dict(q=_layout((8, 64, 32), 2, 0x10)), r"q must be \(W, H, N, hd\)"),
], ids=["q_base_8", "k_base_2", "bias_base_4", "v_wide_rows", "v_pitch",
        "bias_pitch", "bias_head_gap", "k_transposed", "q_rows_pitch",
        "q_f32", "bias_bf16", "k_shape", "bias_shape", "hd24", "ragged_n",
        "n512", "no_windows", "too_many_slabs", "q_3d"])
def test_headmajor_layout_refuses_what_the_tensor_maps_cannot_read(
        change, match):
    """q, k, v (8, 2, 64, 32) bf16 and the bias (2, 64, 64) f32, one rule
    broken."""
    with pytest.raises(ValueError, match=match):
        wa._headmajor_layout(*_operands(*Q, **change))


def _fake_card(monkeypatch):
    """The wrappers run here up to their launch: ``_check`` keeps its
    dtype, shape, contiguity and alignment rules but not the device one,
    and each C entry is replaced by a recorder of its arguments after the
    five tensor pointers."""
    calls = []

    def host_check(name, t, shape, dtype=torch.bfloat16):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
        return t

    def fake_entry(lib, name):
        def launch(*args):
            calls.append((lib, name, args[5:]))
            return 0
        return launch

    monkeypatch.setattr(wa, "_check", host_check)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(wa, "_stream", lambda: 0)
    return calls


def _c_body(entry):
    m = re.search(r'extern "C" int ' + entry + r"\(.*?\n\}",
                  SOURCE.read_text(), re.S)
    assert m, entry
    return m.group(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k8b_routes_bf16_to_the_hopper_entry_and_f32_to_the_twin(
        monkeypatch, dtype):
    """Through ``window_attention``'s dispatch (W a multiple of BLOCK_W, N
    below 512), a bf16 call reaches ``attention_batched_bf16`` with G =
    ``_headmajor_groups`` after the layout check, an f32 call the twin
    with BLOCK_W windows a block; one K8b launch either way.  The bf16
    entry runs the Hopper kernel, the f32 one the first design."""
    calls = _fake_card(monkeypatch)
    checked = []
    real_layout = wa._headmajor_layout
    monkeypatch.setattr(wa, "_headmajor_layout",
                        lambda *a: checked.append(a) or real_layout(*a))
    W, H, N, hd = 64, 3, 256, 32
    q, k, v = (torch.zeros(W, H, N, hd, dtype=dtype) for _ in range(3))
    wa.reset_launches()
    out = wa._attention_headmajor_cuda(q, k, v, torch.zeros(H, N, N), 0.25)
    assert out.shape == q.shape and out.dtype == dtype
    assert wa.LAUNCHES["_attention_batched_cuda"] == 1
    assert sum(wa.LAUNCHES.values()) == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("attention_headmajor",
                            f"attention_batched_{suffix}")
    windows = wa._headmajor_groups(W, H, N) if suffix == "bf16" \
        else wa.BLOCK_W
    assert tail == (W, H, N, hd, windows, 0.25, 0)
    assert len(checked) == (suffix == "bf16")
    body = _c_body(entry)
    if suffix == "bf16":
        assert "run<kHeadMajor, float, HD, false>(" in body and "groups" in body
    else:
        assert "fwd90" not in body and "batched<float>(" in body


def _hm90_source():
    """The forward core that K8b's bf16 entry runs (shared with K3 and
    K8a)."""
    src = CORE.read_text()
    return src[src.index("namespace fwd90 {"):src.index("}  // namespace fwd90")]


def test_the_k8b_entry_is_hopper_code():
    """The bf16 kernel reads q, k, v and the bias through tensor maps (the
    bias with the 128-byte swizzle), keeps its pipelines with mbarriers,
    specialises its warps and runs both products as wgmma; it takes no
    atomics.  The first design it replaces in bf16 (mma.sync) stays for
    the f32 twin and K8a."""
    core = _hm90_source()
    for feature in ("encode_rows<HD>(", "encode_3d(",
                    "CU_TENSOR_MAP_SWIZZLE_128B", "tma_load(", "swizzle128(",
                    "setmaxnreg.dec", "setmaxnreg.inc", "mbar_wait(",
                    "mbar_expect_tx(", "wgmma_m64n64k16_ss(",
                    "wgmma_k64_rs<HD>(", "wgmma_wait<0>()"):
        assert feature in core, feature
    atomics = re.compile(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.")
    assert not atomics.search(SOURCE.read_text())
    assert '#include "attention_fwd_sm90.cuh"' in SOURCE.read_text()
    assert '#include "sm90.cuh"' in CORE.read_text()
    assert "mma(" not in core and "attend_tile" not in core


def _source_int(name):
    m = re.search(r"constexpr int " + name + r" = (\d+);", _hm90_source())
    assert m, name
    return int(m.group(1))


def _chunk_tiles(C):
    """The kernel's ``chunk_tiles``: the largest of 4, 3, 2, 1 key tiles
    that divides the C tiles of N."""
    return next(t for t in (4, 3, 2, 1) if C % t == 0)


def _plan(N, hd):
    """A mirror of the kernel's ``make_plan``: (bias buffers, k/v slots of
    each group's ring, shared memory bytes) or None when nothing fits."""
    smem_max, max_slots = _source_int("kSmemMax"), _source_int("kMaxSlots")
    NT = _chunk_tiles(N // 64)
    tile, bias = 64 * hd * 2, 64 * N * 4
    for nb in (2, 1):
        barriers = 8 * (2 * nb + 2 * (4 + 2 * max_slots))
        slots = min((smem_max - 1024 - barriers - nb * bias) // (2 * tile)
                    - 2, max_slots)
        if slots >= (2 * NT if nb == 2 else NT):
            used = 1024 + nb * bias + 2 * (2 + slots) * tile + 8 * (
                2 * nb + 2 * (4 + 2 * slots))
            return nb, slots, used
    return None


@pytest.mark.parametrize("N", [64, 128, 192, 256, 320, 384, 448])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_every_accepted_shape_has_a_shared_memory_plan(hd, N):
    """Every N the wrapper accepts (a multiple of 64 below 512) at every
    head dim fits one block's 227 KB: the resident bias tile (64 x N f32),
    two q buffers and a ring that holds a chunk's k tiles for each
    consumer group; two bias buffers where they fit beside a ring of two
    chunks (the serving shapes at hd 32)."""
    src = CORE.read_text()
    assert "C % 4 == 0 ? 4 : C % 3 == 0 ? 3 : C % 2 == 0 ? 2 : 1" in src
    plan = _plan(N, hd)
    assert plan is not None
    nb, slots, used = plan
    assert used <= 232448 and slots >= _chunk_tiles(N // 64)
    if (N, hd) == (256, 32):
        assert (nb, slots) == (2, 10)


def _mirror(q, k, v, bias, scale):
    """K8b's arithmetic on one (window, head) at a time, in f32 with bf16
    operands: chunks of ``_chunk_tiles`` 64-key tiles; s * scale + bias in
    f32; the running max and the row sum rescaled by exp(m_old - m_new);
    p normalised before it is rounded to bf16 when one chunk is the whole
    row, else rounded relative to the running max and o divided by the sum
    at the end."""
    W, H, N, hd = q.shape
    C = N // 64
    NT = _chunk_tiles(C)
    s_all = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    x_all = s_all * scale + bias[None].float()
    m = torch.full((W, H, N, 1), -float("inf"))
    l = torch.zeros(W, H, N, 1)
    o = torch.zeros(W, H, N, hd)
    for k0 in range(0, C, NT):
        cols = slice(k0 * 64, (k0 + NT) * 64)
        x = x_all[..., cols]
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        e = torch.exp(x - mx)
        l = l * alpha + e.sum(-1, keepdim=True)
        m = mx
        p = e / l if NT == C else e
        o = o * alpha + torch.einsum(
            "whnm,whmd->whnd", p.to(torch.bfloat16).float(),
            v[:, :, cols].float())
    return (o if NT == C else o / l).to(torch.bfloat16)


@pytest.mark.parametrize("N", [64, 192, 256, 320, 384, 448])
def test_the_chunked_softmax_matches_the_plain_version(N):
    """The mirror of the kernel's softmax, at N with one chunk (64, 192,
    256) and with several (320 and 448 in 64-key chunks, 384 in 192-key
    ones), against ``_attention_plain`` within the card tests' 2e-2 of
    the output's range; where one chunk is the whole row the rounding is
    the plain version's, so the two agree far closer."""
    rng = np.random.default_rng(N)
    W, H, hd = 2, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (W, H, N, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    bias = torch.from_numpy(rng.normal(0, 0.5, (H, N, N)).astype(np.float32))
    got = _mirror(q, k, v, bias, hd ** -0.5).float()
    want = wa._attention_plain(q, k, v, bias, hd ** -0.5).float()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 2e-2
    if _chunk_tiles(N // 64) == N // 64:
        assert rel < 1e-2

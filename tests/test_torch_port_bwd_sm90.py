"""The bf16 entries of K4, K5 and K7, the Hopper backward core, on the
CPU: the window groups of its d_bias launch, its scratch, its layout
rules, its routing, and Python mirrors of the d_bias sum it takes in
another order than the first design and of its row statistics.

In bf16 ``_attention_qkv_bwd_cuda`` (K4), ``_attention_bwd_merged_cuda``
(K5) and ``_attention_bwd_qtiled_cuda`` (K7) launch
``attention_qkv_bwd_bf16``, ``attention_bwd_merged_bf16`` and
``attention_bwd_qtiled_bf16``, which run ``csrc/attention_bwd_sm90.cuh``:
TMA loads through tensor maps over qkv and g (so both must be 16-byte
aligned with rows a multiple of 16 bytes apart, ``_bwd_layout``), and a
d_bias launch that sums ds over ``_bwd_groups`` groups of windows (K5:
one group) into (G, H, N, N) partials, then sums the partials in group
order.  The f32 entries keep the first design (``attention_bwd.cuh``).
What is checked here,
where there is no ``nvcc`` and no card: the grouping, the scratch shapes,
every layout rule, which entry each call reaches with which arguments,
and that the group-ordered sums and the row statistics (one pass in K4,
two in K7) agree with the plain versions' sums.  The kernels themselves are held against
the plain versions by tests/test_torch_port_cuda.py on the card.
"""

import re

import numpy as np
import pytest
import torch

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import window_attention as wa

#: (W, N, H) of the train path: K4 at stages 1 and 3, K7 at stage 2.
TRAIN_SHAPES = ((1024, 256, 6), (64, 256, 18), (64, 1024, 12))


def _group_bounds(W, G):
    """The first window of each group and W, as the kernel splits them
    (``Geometry::decode``): group i sums windows [i W // G, (i + 1) W //
    G) in order."""
    return [i * W // G for i in range(G + 1)]


@pytest.mark.parametrize("W", [1, 3, 17, 64, 1024])
@pytest.mark.parametrize("N,H", [(64, 2), (256, 6), (256, 18), (1024, 12),
                                 (1280, 1)])
def test_window_groups_cover_every_window_once_in_order(W, N, H):
    G = wa._bwd_groups(W, N, H)
    assert 1 <= G <= W
    bounds = _group_bounds(W, G)
    assert bounds[0] == 0 and bounds[-1] == W and len(bounds) == G + 1
    # every group non-empty and the groups in window order
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert [w for a, b in zip(bounds, bounds[1:]) for w in range(a, b)] == \
        list(range(W))
    # the d_bias launch reaches about BWD_DBIAS_ITEMS items unless W caps G
    items = wa._bwd_items(W, N, H, G)["dbias"]
    assert items <= max(wa._BWD_DBIAS_ITEMS, items // G)
    assert G == W or items * 2 > wa._BWD_DBIAS_ITEMS or G == 1


def test_window_groups_at_the_train_shapes_and_only_from_the_shape(
        monkeypatch):
    """G is 21 at stage 1, 7 at stage 3 and 1 at K7's stage 2, and is a
    function of (W, N, H) alone: it reads no card and no other state."""
    def no_card(*args, **kwargs):
        raise AssertionError("the group count must not read the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    assert [wa._bwd_groups(*s) for s in TRAIN_SHAPES] == [21, 7, 1]


@pytest.mark.parametrize("W,N,H,G,items,partial", [
    (1024, 256, 6, 21, {"stats": 12288, "dkdv": 12288, "dq": 12288,
                        "dbias": 1008}, (21, 6, 256, 256)),
    (64, 256, 18, 7, {"stats": 2304, "dkdv": 2304, "dq": 2304,
                      "dbias": 1008}, (7, 18, 256, 256)),
    (64, 1024, 12, 1, {"stats": 6144, "dkdv": 6144, "dq": 6144,
                       "dbias": 1536}, None),
    (3, 192, 2, 3, {"stats": 12, "dkdv": 12, "dq": 12, "dbias": 36},
     (3, 2, 192, 192)),
], ids=["stage1", "stage3", "k7_stage2", "odd_tiles"])
def test_items_and_scratch_of_each_call(W, N, H, G, items, partial):
    assert wa._bwd_groups(W, N, H) == G
    assert wa._bwd_items(W, N, H, G) == items
    shapes = wa._bwd_scratch_shapes(W, N, H, G)
    assert shapes == {"stats": (3, W, H, N), "partial": partial}
    if partial is not None:  # 25 MB of partials at stage 1
        assert np.prod(partial) * 4 <= 32 * 2 ** 20


def _contig(shape):
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


@pytest.mark.parametrize("W,N,H,hd", [(1024, 256, 6, 32), (64, 1024, 12, 32),
                                      (1, 64, 2, 16), (3, 256, 2, 64),
                                      (65535, 64, 1, 16)],
                         ids=["stage1", "stage2", "hd16", "hd64",
                              "max_windows"])
def test_bwd_layout_accepts_what_the_tensor_maps_read(W, N, H, hd):
    D = H * hd
    qkv, g = (W, N, 3 * D), (W, N, D)
    assert wa._bwd_layout(qkv, _contig(qkv), 0x7f0000000000, g, _contig(g),
                          0x7f0000100010, 2, H) == (W, N, D, hd)


@pytest.mark.parametrize("change,match", [
    (dict(qkv_ptr=0x7f0000000008), "qkv must have a 16-byte aligned base"),
    (dict(qkv_ptr=0x7f0000000002), "qkv must have a 16-byte aligned base"),
    (dict(g_ptr=0x7f0000000004), "g must have a 16-byte aligned base"),
    (dict(qkv_strides=(64 * 196, 196, 1)),
     "qkv rows must be a multiple of 16 bytes apart"),
    (dict(g_strides=(64 * 68, 68, 1)),
     "g rows must be a multiple of 16 bytes apart"),
    (dict(qkv_strides=(64 * 200, 200, 1)), "qkv must be contiguous"),
    (dict(g_strides=(64 * 64 + 8, 64, 1)), "g must be contiguous"),
    (dict(qkv_strides=(1, 3 * 2 * 192, 192)),
     "qkv rows must be a multiple of 16 bytes apart"),
    (dict(elem_size=4), "2-byte elements"),
    (dict(g_shape=(2, 64, 32)), r"g must be \(2, 64, 64\)"),
    (dict(qkv_shape=(2, 64, 193)), r"qkv must be \(W, N, 3D\)"),
    (dict(qkv_shape=(2, 64, 144), g_shape=(2, 64, 48)), "head dim"),
    (dict(qkv_shape=(2, 96, 192), g_shape=(2, 96, 64)),
     "N a multiple of 64"),
    (dict(qkv_shape=(0, 64, 192), g_shape=(0, 64, 64)), "1 <= W <= 65535"),
    (dict(qkv_shape=(65536, 64, 192), g_shape=(65536, 64, 64)),
     "1 <= W <= 65535"),
], ids=["qkv_base_8", "qkv_base_2", "g_base_4", "qkv_pitch", "g_pitch",
        "qkv_wide_rows", "g_window_gap", "qkv_transposed", "f32", "g_shape",
        "not_3d", "hd24", "ragged_n", "no_windows", "too_many_windows"])
def test_bwd_layout_refuses_what_the_tensor_maps_cannot_read(change, match):
    """qkv (2, 64, 192) and g (2, 64, 64) at H=2 (hd 32), one rule broken."""
    args = dict(qkv_shape=(2, 64, 192), qkv_strides=(64 * 192, 192, 1),
                qkv_ptr=0x10, g_shape=(2, 64, 64), g_strides=(64 * 64, 64, 1),
                g_ptr=0x20, elem_size=2, num_heads=2)
    args.update(change)
    with pytest.raises(ValueError, match=match):
        wa._bwd_layout(**args)


def _fake_card(monkeypatch):
    """The wrappers run here up to their launch: ``_check`` keeps its
    dtype, shape, contiguity and alignment rules but not the device one,
    and each C entry is replaced by a recorder of its arguments after the
    six tensor pointers."""
    calls = []

    def host_check(name, t, shape, dtype=torch.bfloat16):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
        return t

    def fake_entry(lib, name):
        def launch(*args):
            calls.append((lib, name, args[6:]))
            return 0
        return launch

    monkeypatch.setattr(wa, "_check", host_check)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(wa, "_stream", lambda: 0)
    return calls


def _c_body(lib, entry):
    src = open(_build.CSRC / f"{lib}.cu").read()
    m = re.search(r'extern "C" int ' + entry + r"\(.*?\n\}", src, re.S)
    assert m, entry
    return m.group(0)


@pytest.mark.parametrize("kernel,lib", [
    ("_attention_qkv_bwd_cuda", "attention_qkv_bwd"),
    ("_attention_bwd_qtiled_cuda", "attention_bwd_qtiled"),
    ("_attention_bwd_merged_cuda", "attention_bwd_merged"),
], ids=["K4", "K7", "K5"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k4_k7_route_bf16_to_the_core_and_f32_to_the_twin(
        monkeypatch, kernel, lib, dtype):
    """A bf16 call of K4 or K7 reaches the ``_bf16`` entry with the d_bias
    partials and G = ``_bwd_groups``; an f32 call reaches the ``_f32`` twin
    with no partials and G = 1; K5 takes neither (one window group) in
    either dtype; one launch counted either way.  Every bf16 entry's body
    runs the Hopper core, every f32 one the first design."""
    calls = _fake_card(monkeypatch)
    W, N, H, hd = 17, 128, 2, 32
    qkv = torch.zeros(W, N, 3 * H * hd, dtype=dtype)
    g = torch.zeros(W, N, H * hd, dtype=dtype)
    bias = torch.zeros(H, N, N)
    wa.reset_launches()
    dqkv, dbias = getattr(wa, kernel)(qkv, bias, g, 0.25, H)
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert dbias.shape == (H, N, N) and dbias.dtype == torch.float32
    assert wa.LAUNCHES[kernel] == 1
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    ((got_lib, entry, tail),) = calls
    assert (got_lib, entry) == (lib, f"{lib}_{suffix}")
    if lib == "attention_bwd_merged":
        assert tail == (W, N, H, hd, 0.25, 0)
    else:
        partial, rest = tail[0], tail[1:]
        G = wa._bwd_groups(W, N, H) if suffix == "bf16" else 1
        assert G == (17 if suffix == "bf16" else 1)
        assert rest[:5] == (W, N, H, hd, G) and rest[5] == 0.25
        assert (partial != 0) == (G > 1)
    body = _c_body(lib, entry)
    if suffix == "bf16":
        assert "gg::bwd90::launch(" in body
    else:
        assert "bwd90" not in body
        assert ("launch_attention_bwd(" in body) or ("run_f32(" in body)


def test_k5_keeps_its_entry_and_its_core(monkeypatch):
    """K5 (``attention_bwd_merged``) keeps its entry, which takes no
    partials or groups; in bf16 the entry runs the Hopper core with one
    window group (G = 1: d_bias summed over all windows in order) and t in
    two passes, as K7's does, so the two give equal bits at one group; its
    f32 twin keeps the first design.  A bf16 call checks the core's TMA
    layout (``_bwd_layout``) first."""
    calls = _fake_card(monkeypatch)
    checked = []
    real_layout = wa._bwd_layout
    monkeypatch.setattr(wa, "_bwd_layout",
                        lambda *a: checked.append(a) or real_layout(*a))
    W, N, H = 2, 1024, 2
    qkv = torch.zeros(W, N, 3 * H * 32, dtype=torch.bfloat16)
    g = torch.zeros(W, N, H * 32, dtype=torch.bfloat16)
    wa._attention_bwd_merged_cuda(qkv, torch.zeros(H, N, N), g, 0.25, H)
    ((lib, entry, tail),) = calls
    assert (lib, entry) == ("attention_bwd_merged",
                            "attention_bwd_merged_bf16")
    assert tail == (W, N, H, 32, 0.25, 0)
    assert len(checked) == 1
    assert len(_build.SIGNATURES[lib][entry]) == 12
    bf16 = _c_body(lib, "attention_bwd_merged_bf16")
    assert "gg::bwd90::launch(" in bf16
    # the f32 bias, no partials, one group, hd, two passes
    assert re.search(r"launch\(a, b, nullptr, 1, hd, 2, static_cast<cudaStream_t>",
                     bf16)
    assert "const float* b = static_cast<const float*>(bias)" in bf16
    f32 = _c_body(lib, "attention_bwd_merged_f32")
    assert "bwd90" not in f32 and "launch_attention_bwd(" in f32
    src = open(_build.CSRC / "attention_bwd_merged.cu").read()
    assert '#include "attention_bwd_sm90.cuh"' in src
    for k in ("attention_qkv_bwd", "attention_bwd_qtiled"):
        assert all(len(a) == 14 for a in _build.SIGNATURES[k].values())


def test_the_core_is_hopper_code():
    """The bf16 core reads through tensor maps, runs wgmma and specialises
    its warps; the f32 twins' core does none of that."""
    core = open(_build.CSRC / "attention_bwd_sm90.cuh").read()
    for feature in ("tma_load(", "bulk_load(", "setmaxnreg.dec", "setmaxnreg.inc",
                    "wgmma_m64n64k16_ss(",
                    "wgmma_k64_rs<HD>(", "mbar_wait(full_col",
                    "mbar_wait(empty_col", "dbias_reduce"):
        assert feature in core, feature
    atomics = re.compile(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.")
    assert not atomics.search(core)
    old = open(_build.CSRC / "attention_bwd.cuh").read()
    assert "wgmma" not in old and not atomics.search(old)


def _ds_per_window(W, N, H, seed=0):
    """ds (W, H, N, N) in f32 of random inputs, as the plain versions
    compute it, and the (W, H, N) scores' inputs for the stats mirror."""
    rng = np.random.default_rng(seed)
    hd = 16
    q, k, v, gr = (torch.from_numpy(rng.normal(0, 1, (W, H, N, hd)).astype(
        np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.normal(0, 0.5, (H, N, N)).astype(np.float32))
    s = torch.einsum("whnd,whmd->whnm", q, k) * hd ** -0.5 + bias
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("whnd,whmd->whnm", gr, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return s, dp, ds


@pytest.mark.parametrize("W,N,H", [(1, 64, 2), (3, 64, 2), (17, 64, 1),
                                   (64, 64, 1)])
def test_group_ordered_dbias_sum_matches_the_plain_sum(W, N, H):
    """The kernel's sum: windows in order inside each group (f32 adds),
    then the G partials in group order; against ``ds.sum(0)``, the plain
    versions' sum, at f32 tolerance."""
    _, _, ds = _ds_per_window(W, N, H)
    G = wa._bwd_groups(W, N, H)
    bounds = _group_bounds(W, G)
    partials = []
    for a, b in zip(bounds, bounds[1:]):
        acc = torch.zeros(H, N, N)
        for w in range(a, b):
            acc = acc + ds[w]
        partials.append(acc)
    got = partials[0]
    for part in partials[1:]:
        got = got + part
    want = ds.sum(0)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(
        want.abs().max()))


@pytest.mark.parametrize("lib,passes", [("attention_qkv_bwd", 1),
                                         ("attention_bwd_qtiled", 2),
                                         ("attention_bwd_merged", 2)],
                         ids=["K4", "K7", "K5"])
def test_stats_passes_of_each_entry(lib, passes):
    """K4's bf16 entry takes t in the online pass of the row statistics;
    K7's and K5's in a second pass, as K5's first design did, so that K7
    rounds as K5."""
    body = _c_body(lib, f"{lib}_bf16")
    assert re.search(r"hd, %d, static_cast<cudaStream_t>" % passes, body)


@pytest.mark.parametrize("passes", [1, 2], ids=["one_pass", "two_passes"])
def test_the_row_statistics_passes_match_softmax(passes):
    """The stats launch over 64-key tiles: the running max m and the row
    sum l, rescaled by exp(m_old - m_new) as the max grows, then 1 / l;
    t either in the same pass (u = sum exp(s - m) dp rescaled as l is, t =
    u / l) or in a second (t = sum exp(s - m) / l * dp with the final m);
    against softmax and t = sum p dp of the whole row at f32 tolerance."""
    s, dp, _ = _ds_per_window(2, 256, 2, seed=3)
    m = torch.full(s.shape[:-1], -float("inf"))
    l = torch.zeros(s.shape[:-1])
    u = torch.zeros(s.shape[:-1])
    for k0 in range(0, s.shape[-1], 64):
        st, dt = s[..., k0:k0 + 64], dp[..., k0:k0 + 64]
        mx = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - mx)
        e = torch.exp(st - mx[..., None])
        l = l * alpha + e.sum(-1)
        u = u * alpha + (e * dt).sum(-1)
        m = mx
    il = 1 / l
    if passes == 1:
        t = u * il
    else:
        t = torch.zeros(s.shape[:-1])
        for k0 in range(0, s.shape[-1], 64):
            p = torch.exp(s[..., k0:k0 + 64] - m[..., None]) * il[..., None]
            t = t + (p * dp[..., k0:k0 + 64]).sum(-1)
    assert torch.equal(m, s.amax(-1))
    assert torch.allclose(torch.exp(s - m[..., None]) * il[..., None],
                          torch.softmax(s, dim=-1), rtol=1e-5, atol=1e-7)
    want = (dp * torch.softmax(s, dim=-1)).sum(-1)
    assert torch.allclose(t, want, rtol=1e-4, atol=1e-5 * float(
        want.abs().max()))


@pytest.mark.parametrize("kernel_name,group", [
    ("void gg::bwd90::attn_bwd_sm90<32, 0, float, 2>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, gg::BwdArgs<__nv_bfloat16>)",
     "attention backward (K5/K7 CUDA)"),
    ("void gg::bwd90::attn_bwd_sm90<32, 3, float, 1>(CUtensorMap_st)",
     "attention backward (K5/K7 CUDA)"),
    ("void gg::bwd90::attn_bwd_sm90<32, 1, __nv_bfloat16, 1>(CUtensorMap_st)",
     "attention backward (K4 CUDA)"),
    ("gg::bwd90::dbias_reduce(float4 const*, float4*, long, int)",
     "attention backward (K4/K7 CUDA)"),
    ("void gg::hm90::attention_batched_sm90<32, 4>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*)",
     "head-major attention (K8b CUDA)"),
    ("void gg::(anonymous namespace)::attention_batched_kernel<float, 32>("
     "float const*)", "head-major attention (K8b CUDA)"),
], ids=["core_stats_f32_bias", "core_dbias_f32_bias", "core_bf16_bias",
        "partials_sum", "k8b_bf16", "k8b_f32"])
def test_profile_groups_name_the_core_launches_by_their_kernels(kernel_name,
                                                                group):
    """``profile_forward`` counts the f32-bias launches of the core as K5/K7
    (the default train step's K5 runs them since K5 moved onto the core)
    and both of K8b's kernels as K8b."""
    from geoguessr_ai_torch import profile_forward

    assert profile_forward._group(kernel_name) == group

"""K6's entries, the Hopper kernel, on the CPU: their routing and their
layout rules.

In bf16 ``_flash_cuda`` launches ``clip_flash_bf16``, the kernel that
reads qkv through one TMA tensor map and multiplies with wgmma
(``ops/csrc/clip_flash_sm90.cuh``, ``sm90``, which K11's entries launch
too); in f32 it launches ``clip_flash_f32``, the same kernel's f32 kind,
which first splits k and v into a (2, B, N, 2D) bf16 scratch the wrapper
allocates and reads those planes through one tensor map and q in f32
through another.  The tensor map
needs a 16-byte aligned base and rows a multiple of 16 bytes apart, and
the C entries take no strides, so ``_qkv_layout`` (a pure function of
shape, strides, address and element size) refuses anything else before a
launch.  What is checked here, where there is no ``nvcc`` and no card:
which entry each dtype reaches, that each entry's C body reaches the
kernel kind it names, and every layout rule.  The kernel itself is held
against ``_flash_plain`` by tests/test_torch_port_cuda.py on the card; the
f32 kind's plan and arithmetic by tests/test_torch_port_clip_f32.py.
"""

import re

import pytest
import torch

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import clip_attention as ca


def _c_body(entry):
    src = open(_build.CSRC / "clip_flash.cu").read()
    m = re.search(r'extern "C" int ' + entry + r'\(.*?\n\}', src, re.S)
    assert m, entry
    return m.group(0)


@pytest.mark.parametrize("dtype,entry,core", [
    (torch.bfloat16, "clip_flash_bf16", "sm90::run<HD>"),
    (torch.float32, "clip_flash_f32", "sm90::run_f32<HD, false>("),
], ids=["bf16", "f32"])
def test_flash_wrapper_routes_each_dtype_to_its_entry(monkeypatch, dtype,
                                                      entry, core):
    """``_flash_cuda`` launches the entry of its qkv's dtype once, and that
    entry's body runs the Hopper kernel's bf16 kind or its f32 kind, the
    latter with a bf16 scratch of k's and v's two planes (2 B N 2D
    elements) and
    the bf16 entry with none.  The card check is replaced by the layout
    rules alone, and the entry by a recorder, so the wrapper runs here up
    to its launch."""
    calls = []

    def fake_entry(lib, name):
        def launch(*args):
            calls.append((lib, name, args[1], args[3:8]))
            return 0
        return launch

    empties = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        empties.append((shape[0] if len(shape) == 1 else shape,
                        kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(ca, "_stream", lambda: 0)
    monkeypatch.setattr(ca, "_check_qkv", lambda qkv, h: ca._qkv_layout(
        tuple(qkv.shape), qkv.stride(), 0, qkv.element_size(), h))
    monkeypatch.setattr(torch, "empty", empty)
    ca.reset_launches()
    out = ca._flash_cuda(torch.zeros(3, 50, 3 * 128, dtype=dtype), 0.125, 2)
    assert out.shape == (3, 50, 128) and out.dtype == dtype
    (lib, name, planes, args), = calls
    assert (lib, name, args) == ("clip_flash", entry, (3, 50, 2, 64, 0.125))
    if dtype == torch.float32:
        assert isinstance(planes, int)
        assert (2 * 3 * 50 * 2 * 128, torch.bfloat16) in empties
    else:
        assert planes is None
    assert ca.LAUNCHES["_flash_cuda"] == 1
    assert core in _c_body(entry)


def test_only_the_bf16_entry_reads_through_a_tensor_map():
    """Both kinds read through tensor maps now: the bf16 kind over qkv,
    the f32 kind over qkv's q rows in f32 and over k's and v's planes (hi
    at plane image b, lo at B + b), each with the same warp-specialised TMA
    + wgmma pipeline; the first design (attend_rows, mma.sync) is gone from
    both CLIP libraries."""
    src = open(_build.CSRC / "clip_flash_sm90.cuh").read()
    kernel = src[src.index("clip_flash_sm90("):src.index("int run(")]
    f32 = src[src.index("clip_flash_f32_sm90("):src.index("int run_f32(")]
    assert '#include "clip_flash_sm90.cuh"' in open(
        _build.CSRC / "clip_flash.cu").read()
    assert "cp.async.bulk.tensor.3d" in src and "tma_load(" in kernel
    for feature in ("setmaxnreg.dec", "setmaxnreg.inc", "mbar_wait(full_k",
                    "mbar_wait(empty", "wgmma_s<HD>(", "wgmma_pv<HD>("):
        assert feature in kernel, feature
    for feature in ("setmaxnreg.dec", "setmaxnreg.inc", "mbar_wait(full_k",
                    "mbar_wait(empty", "split_scores<HD>(", "split_pv<HD>(",
                    "tma_load(dst + T::kBytes, &kv_map, bar, c0, row, B + b)",
                    "&q_map, full_q"):
        assert feature in f32, feature
    for fn in ("wgmma_m64n128k16_ss", "wgmma_m64n64k16_rs",
               "wgmma_m64n32k16_rs", "wgmma_m64n16k16_rs"):
        assert f"wgmma.mma_async.sync.aligned.{fn[6:-3]}.f32.bf16.bf16" in src
    assert "attend_rows" not in kernel and "attend_rows" not in f32
    # the first design is gone with its header
    for lib in ("clip_flash", "clip_flash_proj"):
        assert "attend_rows" not in open(_build.CSRC / f"{lib}.cu").read()
    assert not (_build.CSRC / "clip_flash.cuh").exists()


@pytest.mark.parametrize("shape,strides,ptr,elem,H,want", [
    ((64, 577, 3072), (577 * 3072, 3072, 1), 0x7f0000000000, 2, 16,
     (64, 577, 1024, 64)),                                   # CLIP-L, bf16
    ((64, 50, 2304), (50 * 2304, 2304, 1), 0x7f0000000010, 2, 12,
     (64, 50, 768, 64)),                                     # ViT-B/32
    ((2, 50, 192), (50 * 192, 192, 1), 0x7f0000000020, 4, 2,
     (2, 50, 64, 32)),                                       # f32, hd 32
    ((3, 129, 96), (129 * 96, 96, 1), 0x7f0000000030, 2, 2,
     (3, 129, 32, 16)),                                      # hd 16
    ((1, 1, 384), (7, 5, 1), 0x10, 2, 2, (1, 1, 128, 64)),   # size-1 dims
    ((65535, 1, 192), (192, 192, 1), 0x10, 2, 1, (65535, 1, 64, 64)),
], ids=["vit_l14", "vit_b32", "f32_hd32", "hd16", "size1", "max_images"])
def test_qkv_layout_accepts_what_the_tensor_map_reads(shape, strides, ptr,
                                                      elem, H, want):
    assert ca._qkv_layout(shape, strides, ptr, elem, H) == want


@pytest.mark.parametrize("shape,strides,ptr,H,match", [
    ((64, 577, 3072), (577 * 3072, 3072, 1), 0x7f0000000002, 16,
     "16-byte aligned base"),
    ((64, 577, 3072), (577 * 3072, 3072, 1), 0x7f0000000008, 16,
     "16-byte aligned base"),
    ((2, 50, 384), (50 * 388, 388, 1), 0x10, 2, "16 bytes apart"),
    ((2, 50, 384), (50 * 384, 1, 50), 0x10, 2, "16 bytes apart"),
    ((2, 50, 384), (50 * 392, 392, 1), 0x10, 2, "contiguous"),
    ((2, 50, 384), (50 * 384 + 8, 384, 1), 0x10, 2, "contiguous"),
    ((2, 50, 3 * 96), (50 * 288, 288, 1), 0x10, 2, "head dim"),   # hd 48
    ((2, 50, 3 * 128), (50 * 384, 384, 1), 0x10, 3, "head dim"),  # D/H
    ((2, 50, 385), (50 * 385, 385, 1), 0x10, 2, r"\(B, N, 3D\)"),
    ((100, 384), (384, 1), 0x10, 2, r"\(B, N, 3D\)"),
    ((0, 50, 384), (50 * 384, 384, 1), 0x10, 2, "1 <= B <= 65535"),
    ((65536, 1, 384), (384, 384, 1), 0x10, 2, "1 <= B <= 65535"),
    ((2, 0, 384), (0, 384, 1), 0x10, 2, "N >= 1"),
], ids=["base_2", "base_8", "pitch_388", "transposed", "pitch_392",
        "image_stride", "hd48", "heads", "not_3d", "rank2", "no_images",
        "too_many_images", "no_tokens"])
def test_qkv_layout_refuses_what_the_tensor_map_cannot_read(shape, strides,
                                                            ptr, H, match):
    with pytest.raises(ValueError, match=match):
        ca._qkv_layout(shape, strides, ptr, 2, H)


def test_qkv_layout_reads_a_tensors_own_strides():
    """A strided view reaches the rules with its own strides: a slice of
    wider rows is refused by its pitch or by contiguity, a contiguous view
    at an offset of 16 bytes into a larger buffer passes."""
    big = torch.zeros(2, 50, 3 * 128 + 4, dtype=torch.bfloat16)
    view = big[..., :3 * 128]
    with pytest.raises(ValueError, match="16 bytes apart"):
        ca._qkv_layout(tuple(view.shape), view.stride(), 0, 2, 2)
    wide = torch.zeros(2, 50, 3 * 128 + 8, dtype=torch.bfloat16)[..., :384]
    with pytest.raises(ValueError, match="contiguous"):
        ca._qkv_layout(tuple(wide.shape), wide.stride(), 0, 2, 2)
    buf = torch.zeros(8 + 2 * 50 * 384, dtype=torch.bfloat16)
    sl = buf[8:].view(2, 50, 384)
    offset = sl.data_ptr() - buf.data_ptr()
    assert offset == 16
    assert ca._qkv_layout(tuple(sl.shape), sl.stride(), offset, 2, 2) == \
        (2, 50, 128, 64)

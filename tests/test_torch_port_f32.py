"""The f32 compute dtype of the port's kernels, on the CPU.

``BackboneConfig(dtype="float32")`` runs TinyViT and CLIP in f32 through
K1-K11 on the card.  Each of their C entry points has an f32 twin beside
its bf16 one (``ops/_build.py SIGNATURES``), and each wrapper launches
the twin of its activations' dtype.  What is checked here, where there is
no ``nvcc`` and no card: every C name in ``SIGNATURES`` is defined in its
source, the twelve bf16 entries of K1-K11 each have an f32 twin, the
wrappers let bf16 and f32 through their dtype gate and refuse any other
dtype and operands of two dtypes before anything is built, and the plan of
K11's f32 projection (the GEMM core's kSplitF32 kind, which streams all D
input channels: no head chunks) fits in shared memory.  The kernels themselves are held against
their plain f32 versions by tests/test_torch_port_cuda.py on the card; the
plain f32 versions against the JAX package by the other port tests.
"""

import re

import pytest
import torch

from geoguessr_ai_torch.ops import _build
from geoguessr_ai_torch.ops import clip_attention as ca
from geoguessr_ai_torch.ops import mbconv
from geoguessr_ai_torch.ops import window_attention as wa

#: The bf16 C entries of K1-K11 (library, entry): each has an f32 twin.
BF16_ENTRIES = (
    ("fused_block", "fused_block_bf16"),             # K1
    ("fb_s2", "fb_s2_bf16"),                         # K2
    ("attention_qkv", "attention_qkv_bf16"),         # K3
    ("attention_qkv_bwd", "attention_qkv_bwd_bf16"),  # K4
    ("attention_bwd_merged", "attention_bwd_merged_bf16"),  # K5
    ("attention_bwd_qtiled", "attention_bwd_qtiled_bf16"),  # K7
    ("attention_headmajor", "attention_qtiled_bf16"),   # K8a
    ("attention_headmajor", "attention_batched_bf16"),  # K8b
    ("fb4d", "fb4d_bf16"),                           # K9
    ("mbconv", "mbconv_bf16"),                       # K10
    ("clip_flash", "clip_flash_bf16"),               # K6
    ("clip_flash_proj", "clip_flash_proj_bf16"),     # K11
)


def _defined_entries(lib):
    src = open(_build.CSRC / f"{lib}.cu").read()
    return set(re.findall(r'extern "C" int (\w+)\(', src))


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_every_entry_point_is_defined_in_its_source(lib):
    assert set(_build.SIGNATURES[lib]) == _defined_entries(lib)


@pytest.mark.parametrize("lib,entry", BF16_ENTRIES)
def test_every_bf16_kernel_entry_has_an_f32_twin(lib, entry):
    twin = entry[:-len("bf16")] + "f32"
    assert twin in _build.SIGNATURES[lib]
    assert _build.SIGNATURES[lib][twin] == _build.SIGNATURES[lib][entry]
    assert twin in _defined_entries(lib)


def _t(*shape, dtype):
    return torch.zeros(*shape, dtype=dtype)


def _calls(dtype, g_dtype=None):
    """Each kernel wrapper of K1-K11 called on CPU tensors of ``dtype`` (the
    backward's cotangent and K8's k in ``g_dtype``, when given), at shapes
    every other check passes."""
    g_dtype = g_dtype or dtype
    f32 = torch.float32
    W, N, C, H = 2, 256, 64, 2
    x = _t(W, N, C, dtype=dtype)
    p = dict(ln_scale=_t(C, dtype=f32), ln_bias=_t(C, dtype=f32),
             w_qkv=_t(C, 3 * C, dtype=f32), b_qkv=_t(3 * C, dtype=f32),
             w_proj=_t(C, C, dtype=f32), b_proj=_t(C, dtype=f32))
    bias = _t(H, N, N, dtype=f32)
    qkv = _t(W, N, 3 * C, dtype=dtype)
    g = _t(W, N, C, dtype=g_dtype)
    q = _t(8, H, N, 32, dtype=dtype)
    k = _t(8, H, N, 32, dtype=g_dtype)
    cq = _t(2, 50, 3 * 128, dtype=dtype)
    mb = (_t(1, 16, 16, 32, dtype=dtype), _t(32, 128, dtype=f32),
          _t(128, dtype=f32), _t(128, dtype=f32), _t(3, 3, 128, dtype=f32),
          _t(128, dtype=f32), _t(128, dtype=f32), _t(128, 32, dtype=f32),
          _t(32, dtype=f32), _t(32, dtype=f32))
    return {
        "K1": lambda: wa._fused_block_cuda(x, *p.values(), bias, 0.1, H,
                                           1e-5),
        "K2": lambda: wa._fb_s2_cuda(x, p["ln_scale"], p["ln_bias"],
                                     p["w_qkv"], p["b_qkv"], bias, 0.1, H,
                                     1e-5),
        "K3": lambda: wa._attention_qkv_fused_cuda(qkv, bias, 0.1, H),
        "K4": lambda: wa._attention_qkv_bwd_cuda(qkv, bias, g, 0.1, H),
        "K5": lambda: wa._attention_bwd_merged_cuda(qkv, bias, g, 0.1, H),
        "K7": lambda: wa._attention_bwd_qtiled_cuda(qkv, bias, g, 0.1, H),
        "K8a": lambda: wa._attention_qtiled_cuda(q, k, q, bias, 0.1),
        "K8b": lambda: wa._attention_batched_cuda(q, k, q, bias, 0.1),
        "K9": lambda: wa._fb4d_cuda(x.reshape(2, 16, 16, C), *p.values(),
                                    bias, 0.1, H, 16, 1e-5),
        "K10": lambda: mbconv._mbconv_cuda(*mb, False),
        "K6": lambda: ca._flash_cuda(cq, 0.1, 2),
        "K11": lambda: ca._flash_proj_cuda(cq, _t(128, 128, dtype=f32), 0.1,
                                           2),
    }


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K7", "K8a", "K8b", "K9", "K10",
           "K6", "K11")


@pytest.fixture
def nothing_built(monkeypatch):
    def no_build(names=()):
        raise AssertionError("nothing may be built")

    monkeypatch.setattr(_build, "build", no_build)


def test_typed_entry_refuses_other_dtypes_before_building(nothing_built):
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
            _build.typed_entry("attention_qkv", "attention_qkv", dtype)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_wrappers_let_bf16_and_f32_through_the_dtype_gate(nothing_built,
                                                          kernel, dtype):
    """bf16 and f32 pass the dtype checks and stop only at the device: a
    CPU tensor never reaches a kernel wrapper's launch."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _calls(dtype)[kernel]()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["f16", "f64"])
def test_wrappers_refuse_other_dtypes(nothing_built, kernel, dtype):
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        _calls(dtype)[kernel]()


@pytest.mark.parametrize("kernel", ["K4", "K5", "K7", "K8a", "K8b"])
def test_wrappers_refuse_operands_of_two_dtypes(nothing_built, kernel):
    """The backward's qkv and cotangent, and K8's q and k, of two dtypes."""
    with pytest.raises(ValueError, match="mixed"):
        _calls(torch.bfloat16, torch.float32)[kernel]()


@pytest.mark.parametrize("D,hd,want", [
    (1024, 64, dict(BN=256, S=2, KB=16)),   # ViT-L/14
    (768, 64, dict(BN=256, S=2, KB=12)),    # ViT-B/32
    (256, 64, dict(BN=256, S=2, KB=4)),     # narrow
    (128, 16, dict(BN=128, S=3, KB=2)),
])
def test_flash_proj_f32_core_plan_fits_in_shared_memory(D, hd, want):
    """K11 in f32 projects o's planes with the GEMM core's kSplitF32 kind,
    which streams all D input channels in 128-byte k-boxes of both planes
    (the first design's head chunks are gone): two ring stages at 256
    columns, three at 128, within the bytes a block may opt in to, the same
    tiles as the bf16 kind with half its stages; a head dim only picks H."""
    from test_torch_port_gemm_sm90 import SMEM_MAX, _plan

    M = 64 * 577
    got = _plan(M, D, D, 2, planes=2)
    assert {k: got[k] for k in want} == want
    assert got["bytes"] <= SMEM_MAX
    bf16 = _plan(M, D, D, 2)
    assert bf16["BN"] == got["BN"] and bf16["KB"] == got["KB"]
    assert got["S"] == bf16["S"] // 2
    assert D % 128 == 0 and (D // hd) * hd == D
    assert not hasattr(ca, "_flash_proj_chunk")


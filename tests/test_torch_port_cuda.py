"""The port's CUDA kernels, its autograd ops and its guess path on the
card, held against the plain PyTorch path.

Every test here needs a CUDA GPU and ``nvcc`` and skips without them.  The
file imports no JAX, so it also runs on a GPU machine that has none;
``--noconftest`` skips tests/conftest.py, which sets JAX up:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import glob
import os

import numpy as np
import pytest
import torch

from geoguessr_ai_torch.ops import clip_attention as ca
from geoguessr_ai_torch.ops import window_attention as wa

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

#: Kernel vs plain version, both bf16 on the card: max |k - p| / max |p|
#: (a few bf16 ulps of the output's range; as chip_smoke.py).
KERNEL_REL_TOL = 2e-2
#: An op's input gradients through the kernels vs autograd through the
#: plain version, both bf16 on the card: the plain backward also rounds
#: dp = g.v and the bf16 GEMM cotangents at other points (as chip_smoke.py).
GRAD_REL_TOL = 2e-2

#: TinyViT's head dim (every stage), which the tests below use unless they
#: name another.
HD = 32

#: The narrow TinyViT of tests/test_torch_port_serving.py: hd=32 at every
#: stage, so K1 (stage 1), K2 (stage 2) and K3 (stage 3) all run.
NARROW = dict(image_size=512, embed_dims=(32, 64, 64, 96), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 2, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for "
                    "sm_90a and have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(W, N, C, H, device, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)

    def t(*shape, mean=0.0, std=0.1):
        a = rng.normal(mean, std, shape).astype(np.float32)
        return torch.from_numpy(a).to(device)

    return dict(x=t(W, N, C, std=1.0).to(dtype), ln_scale=t(C, mean=1.0),
                ln_bias=t(C), w_qkv=t(C, 3 * C), b_qkv=t(3 * C),
                w_proj=t(C, C), b_proj=t(C), bias=t(H, N, N, std=0.5))


_K1_KEYS = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
            "bias")
_K2_KEYS = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "bias")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("W,N,C,H", [(4, 256, 192, 6), (2, 1024, 64, 2)])
def test_cuda_kernel_matches_plain(cuda_device, kernel, W, N, C, H):
    a = _inputs(W, N, C, H, cuda_device)
    scale = (C // H) ** -0.5
    if kernel == "K1":
        args = [a[k] for k in _K1_KEYS] + [scale, H, 1e-5]
        kern, plain = wa._fused_block_cuda, wa._fused_block_plain
        name = "_fused_block_cuda"
    elif kernel == "K2":
        args = [a[k] for k in _K2_KEYS] + [scale, H, 1e-5]
        kern, plain = wa._fb_s2_cuda, wa._fb_s2_plain
        name = "_fb_s2_cuda"
    else:
        qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                               a["b_qkv"], 1e-5)
        args = [qkv, a["bias"], scale, H]
        kern = wa._attention_qkv_fused_cuda
        plain = wa._attention_qkv_fused_plain
        name = "_attention_qkv_fused_cuda"
    before = wa.LAUNCHES[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 1
    want = plain(*args).float()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _bwd_inputs(W, N, H, device, seed=0, hd=HD, dtype=torch.bfloat16):
    """qkv and the cotangent g in ``dtype``, an f32 bias: as the train
    path hands them to the attention backward."""
    rng = np.random.default_rng(seed)
    D = H * hd

    def t(*shape, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(device)

    return (t(W, N, 3 * D).to(dtype), t(H, N, N, std=0.5),
            t(W, N, D).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("W,N,H", [(4, 256, 6), (2, 1024, 12), (3, 128, 2)])
def test_cuda_backward_kernel_matches_plain(cuda_device, kernel, W, N, H):
    """K4 and K5 against their plain mirrors: d_qkv and d_bias each within
    KERNEL_REL_TOL of the mirror's range."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device)
    scale = HD ** -0.5
    if kernel == "K4":
        kern, plain = wa._attention_qkv_bwd_cuda, wa._attention_qkv_bwd_plain
        name = "_attention_qkv_bwd_cuda"
    else:
        kern = wa._attention_bwd_merged_cuda
        plain = wa._attention_bwd_merged_plain
        name = "_attention_bwd_merged_cuda"
    before = wa.LAUNCHES[name]
    dqkv, dbias = kern(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 1
    want_dqkv, want_dbias = plain(qkv, bias, g, scale, H)
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    assert bool(torch.isfinite(dqkv).all() and torch.isfinite(dbias).all())
    assert _rel_err(dqkv, want_dqkv) < KERNEL_REL_TOL
    assert _rel_err(dbias, want_dbias) < KERNEL_REL_TOL


#: op -> (W, N, C, H): stage 1 (K1 and K4), stage 2 (K2 and K5) and stage 3
#: (K3 and K4) of TinyViT-21M-512, with fewer windows.
OP_SHAPES = {
    "fused_block_attention": (16, 256, 192, 6),
    "fused_block_attention_noproj": (2, 1024, 384, 12),
    "window_attention_qkv": (4, 256, 576, 18),
}


def _op_args(op, device):
    W, N, C, H = OP_SHAPES[op]
    a = _inputs(W, N, C, H, device)
    if op == "window_attention_qkv":
        qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                               a["b_qkv"], 1e-5)
        args = [qkv, a["bias"]]
    else:
        args = [a[k] for k in (_K1_KEYS if op == "fused_block_attention"
                               else _K2_KEYS)]
    return [t.detach().requires_grad_() for t in args], (C // H) ** -0.5, H


_PLAIN_OPS = {
    "fused_block_attention": lambda *a: wa._fused_block_plain(*a, 1e-5),
    "fused_block_attention_noproj": lambda *a: wa._fb_s2_plain(*a, 1e-5),
    "window_attention_qkv": wa._attention_qkv_fused_plain,
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(OP_SHAPES))
def test_cuda_op_gradients_match_plain_autograd(cuda_device, op):
    """Each op on CUDA tensors that require grad has a grad_fn, and its
    input gradients (kernels forward and backward) match autograd through
    the plain version on the same bf16 inputs."""
    args, scale, H = _op_args(op, cuda_device)
    out = getattr(wa, op)(*args, scale, H)
    assert out.grad_fn is not None
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    gout = torch.randn(out.shape, generator=gen, device=cuda_device).to(out.dtype)
    got = torch.autograd.grad(out, args, gout)
    want = torch.autograd.grad(_PLAIN_OPS[op](*args, scale, H), args, gout)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL, (i, _rel_err(a, b))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = _inputs(2, 256, 192, 6, cuda_device)
    args = [a[k] for k in _K2_KEYS]
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        wa._fb_s2_cuda(args[0].half(), *args[1:], 0.18, 6, 1e-5)
    qkv, bias, g = _bwd_inputs(2, 256, 6, cuda_device)
    with pytest.raises(ValueError, match="mixed"):
        wa._attention_qkv_bwd_cuda(qkv, bias, g.float(), 0.18, 6)
    with pytest.raises(ValueError, match="head dim"):
        wa._fb_s2_cuda(*args[:-1], a["bias"][:4], 0.18, 4, 1e-5)
    qkv = torch.zeros(2, 100, 576, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 64"):
        wa._attention_qkv_fused_cuda(qkv, a["bias"], 0.18, 6)


@pytest.mark.cuda
def test_narrow_engine_on_the_card_matches_the_cpu(cuda_device):
    """The guess path with seeded weights: bf16 on the card (kernels) vs
    f32 on the CPU (plain path), on the fixture panorama."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    paths = sorted(glob.glob(os.path.join(FIXTURES, "heading=*.jpg")))
    gpu = ServingEngine(seed=1, backbone_config=TinyViTConfig(**NARROW))
    assert gpu.device.type == "cuda"
    wa.reset_launches()
    got = gpu.predict_images(paths)
    torch.cuda.synchronize()
    forwards = ("_fused_block_cuda", "_fb_s2_cuda", "_attention_qkv_fused_cuda")
    assert {k: wa.LAUNCHES[k] for k in forwards} == dict.fromkeys(forwards, 1)
    assert sum(wa.LAUNCHES.values()) == 3, wa.LAUNCHES

    cpu = ServingEngine(device="cpu", seed=1, backbone_config=TinyViTConfig(
        dtype=torch.float32, **NARROW))
    want = cpu.predict_images(paths)
    a, b = got.embedding.astype(np.float64), want.embedding.astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos
    assert got.top_ids[0] == want.top_ids[0]


# ---------------------------------------------------------------------------
# CLIP attention: K6 and K11 (hd=64, q|k|v block layout, ragged N).
# ---------------------------------------------------------------------------

#: (B, N, D, H): ViT-L/14-336's N=577 (9 x 64 + 1) and ViT-B/32's N=50 (one
#: partial tile), at narrow widths with hd=64.
CLIP_SHAPES = [(2, 577, 256, 4), (3, 50, 128, 2)]


def _clip_inputs(B, N, D, device, seed=0, dtype=torch.bfloat16):
    """qkv as the fused GEMM hands it over (in ``dtype``), and a (D, D)
    out-proj weight in (in, out) layout."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, N, 3 * D)).astype(np.float32)
    w = rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)
    return (torch.from_numpy(qkv).to(device, dtype),
            torch.from_numpy(w).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K6", "K11"])
@pytest.mark.parametrize("B,N,D,H", CLIP_SHAPES)
def test_cuda_clip_kernel_matches_plain(cuda_device, kernel, B, N, D, H):
    qkv, w = _clip_inputs(B, N, D, cuda_device)
    scale = 64 ** -0.5
    if kernel == "K6":
        name, run = "_flash_cuda", lambda f: f(qkv, scale, H)
        kern, plain = ca._flash_cuda, ca._flash_plain
    else:
        name, run = "_flash_proj_cuda", lambda f: f(qkv, w, scale, H)
        kern, plain = ca._flash_proj_cuda, ca._flash_proj_plain
    before = ca.LAUNCHES[name]
    got = run(kern)
    torch.cuda.synchronize()
    assert ca.LAUNCHES[name] == before + 1
    want = run(plain)
    assert got.shape == want.shape == (B, N, D)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["clip_attention", "clip_attention_proj"])
def test_cuda_clip_op_gradients_match_plain_autograd(cuda_device, op):
    """The kernel forward and the plain-autograd backward (the JAX
    package's own recompute) on the card, against autograd through the
    plain version."""
    qkv, w = _clip_inputs(2, 577, 256, cuda_device, seed=1)
    leaves = [qkv.requires_grad_()] + ([w.requires_grad_()]
                                       if op == "clip_attention_proj" else [])
    scale = 64 ** -0.5
    out = getattr(ca, op)(*leaves, scale, 4)
    assert out.grad_fn is not None
    gout = torch.randn(out.shape, device=cuda_device).to(out.dtype)
    got = torch.autograd.grad(out, leaves, gout)
    plain = ca._flash_plain if op == "clip_attention" else ca._flash_proj_plain
    want = torch.autograd.grad(plain(*leaves, scale, 4), leaves, gout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL


@pytest.mark.cuda
def test_cuda_clip_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    qkv, w = _clip_inputs(2, 50, 128, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        ca._flash_cuda(qkv.half(), 0.125, 2)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        ca._flash_proj_cuda(qkv.half(), w, 0.125, 2)
    with pytest.raises(ValueError, match="head dim"):
        ca._flash_cuda(qkv, 0.125, 3)  # D=128 is no whole number of heads
    with pytest.raises(ValueError, match="w_proj"):
        ca._flash_proj_cuda(qkv, w[:64], 0.125, 2)
    odd, _ = _clip_inputs(2, 50, 192, cuda_device)  # H=3: D not a multiple of 128
    with pytest.raises(ValueError, match="multiple of 128"):
        ca._flash_proj_cuda(odd, torch.zeros(192, 192, dtype=torch.bfloat16,
                                              device=cuda_device), 0.125, 3)


#: A narrow CLIP tower with hd=64 at 84 px: N = 6 x 6 + 1 = 37.
CLIP_NARROW = dict(image_size=84, patch_size=14, hidden_size=128,
                   num_layers=2, num_heads=2, mlp_dim=256)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_proj", [False, True])
def test_narrow_clip_engine_on_the_card_matches_the_cpu(cuda_device,
                                                        fuse_proj):
    """The CLIP guess path with seeded weights: bf16 on the card (K6, or
    K11 with pallas_fuse_proj) vs f32 on the CPU, on the fixture panorama."""
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    paths = sorted(glob.glob(os.path.join(FIXTURES, "heading=*.jpg")))
    gpu = ServingEngine(backbone="clip", seed=1,
                        backbone_config=CLIPVisionConfig(
                            pallas_fuse_proj=fuse_proj, **CLIP_NARROW))
    ca.reset_launches()
    wa.reset_launches()
    got = gpu.predict_images(paths)
    torch.cuda.synchronize()
    want = {"_flash_cuda": 0, "_flash_proj_cuda": 0}
    want["_flash_proj_cuda" if fuse_proj else "_flash_cuda"] = 2  # 2 layers
    assert ca.LAUNCHES == want
    assert sum(wa.LAUNCHES.values()) == 0, wa.LAUNCHES

    cpu = ServingEngine(backbone="clip", device="cpu", seed=1,
                        backbone_config=CLIPVisionConfig(
                            dtype=torch.float32, **CLIP_NARROW))
    ref = cpu.predict_images(paths)
    a, b = got.embedding.astype(np.float64), ref.embedding.astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos
    assert got.top_ids[0] == ref.top_ids[0]


# ---------------------------------------------------------------------------
# The bulk-embedding kernels: K9 (the 4D fused block) and K10 (the fused
# MBConv).
# ---------------------------------------------------------------------------

#: (B, Hm, Wm, C, H): stage 1 of TinyViT-21M-512 (a 64x64 map of 16x16
#: windows) at 2 images, and a narrow 32x32 map; window 16, hd=32.
FB4D_SHAPES = [(2, 64, 64, 192, 6), (1, 32, 32, 64, 2)]


def _fb4d_args(B, Hm, Wm, C, H, device, seed=0, dtype=torch.bfloat16):
    a = _inputs(B * Hm * Wm // 256, 256, C, H, device, seed, dtype)
    a["x"] = a["x"].reshape(B, Hm, Wm, C)
    return [a[k] for k in _K1_KEYS], (C // H) ** -0.5, H


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hm,Wm,C,H", FB4D_SHAPES)
def test_cuda_fb4d_matches_plain(cuda_device, B, Hm, Wm, C, H):
    args, scale, H = _fb4d_args(B, Hm, Wm, C, H, cuda_device)
    before = wa.LAUNCHES["_fb4d_cuda"]
    got = wa._fb4d_cuda(*args, scale, H, 16, 1e-5)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_fb4d_cuda"] == before + 1
    want = wa._fb4d_plain(*args, scale, H, 16, 1e-5)
    assert got.shape == want.shape == (B, Hm, Wm, C)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_fb4d_gradients_match_plain_autograd(cuda_device):
    """K9 forward, then the partition-path recompute with K3 and K4, against
    autograd through the plain version, at 1 image of stage 1."""
    args, scale, H = _fb4d_args(1, 64, 64, 192, 6, cuda_device, seed=2)
    leaves = [t.detach().requires_grad_() for t in args]
    out = wa.fused_block_attention_4d(*leaves, scale, H, 16)
    assert out.grad_fn is not None
    gout = torch.randn(out.shape, device=cuda_device).to(out.dtype)
    got = torch.autograd.grad(out, leaves, gout)
    want = torch.autograd.grad(wa._fb4d_plain(*leaves, scale, H, 16, 1e-5),
                               leaves, gout)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL, (i, _rel_err(a, b))


def _mbconv_args(B, H, W, C, E, device, seed=0, dtype=torch.bfloat16):
    """x in ``dtype``, f32 conv weights in the JAX layouts and folded BN
    pairs."""
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, mean=0.0):
        a = rng.normal(mean, std, shape).astype(np.float32)
        return torch.from_numpy(a).to(device)

    def folded(n):
        var = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        return fold_bn(t(n, mean=1.0, std=0.1), t(n, std=0.1),
                       t(n, std=0.1), var.to(device))

    return (t(B, H, W, C).to(dtype), t(C, E, std=C ** -0.5), *folded(E),
            t(3, 3, E, std=3 ** -1), *folded(E), t(E, C, std=E ** -0.5),
            *folded(C))


#: (B, H, W, C, E): stage 0 of TinyViT-21M-512 at 2 images, and a narrow
#: map whose sides are no multiple of the 8 x 16 output tile.
MBCONV_SHAPES = [(2, 128, 128, 96, 384), (3, 20, 24, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("B,H,W,C,E", MBCONV_SHAPES)
def test_cuda_mbconv_matches_plain(cuda_device, B, H, W, C, E, exact):
    from geoguessr_ai_torch.ops import mbconv

    args = _mbconv_args(B, H, W, C, E, cuda_device)
    before = mbconv.LAUNCHES["_mbconv_cuda"]
    got = mbconv._mbconv_cuda(*args, exact)
    torch.cuda.synchronize()
    assert mbconv.LAUNCHES["_mbconv_cuda"] == before + 1
    want = mbconv._mbconv_plain(*args, exact)
    assert got.shape == want.shape == (B, H, W, C)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_fused_mbconv_refuses_autograd_and_odd_shapes(cuda_device):
    from geoguessr_ai_torch.ops import mbconv

    args = list(_mbconv_args(1, 16, 16, 32, 128, cuda_device))
    args[1] = args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        mbconv.fused_mbconv(*args)
    with torch.no_grad():
        assert mbconv.fused_mbconv(*args).shape == (1, 16, 16, 32)
    with pytest.raises(ValueError, match="C in"):
        mbconv._mbconv_cuda(args[0][..., :16].contiguous(), args[1][:16],
                            *args[2:7], args[7][:, :16], *(a[:16] for a in
                                                            args[8:]), False)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        mbconv._mbconv_cuda(args[0].half(), *args[1:], False)


@pytest.mark.cuda
def test_narrow_engine_with_both_knobs_on_the_card_matches_the_cpu(
        cuda_device):
    """fused_mbconv and fused_block_4d on the card (K10 at stage 0, K9 at
    stage 1) vs f32 on the CPU (plain path), on the fixture panorama."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.serving.engine import ServingEngine

    knobs = dict(fused_mbconv=True, fused_block_4d=True, **NARROW)
    paths = sorted(glob.glob(os.path.join(FIXTURES, "heading=*.jpg")))
    gpu = ServingEngine(seed=1, backbone_config=TinyViTConfig(**knobs))
    wa.reset_launches()
    mbconv.reset_launches()
    got = gpu.predict_images(paths)
    torch.cuda.synchronize()
    assert mbconv.LAUNCHES["_mbconv_cuda"] == 1
    assert wa.LAUNCHES == dict(wa.LAUNCHES, _fb4d_cuda=1, _fb_s2_cuda=1,
                               _attention_qkv_fused_cuda=1,
                               _fused_block_cuda=0)
    assert sum(wa.LAUNCHES.values()) == 3, wa.LAUNCHES

    cpu = ServingEngine(device="cpu", seed=1, backbone_config=TinyViTConfig(
        dtype=torch.float32, **knobs))
    want = cpu.predict_images(paths)
    a, b = got.embedding.astype(np.float64), want.embedding.astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos
    assert got.top_ids[0] == want.top_ids[0]


# ---------------------------------------------------------------------------
# The head-major window attention (K8a, K8b), the two-kernel large-N
# backward (K7) and the plain-forward / kernel-backward route.
# ---------------------------------------------------------------------------

#: (kernel, W, H, N): the shapes the head-major serving path gives K8b
#: (stage 1 at bucket 16, stage 3 at bucket 16) and K8a (stage 2 at bucket
#: 16, stage 3 at bucket 1, W=4 not a multiple of BLOCK_W).
HEADMAJOR_SHAPES = [("K8b", 1024, 6, 256), ("K8b", 64, 18, 256),
                    ("K8a", 64, 12, 1024), ("K8a", 4, 18, 256)]


def _headmajor_inputs(W, H, N, device, seed=0, hd=HD, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(device)

    q, k, v = (t(W, H, N, hd).to(dtype) for _ in range(3))
    return q, k, v, t(H, N, N, std=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,W,H,N", HEADMAJOR_SHAPES)
def test_cuda_headmajor_kernel_matches_plain(cuda_device, kernel, W, H, N):
    """K8a and K8b against ``_attention_plain``, called directly and
    through ``window_attention``'s dispatch."""
    q, k, v, bias = _headmajor_inputs(W, H, N, cuda_device)
    name = {"K8a": "_attention_qtiled_cuda",
            "K8b": "_attention_batched_cuda"}[kernel]
    scale = 32 ** -0.5
    want = wa._attention_plain(q, k, v, bias, scale)
    before = dict(wa.LAUNCHES)
    got = getattr(wa, name)(q, k, v, bias, scale)
    routed = wa.window_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before[name] + 2
    assert sum(wa.LAUNCHES.values()) == sum(before.values()) + 2
    assert torch.equal(got, routed)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_window_attention_gradients_match_plain_autograd(cuda_device):
    """K8a forward, the plain-autograd backward (the JAX package's own
    recompute), against autograd through the plain version."""
    leaves = [t.requires_grad_() for t in
              _headmajor_inputs(2, 12, 1024, cuda_device, seed=1)]
    scale = 32 ** -0.5
    out = wa.window_attention(*leaves, scale)
    assert out.grad_fn is not None
    gout = torch.randn(out.shape, device=cuda_device).to(out.dtype)
    got = torch.autograd.grad(out, leaves, gout)
    want = torch.autograd.grad(wa._attention_plain(*leaves, scale), leaves,
                               gout)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL, (i, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,H", [(64, 1024, 12), (2, 1024, 2), (3, 512, 6)])
def test_cuda_bwd_qtiled_matches_plain_and_k5(cuda_device, W, N, H):
    """K7 against its plain mirror and against K5 on the same inputs, and
    its d_bias (and d_qkv) bitwise the same over two calls."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device)
    scale = HD ** -0.5
    before = wa.LAUNCHES["_attention_bwd_qtiled_cuda"]
    dqkv, dbias = wa._attention_bwd_qtiled_cuda(qkv, bias, g, scale, H)
    again = wa._attention_bwd_qtiled_cuda(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_attention_bwd_qtiled_cuda"] == before + 2
    assert torch.equal(dbias, again[1]) and torch.equal(dqkv, again[0])
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    for want in (wa._attention_bwd_qtiled_plain(qkv, bias, g, scale, H),
                 wa._attention_bwd_merged_cuda(qkv, bias, g, scale, H)):
        assert _rel_err(dqkv, want[0]) < KERNEL_REL_TOL
        assert _rel_err(dbias, want[1]) < KERNEL_REL_TOL


#: (W, N, H) of the bf16 core's cases at each head dim: one window at
#: N=64 (half a 128-row tile), three at N=128, 17 at a ragged N=196 (padded
#: to 256, 17 window groups), N=256 and N=1024.
SM90_SHAPES = ((1, 64, 2), (3, 128, 2), (17, 196, 2), (3, 256, 3),
               (2, 1024, 2))
#: The train shapes: K4 at stages 1 and 3, K5 and K7 at stage 2 (hd 32).
SM90_TRAIN_SHAPES = (("K4", 1024, 256, 6), ("K4", 64, 256, 18),
                     ("K7", 64, 1024, 12), ("K5", 64, 1024, 12))
SM90_KERNELS = {
    "K4": ("_attention_qkv_bwd_cuda", wa._attention_qkv_bwd_plain),
    "K7": ("_attention_bwd_qtiled_cuda", wa._attention_bwd_qtiled_plain),
    "K5": ("_attention_bwd_merged_cuda", wa._attention_bwd_merged_plain),
}
#: NaN elements on each side of every buffer a wrapper allocates in
#: ``_nan_fenced_buffers`` (128 bytes of bf16, so views stay aligned).
FENCE = 64


def _nan_fenced_buffers(monkeypatch):
    """Makes torch.empty and torch.empty_like return views into NaN-filled
    buffers with FENCE NaN elements before and after; returns the list of
    (buffer, elements) made, for ``_check_fenced``."""
    made = []
    real_empty = torch.empty

    def fenced(shape, dtype, device):
        n = int(np.prod(shape))
        buf = real_empty(n + 2 * FENCE, dtype=dtype, device=device)
        buf.fill_(float("nan"))
        made.append((buf, n))
        return buf[FENCE:FENCE + n].view(shape)

    def empty(*shape, dtype=torch.float32, device=None, **kwargs):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = shape[0]
        return fenced(tuple(shape), dtype, device)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t, **kw: fenced(tuple(t.shape), t.dtype,
                                               t.device))
    return made


def _check_fenced(made):
    """Every element of every buffer was written (no NaN left) and no
    element around one was (the fences still NaN)."""
    assert made
    for buf, n in made:
        assert bool(torch.isnan(buf[:FENCE]).all()
                    and torch.isnan(buf[FENCE + n:]).all())
        assert bool(torch.isfinite(buf[FENCE:FENCE + n]).all())


def _sm90_case(monkeypatch, kernel, W, N, H, hd):
    """One bf16 K4, K5 or K7 call in NaN-fenced outputs and scratch, a second
    call, and the plain version: every element written and none outside,
    one launch a call, bitwise equal calls, d_qkv and d_bias within
    KERNEL_REL_TOL of the plain version."""
    name, plain = SM90_KERNELS[kernel]
    qkv, bias, g = _bwd_inputs(W, N, H, torch.device("cuda"), hd=hd)
    scale = hd ** -0.5
    kern = getattr(wa, name)
    before = wa.LAUNCHES[name]
    made = _nan_fenced_buffers(monkeypatch)
    dqkv, dbias = kern(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    # stats, d_qkv and d_bias, and the partials when G > 1 (K5: one group)
    G = wa._bwd_call_plan(kernel, W, -(-N // 64) * 64, H, hd,
                          wa.tile_knobs())["G"]
    assert len(made) >= 3 + (G > 1)
    again = kern(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 2
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    assert dbias.shape == (H, N, N) and dbias.dtype == torch.float32
    want_dqkv, want_dbias = plain(qkv, bias, g, scale, H)
    assert _rel_err(dqkv, want_dqkv) < KERNEL_REL_TOL
    assert _rel_err(dbias, want_dbias) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,H", SM90_SHAPES)
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("kernel", ["K4", "K7", "K5"])
def test_cuda_bwd_sm90_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, kernel, hd, W, N, H):
    """The bf16 core of K4, K5 and K7 (``csrc/attention_bwd_sm90.cuh``) at
    head dims 16, 32 and 64, N from half a row tile to 1024, ragged N and
    W of 1, 3 and 17 (window groups of one and of several windows; K5
    always one)."""
    _sm90_case(monkeypatch, kernel, W, N, H, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,W,N,H", SM90_TRAIN_SHAPES)
def test_cuda_bwd_sm90_at_the_train_shapes(cuda_device, monkeypatch, kernel,
                                           W, N, H):
    """As above at the shapes a B=16 train step gives K4 (21 and 7 window
    groups), K7 and K5 (one group of 64 windows)."""
    _sm90_case(monkeypatch, kernel, W, N, H, HD)


@pytest.mark.cuda
def test_cuda_bwd_sm90_k5_and_k7_give_equal_bits(cuda_device):
    """At one window group K7 runs K5's launches: d_qkv and d_bias equal
    bit for bit (W=8 at stage 2's N and H)."""
    W, N, H = 8, 1024, 12
    assert wa._bwd_groups(W, N, H) == 1
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device, seed=4)
    k7 = wa._attention_bwd_qtiled_cuda(qkv, bias, g, HD ** -0.5, H)
    k5 = wa._attention_bwd_merged_cuda(qkv, bias, g, HD ** -0.5, H)
    torch.cuda.synchronize()
    assert torch.equal(k7[0], k5[0]) and torch.equal(k7[1], k5[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8, 64, 1024])
@pytest.mark.parametrize("N", [64, 128, 192, 256, 448])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_cuda_headmajor_sm90_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, hd, N, W):
    """K8b's bf16 kernel (TMA + wgmma, ``csrc/attention_headmajor.cu``) at
    head dims 16, 32 and 64, N from one 64-key tile to 448 (the whole row
    in one chunk up to 256, several above) and W from one group of
    BLOCK_W=8 windows to 1024: the output in a NaN-fenced buffer (every
    element written, none around it), one launch a call, two calls
    bitwise equal, within KERNEL_REL_TOL of ``_attention_plain``."""
    assert wa.BLOCK_W == 8
    H = 2
    q, k, v, bias = _headmajor_inputs(W, H, N, cuda_device, seed=N + hd,
                                      hd=hd)
    scale = hd ** -0.5
    name = "_attention_batched_cuda"
    before = wa.LAUNCHES[name]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._attention_batched_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    again = wa._attention_batched_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = wa._attention_plain(q, k, v, bias, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,H", [(3, 49, 4), (17, 196, 2), (3, 256, 3),
                                   (2, 1024, 2), (1024, 64, 4)])
@pytest.mark.parametrize("kernel", ["K4", "K7", "K5"])
def test_cuda_bwd_sm90_64_row_kind(cuda_device, monkeypatch, kernel, W, N, H):
    """BWD_Q_ROWS = 64, the backward core's 64-row kind (hd 32: two pipes a
    block), as ``_sm90_case`` holds the default kind: ragged and whole
    N, one window group and several."""
    with pytest.MonkeyPatch.context() as knobs:
        knobs.setattr(wa, "BWD_Q_ROWS", 64)
        _sm90_case(monkeypatch, kernel, W, N, H, HD)


@pytest.mark.cuda
@pytest.mark.parametrize("W,H,N", [(3, 2, 128), (8, 6, 256), (5, 3, 1024),
                                   (1, 2, 384)])
@pytest.mark.parametrize("kernel", ["K8a", "K8b", "K3"])
def test_cuda_fwd_sm90_128_row_kind(cuda_device, monkeypatch, kernel, W, H,
                                    N):
    """FWD_Q_ROWS = 128, the forward core's 128-row kind (hd 32, N a
    multiple of 128; the last pair of an odd group repeats its window
    unstored): the output in a NaN-fenced buffer, one launch a call, two
    calls bitwise equal, within KERNEL_REL_TOL of the plain version."""
    if kernel == "K8b" and N >= 512:
        pytest.skip("K8b takes N below 512")
    scale = HD ** -0.5
    if kernel == "K3":
        qkv, bias, _ = _bwd_inputs(W, N, H, cuda_device, seed=N)
        args, name = (qkv, bias, scale, H), "_attention_qkv_fused_cuda"
        plain = wa._attention_qkv_fused_plain
    else:
        args = (*_headmajor_inputs(W, H, N, cuda_device, seed=N), scale)
        name = ("_attention_qtiled_cuda" if kernel == "K8a"
                else "_attention_batched_cuda")
        plain = wa._attention_plain
    kern = getattr(wa, name)
    with pytest.MonkeyPatch.context() as knobs:
        knobs.setattr(wa, "FWD_Q_ROWS", 128)
        before = wa.LAUNCHES[name]
        made = _nan_fenced_buffers(monkeypatch)
        got = kern(*args)
        torch.cuda.synchronize()
        monkeypatch.undo()
        _check_fenced(made)
        again = kern(*args)
        torch.cuda.synchronize()
        assert wa.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_headmajor_sm90_refuses_a_misaligned_base(cuda_device):
    """q 2 bytes past a 16-byte boundary: refused before any launch."""
    q, k, v, bias = _headmajor_inputs(8, 2, 64, cuda_device)
    buf = torch.zeros(1 + q.numel(), dtype=torch.bfloat16,
                      device=cuda_device)
    odd = buf[1:].view(q.shape)
    before = wa.LAUNCHES["_attention_batched_cuda"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa._attention_batched_cuda(odd, k, v, bias, 0.18)
    assert wa.LAUNCHES["_attention_batched_cuda"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("W,H,N,hd", [
    (64, 12, 1024, 32), (4, 18, 256, 32), (16, 8, 1024, 16),
    (16, 6, 1024, 64), (8, 2, 512, 32), (6, 2, 768, 32), (5, 2, 832, 64),
    (1, 3, 1024, 32), (3, 2, 576, 16), (7, 2, 2048, 32)])
def test_cuda_fwd_sm90_k8a_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, W, H, N, hd):
    """K8a's bf16 entry (the forward core, ``csrc/attention_fwd_sm90.cuh``)
    at the head-major serving shapes (stage 2 of bucket 16, stage 3 of
    bucket 1), at head dims 16 and 64, with the f32 bias resident (N up to
    704 at hd 32) and streamed (two-tile chunks, one-tile chunks at an odd
    C, item window groups cut short, one window): the output in a
    NaN-fenced buffer, one launch a call, two calls bitwise equal, within
    KERNEL_REL_TOL of ``_attention_plain``."""
    q, k, v, bias = _headmajor_inputs(W, H, N, cuda_device, seed=N + hd,
                                      hd=hd)
    scale = hd ** -0.5
    name = "_attention_qtiled_cuda"
    before = wa.LAUNCHES[name]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._attention_qtiled_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    again = wa._attention_qtiled_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = wa._attention_plain(q, k, v, bias, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,H,hd", [
    (64, 256, 18, 32), (4, 256, 18, 32), (8, 64, 2, 16), (8, 320, 2, 64),
    (16, 1024, 12, 32), (3, 1024, 2, 64), (1, 512, 4, 16)])
def test_cuda_fwd_sm90_k3_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, W, N, H, hd):
    """K3's bf16 entry (the forward core in the interleaved layout, the
    bf16 bias resident) at the stage-3 serving shapes of buckets 16 and 1,
    at head dims 16, 32 and 64 and N from 64 to 1024: the output in a
    NaN-fenced buffer, one launch a call, two calls bitwise equal, within
    KERNEL_REL_TOL of ``_attention_qkv_fused_plain``."""
    qkv, bias, _ = _bwd_inputs(W, N, H, cuda_device, seed=N + hd, hd=hd)
    scale = hd ** -0.5
    name = "_attention_qkv_fused_cuda"
    before = wa.LAUNCHES[name]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._attention_qkv_fused_cuda(qkv, bias, scale, H)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    again = wa._attention_qkv_fused_cuda(qkv, bias, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = wa._attention_qkv_fused_plain(qkv, bias, scale, H)
    assert got.shape == want.shape == (W, N, H * hd)
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_fwd_sm90_k3_refuses_a_misaligned_base_and_an_n_with_no_plan(
        cuda_device):
    """qkv 2 bytes past a 16-byte boundary is refused before any launch; at
    N = 1280 with hd 64 the resident bf16 bias tile leaves no room for a
    ring, so the entry returns an error and the wrapper raises, counting
    no launch."""
    qkv, bias, _ = _bwd_inputs(2, 64, 2, cuda_device)
    buf = torch.zeros(1 + qkv.numel(), dtype=torch.bfloat16,
                      device=cuda_device)
    odd = buf[1:].view(qkv.shape)
    name = "_attention_qkv_fused_cuda"
    before = wa.LAUNCHES[name]
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa._attention_qkv_fused_cuda(odd, bias, 0.18, 2)
    qkv, bias, _ = _bwd_inputs(1, 1280, 2, cuda_device, hd=64)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        wa._attention_qkv_fused_cuda(qkv, bias, 0.125, 2)
    assert wa.LAUNCHES[name] == before


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,kernel", [
    (256, 6, "_attention_qkv_bwd_cuda"),
    (1024, 2, "_attention_bwd_merged_cuda"),
])
def test_cuda_qkv_xla_route_backward_launches_the_kernel(cuda_device, N, H,
                                                         kernel):
    """``window_attention_qkv_xla`` (a stage that takes no kernel): the
    plain forward launches nothing; its backward launches K4 at N=256 and
    K5 at N=1024, and its gradients match autograd through the plain
    version."""
    qkv, bias, g = _bwd_inputs(2, N, H, cuda_device, seed=2)
    qkv.requires_grad_()
    bias.requires_grad_()
    scale = HD ** -0.5
    wa.reset_launches()
    out = wa.window_attention_qkv_xla(qkv, bias, scale, H)
    torch.cuda.synchronize()
    assert sum(wa.LAUNCHES.values()) == 0
    got = torch.autograd.grad(out, (qkv, bias), g)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[kernel] == 1 and sum(wa.LAUNCHES.values()) == 1
    want = torch.autograd.grad(wa._attention_qkv_fused_plain(qkv, bias,
                                                             scale, H),
                               (qkv, bias), g)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL


@pytest.mark.cuda
def test_cuda_headmajor_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    q, k, v, bias = _headmajor_inputs(8, 2, 256, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        wa._attention_qtiled_cuda(q.half(), k.half(), v.half(), bias, 0.18)
    with pytest.raises(ValueError, match="mixed"):
        wa._attention_qtiled_cuda(q.float(), k, v, bias, 0.18)
    with pytest.raises(ValueError, match="head dim"):  # hd 8
        wa._attention_qtiled_cuda(q[..., :8].contiguous(),
                                  k[..., :8].contiguous(),
                                  v[..., :8].contiguous(), bias, 0.35)
    with pytest.raises(ValueError, match="contiguous"):
        wa._attention_qtiled_cuda(q.transpose(0, 1), k, v, bias, 0.18)
    twelve = _headmajor_inputs(12, 2, 256, cuda_device)
    with pytest.raises(ValueError, match="BLOCK_W"):  # 12 % 8 != 0
        wa._attention_batched_cuda(*twelve, 0.18)
    big = _headmajor_inputs(8, 2, 512, cuda_device)
    with pytest.raises(ValueError, match="N < 512"):
        wa._attention_batched_cuda(*big, 0.18)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mirror,W,N,H", [
    # stage 3 and stage 2 of TinyViT at 448 px: 14x14 and 28x28 windows
    ("_attention_qkv_bwd_cuda", "_attention_qkv_bwd_plain", 4, 196, 18),
    ("_attention_bwd_merged_cuda", "_attention_bwd_merged_plain", 2, 784, 12),
    ("_attention_bwd_qtiled_cuda", "_attention_bwd_qtiled_plain", 2, 784, 12),
])
def test_cuda_bwd_kernels_take_ragged_n(cuda_device, name, mirror, W, N, H):
    """K4, K5 and K7 at an N that is not a multiple of 64 (run padded)
    against their plain mirrors: one launch each, N-sized cotangents."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device, seed=3)
    scale = HD ** -0.5
    before = wa.LAUNCHES[name]
    dqkv, dbias = getattr(wa, name)(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 1
    want = getattr(wa, mirror)(qkv, bias, g, scale, H)
    assert dqkv.shape == qkv.shape and dbias.shape == (H, N, N)
    assert bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(dbias).all())
    assert _rel_err(dqkv, want[0]) < KERNEL_REL_TOL
    assert _rel_err(dbias, want[1]) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,H", [
    # TinyViT-5M-224's attention at B=64: stage 1 (7x7 windows), stage 2
    # (one 14x14 window), stage 3 (7x7); every one padded to 64 or 256
    (1024, 49, 4), (64, 196, 5), (64, 49, 10),
])
def test_cuda_k4_takes_the_tinyvit_5m_224_shapes(cuda_device, W, N, H):
    """K4 at the finetune's three shapes (odd and small head counts, 1024
    windows of 49 tokens) against its plain mirror, one launch a call, and
    bitwise equal over two calls."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device, seed=5)
    scale = HD ** -0.5
    before = wa.LAUNCHES["_attention_qkv_bwd_cuda"]
    dqkv, dbias = wa._attention_qkv_bwd_cuda(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_attention_qkv_bwd_cuda"] == before + 1
    want = wa._attention_qkv_bwd_plain(qkv, bias, g, scale, H)
    assert dqkv.shape == qkv.shape and dbias.shape == (H, N, N)
    assert bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(dbias).all())
    assert _rel_err(dqkv, want[0]) < KERNEL_REL_TOL
    assert _rel_err(dbias, want[1]) < KERNEL_REL_TOL
    again = wa._attention_qkv_bwd_cuda(qkv, bias, g, scale, H)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,N,H,kernel", [
    (16, 256, 2, "_attention_qkv_bwd_cuda"),
    (64, 256, 2, "_attention_qkv_bwd_cuda"),
    (16, 1024, 2, "_attention_bwd_merged_cuda"),
    (64, 1024, 2, "_attention_bwd_merged_cuda"),
])
def test_cuda_qkv_xla_route_backward_takes_head_dims_16_and_64(
        cuda_device, hd, N, H, kernel):
    """A stage of head dim 16 or 64 on ``window_attention_qkv_xla``: the
    plain forward, and the backward through K4 (N=256) or K5 (N=1024),
    against autograd through the plain version."""
    qkv, bias, g = _bwd_inputs(2, N, H, cuda_device, seed=4, hd=hd)
    qkv.requires_grad_()
    bias.requires_grad_()
    scale = hd ** -0.5
    wa.reset_launches()
    out = wa.window_attention_qkv_xla(qkv, bias, scale, H)
    got = torch.autograd.grad(out, (qkv, bias), g)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[kernel] == 1 and sum(wa.LAUNCHES.values()) == 1
    want = torch.autograd.grad(wa._attention_qkv_fused_plain(qkv, bias,
                                                             scale, H),
                               (qkv, bias), g)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) < GRAD_REL_TOL


#: hd -> (C, H) with D = C a multiple of 64, as the fused kernels' GEMMs
#: need.
HEAD_DIM_WIDTHS = {16: (64, 4), 64: (128, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K9", "K8a", "K8b"])
def test_cuda_forward_kernels_take_head_dims_16_and_64(cuda_device, hd,
                                                       kernel):
    """Each TinyViT forward kernel at head dim 16 and 64 against its plain
    version."""
    C, H = HEAD_DIM_WIDTHS[hd]
    scale = hd ** -0.5
    if kernel in ("K8a", "K8b"):
        W, N = (2, 1024) if kernel == "K8a" else (8, 256)
        q, k, v, bias = _headmajor_inputs(W, H, N, cuda_device, hd=hd)
        name = {"K8a": "_attention_qtiled_cuda",
                "K8b": "_attention_batched_cuda"}[kernel]
        args = (q, k, v, bias, scale)
        kern, plain = getattr(wa, name), wa._attention_plain
    elif kernel == "K9":
        B, Hm, window = 2, 32, 16
        args = _fb4d_args(B, Hm, Hm, C, H, cuda_device)[0] + [
            scale, H, window, 1e-5]
        name, kern, plain = "_fb4d_cuda", wa._fb4d_cuda, wa._fb4d_plain
    else:
        a = _inputs(4, 256, C, H, cuda_device)
        if kernel == "K1":
            args = [a[k] for k in _K1_KEYS] + [scale, H, 1e-5]
            name, kern = "_fused_block_cuda", wa._fused_block_cuda
            plain = wa._fused_block_plain
        elif kernel == "K2":
            args = [a[k] for k in _K2_KEYS] + [scale, H, 1e-5]
            name, kern, plain = "_fb_s2_cuda", wa._fb_s2_cuda, wa._fb_s2_plain
        else:
            qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"],
                                   a["w_qkv"], a["b_qkv"], 1e-5)
            args = [qkv, a["bias"], scale, H]
            name = "_attention_qkv_fused_cuda"
            kern = wa._attention_qkv_fused_cuda
            plain = wa._attention_qkv_fused_plain
    before = wa.LAUNCHES[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 1
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("name,mirror,W,N", [
    ("_attention_qkv_bwd_cuda", "_attention_qkv_bwd_plain", 4, 256),
    ("_attention_bwd_merged_cuda", "_attention_bwd_merged_plain", 2, 1024),
    ("_attention_bwd_qtiled_cuda", "_attention_bwd_qtiled_plain", 2, 1024),
])
def test_cuda_backward_kernels_take_head_dims_16_and_64(cuda_device, hd,
                                                        name, mirror, W, N):
    """K4, K5 and K7 at head dim 16 and 64 against their plain mirrors."""
    H = 2
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device, seed=5, hd=hd)
    scale = hd ** -0.5
    before = wa.LAUNCHES[name]
    dqkv, dbias = getattr(wa, name)(qkv, bias, g, scale, H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES[name] == before + 1
    want = getattr(wa, mirror)(qkv, bias, g, scale, H)
    assert bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(dbias).all())
    assert _rel_err(dqkv, want[0]) < KERNEL_REL_TOL
    assert _rel_err(dbias, want[1]) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,N,D,H", [
    ("K6", 2, 50, 64, 2),     # CLIP test_tiny's width: hd 32
    ("K6", 2, 577, 128, 8),   # hd 16
    ("K11", 2, 50, 128, 4),   # hd 32
    ("K11", 2, 577, 128, 8),  # hd 16
])
def test_cuda_clip_kernels_take_head_dims_16_and_32(cuda_device, kernel, B,
                                                    N, D, H):
    qkv, w = _clip_inputs(B, N, D, cuda_device)
    scale = (D // H) ** -0.5
    if kernel == "K6":
        name, run = "_flash_cuda", lambda f: f(qkv, scale, H)
        kern, plain = ca._flash_cuda, ca._flash_plain
    else:
        name, run = "_flash_proj_cuda", lambda f: f(qkv, w, scale, H)
        kern, plain = ca._flash_proj_cuda, ca._flash_proj_plain
    before = ca.LAUNCHES[name]
    got = run(kern)
    torch.cuda.synchronize()
    assert ca.LAUNCHES[name] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, run(plain)) < KERNEL_REL_TOL


def _flash_once(qkv, scale, H):
    """K6 on qkv with its launch counted: exactly one a call."""
    before = ca.LAUNCHES["_flash_cuda"]
    got = ca._flash_cuda(qkv, scale, H)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["_flash_cuda"] == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [1, 50, 63, 64, 65, 127, 128, 129, 577])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_cuda_flash_sm90_matches_plain(cuda_device, hd, N, B):
    """The bf16 K6 (TMA + wgmma) at every head dim, at token counts around
    its 128-row query and key tiles, one image and three."""
    H = 2
    qkv, _ = _clip_inputs(B, N, H * hd, cuda_device, seed=N + hd)
    got = _flash_once(qkv, hd ** -0.5, H)
    want = ca._flash_plain(qkv, hd ** -0.5, H)
    assert got.shape == want.shape == (B, N, H * hd)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


def _qkv_in(buf, offset, B, N, D):
    """A contiguous (B, N, 3D) qkv at ``offset`` elements into ``buf``,
    filled from seeded normals; the rest of ``buf`` keeps its NaNs."""
    n = B * N * 3 * D
    qkv = buf[offset:offset + n].view(B, N, 3 * D)
    qkv.copy_(_clip_inputs(B, N, D, buf.device, seed=7)[0])
    return qkv


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 8], ids=["at_start", "16_bytes_in"])
def test_cuda_flash_sm90_reads_nothing_past_qkv(cuda_device, offset):
    """qkv a 16-byte aligned slice of a NaN buffer with nothing after it:
    the last image's last tile is ragged (N = 129 = 128 + 1), so its k/v
    boxes reach past the tensor's end, where TMA must fill zeros and not
    read the NaNs that follow."""
    B, N, D, H = 3, 129, 128, 2
    buf = torch.full((offset + B * N * 3 * D + 4096,), float("nan"),
                     dtype=torch.bfloat16, device=cuda_device)
    qkv = _qkv_in(buf, offset, B, N, D)
    assert (qkv.data_ptr() - buf.data_ptr()) == 2 * offset
    got = _flash_once(qkv, 64 ** -0.5, H)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, ca._flash_plain(qkv, 64 ** -0.5, H)) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_flash_sm90_refuses_a_misaligned_base_or_pitch(cuda_device):
    B, N, D, H = 2, 50, 128, 2
    buf = torch.zeros(1 + B * N * 3 * D, dtype=torch.bfloat16,
                      device=cuda_device)
    odd = buf[1:].view(B, N, 3 * D)  # 2 bytes past a 16-byte boundary
    before = ca.LAUNCHES["_flash_cuda"]
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ca._flash_cuda(odd, 0.125, H)
    wide = torch.zeros(B, N, 3 * D + 4, dtype=torch.bfloat16,
                       device=cuda_device)[..., :3 * D]  # rows 776 bytes apart
    with pytest.raises(ValueError, match="16 bytes apart"):
        ca._flash_cuda(wide, 0.125, H)
    assert ca.LAUNCHES["_flash_cuda"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,W,N,H", [
    ("_attention_qkv_bwd_cuda", 1024, 256, 6),    # K4, stage 1 at B=16
    ("_attention_bwd_merged_cuda", 64, 1024, 12),  # K5, stage 2 at B=16
])
def test_cuda_backward_dbias_is_bitwise_stable(cuda_device, name, W, N, H):
    """K4's and K5's d_bias (and d_qkv) are the same bits over two calls:
    one block per d_bias tile walks the windows in order, no atomics."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device, seed=6)
    fn = getattr(wa, name)
    first = fn(qkv, bias, g, HD ** -0.5, H)
    second = fn(qkv, bias, g, HD ** -0.5, H)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0], second[0])


# ---------------------------------------------------------------------------
# K12a / K12b (ops/experimental/fused_mbconv.py) and K13
# (ops/experimental/tiled_gemm.py)


def _exp_mbconv_args(B, H, W, device, seed=0, C=96, E=384):
    rng = np.random.default_rng(seed)

    def t(shape, scale, dtype):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(device,
                                                                   dtype)

    return (t((B, H, W, C), 0.5, torch.bfloat16),
            t((C, E), 0.1, torch.bfloat16), t((E,), 0.1, torch.float32),
            t((3, 3, E), 0.1, torch.float32), t((E,), 0.1, torch.float32),
            t((E, C), 0.1, torch.bfloat16), t((C,), 0.1, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,E", [(2, 32, 24, 96, 384),
                                       (4, 128, 128, 96, 384),
                                       (3, 16, 40, 32, 128),
                                       (2, 48, 20, 64, 256),
                                       (1, 16, 10, 32, 64)])
def test_cuda_fused_mbconv_exp_matches_plain(cuda_device, B, H, W, C, E):
    """K12a and K12b (the PLAIN kind of K10's Hopper kernel) against their
    plain mirror at each channel count they take, ragged widths (W not a
    multiple of the 16-column tile) among them; each bitwise stable over
    two calls, and K12b bitwise equal to K12a."""
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm

    args = _exp_mbconv_args(B, H, W, cuda_device, C=C, E=E)
    before = dict(fm.LAUNCHES)
    got = fm.fused_mbconv(*args)
    got2 = fm.fused_mbconv_v2(*args)
    again = fm.fused_mbconv(*args)
    again2 = fm.fused_mbconv_v2(*args)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["_fused_mbconv_cuda"] == before["_fused_mbconv_cuda"] + 2
    assert (fm.LAUNCHES["_fused_mbconv_v2_cuda"]
            == before["_fused_mbconv_v2_cuda"] + 2)
    want = fm._fused_mbconv_plain(*args)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) < KERNEL_REL_TOL
    assert torch.equal(got, again) and torch.equal(got2, again2)
    assert torch.equal(got, got2)


@pytest.mark.cuda
def test_cuda_fused_mbconv_exp_refuses_what_the_kernels_do_not_take(
        cuda_device):
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm

    args = _exp_mbconv_args(1, 24, 16, cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        fm.fused_mbconv(*args)
    before = dict(fm.LAUNCHES)
    narrow = _exp_mbconv_args(1, 16, 16, cuda_device, C=48, E=192)
    with pytest.raises(ValueError, match="C in"):
        fm.fused_mbconv_v2(*narrow)
    assert fm.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(256, 384, 256), (128, 64, 384)])
def test_cuda_tiled_matmul_matches_plain(cuda_device, M, K, N):
    """K13: int8 -> int32 exactly the plain product, bf16 -> f32 within
    KERNEL_REL_TOL."""
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    rng = np.random.default_rng(7)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)
                          ).to(cuda_device)
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)
                          ).to(cuda_device)
    before = tg.LAUNCHES["_tiled_matmul_cuda"]
    got8 = tg.tiled_matmul(a8, b8, torch.int32)
    a = torch.from_numpy(rng.normal(size=(M, K))).to(cuda_device,
                                                    torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(K, N))).to(cuda_device,
                                                    torch.bfloat16)
    got = tg.tiled_matmul(a, b, torch.float32)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["_tiled_matmul_cuda"] == before + 2
    assert got8.dtype == torch.int32 and got.dtype == torch.float32
    assert torch.equal(got8, tg._tiled_matmul_plain(a8, b8, torch.int32))
    assert _rel_err(got, tg._tiled_matmul_plain(a, b, torch.float32)) \
        < KERNEL_REL_TOL
    with pytest.raises(ValueError, match="multiples of 128"):
        tg.tiled_matmul(a[:100], b, torch.float32)


# ---------------------------------------------------------------------------
# The f32 compute dtype: every f32 entry against its plain f32 version, the
# autograd ops' f32 gradients, and K14 (ops/experimental/smem_probe.py)

#: f32 kernel vs its plain f32 version on the card: max |k - p| / max |p|.
#: The kernels split each f32 operand into a bf16 (hi, lo) pair (about
#: 2^-17 of error a product, common.cuh "Element types"); bf16 operands,
#: at 2^-9 each, would miss this bound.
F32_REL_TOL = 1e-3
#: hd -> (C = D, H) of the f32 cases: D a multiple of 64, as the fused
#: kernels' GEMMs need.
F32_WIDTHS = {16: (64, 4), 32: (64, 2), 64: (128, 2)}
F32 = torch.float32


def _f32_case(kernel, hd, device):
    """(name, kernel fn, plain fn, args, launch counters) at a narrow
    width and head dim ``hd``, every operand in f32."""
    from geoguessr_ai_torch.ops import mbconv

    C, H = F32_WIDTHS[hd]
    scale = hd ** -0.5
    if kernel in ("K4", "K5", "K7"):
        W, N = (4, 256) if kernel == "K4" else (2, 1024)
        name, plain = {
            "K4": ("_attention_qkv_bwd_cuda", wa._attention_qkv_bwd_plain),
            "K5": ("_attention_bwd_merged_cuda",
                   wa._attention_bwd_merged_plain),
            "K7": ("_attention_bwd_qtiled_cuda",
                   wa._attention_bwd_qtiled_plain)}[kernel]
        qkv, bias, g = _bwd_inputs(W, N, H, device, seed=8, hd=hd, dtype=F32)
        return (name, getattr(wa, name), plain, (qkv, bias, g, scale, H),
                wa.LAUNCHES)
    if kernel in ("K8a", "K8b"):
        W, N = (2, 1024) if kernel == "K8a" else (8, 256)
        name = {"K8a": "_attention_qtiled_cuda",
                "K8b": "_attention_batched_cuda"}[kernel]
        args = (*_headmajor_inputs(W, H, N, device, seed=8, hd=hd,
                                   dtype=F32), scale)
        return name, getattr(wa, name), wa._attention_plain, args, wa.LAUNCHES
    if kernel in ("K6", "K11"):
        Hc = {16: 8, 32: 4, 64: 2}[hd]
        qkv, w = _clip_inputs(2, 577, Hc * hd, device, seed=8, dtype=F32)
        if kernel == "K6":
            return ("_flash_cuda", ca._flash_cuda, ca._flash_plain,
                    (qkv, scale, Hc), ca.LAUNCHES)
        return ("_flash_proj_cuda", ca._flash_proj_cuda, ca._flash_proj_plain,
                (qkv, w, scale, Hc), ca.LAUNCHES)
    if kernel == "K10":
        args = (*_mbconv_args(2, 20, 24, 32, 128, device, seed=8, dtype=F32),
                False)
        return ("_mbconv_cuda", mbconv._mbconv_cuda, mbconv._mbconv_plain,
                args, mbconv.LAUNCHES)
    if kernel == "K9":
        args = _fb4d_args(2, 32, 32, C, H, device, seed=8, dtype=F32)[0] + [
            scale, H, 16, 1e-5]
        return "_fb4d_cuda", wa._fb4d_cuda, wa._fb4d_plain, args, wa.LAUNCHES
    a = _inputs(4, 256, C, H, device, seed=8, dtype=F32)
    if kernel == "K1":
        return ("_fused_block_cuda", wa._fused_block_cuda,
                wa._fused_block_plain,
                [a[k] for k in _K1_KEYS] + [scale, H, 1e-5], wa.LAUNCHES)
    if kernel == "K2":
        return ("_fb_s2_cuda", wa._fb_s2_cuda, wa._fb_s2_plain,
                [a[k] for k in _K2_KEYS] + [scale, H, 1e-5], wa.LAUNCHES)
    qkv = wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"],
                           a["b_qkv"], 1e-5)
    return ("_attention_qkv_fused_cuda", wa._attention_qkv_fused_cuda,
            wa._attention_qkv_fused_plain, (qkv, a["bias"], scale, H),
            wa.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K9", "K4", "K5", "K7",
                                    "K8a", "K8b", "K6", "K11"])
def test_cuda_f32_entries_match_plain(cuda_device, kernel, hd):
    """Each kernel's f32 entry (the f32 twin of its bf16 one) at head dims
    16, 32 and 64 against its plain f32 version, within F32_REL_TOL."""
    name, kern, plain, args, launches = _f32_case(kernel, hd, cuda_device)
    before = launches[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    want = plain(*args)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype == F32
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, b) < F32_REL_TOL, _rel_err(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(768, 12), (1024, 16)])
def test_cuda_f32_flash_proj_walks_head_chunks(cuda_device, D, H):
    """K11's f32 entry at ViT-B/32's and ViT-L/14's widths, whose (64, D)
    f32 attention rows do not fit beside the k/v tiles: two head chunks,
    the second added into the first's output, against the plain version."""
    qkv, w = _clip_inputs(1, 197, D, cuda_device, seed=10, dtype=F32)
    assert ca._flash_proj_chunk(D, 64, F32) == D // 2
    got = ca._flash_proj_cuda(qkv, w, 0.125, H)
    torch.cuda.synchronize()
    assert _rel_err(got, ca._flash_proj_plain(qkv, w, 0.125, H)) < F32_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("B,H,W,C,E", MBCONV_SHAPES)
def test_cuda_f32_mbconv_matches_plain(cuda_device, B, H, W, C, E, exact):
    """K10's f32 entry against its plain f32 version (no rounding point of
    the bf16 path), within F32_REL_TOL."""
    from geoguessr_ai_torch.ops import mbconv

    args = _mbconv_args(B, H, W, C, E, cuda_device, seed=3, dtype=F32)
    before = mbconv.LAUNCHES["_mbconv_cuda"]
    got = mbconv._mbconv_cuda(*args, exact)
    torch.cuda.synchronize()
    assert mbconv.LAUNCHES["_mbconv_cuda"] == before + 1
    want = mbconv._mbconv_plain(*args, exact)
    assert got.dtype == F32 and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < F32_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(OP_SHAPES))
def test_cuda_f32_op_gradients_match_plain_autograd(cuda_device, op):
    """Each autograd op in f32 (K1/K2/K3 forward, K3 and K4/K5 in the
    backward): its input gradients against autograd through the plain f32
    version, within F32_REL_TOL."""
    W, N, C, H = OP_SHAPES[op]
    a = _inputs(W, N, C, H, cuda_device, seed=9, dtype=F32)
    if op == "window_attention_qkv":
        args = [wa._ln_qkv_plain(a["x"], a["ln_scale"], a["ln_bias"],
                                 a["w_qkv"], a["b_qkv"], 1e-5), a["bias"]]
    else:
        args = [a[k] for k in (_K1_KEYS if op == "fused_block_attention"
                               else _K2_KEYS)]
    args = [t.detach().requires_grad_() for t in args]
    scale = (C // H) ** -0.5
    wa.reset_launches()
    out = getattr(wa, op)(*args, scale, H)
    gout = torch.randn(out.shape, device=cuda_device, dtype=F32)
    got = torch.autograd.grad(out, args, gout)
    torch.cuda.synchronize()
    assert sum(wa.LAUNCHES.values()) >= 2  # a forward and a backward kernel
    want = torch.autograd.grad(_PLAIN_OPS[op](*args, scale, H), args, gout)
    for i, (a_, b) in enumerate(zip(got, want)):
        assert a_.shape == b.shape and a_.dtype == b.dtype
        assert _rel_err(a_, b) < F32_REL_TOL, (i, _rel_err(a_, b))


@pytest.mark.cuda
def test_cuda_smem_probe_needs_the_opt_in(cuda_device):
    """K14: with no opt-in its 192 KiB launch is refused (and runs
    nothing); with the card's opt-in it equals its plain version, 21 x."""
    from geoguessr_ai_torch.ops.experimental import smem_probe as sp

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert sp.smem_bytes(1024) > 48 * 1024
    ones = torch.ones(1, 1024, 1024, device=cuda_device)
    sp.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        sp.smem_probe(ones, None)
    assert sp.LAUNCHES["_smem_probe_cuda"] == 0
    got = sp.smem_probe(ones, optin)
    torch.cuda.synchronize()
    assert sp.LAUNCHES["_smem_probe_cuda"] == 1
    assert bool((got == 21.0).all())
    x = torch.randn(1, 1024, 1024, device=cuda_device)
    assert torch.equal(sp.smem_probe(x, optin), sp._smem_probe_plain(x))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        sp.smem_probe(x, None)  # None sets the opt-in back first


#: (B, H, W, C, E) of K10's bf16 Hopper kernel: stage 0 of TinyViT-21M-512,
#: the other channel counts, and maps whose sides are no multiple of its
#: 16 x 16 tile (one smaller than a tile).
MBCONV_SM90_SHAPES = [(2, 128, 128, 96, 384), (3, 128, 128, 64, 256),
                      (3, 128, 128, 32, 128), (2, 7, 9, 96, 384),
                      (2, 17, 33, 32, 192), (1, 112, 112, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("B,H,W,C,E", MBCONV_SM90_SHAPES)
def test_cuda_mbconv_sm90_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, B, H, W, C, E, exact):
    """K10's bf16 entry (mbconv_sm90.cuh): the output in a NaN-fenced
    buffer, one launch a call, two calls bitwise equal, within
    KERNEL_REL_TOL of ``_mbconv_plain``."""
    from geoguessr_ai_torch.ops import mbconv

    args = _mbconv_args(B, H, W, C, E, cuda_device, seed=C + E)
    before = mbconv.LAUNCHES["_mbconv_cuda"]
    made = _nan_fenced_buffers(monkeypatch)
    got = mbconv._mbconv_cuda(*args, exact)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    again = mbconv._mbconv_cuda(*args, exact)
    torch.cuda.synchronize()
    assert mbconv.LAUNCHES["_mbconv_cuda"] == before + 2
    assert torch.equal(got, again)
    want = mbconv._mbconv_plain(*args, exact)
    assert got.shape == want.shape == (B, H, W, C)
    assert _rel_err(got, want) < KERNEL_REL_TOL


#: (W, N, C, H) of K2's bf16 entry: stage 2 of a serving bucket of 16, head
#: dims 16 and 64 at N = 1024, a row count W N that is no multiple of the
#: GEMM's 128-row tile, and smaller windows.
FB_S2_SM90_SHAPES = [(64, 1024, 384, 12), (16, 1024, 128, 8),
                     (4, 1024, 384, 6), (7, 64, 192, 6), (5, 256, 384, 12),
                     (1, 1024, 384, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,C,H", FB_S2_SM90_SHAPES)
def test_cuda_fb_s2_sm90_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, W, N, C, H):
    """K2's bf16 entry (ln_gemm_sm90.cuh, then the forward core): qkv
    scratch and output in NaN-fenced buffers, one launch a call, two calls
    bitwise equal, within KERNEL_REL_TOL of ``_fb_s2_plain``."""
    a = _inputs(W, N, C, H, cuda_device, seed=N + C)
    args = [a[k] for k in _K2_KEYS] + [(C // H) ** -0.5, H, 1e-5]
    before = wa.LAUNCHES["_fb_s2_cuda"]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._fb_s2_cuda(*args)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    again = wa._fb_s2_cuda(*args)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_fb_s2_cuda"] == before + 2
    assert torch.equal(got, again)
    want = wa._fb_s2_plain(*args)
    assert got.shape == want.shape == (W, N, C)
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_fb_s2_refuses_what_its_bf16_entry_cannot_plan(cuda_device):
    """N above FB_S2_MAX_N or C above FB_S2_MAX_C is refused in bf16 before
    any launch; the f32 twin (the first design) still takes them."""
    before = wa.LAUNCHES["_fb_s2_cuda"]
    for W, N, C, H in ((1, 1088, 64, 2), (2, 64, 512, 8)):
        a = _inputs(W, N, C, H, cuda_device)
        args = [a[k] for k in _K2_KEYS] + [(C // H) ** -0.5, H, 1e-5]
        with pytest.raises(ValueError, match="K2 takes N up to"):
            wa._fb_s2_cuda(*args)
        assert wa.LAUNCHES["_fb_s2_cuda"] == before
        f32 = [t.float() if isinstance(t, torch.Tensor) else t for t in args]
        got = wa._fb_s2_cuda(*f32)
        torch.cuda.synchronize()
        assert _rel_err(got, wa._fb_s2_plain(*f32)) < KERNEL_REL_TOL
        before += 1


#: (W, N, C, H) of K1's bf16 entry: stage 1 of a serving bucket of 16 and
#: the embed configuration's stage 3 (C = 576: nine k-boxes, one x buffer),
#: head dims 16 and 64, a row count W N that is no multiple of the GEMMs'
#: 128-row tile, and N = 1024.
FUSED_BLOCK_SM90_SHAPES = [(1024, 256, 192, 6), (64, 256, 576, 18),
                           (64, 256, 128, 8), (64, 256, 384, 6),
                           (5, 64, 192, 6), (3, 128, 576, 18),
                           (2, 1024, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,C,H", FUSED_BLOCK_SM90_SHAPES)
def test_cuda_fused_block_sm90_matches_plain_and_writes_every_element(
        cuda_device, monkeypatch, W, N, C, H):
    """K1's bf16 entry (the GEMM core's two kinds around the forward core):
    qkv and attention scratch and the output in NaN-fenced buffers, one
    launch a call, two calls bitwise equal, within KERNEL_REL_TOL of
    ``_fused_block_plain``."""
    a = _inputs(W, N, C, H, cuda_device, seed=N + C)
    args = [a[k] for k in _K1_KEYS] + [(C // H) ** -0.5, H, 1e-5]
    before = wa.LAUNCHES["_fused_block_cuda"]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._fused_block_cuda(*args)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    assert len(made) == 3
    again = wa._fused_block_cuda(*args)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_fused_block_cuda"] == before + 2
    assert torch.equal(got, again)
    want = wa._fused_block_plain(*args)
    assert got.shape == want.shape == (W, N, C)
    assert _rel_err(got, want) < KERNEL_REL_TOL


#: (B, Hm, Wm, C, H, window) of K9's bf16 entry: stage 1 at 4 images, head
#: dims 16 and 64, a map that is not square, and 32 x 32 windows.
FB4D_SM90_SHAPES = [(4, 64, 64, 192, 6, 16), (1, 128, 128, 128, 8, 16),
                    (1, 128, 128, 384, 6, 16), (2, 32, 48, 64, 2, 16),
                    (2, 64, 64, 64, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hm,Wm,C,H,window", FB4D_SM90_SHAPES)
def test_cuda_fb4d_sm90_equals_k1_and_writes_every_element(
        cuda_device, monkeypatch, B, Hm, Wm, C, H, window):
    """K9's bf16 entry (K1's launches with the window map): scratch and
    output in NaN-fenced buffers, one launch a call, two calls bitwise
    equal, equal to K1 on the partitioned map bit for bit, within
    KERNEL_REL_TOL of ``_fb4d_plain``."""
    N = window * window
    a = _inputs(B * Hm * Wm // N, N, C, H, cuda_device, seed=C + window)
    x4 = a["x"].reshape(B, Hm, Wm, C)
    rest = [a[k] for k in _K1_KEYS[1:]] + [(C // H) ** -0.5, H]
    args = [x4] + rest + [window, 1e-5]
    before = wa.LAUNCHES["_fb4d_cuda"]
    made = _nan_fenced_buffers(monkeypatch)
    got = wa._fb4d_cuda(*args)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _check_fenced(made)
    assert len(made) == 3
    again = wa._fb4d_cuda(*args)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["_fb4d_cuda"] == before + 2
    assert torch.equal(got, again)
    k1 = wa._fused_block_cuda(wa.window_partition(x4, window), *rest, 1e-5)
    assert torch.equal(got, wa.window_unpartition(k1, window, (Hm, Wm)))
    want = wa._fb4d_plain(*args)
    assert got.shape == want.shape == (B, Hm, Wm, C)
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
def test_cuda_fused_block_sm90_refuses_what_its_bf16_entries_cannot_plan(
        cuda_device):
    """C above LN_GEMM_MAX_K (K1) and a window of 8 (K9: its 128-row tiles
    would straddle windows) are refused in bf16 before any launch; the f32
    twins (the first design) still take them."""
    a = _inputs(2, 256, 640, 10, cuda_device)
    k1 = [a[k] for k in _K1_KEYS] + [64 ** -0.5, 10, 1e-5]
    b = _inputs(4, 64, 64, 2, cuda_device)
    b["x"] = b["x"].reshape(1, 16, 16, 64)
    k9 = [b[k] for k in _K1_KEYS] + [32 ** -0.5, 2, 8, 1e-5]
    for fn, plain, args, match in (
            (wa._fused_block_cuda, wa._fused_block_plain, k1, "K1 takes N"),
            (wa._fb4d_cuda, wa._fb4d_plain, k9, "K9 takes a window side")):
        before = dict(wa.LAUNCHES)
        with pytest.raises(ValueError, match=match):
            fn(*args)
        assert wa.LAUNCHES == before
        f32 = [t.float() if isinstance(t, torch.Tensor) else t for t in args]
        got = fn(*f32)
        torch.cuda.synchronize()
        assert _rel_err(got, plain(*f32)) < KERNEL_REL_TOL


# ---------------------------------------------------------------------------
# The Hopper GEMM core (csrc/gemm_sm90.cuh): K11's bf16 entry (K6's kernel,
# then the core's bf16 kind on its output) and K13 (its int8 and bf16
# kinds).  Run with -k gemm_sm90.


def _k13_operands(M, K, N, int8, device, seed=0):
    """a (M, K) and b (K, N) from numpy seeds; b also as the kernel reads
    it, K-major (the transpose view of an (N, K) tensor)."""
    rng = np.random.default_rng(seed)
    if int8:
        a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    else:
        a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                             ).bfloat16()
        b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)
                             ).bfloat16()
    a, b = a.to(device), b.to(device)
    return a, b, b.t().contiguous().t()


def _k13_check(got, a, b, int8):
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    want = tg._tiled_matmul_plain(a, b, torch.int32 if int8 else torch.float32)
    assert got.shape == want.shape and got.dtype == want.dtype
    if int8:
        assert torch.equal(got, want)
    else:
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [1, 50, 63, 64, 65, 127, 128, 129, 577])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_cuda_gemm_sm90_k11_matches_plain(cuda_device, hd, N, B):
    """K11 in bf16 (K6's kernel, then the core) at every head dim, at
    token counts around K6's 128-row tiles and the core's 128-row tiles,
    one image and three; one K11 launch counted a call, no K6 launch."""
    H = 128 // hd
    qkv, w = _clip_inputs(B, N, 128, cuda_device, seed=N + hd)
    before = dict(ca.LAUNCHES)
    got = ca._flash_proj_cuda(qkv, w, hd ** -0.5, H)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == {**before, "_flash_proj_cuda":
                           before["_flash_proj_cuda"] + 1}
    want = ca._flash_proj_plain(qkv, w, hd ** -0.5, H)
    assert got.shape == want.shape == (B, N, 128)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(2, 577, 256, 4), (3, 50, 768, 12),
                                     (1, 129, 128, 8), (4, 577, 1024, 16)])
def test_cuda_gemm_sm90_k11_is_the_core_on_k6_and_bitwise_stable(
        cuda_device, B, N, D, H):
    """K11's bf16 output equals, bit for bit, the core applied to K6's
    output (chip_smoke.py's ``_core_of_k6``: K13's bf16 kind on K6's
    output, rounded once), and itself over two calls."""
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    from chip_smoke import _core_of_k6

    qkv, w = _clip_inputs(B, N, D, cuda_device, seed=D)
    scale = (D // H) ** -0.5
    got = ca._flash_proj_cuda(qkv, w, scale, H)
    again = ca._flash_proj_cuda(qkv, w, scale, H)
    core = _core_of_k6(qkv, w, scale, H)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, core)
    assert tg.core_plan(B * N, D, D, torch.bfloat16)["BN"] == (
        256 if D % 256 == 0 else 128)


#: (M, K, N, int8) of K13's card checks: the edges (M = N = 128 with K
#: one 64-byte box; a 64-byte K tail; 128-column tiles) in each type, and
#: the JAX tool's four shapes in both.
K13_CASES = [(128, 64, 128, True), (128, 32, 128, False),
             (128, 192, 256, True), (256, 96, 384, False)] + [
    (M, K, N, int8) for M, K, N in ((4096, 2048, 4096), (4096, 4096, 4096),
                                    (131072, 384, 1536), (131072, 1536, 384))
    for int8 in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,int8", K13_CASES)
def test_cuda_gemm_sm90_k13_matches_plain(cuda_device, M, K, N, int8):
    """K13: int8 -> int32 exactly the plain product, bf16 -> f32 within
    KERNEL_REL_TOL, from b K-major and from b (K, N) (which the wrapper
    transposes), the same bits both ways and over two calls; one launch
    counted a call."""
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    a, b, bk = _k13_operands(M, K, N, int8, cuda_device, seed=K)
    out_dtype = torch.int32 if int8 else torch.float32
    before = tg.LAUNCHES["_tiled_matmul_cuda"]
    got = tg.tiled_matmul(a, bk, out_dtype)
    again = tg.tiled_matmul(a, bk, out_dtype)
    from_kn = tg.tiled_matmul(a, b, out_dtype)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["_tiled_matmul_cuda"] == before + 3
    assert torch.equal(got, again) and torch.equal(got, from_kn)
    _k13_check(got, a, b, int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_cuda_gemm_sm90_k13_reads_nothing_past_its_operands(cuda_device, int8):
    """a and b^T (K-major) each the last bytes of a buffer whose rest is
    a fence (NaN in bf16, 127 in int8), with a K that ends half a 128-byte
    box in: the last k-box of the last row reaches past both tensors' ends,
    where TMA must fill zeros and read nothing of the fence."""
    M, N = 256, 384
    K = 192 if int8 else 96
    a0, b0, _ = _k13_operands(M, K, N, int8, cuda_device, seed=5)
    fence = 127 if int8 else float("nan")

    def fenced(t):
        buf = torch.full((t.numel() + 4096,), fence, dtype=t.dtype,
                         device=cuda_device)
        view = buf[:t.numel()].view(t.shape)
        view.copy_(t)
        return view

    a = fenced(a0)
    bk = fenced(b0.t().contiguous()).t()
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    got = tg.tiled_matmul(a, bk, torch.int32 if int8 else torch.float32)
    torch.cuda.synchronize()
    _k13_check(got, a0, b0, int8)


@pytest.mark.cuda
def test_cuda_gemm_sm90_k11_reads_nothing_past_its_operands(cuda_device):
    """qkv and W_out (given as the transpose view of its (out, in) rows,
    which the wrapper then reads without a copy) each at the end of a NaN
    buffer; N = 129 leaves a ragged 128-row tile for K6 and for the core."""
    B, N, D, H = 3, 129, 256, 4
    qkv0, w0 = _clip_inputs(B, N, D, cuda_device, seed=9)
    buf = torch.full((B * N * 3 * D + 4096,), float("nan"),
                     dtype=torch.bfloat16, device=cuda_device)
    qkv = buf[:B * N * 3 * D].view(B, N, 3 * D)
    qkv.copy_(qkv0)
    wbuf = torch.full((D * D + 4096,), float("nan"), dtype=torch.bfloat16,
                      device=cuda_device)
    wt = wbuf[:D * D].view(D, D)
    wt.copy_(w0.t())
    got = ca._flash_proj_cuda(qkv, wt.t(), 64 ** -0.5, H)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, ca._flash_proj_plain(qkv0, w0, 64 ** -0.5, H)) \
        < KERNEL_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype,want", [
    (64 * 577, 1024, 1024, torch.bfloat16,
     dict(KB=16, BN=256, S=4, mtiles=289, ntiles=4)),
    (64 * 50, 768, 768, torch.bfloat16,
     dict(KB=12, BN=256, S=4, mtiles=25, ntiles=3)),
    (4096, 4096, 4096, torch.int8, dict(KB=32, BN=256, S=4, mtiles=32,
                                        ntiles=16)),
    (131072, 1536, 384, torch.bfloat16,
     dict(KB=24, BN=128, S=6, mtiles=1024, ntiles=3)),
    (128, 64, 128, torch.int8, dict(KB=1, BN=128, S=6, mtiles=1, ntiles=1)),
])
def test_cuda_gemm_sm90_plan_agrees_with_its_mirror(cuda_device, M, K, N,
                                                    dtype, want):
    """The C plan (``tiled_gemm_plan``) is what the CPU tests' mirror
    (tests/test_torch_port_gemm_sm90.py) gives at the same shapes, within
    the 232,448 bytes a block may opt in to; it refuses K off 64 bytes and
    N off 128."""
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    plan = tg.core_plan(M, K, N, dtype)
    assert {k: plan[k] for k in want} == want
    assert plan["bytes"] <= 232448
    assert tg.core_plan(128, 48, 128, torch.bfloat16) is None
    assert tg.core_plan(128, 64, 192, torch.int8) is None


@pytest.mark.cuda
def test_cuda_gemm_sm90_k13_refuses_a_misaligned_operand(cuda_device):
    from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg

    buf = torch.zeros(128 * 64 + 8, dtype=torch.int8, device=cuda_device)
    a = buf[8:].view(128, 64)  # 8 bytes past a 16-byte boundary
    b = torch.zeros(64, 128, dtype=torch.int8, device=cuda_device)
    before = tg.LAUNCHES["_tiled_matmul_cuda"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tg.tiled_matmul(a, b, torch.int32)
    assert tg.LAUNCHES["_tiled_matmul_cuda"] == before

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


def _inputs(W, N, C, H, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, mean=0.0, std=0.1):
        a = rng.normal(mean, std, shape).astype(np.float32)
        return torch.from_numpy(a).to(device)

    return dict(x=t(W, N, C, std=1.0).bfloat16(), ln_scale=t(C, mean=1.0),
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


def _bwd_inputs(W, N, H, device, seed=0):
    """qkv and the cotangent g in bf16, an f32 bias: as the train path
    hands them to the attention backward."""
    rng = np.random.default_rng(seed)
    D = H * wa.KERNEL_HEAD_DIM

    def t(*shape, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(device)

    return t(W, N, 3 * D).bfloat16(), t(H, N, N, std=0.5), t(W, N, D).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("W,N,H", [(4, 256, 6), (2, 1024, 12), (3, 128, 2)])
def test_cuda_backward_kernel_matches_plain(cuda_device, kernel, W, N, H):
    """K4 and K5 against their plain mirrors: d_qkv and d_bias each within
    KERNEL_REL_TOL of the mirror's range."""
    qkv, bias, g = _bwd_inputs(W, N, H, cuda_device)
    scale = wa.KERNEL_HEAD_DIM ** -0.5
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
    with pytest.raises(ValueError, match="bfloat16"):
        wa._fb_s2_cuda(args[0].float(), *args[1:], 0.18, 6, 1e-5)
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


def _clip_inputs(B, N, D, device, seed=0):
    """qkv as the fused GEMM hands it over (bf16), and a (D, D) out-proj
    weight in (in, out) layout."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, N, 3 * D)).astype(np.float32)
    w = rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)
    return (torch.from_numpy(qkv).to(device).bfloat16(),
            torch.from_numpy(w).to(device).bfloat16())


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
    with pytest.raises(ValueError, match="bfloat16"):
        ca._flash_cuda(qkv.float(), 0.125, 2)
    with pytest.raises(ValueError, match="head dim"):
        ca._flash_cuda(qkv, 0.125, 4)
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


def _fb4d_args(B, Hm, Wm, C, H, device, seed=0):
    a = _inputs(B * Hm * Wm // 256, 256, C, H, device, seed)
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


def _mbconv_args(B, H, W, C, E, device, seed=0):
    """bf16 x, f32 conv weights in the JAX layouts and folded BN pairs."""
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, mean=0.0):
        a = rng.normal(mean, std, shape).astype(np.float32)
        return torch.from_numpy(a).to(device)

    def folded(n):
        var = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        return fold_bn(t(n, mean=1.0, std=0.1), t(n, std=0.1),
                       t(n, std=0.1), var.to(device))

    return (t(B, H, W, C).bfloat16(), t(C, E, std=C ** -0.5), *folded(E),
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
    with pytest.raises(ValueError, match="bfloat16"):
        mbconv._mbconv_cuda(args[0].float(), *args[1:], False)


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

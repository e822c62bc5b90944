"""The port's CUDA kernels and guess path on the card, held against the
plain PyTorch path.

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

from geoguessr_ai_torch.ops import window_attention as wa

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

#: Kernel vs plain version, both bf16 on the card: max |k - p| / max |p|
#: (a few bf16 ulps of the output's range; as chip_smoke.py).
KERNEL_REL_TOL = 2e-2

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
    err = (got.float() - want).abs().max() / want.abs().max()
    assert float(err) < KERNEL_REL_TOL


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
    assert all(n == 1 for n in wa.LAUNCHES.values()), wa.LAUNCHES

    cpu = ServingEngine(device="cpu", seed=1, backbone_config=TinyViTConfig(
        dtype=torch.float32, **NARROW))
    want = cpu.predict_images(paths)
    a, b = got.embedding.astype(np.float64), want.embedding.astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos
    assert got.top_ids[0] == want.top_ids[0]

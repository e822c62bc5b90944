"""CLIP vision transformer in PyTorch (ViT-L/14-336 preset).

Counterpart of geoguessr_ai_tpu/models/clip_vit.py.  Modules carry the
flax module names (``patch_embedding``, ``class_embedding``,
``position_embedding``, ``pre_layrnorm`` with the reference's spelling,
``layer{i}.layer_norm1``, ``layer{i}.self_attn.{query,key,value,out}``,
``layer{i}.mlp_fc1`` / ``mlp_fc2`` / ``layer_norm2``, ``post_layernorm``),
so a flax parameter tree maps onto the state dict by name
(models/convert.py; the DenseGeneral attention kernels become (D, D)
Linear weights there).

Numerics follow the flax forward: LayerNorms in f32 on the f32 input
(eps 1e-5) cast to the compute dtype; every GEMM in the compute dtype with
its output rounded before the bias is added; quick-GELU, the residual adds
and the position-embedding add in the compute dtype.  Self-attention is
one fused qkv GEMM into ``ops.clip_attention`` (K6 on the card), or with
``pallas_fuse_proj`` K11 with the out-projection inside.

Not ported: ``pallas_attention=False`` (flax MultiHeadDotProductAttention)
and ``quantize_gemms=True`` (ops/quant.py); both raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from geoguessr_ai_torch.ops import clip_attention as ca


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: the fused qkv GEMM into clip_attention (K6); False is not ported.
    pallas_attention: bool = True
    #: the out-projection inside the attention kernel (K11).
    pallas_fuse_proj: bool = False
    #: heads per Pallas grid cell, lowered until it divides num_heads (the
    #: CUDA kernels' result does not depend on it).
    pallas_head_block: int = 4
    #: int8 GEMMs (ops/quant.py); not ported.
    quantize_gemms: bool = False

    @staticmethod
    def vit_l_14_336(**overrides) -> "CLIPVisionConfig":
        return CLIPVisionConfig(**overrides)

    @staticmethod
    def vit_b_32_224(**overrides) -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=768,
                                num_layers=12, num_heads=12, mlp_dim=3072,
                                **overrides)

    @staticmethod
    def test_tiny(**overrides) -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=56, patch_size=14, hidden_size=64,
                                num_layers=2, num_heads=2, mlp_dim=128,
                                **overrides)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def embed_dim(self) -> int:
        return self.hidden_size


class CLIPVisionOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, 1+P, D)
    pooler_output: torch.Tensor  # (B, D) f32 post-LN CLS token


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x), in x's dtype."""
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """flax ``nn.LayerNorm(dtype=f32)`` on ``x.astype(f32)``, cast back."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _dense(x, lin: nn.Linear, dtype):
    """flax Dense in ``dtype``: the GEMM's output rounded, then the bias."""
    return F.linear(x, lin.weight.to(dtype)) + lin.bias.to(dtype)


class CLIPSelfAttention(nn.Module):
    """nn.MultiHeadDotProductAttention's parameters (query, key, value, out)
    run as one fused qkv GEMM into the CLIP attention op."""

    def __init__(self, dim: int, num_heads: int, head_block: int,
                 fuse_proj: bool):
        super().__init__()
        self.num_heads = num_heads
        self.head_block = head_block
        self.fuse_proj = fuse_proj
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, dtype):
        D = x.shape[-1]
        H = self.num_heads
        scale = (D // H) ** -0.5
        # weight rows h*hd + d: the q|k|v block layout the kernels read
        w_qkv = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]).to(dtype)
        b_qkv = torch.cat([self.query.bias, self.key.bias,
                           self.value.bias]).to(dtype)
        qkv = F.linear(x, w_qkv) + b_qkv
        if self.fuse_proj:
            o = ca.clip_attention_proj(qkv, self.out.weight.to(dtype).t(),
                                       scale, H, self.head_block)
            return o + self.out.bias.to(dtype)
        o = ca.clip_attention(qkv, scale, H, self.head_block)
        return _dense(o, self.out, dtype)


class CLIPEncoderLayer(nn.Module):
    """Pre-LN transformer layer: x + attn(LN1(x)), then + mlp(LN2(x))."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = config
        D = cfg.hidden_size
        hb = cfg.pallas_head_block
        while cfg.num_heads % hb:
            hb -= 1
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(D, eps=eps)
        self.self_attn = CLIPSelfAttention(D, cfg.num_heads, hb,
                                           cfg.pallas_fuse_proj)
        self.layer_norm2 = nn.LayerNorm(D, eps=eps)
        self.mlp_fc1 = nn.Linear(D, cfg.mlp_dim)
        self.mlp_fc2 = nn.Linear(cfg.mlp_dim, D)

    def forward(self, x, dtype):
        x = x + self.self_attn(_layer_norm(x, self.layer_norm1, dtype), dtype)
        h = _layer_norm(x, self.layer_norm2, dtype)
        h = quick_gelu(_dense(h, self.mlp_fc1, dtype))
        return x + _dense(h, self.mlp_fc2, dtype)


class CLIPVisionTower(nn.Module):
    """CLIP image encoder: patchify GEMM + CLS + learned position embedding
    + pre-LN transformer + final LayerNorm on the CLS token.
    (B, H, W, 3) pixels -> CLIPVisionOutput."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = self.config = config
        if not cfg.pallas_attention:
            raise NotImplementedError(
                "pallas_attention=False (flax MultiHeadDotProductAttention) "
                "is not ported; the CLIP tower runs the fused attention op")
        if cfg.quantize_gemms:
            raise NotImplementedError(
                "quantize_gemms (int8 GEMMs, ops/quant.py) is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        D, p = cfg.hidden_size, cfg.patch_size
        # the flax (p, p, 3, D) kernel, converted to (D, 3, p, p)
        self.patch_embedding = nn.Conv2d(3, D, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.seq_len, D))
        self.pre_layrnorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", CLIPEncoderLayer(cfg))
        self.post_layernorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def cast_weights_(self) -> "CLIPVisionTower":
        """Stores the patch and linear weights in the compute dtype once, so
        the forward's per-use casts are no-ops.  Norm parameters, biases and
        the class and position embeddings stay f32, as the JAX forward
        reads them."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.data = m.weight.data.to(self.config.dtype)
        return self

    def forward(self, pixel_values: torch.Tensor) -> CLIPVisionOutput:
        cfg = self.config
        dtype = cfg.dtype
        B = pixel_values.shape[0]
        p = cfg.patch_size
        grid = cfg.image_size // p
        D = cfg.hidden_size
        # a stride-p p x p conv as space-to-depth + GEMM, (py, px, c) order
        patches = (pixel_values.to(dtype)
                   .reshape(B, grid, p, grid, p, 3)
                   .permute(0, 1, 3, 2, 4, 5)
                   .reshape(B, grid * grid, p * p * 3))
        kernel = self.patch_embedding.weight.permute(0, 2, 3, 1).reshape(D, -1)
        x = F.linear(patches, kernel.to(dtype))
        cls = self.class_embedding.to(dtype).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dtype)
        x = _layer_norm(x, self.pre_layrnorm, dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer{i}")(x, dtype)
        n = self.post_layernorm
        pooled = F.layer_norm(x[:, 0].float(), n.normalized_shape, n.weight,
                              n.bias, n.eps)
        return CLIPVisionOutput(last_hidden_state=x, pooler_output=pooled)


def clip_mean_token_embedding(out: CLIPVisionOutput) -> torch.Tensor:
    """The reference's embedding: the f32 mean over all tokens (CLS
    included) of the last hidden state, without post_layernorm."""
    return out.last_hidden_state.float().mean(dim=1)


class CLIPEmbed(CLIPVisionTower):
    """The CLIP tower as SuperGuessr's backbone (JAX ``_ClipEmbed``):
    (B, H, W, 3) pixels -> (B, D) f32 mean-token embedding.  ``train`` and
    ``generator`` are taken as SuperGuessr passes them; the tower has no
    BatchNorm or dropout, so neither changes the result."""

    def forward(self, pixel_values: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        return clip_mean_token_embedding(super().forward(pixel_values))

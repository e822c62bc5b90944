"""TinyViT forward (eval and train) in PyTorch, NHWC like the JAX package.

Counterpart of geoguessr_ai_tpu/models/tinyvit.py.  Modules carry the
flax module names (``patch_embed``, ``stage1_block0.attn.qkv``, ...), so a
flax parameter tree maps onto the state dict by name
(models/convert.py).  Activations stay NHWC; the convolutions see an
NCHW view with channels-last strides.

Attention per stage follows the JAX config's kernel stage lists, selected
exactly as the JAX ``WindowAttention`` selects them:

* ``fused_block_noproj_stages`` and N % 128 == 0: K2
  (``fused_block_attention_noproj``), then the out-projection;
* ``fused_block_stages`` and N % 128 == 0: K1 (``fused_block_attention``);
* ``pallas_attention_stages`` and N % 128 == 0: LN and qkv GEMM, K3
  (``window_attention_qkv``), out-projection;
* otherwise the plain attention.

Two opt-in knobs of the JAX config, both off by default and both turned on
by the bulk-embedding configuration, route through further kernels under
the JAX gates: ``fused_mbconv`` runs each eval-mode stage-0 MBConv as K10
(``ops/mbconv.py fused_mbconv``), and ``fused_block_4d`` runs a
multi-window ``fused_block_stages`` stage as K9 over the raw map
(``fused_block_attention_4d``), with no window partition copies.

``train=True`` (the flax ``train`` argument) normalises BatchNorm with
the batch statistics and updates the running ones, and applies DropPath
with the caller's ``torch.Generator``.  Training keeps the parameters in
f32 and casts them per use; ``TinyViT.cast_weights_`` is for serving.

Quantization, remat and scan of the JAX config are not ported; the config
has no such fields.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geoguessr_ai_torch.ops import mbconv
from geoguessr_ai_torch.ops import window_attention as wa
from geoguessr_ai_torch.ops.window_attention import (
    window_partition,
    window_unpartition,
)


@dataclasses.dataclass(frozen=True)
class TinyViTConfig:
    image_size: int = 512
    in_channels: int = 3
    embed_dims: Tuple[int, ...] = (96, 192, 384, 576)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 18)
    window_sizes: Tuple[int, ...] = (16, 16, 32, 16)
    mlp_ratio: float = 4.0
    mbconv_expand_ratio: float = 4.0
    #: stochastic depth at the last block (linear ramp from 0, as timm).
    drop_path_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    #: tanh-approximated GELU, the JAX default.
    exact_gelu: bool = False
    pallas_attention_stages: Tuple[int, ...] = (3,)
    fused_block_stages: Tuple[int, ...] = (1,)
    fused_block_noproj_stages: Tuple[int, ...] = (2,)
    #: Eval-mode stage-0 MBConv as one kernel (K10) with folded BatchNorm.
    fused_mbconv: bool = False
    #: Multi-window ``fused_block_stages`` stages (stage 1 at 64x64, w=16)
    #: through the 4D fused block (K9) on the raw map.
    fused_block_4d: bool = False

    @staticmethod
    def tiny_vit_21m_512(**overrides) -> "TinyViTConfig":
        return TinyViTConfig(**overrides)

    @property
    def embed_dim(self) -> int:
        return self.embed_dims[-1]


def _gelu(x, exact: bool):
    return F.gelu(x, approximate="none" if exact else "tanh")


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class _BN(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NHWC tensor."""

    MOMENTUM = 0.9

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, dtype, train: bool = False):
        """f32 arithmetic, result in the compute dtype.  Eval normalises
        with the running statistics.  Train normalises with the batch mean
        and flax's fast variance max(E[x^2] - E[x]^2, 0), both f32 over
        (N, H, W), and moves the running statistics 0.1 of the way to them
        (the biased variance, unlike ``F.batch_norm``)."""
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        return ((xf - mean) * mul + self.bias).to(dtype)

    def folded(self):
        """Eval BatchNorm as f32 (scale, bias) from the running statistics."""
        return mbconv.fold_bn(self.weight, self.bias, self.running_mean,
                              self.running_var)


class DropPath(nn.Module):
    """Stochastic depth: zeroes a whole sample's residual branch with
    probability ``rate`` in train mode and scales the kept ones by
    1 / (1 - rate); the identity otherwise or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool, generator=None):
        if self.rate == 0.0 or not train:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator,
                          device=generator.device) < keep
        return torch.where(mask.to(x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBN(nn.Module):
    """Conv (no bias, padding k // 2 as flax) + BatchNorm, on NHWC."""

    def __init__(self, cin, cout, kernel=1, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = _BN(cout)

    def forward(self, x, dtype, train: bool = False):
        c = self.conv
        y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(dtype), None,
                     c.stride, c.padding, c.dilation, c.groups)
        return self.bn(y.permute(0, 2, 3, 1), dtype, train)


class MBConv(nn.Module):
    def __init__(self, dim, expand_ratio, exact_gelu, drop_path=0.0,
                 fused=False):
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.exact_gelu = exact_gelu
        self.fused = fused
        self.conv1 = ConvBN(dim, hidden, 1)
        self.conv2 = ConvBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = ConvBN(hidden, dim, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, dtype, train: bool = False, generator=None):
        g = self.exact_gelu
        # The JAX gate also requires that no int8 conv site is active; the
        # port has no quantization, so that part is always true.
        if self.fused and not train:
            c1, c2, c3 = self.conv1, self.conv2, self.conv3
            return mbconv.fused_mbconv(
                x.to(dtype),
                c1.conv.weight[:, :, 0, 0].t(), *c1.bn.folded(),
                c2.conv.weight[:, 0].permute(1, 2, 0), *c2.bn.folded(),
                c3.conv.weight[:, :, 0, 0].t(), *c3.bn.folded(),
                exact_gelu=g)
        y = _gelu(self.conv1(x, dtype, train), g)
        y = _gelu(self.conv2(y, dtype, train), g)
        y = self.drop_path(self.conv3(y, dtype, train), train, generator)
        return _gelu(x + y, g)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.conv1 = ConvBN(cin, dim // 2, 3, stride=2)
        self.conv2 = ConvBN(dim // 2, dim, 3, stride=2)

    def forward(self, x, dtype, train: bool = False, generator=None):
        x = _gelu(self.conv1(x, dtype, train), self.exact_gelu)
        return self.conv2(x, dtype, train)


class PatchMerging(nn.Module):
    """1x1 -> depthwise 3x3 stride 2 -> 1x1, BN and GELU between."""

    def __init__(self, cin, cout, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.conv1 = ConvBN(cin, cout, 1)
        self.conv2 = ConvBN(cout, cout, 3, stride=2, groups=cout)
        self.conv3 = ConvBN(cout, cout, 1)

    def forward(self, x, dtype, train: bool = False, generator=None):
        g = self.exact_gelu
        x = _gelu(self.conv1(x, dtype, train), g)
        x = _gelu(self.conv2(x, dtype, train), g)
        return self.conv3(x, dtype, train)


def _relative_bias_index(window: int) -> np.ndarray:
    """(N, N) index into the unique-offset bias table for an N = window^2
    window: offsets |dy| * window + |dx| renumbered in sorted order
    (np.unique), as the JAX package does; not timm's insertion order."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)
    rel = np.abs(coords[:, None, :] - coords[None, :, :])
    offsets = rel[..., 0] * window + rel[..., 1]
    _, inv = np.unique(offsets, return_inverse=True)
    return inv.reshape(offsets.shape).astype(np.int64)


class WindowAttention(nn.Module):
    """LeViT-style attention with learned relative biases; (B, N, C)
    window tokens in, its own pre-LayerNorm inside."""

    def __init__(self, dim, num_heads, window, use_kernel_qkv=False,
                 fused_block=False, fused_block_noproj=False):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel_qkv = use_kernel_qkv
        self.fused_block = fused_block
        self.fused_block_noproj = fused_block_noproj
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        idx = _relative_bias_index(window)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, int(idx.max()) + 1))
        self.register_buffer("bias_idx", torch.from_numpy(idx),
                             persistent=False)

    def forward_map(self, x, dtype, window):
        """The fused block over the raw (B, H, W, C) map (the JAX module's
        ``four_d``): K9 on the card.  -> (B, H, W, C)."""
        C = x.shape[-1]
        H = self.num_heads
        n, q, p = self.norm, self.qkv, self.proj
        return wa.fused_block_attention_4d(
            x.to(dtype), n.weight, n.bias, q.weight.t(), q.bias,
            p.weight.t(), p.bias, self.attention_biases[:, self.bias_idx],
            (C // H) ** -0.5, H, window)

    def forward(self, x, dtype):
        B, N, C = x.shape
        H = self.num_heads
        scale = (C // H) ** -0.5
        bias = self.attention_biases[:, self.bias_idx]  # (H, N, N)
        x = x.to(dtype)
        n, q, p = self.norm, self.qkv, self.proj
        if self.fused_block_noproj and N % 128 == 0:
            out = wa.fused_block_attention_noproj(
                x, n.weight, n.bias, q.weight.t(), q.bias, bias, scale, H)
            return _linear(out, p, dtype)
        if self.fused_block and N % 128 == 0:
            return wa.fused_block_attention(
                x, n.weight, n.bias, q.weight.t(), q.bias, p.weight.t(),
                p.bias, bias, scale, H)
        x = F.layer_norm(x.float(), (C,), n.weight, n.bias, 1e-5).to(dtype)
        qkv = _linear(x, q, dtype)
        if self.use_kernel_qkv and N % 128 == 0:
            out = wa.window_attention_qkv(qkv, bias, scale, H)
        else:
            out = wa._attention_qkv_fused_plain(qkv, bias, scale, H)
        return _linear(out, p, dtype)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        n = self.norm
        x = F.layer_norm(x.float(), n.normalized_shape, n.weight, n.bias,
                         1e-5).to(dtype)
        x = _gelu(_linear(x, self.fc1, dtype), self.exact_gelu)
        return _linear(x, self.fc2, dtype)


class TinyViTBlock(nn.Module):
    """Window attention -> depthwise local conv -> MLP, all residual."""

    def __init__(self, dim, num_heads, window, mlp_ratio, exact_gelu,
                 use_kernel_qkv, fused_block, fused_block_noproj,
                 drop_path=0.0, fused_block_4d=False):
        super().__init__()
        self.window = window
        self.four_d = fused_block_4d and fused_block and not fused_block_noproj
        self.attn = WindowAttention(dim, num_heads, window, use_kernel_qkv,
                                    fused_block, fused_block_noproj)
        self.local_conv = ConvBN(dim, dim, 3, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), exact_gelu)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, dtype, train: bool = False, generator=None):
        B, H, W, C = x.shape
        w = min(self.window, H, W)
        if (H, W) == (w, w):
            attn_out = self.attn(x.reshape(B, H * W, C), dtype)
            attn_out = attn_out.reshape(B, H, W, C)
        elif self.four_d and H % w == 0 and W % w == 0 and (w * w) % 128 == 0:
            attn_out = self.attn.forward_map(x, dtype, w)
        else:
            pad_h, pad_w = (-H) % w, (-W) % w
            xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            win = self.attn(window_partition(xp, w), dtype)
            attn_out = window_unpartition(win, w, (H + pad_h, W + pad_w))
            attn_out = attn_out[:, :H, :W, :]
        x = x + self.drop_path(attn_out, train, generator)
        x = self.local_conv(x, dtype, train)
        mlp_out = self.mlp(x.reshape(B, H * W, C), dtype).reshape(B, H, W, C)
        return x + self.drop_path(mlp_out, train, generator)


class TinyViT(nn.Module):
    """(B, H, W, 3) pixels -> (B, embed_dim) f32 pooled, normed features."""

    def __init__(self, config: TinyViTConfig):
        super().__init__()
        cfg = self.config = config
        g = cfg.exact_gelu
        self.patch_embed = PatchEmbed(cfg.in_channels, cfg.embed_dims[0], g)
        self._order = ["patch_embed"]
        dpr = iter(np.linspace(0.0, cfg.drop_path_rate,
                               sum(cfg.depths)).tolist())
        res = -(-cfg.image_size // 4)  # the stem's two stride-2 convs
        for stage, depth in enumerate(cfg.depths):
            dim = cfg.embed_dims[stage]
            # a window larger than the map shrinks to it, as the JAX block's
            # w = min(window, H, W) does; its bias table follows
            window = min(cfg.window_sizes[stage], res)
            for d in range(depth):
                name = f"stage{stage}_block{d}"
                if stage == 0:
                    block = MBConv(dim, cfg.mbconv_expand_ratio, g, next(dpr),
                                   fused=cfg.fused_mbconv)
                else:
                    block = TinyViTBlock(
                        dim, cfg.num_heads[stage], window,
                        cfg.mlp_ratio, g,
                        use_kernel_qkv=stage in cfg.pallas_attention_stages,
                        fused_block=stage in cfg.fused_block_stages,
                        fused_block_noproj=(
                            stage in cfg.fused_block_noproj_stages),
                        drop_path=next(dpr),
                        fused_block_4d=cfg.fused_block_4d,
                    )
                self.add_module(name, block)
                self._order.append(name)
            if stage < len(cfg.depths) - 1:
                name = f"downsample{stage}"
                self.add_module(name, PatchMerging(
                    dim, cfg.embed_dims[stage + 1], g))
                self._order.append(name)
                res = -(-res // 2)
        self.norm_head = nn.LayerNorm(cfg.embed_dims[-1], eps=1e-5)

    def cast_weights_(self) -> "TinyViT":
        """Stores conv and linear weights in the compute dtype once, so the
        forward's per-use casts are no-ops.  Norm parameters, biases and
        attention biases stay f32, as the JAX forward reads them."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.data = m.weight.data.to(self.config.dtype)
        return self

    def forward(self, pixel_values: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        """``train``: batch-statistics BatchNorm (updating the running
        statistics) and DropPath drawn from ``generator``."""
        dtype = self.config.dtype
        x = pixel_values.to(dtype)
        for name in self._order:
            x = getattr(self, name)(x, dtype, train, generator)
        x = x.reshape(x.shape[0], -1, x.shape[-1]).float().mean(dim=1)
        n = self.norm_head
        return F.layer_norm(x, n.normalized_shape, n.weight, n.bias, 1e-5)

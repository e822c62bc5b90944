"""SuperGuessr: geocell classification head over a vision backbone
(TinyViT or the CLIP tower), and its losses (counterpart of
geoguessr_ai_tpu/models/super_guessr.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoguessr_ai_torch.config import NUM_ATTENTION_HEADS, NUM_CANDIDATES
from geoguessr_ai_torch.geo.core import haversine_matrix, smooth_labels
from geoguessr_ai_torch.models.outputs import TopK
from geoguessr_ai_torch.models.positional import PositionalEncoder, dropout


def init_parameters_(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded random parameters (no weights ship with the repo):
    conv/linear weights N(0, 1/fan_in), norm scales 1, biases and attention
    biases small N(0, 0.02^2).  CLIP's ``class_embedding`` and
    ``position_embedding`` draw from N(0, 0.02^2), flax's
    ``normal(0.02)`` initialiser for them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("class_embedding", "position_embedding")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif p.ndim >= 2 and not name.endswith("attention_biases"):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


class ViewSelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` over a panorama's views:
    per-head query / key / value / out projections (channel h * hd + d is
    head h's dim d, the layout ``convert.from_jax_variables`` gives flax's
    DenseGeneral kernels), computed in ``dtype`` as flax computes them: q
    scaled by 1 / sqrt(hd) before q.k, masked keys set to
    ``finfo(dtype).min`` (a row whose keys are all masked gets uniform
    weights, where -inf would give NaN), dropout on the weights in train
    mode, one mask broadcast over batch and heads."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        # flax divides q by sqrt(hd) rounded to the compute dtype
        self.scale = float(torch.tensor(math.sqrt(embed_dim // num_heads),
                                        dtype=dtype))
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def cast_weights_(self) -> "ViewSelfAttention":
        """Stores the four projections' weights and biases in the compute
        dtype once (flax casts both to it), so the forward's per-use casts
        are no-ops."""
        for layer in (self.query, self.key, self.value, self.out):
            layer.weight.data = layer.weight.data.to(self.dtype)
            layer.bias.data = layer.bias.data.to(self.dtype)
        return self

    def _proj(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator=None) -> torch.Tensor:
        """x: (B, V, D); key_mask: optional (B, V) bool, True for real
        views.  Returns (B, V, D) in ``dtype``."""
        B, V, D = x.shape
        H = self.num_heads
        hd = D // H
        x = x.to(self.dtype)
        q, k, v = (self._proj(p, x).reshape(B, V, H, hd)
                   for p in (self.query, self.key, self.value))
        q = q / self.scale
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:
            s = s.masked_fill(~key_mask[:, None, None, :],
                              torch.finfo(self.dtype).min)
        p = torch.softmax(s, dim=-1)
        p = dropout(p, self.dropout_rate, train, generator, (1, 1, V, V))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, V, D)
        return self._proj(self.out, o)


class SuperGuessr(nn.Module):
    """Backbone + view fusion + f32 geocell linear layer.

    backbone: maps (N, H, W, C) pixels to (N, D) embeddings; None runs on
      precomputed embeddings (``forward(embedding=...)``).
    panorama: inputs carry a view axis V.
    hierarchical: fuse the views by positional encoding + self-attention
      (``pos_encoder``, ``self_attn``, ``num_attention_heads`` heads in
      ``dtype``) instead of their mean.
    """

    def __init__(self, num_cells: int, backbone: Optional[nn.Module] = None,
                 embed_dim: int = 576, hierarchical: bool = False,
                 panorama: bool = True,
                 num_attention_heads: int = NUM_ATTENTION_HEADS,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.panorama = panorama
        self.hierarchical = hierarchical
        if hierarchical:
            self.pos_encoder = PositionalEncoder(embed_dim)
            self.self_attn = ViewSelfAttention(embed_dim, num_attention_heads,
                                               dtype)
        self.cell_layer = nn.Linear(embed_dim, num_cells)

    def forward(self, pixel_values: Optional[torch.Tensor] = None,
                view_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator=None,
                embedding: Optional[torch.Tensor] = None):
        """pixel_values: (B, V, H, W, C) (panorama) or (B, H, W, C).
        view_mask: optional (B, V) 1/0 mask of real views.
        train / generator: the backbone's train mode (BatchNorm batch
        statistics, DropPath) and the fusion's dropout.
        embedding: (B, V, D) or (B, D) when there is no backbone.

        Returns (embedding (B, V, D) or (B, D), logits (B, num_cells) f32).
        """
        if self.backbone is not None:
            if pixel_values is None:
                raise ValueError("pixel_values must be supplied when a "
                                 "backbone is present")
            if self.panorama:
                B, V = pixel_values.shape[:2]
                flat = pixel_values.reshape((B * V,) + pixel_values.shape[2:])
                embedding = self.backbone(flat, train=train,
                                          generator=generator).reshape(B, V, -1)
            else:
                embedding = self.backbone(pixel_values, train=train,
                                          generator=generator)
        elif embedding is None:
            raise ValueError("embedding must be supplied when backbone is "
                             "None")
        if not self.panorama:
            return embedding, self.cell_layer(embedding.float())
        emb = embedding.float()
        m = None if view_mask is None else view_mask.float()
        if m is not None:  # before the positional encoding, as flax
            emb = emb * m[..., None]
        if self.hierarchical:
            x = self.pos_encoder(emb, train, generator)
            x = self.self_attn(x, None if m is None else m > 0, train,
                               generator).float()
            if m is None:
                fused = x[:, 0]
            else:  # the mean over real views: view 0 may be padding
                fused = (x * m[..., None]).sum(dim=1) \
                    / m.sum(dim=1).clamp(min=1.0)[:, None]
        elif m is not None:
            fused = emb.sum(dim=1) / m.sum(dim=1).clamp(min=1.0)[:, None]
        else:
            fused = emb.mean(dim=1)
        return embedding, self.cell_layer(fused)


def decode_predictions(logits: torch.Tensor, centroids: torch.Tensor,
                       num_candidates: int = NUM_CANDIDATES):
    """argmax -> centroid (lng, lat) + top-k candidates.

    Returns (geocell_probs, preds_geocell, preds_lnglat, TopK)."""
    probs = torch.softmax(logits.float(), dim=-1)
    preds = torch.argmax(probs, dim=-1)
    lnglat = centroids[preds]
    vals, idx = torch.topk(probs, num_candidates, dim=-1)
    return probs, preds, lnglat, TopK(vals, idx)


def smoothed_soft_ce(logits: torch.Tensor, coords_lnglat: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """Haversine-smoothed soft cross-entropy: targets
    normalize(exp(-(d - d_min) / 65 km)) over the cell centroids, loss the
    batch mean of -sum(targets * log_softmax(logits))."""
    soft = smooth_labels(haversine_matrix(coords_lnglat, centroids))
    soft = soft / torch.clamp(soft.sum(-1, keepdim=True), min=1e-12)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -(soft * log_probs).sum(-1).mean()


def hard_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy on geocell indices."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels[:, None].long()).mean()

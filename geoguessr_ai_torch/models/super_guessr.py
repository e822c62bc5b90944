"""SuperGuessr: geocell classification head over a vision backbone
(TinyViT or the CLIP tower), and its losses (counterpart of
geoguessr_ai_tpu/models/super_guessr.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geoguessr_ai_torch.config import NUM_CANDIDATES
from geoguessr_ai_torch.geo.core import haversine_matrix, smooth_labels
from geoguessr_ai_torch.models.outputs import TopK


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


class SuperGuessr(nn.Module):
    """Backbone + mean view fusion + f32 geocell linear layer."""

    def __init__(self, num_cells: int, backbone: nn.Module,
                 embed_dim: int = 576, hierarchical: bool = False):
        super().__init__()
        if hierarchical:
            raise NotImplementedError(
                "hierarchical (positional encoding + self-attention) view "
                "fusion is not ported yet; use the mean fusion")
        self.backbone = backbone
        self.cell_layer = nn.Linear(embed_dim, num_cells)

    def forward(self, pixel_values: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator=None):
        """pixel_values: (B, V, H, W, C), V views per panorama.
        view_mask: optional (B, V) 1/0 mask of real views.
        train / generator: the backbone's train mode (BatchNorm batch
        statistics, DropPath).

        Returns (embedding (B, V, D), logits (B, num_cells) f32).
        """
        B, V = pixel_values.shape[:2]
        flat = pixel_values.reshape((B * V,) + pixel_values.shape[2:])
        embedding = self.backbone(flat, train=train,
                                  generator=generator).reshape(B, V, -1)
        emb = embedding.float()
        if view_mask is not None:
            m = view_mask.float()
            denom = m.sum(dim=1).clamp(min=1.0)
            fused = (emb * m[..., None]).sum(dim=1) / denom[:, None]
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

"""SuperGuessr: geocell classification head over the TinyViT backbone
(counterpart of geoguessr_ai_tpu/models/super_guessr.py, eval only)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geoguessr_ai_torch.config import NUM_CANDIDATES
from geoguessr_ai_torch.models.outputs import TopK


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
                view_mask: Optional[torch.Tensor] = None):
        """pixel_values: (B, V, H, W, C), V views per panorama.
        view_mask: optional (B, V) 1/0 mask of real views.

        Returns (embedding (B, V, D), logits (B, num_cells) f32).
        """
        B, V = pixel_values.shape[:2]
        flat = pixel_values.reshape((B * V,) + pixel_values.shape[2:])
        embedding = self.backbone(flat).reshape(B, V, -1)
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

"""CLIP text tower and the contrastive CLIP model in PyTorch (counterpart of
geoguessr_ai_tpu/models/clip_text.py).

Modules carry the flax names (``text_model.token_embedding``,
``position_embedding``, ``layer{i}.{layer_norm1,self_attn,layer_norm2,
mlp_fc1,mlp_fc2}``, ``final_layer_norm``; ``vision_model``,
``visual_projection``, ``text_projection``, ``logit_scale``), so
``models.convert.from_jax_variables`` maps a flax ``CLIPModel`` tree onto
the state dict by name.

Numerics follow the flax forward.  The text layers are the vision tower's
encoder layer with flax's ``MultiHeadDotProductAttention`` under a causal
mask (``clip_vit.dot_product_attention``: plain PyTorch, the softmax in the
compute dtype; the JAX text tower has no Pallas kernel either).  The token
embedding is gathered in the compute dtype, the f32 position table cast
before it is added, the final LayerNorm in f32, and the pooled output is
the token at the position of the largest id (the end-of-text token).  The
projections are f32 and bias-free; the loss is the symmetric InfoNCE over
the L2-normalised embeddings at the learned temperature.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoguessr_ai_torch.models.clip_vit import (
    CLIPEncoderLayer,
    CLIPVisionConfig,
    CLIPVisionTower,
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def vit_l_text(**overrides) -> "CLIPTextConfig":
        return CLIPTextConfig(**overrides)

    @staticmethod
    def test_tiny(**overrides) -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=128, max_length=16, hidden_size=64,
                              num_layers=2, num_heads=2, mlp_dim=128,
                              **overrides)


def _layer_config(cfg: CLIPTextConfig) -> CLIPVisionConfig:
    """The vision encoder layer's config that builds a text layer: flax's
    attention (no fused kernel), the text widths."""
    return CLIPVisionConfig(hidden_size=cfg.hidden_size,
                            num_heads=cfg.num_heads, mlp_dim=cfg.mlp_dim,
                            layer_norm_eps=cfg.layer_norm_eps,
                            dtype=cfg.dtype, pallas_attention=False)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """flax ``make_causal_mask``: (1, 1, T, T), query i sees keys <= i."""
    i = torch.arange(length, device=device)
    return (i[:, None] >= i[None, :])[None, None]


class CLIPTextTower(nn.Module):
    """Causal transformer over token ids (B, T) -> (last hidden state
    (B, T, D) f32 after the final LayerNorm, pooled (B, D) f32)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        D = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, D)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, D))
        layer_cfg = _layer_config(cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", CLIPEncoderLayer(layer_cfg))
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.config
        dtype = cfg.dtype
        T = input_ids.shape[1]
        x = (F.embedding(input_ids, self.token_embedding.weight).to(dtype)
             + self.position_embedding[:T].to(dtype))
        mask = causal_mask(T, input_ids.device)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer{i}")(x, dtype, mask)
        n = self.final_layer_norm
        x = F.layer_norm(x.float(), n.normalized_shape, n.weight, n.bias,
                         n.eps)
        # End-of-text pooling at the largest id.  The BPE tokenizer pads
        # with the eos id, so the largest id repeats: torch.argmax returns
        # the first maximal index, as jnp.argmax does, i.e. the eos that
        # closes the caption.
        eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x, pooled


class CLIPOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    logits_per_image: torch.Tensor
    logits_per_text: torch.Tensor
    image_embeds: torch.Tensor
    text_embeds: torch.Tensor


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """Vision and text towers with f32 projections and a learned logit
    scale.  The image embedding is the vision tower's pooled output (the
    post-LayerNorm CLS token), not SuperGuessr's mean-token embedding."""

    def __init__(self, vision_config: CLIPVisionConfig,
                 text_config: CLIPTextConfig, projection_dim: int = 768):
        super().__init__()
        self.vision_model = CLIPVisionTower(vision_config)
        self.text_model = CLIPTextTower(text_config)
        self.visual_projection = nn.Linear(vision_config.hidden_size,
                                           projection_dim, bias=False)
        self.text_projection = nn.Linear(text_config.hidden_size,
                                         projection_dim, bias=False)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                return_loss: bool = True) -> CLIPOutput:
        vis = self.vision_model(pixel_values)
        _, text_pooled = self.text_model(input_ids)
        image_embeds = _normalise(self.visual_projection(vis.pooler_output))
        text_embeds = _normalise(self.text_projection(text_pooled))
        logits_per_text, loss = contrastive_loss(image_embeds, text_embeds,
                                                 self.logit_scale, return_loss)
        return CLIPOutput(loss=loss, logits_per_image=logits_per_text.t(),
                          logits_per_text=logits_per_text,
                          image_embeds=image_embeds, text_embeds=text_embeds)


def contrastive_loss(image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                     logit_scale: torch.Tensor, return_loss: bool = True):
    """(logits_per_text, the symmetric InfoNCE loss or None) of normalised
    embeddings, row i of each the pair of the other's row i."""
    logits_per_text = text_embeds @ image_embeds.t() * torch.exp(logit_scale)
    if not return_loss:
        return logits_per_text, None
    labels = torch.arange(logits_per_text.shape[0],
                          device=logits_per_text.device)
    li = F.cross_entropy(logits_per_text.t(), labels)
    lt = F.cross_entropy(logits_per_text, labels)
    return logits_per_text, (li + lt) / 2.0

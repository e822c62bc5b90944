"""Train and eval steps (counterpart of geoguessr_ai_tpu/train/steps.py).

Batches are dicts of tensors on the model's device:
  pixel_values: (B, V, H, W, C) preprocessed panoramas, or (B, H, W, C)
                for a single-image model
  embedding:    (B, V, D) or (B, D) precomputed embeddings, in place of
                pixel_values when the model has no backbone
  view_mask:    optional (B, V) 1/0 mask of real views
  coords:       (B, 2) f32 (lng, lat) ground truth
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from geoguessr_ai_torch.geo.core import (
    geoguessr_score,
    haversine,
    nearest_centroid_labels,
)
from geoguessr_ai_torch.models.super_guessr import (
    decode_predictions,
    hard_ce,
    smoothed_soft_ce,
)
from geoguessr_ai_torch.train.state import TrainState, global_norm

#: Dtype of the gradient sum over microbatches (the JAX package's default
#: accum_dtype: bf16 halves the accumulator's memory).
ACCUM_DTYPE = torch.bfloat16


@torch.no_grad()
def _metrics(logits, coords, centroids, loss, with_distances=False
             ) -> Dict[str, torch.Tensor]:
    """top-1/top-5 geocell accuracy, km error and GeoGuessr score, on the
    device.  ``with_distances`` adds the per-sample km errors under
    "dist_km", for a whole-split median."""
    labels = nearest_centroid_labels(coords, centroids)
    k = min(5, centroids.shape[0])
    _, preds, pred_lnglat, top = decode_predictions(logits, centroids, k)
    dist_km = haversine(coords, pred_lnglat)
    out = {
        "loss": loss.detach(),
        "top1": (preds == labels).float().mean(),
        "top5": (top.indices == labels[:, None]).any(-1).float().mean(),
        "mean_km": dist_km.mean(),
        # the mean of the two middle values at an even count, as jnp.median
        "median_km": torch.quantile(dist_km, 0.5),
        "score": geoguessr_score(dist_km).mean(),
    }
    if with_distances:
        out["dist_km"] = dist_km
    return out


def _forward(model, batch, train, generator=None):
    """The model on the batch's pixel_values or embedding."""
    return model(batch.get("pixel_values"), view_mask=batch.get("view_mask"),
                 train=train, generator=generator,
                 embedding=batch.get("embedding"))


def _loss(state: TrainState, batch, centroids, should_smooth_labels):
    _, logits = _forward(state.model, batch, True, state.generator)
    if should_smooth_labels:
        loss = smoothed_soft_ce(logits, batch["coords"], centroids)
    else:
        labels = nearest_centroid_labels(batch["coords"], centroids)
        loss = hard_ce(logits, labels)
    return loss, logits


def _grads(loss, leaves):
    """d loss / d leaf for every leaf; a leaf the loss never reads (CLIP's
    post_layernorm under the mean-token embedding) gets zeros, as
    jax.grad gives it."""
    return torch.autograd.grad(loss, leaves, materialize_grads=True)


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    centroids: torch.Tensor,
    should_smooth_labels: bool = True,
    grad_accum_steps: int = 1,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step: forward in train mode (BatchNorm batch
    statistics, running statistics updated), the loss, the gradients of
    every parameter, the AdamW update of the trainable ones.

    grad_accum_steps > 1 splits the batch into that many microbatches in
    order and sums their gradients in ``ACCUM_DTYPE``, then divides the
    f32 sum by their count; BatchNorm's running statistics move once per
    microbatch.  Metrics: loss, top1, top5,
    mean_km, median_km, score, grad_norm (over all gradients) and
    param_norm (after the update), as device scalars."""
    params = dict(state.model.named_parameters())
    names = list(params)
    leaves = [params[n] for n in names]
    if grad_accum_steps <= 1:
        loss, logits = _loss(state, batch, centroids, should_smooth_labels)
        grads = _grads(loss, leaves)
    else:
        k = grad_accum_steps
        b = batch["coords"].shape[0]
        if b % k:
            raise ValueError(
                f"batch size {b} is not divisible by grad_accum_steps={k}; "
                "pick a batch size that splits evenly into microbatches")
        acc = [torch.zeros_like(p, dtype=ACCUM_DTYPE) for p in leaves]
        losses, logits_k = [], []
        m = b // k
        for i in range(k):
            mb = {key: v[i * m:(i + 1) * m] for key, v in batch.items()
                  if isinstance(v, torch.Tensor)}
            mb_loss, mb_logits = _loss(state, mb, centroids,
                                       should_smooth_labels)
            for a, g in zip(acc, _grads(mb_loss, leaves)):
                a += g.to(ACCUM_DTYPE)
            losses.append(mb_loss.detach())
            logits_k.append(mb_logits.detach())
        grads = [a.float() / k for a in acc]
        loss = torch.stack(losses).mean()
        logits = torch.cat(logits_k)
    grads = dict(zip(names, grads))
    state.optimizer.step(params, grads)
    state.step += 1
    metrics = _metrics(logits.detach(), batch["coords"], centroids, loss)
    metrics["grad_norm"] = global_norm(grads.values())
    metrics["param_norm"] = global_norm(p.detach() for p in leaves)
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              centroids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Validation forward (running-statistics BatchNorm, no DropPath)."""
    _, logits = _forward(state.model, batch, False)
    loss = smoothed_soft_ce(logits, batch["coords"], centroids)
    return _metrics(logits, batch["coords"], centroids, loss,
                    with_distances=True)

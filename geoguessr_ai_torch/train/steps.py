"""Train and eval steps (counterpart of geoguessr_ai_tpu/train/steps.py).

Batches are dicts of tensors on the model's device:
  pixel_values: (B, V, H, W, C) preprocessed panoramas, or (B, H, W, C)
                for a single-image model
  embedding:    (B, V, D) or (B, D) precomputed embeddings, in place of
                pixel_values when the model has no backbone
  view_mask:    optional (B, V) 1/0 mask of real views
  coords:       (B, 2) f32 (lng, lat) ground truth

Under a ``parallel.mesh.Mesh`` (``mesh=``) a batch is this rank's rows of
the global batch (``mesh.batch_slice``); the step's gradients, BatchNorm's
statistics and the metrics are those of the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
from geoguessr_ai_torch.parallel.mesh import Mesh
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


def _grads(loss, leaves, mesh=None):
    """d loss / d leaf for every leaf; a leaf the loss never reads (CLIP's
    post_layernorm under the mean-token embedding) gets zeros, as
    jax.grad gives it.  On a mesh, averaged over the data group."""
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return grads if mesh is None else mesh.average_gradients(grads)


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    centroids: torch.Tensor,
    should_smooth_labels: bool = True,
    grad_accum_steps: int = 1,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step: forward in train mode (BatchNorm batch
    statistics, running statistics updated), the loss, the gradients of
    every parameter, the AdamW update of the trainable ones.

    grad_accum_steps > 1 splits the batch into that many microbatches in
    order and sums their gradients in ``ACCUM_DTYPE``, then divides the
    f32 sum by their count; BatchNorm's running statistics move once per
    microbatch.  Metrics: loss, top1, top5,
    mean_km, median_km, score, grad_norm (over all gradients) and
    param_norm (after the update), as device scalars.

    ``mesh``: the batch is this rank's rows (``Mesh.batch_rows``, which
    orders them by microbatch as the JAX step splits the global batch).
    Each microbatch's gradient is averaged over the data group before it
    is rounded into the accumulator, the clipping norm and grad_norm /
    param_norm cover the whole of each sharded parameter, and the metrics
    are of the global batch (identical on every rank)."""
    params = dict(state.model.named_parameters())
    names = list(params)
    leaves = [params[n] for n in names]
    if mesh is not None:
        mesh.check_device(batch["coords"])
    if grad_accum_steps <= 1:
        loss, logits = _loss(state, batch, centroids, should_smooth_labels)
        grads = _grads(loss, leaves, mesh)
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
            for a, g in zip(acc, _grads(mb_loss, leaves, mesh)):
                a += g.to(ACCUM_DTYPE)
            losses.append(mb_loss.detach())
            logits_k.append(mb_logits.detach())
        grads = [a.float() / k for a in acc]
        loss = torch.stack(losses).mean()
        logits = torch.cat(logits_k)
    grads = dict(zip(names, grads))
    if mesh is not None and mesh.sharded:
        state.optimizer.step(params, grads, norm=mesh.global_norm(
            {n: grads[n] for n in state.optimizer.names}))
    else:
        state.optimizer.step(params, grads)
    state.step += 1
    logits, coords = logits.detach(), batch["coords"]
    if mesh is None:
        def norm(named):
            return global_norm(named.values())
    else:
        norm = mesh.global_norm
        logits, coords = mesh.gather_rows(logits), mesh.gather_rows(coords)
        loss = mesh.data_mean(loss.detach())
    metrics = _metrics(logits, coords, centroids, loss)
    metrics["grad_norm"] = norm(grads)
    metrics["param_norm"] = norm({n: p.detach() for n, p in params.items()})
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              centroids: torch.Tensor, mesh: Optional[Mesh] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation forward (running-statistics BatchNorm, no DropPath).
    ``mesh``: the batch is this rank's rows (any count, ``Mesh.eval_rows``);
    the logits and coordinates of every data rank are gathered and the
    metrics taken of the global batch."""
    _, logits = _forward(state.model, batch, False)
    coords = batch["coords"]
    if mesh is not None:
        mesh.check_device(coords)
        logits, coords = mesh.gather_rows(logits), mesh.gather_rows(coords)
    loss = smoothed_soft_ce(logits, coords, centroids)
    return _metrics(logits, coords, centroids, loss, with_distances=True)

"""CLIP contrastive geo-pretraining (counterpart of
geoguessr_ai_tpu/train/pretrain_clip.py).

A ``CLIPModel`` trains on (street-view image, synthetic caption) pairs
with everything frozen but ``visual_projection`` and ``logit_scale``,
under a linear warm-up then linear decay, the gradients of
``grad_accum_steps`` micro-batches averaged into one update.

The JAX optimizer is ``optax.MultiSteps(optax.masked(chain(
clip_by_global_norm, adamw(schedule)), trainable_mask), k)``;
``PretrainOptimizer`` takes the same steps on a dict of named
parameters: the running mean ``acc + (g - acc) / (n + 1)`` of the
micro-batch gradients, one inner update every k micro-steps, the clipping
norm over the trainable parameters only, AdamW (decay included) on them
only, the learning rate of the i-th inner update ``schedule(i)``.  Frozen
parameters get no update and no decay.

On a data axis (``PretrainConfig.mesh``, ``parallel.mesh``) each rank
runs its rows of every global micro-batch, the image and text embeddings
of all ranks are gathered (with their gradient) before the logits
matrix, every rank takes the loss of the global matrix, and the gradients
are averaged over the data group: the step of one process on the global
batch.  Rank 0 writes the checkpoints.

``STOP_GRAD_FROZEN`` runs the frozen towers without an autograd graph
(the JAX step's ``stop_gradient``), so only the projection and the logit
scale are differentiated; it gives the numbers of computing every
gradient and zeroing the frozen ones.  On the card the vision tower's
attention is K6, 24 launches a micro-step at ViT-L/14; the text tower is
plain PyTorch, as the JAX one is XLA.

Tokenization is injected (``tokenize_fn``); ``train.clip_bpe`` gives the
CLIP BPE tokenizer over the repo's assets, ``hash_tokenizer`` a test
fallback.  Rows are mappings (``image`` JPEG bytes, ``lat``, ``lon`` and
the caption fields of ``train.captions``).
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import math
import os
import random
import shutil
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import PretrainConfig
from geoguessr_ai_torch.models.clip_text import (
    CLIPModel,
    CLIPTextConfig,
    contrastive_loss,
)
from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
from geoguessr_ai_torch.models.super_guessr import init_parameters_
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.train.captions import select_caption
from geoguessr_ai_torch.parallel.mesh import Mesh, mesh_for
from geoguessr_ai_torch.train.state import AdamW, linear_value
from geoguessr_ai_torch.utils.logging import MetricsLogger, NullMetricsLogger

TRAINABLE_SUBTREES = ("visual_projection", "logit_scale")

#: The file of a pretraining checkpoint directory.
PARAMS_FILE = "params.pt"


def trainable_mask(names: Iterable[str]) -> Dict[str, bool]:
    """Parameter name -> trainable: True only under ``visual_projection``
    and for ``logit_scale``."""
    return {n: any(part in TRAINABLE_SUBTREES for part in n.split("."))
            for n in names}


def pretrain_schedule(cfg: PretrainConfig, total_steps: int
                      ) -> Callable[[int], float]:
    """Linear warm-up from 0 over ``warmup_ratio * total_steps`` steps,
    then linear decay to 0 over the rest (optax.join_schedules of two
    linear schedules).  Step -> learning rate."""
    warmup = max(1, int(cfg.warmup_ratio * total_steps))
    decay = max(1, total_steps - warmup)

    def sched(step: int) -> float:
        if step < warmup:
            return linear_value(0.0, cfg.learning_rate, warmup, step)
        return linear_value(cfg.learning_rate, 0.0, decay, step - warmup)

    return sched


class PretrainOptimizer:
    """optax.MultiSteps over the masked clip + AdamW chain: ``step`` takes
    each micro-batch's gradients; every ``grad_accum_steps``-th call
    updates the trainable parameters in place with their mean."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: PretrainConfig,
                 schedule: Callable[[int], float],
                 trainable: Dict[str, bool]):
        self.inner = AdamW(params, cfg, schedule, trainable)
        self.k = max(1, cfg.grad_accum_steps)
        self.acc = {n: torch.zeros_like(params[n]) for n in self.inner.names}
        #: micro-steps since the last update
        self.mini_step = 0

    @property
    def names(self) -> List[str]:
        return self.inner.names

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        if self.k == 1:
            self.inner.step(params, grads)
            return
        n = self.mini_step
        for name in self.names:
            acc = self.acc[name]
            self.acc[name] = acc + (grads[name].float() - acc) / (n + 1)
        self.mini_step = (n + 1) % self.k
        if self.mini_step == 0:
            self.inner.step(params, self.acc)
            self.acc = {k: torch.zeros_like(v) for k, v in self.acc.items()}


def make_pretrain_optimizer(cfg: PretrainConfig, total_steps: int,
                            params: Dict[str, torch.Tensor]):
    """(PretrainOptimizer over ``params`` under ``trainable_mask``, the
    schedule); ``total_steps`` counts micro-steps, and the schedule is read
    at the inner update count, as optax's is."""
    sched = pretrain_schedule(cfg, total_steps)
    return (PretrainOptimizer(params, cfg, sched, trainable_mask(params)),
            sched)


#: Run the frozen parameters without autograd (the JAX step's
#: ``stop_gradient``); False computes every gradient and zeroes the
#: frozen ones.  Read at each step.
STOP_GRAD_FROZEN = True


def pretrain_step(model: CLIPModel, optimizer: PretrainOptimizer,
                  batch: Dict[str, torch.Tensor],
                  mask: Dict[str, bool],
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One micro-step: the contrastive loss of ``batch`` (pixel_values
    preprocessed, input_ids), the gradients of the trainable parameters,
    ``optimizer.step``.  Returns the loss as a device scalar.  ``mesh``:
    the batch is this rank's rows of the global micro-batch, and the loss
    that of the global batch's logits matrix."""
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(mask[n] or not STOP_GRAD_FROZEN)
    names = [n for n, p in params.items() if p.requires_grad]
    if mesh is None:
        loss = model(batch["pixel_values"], batch["input_ids"],
                     return_loss=True).loss
    else:
        mesh.check_device(batch["input_ids"])
        out = model(batch["pixel_values"], batch["input_ids"],
                    return_loss=False)
        _, loss = contrastive_loss(mesh.gather_data(out.image_embeds),
                                   mesh.gather_data(out.text_embeds),
                                   model.logit_scale)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    if mesh is not None:
        grads = mesh.average_gradients(grads)
    optimizer.step(params, {n: g if mask[n] else torch.zeros_like(g)
                            for n, g in zip(names, grads)})
    return loss.detach()


class CaptionedBatchIterator:
    """Host batches ``{"pixel_values": (B, S, S, 3) uint8, "input_ids":
    (B, T) int32}`` over row mappings: each pass shuffles the rows and
    captions them from one ``random.Random(seed + pass)``, in the JAX
    iterator's order (the shuffle, then each batch's captions after its
    decode); the last partial batch is dropped.  ``batch_rows``: the
    positions of each batch to yield (one rank's rows; every row is still
    captioned, so the caption stream is that of the whole batch)."""

    def __init__(self, rows, tokenize_fn: Callable[[List[str]], np.ndarray],
                 batch_size: int, image_size: int, seed: int = 42,
                 decode_threads: int = 8, batch_rows=None):
        from geoguessr_ai_torch.data import pipeline

        self.rows = list(rows)
        self.tokenize = tokenize_fn
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.decode_threads = decode_threads
        self.batch_rows = batch_rows
        self._decode = pipeline.decode_jpeg
        self._epoch = 0

    def __iter__(self):
        rng = random.Random(self.seed + self._epoch)
        order = list(range(len(self.rows)))
        rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        with cf.ThreadPoolExecutor(self.decode_threads) as pool:
            for start in range(0, len(order) - bs + 1, bs):
                rows = [self.rows[i] for i in order[start:start + bs]]
                mine = (rows if self.batch_rows is None
                        else [rows[i] for i in self.batch_rows])
                images = np.stack(list(pool.map(
                    lambda r: self._decode(r["image"], self.image_size),
                    mine)))
                captions = [select_caption(dict(r), rng) for r in rows]
                ids = np.asarray(self.tokenize(captions), np.int32)
                if self.batch_rows is not None:
                    ids = ids[self.batch_rows]
                yield {"pixel_values": images, "input_ids": ids}


def init_clip_model_(model: CLIPModel, seed: int) -> None:
    """Seeded random weights at flax's scales: ``init_parameters_``, the
    text position table at N(0, 0.01^2), ``logit_scale`` log(1 / 0.07)."""
    init_parameters_(model, seed)
    with torch.no_grad():
        model.text_model.position_embedding.mul_(0.5)
        model.logit_scale.fill_(math.log(1 / 0.07))


def read_pretrain_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``pretrain`` checkpoint directory."""
    return torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                      weights_only=True)["params"]


def pretrain(rows, tokenize_fn: Callable[[List[str]], np.ndarray],
             cfg: PretrainConfig = PretrainConfig(),
             vision_config: Optional[CLIPVisionConfig] = None,
             text_config: Optional[CLIPTextConfig] = None,
             init_params: Optional[Dict[str, torch.Tensor]] = None,
             max_steps: Optional[int] = None,
             metrics_logger: Optional[MetricsLogger] = None,
             checkpoint_dir: Optional[str] = None,
             device=None) -> Dict:
    """Contrastive pretraining over ``rows``; returns ``{"params": state
    dict on the CPU, "losses": [one per micro-step]}``.

    ``init_params``: a CLIPModel state dict (e.g. ``convert.
    from_jax_variables`` of a flax tree), else seeded weights
    (``cfg.seed``).  ``checkpoint_dir``: ``<dir>/step_%07d/`` every
    ``save_every_steps`` micro-steps and ``<dir>/last/`` at the end, each
    holding ``params.pt`` (``read_pretrain_checkpoint``).  ``device``: None
    means the GPU (raises without one; on a mesh ``cuda:LOCAL_RANK``);
    "cpu" runs the plain path (on a mesh, over gloo).  ``cfg.mesh``: the
    data axis (parameters replicated, as the JAX ``pretrain`` holds them);
    a mesh that does not cover the ranks raises ValueError."""
    dev = C.resolve_device(device)
    mesh = mesh_for(cfg.mesh, dev)
    if mesh is not None:
        dev = mesh.device
    vision_config = vision_config or CLIPVisionConfig.vit_l_14_336()
    text_config = text_config or CLIPTextConfig.vit_l_text()
    model = CLIPModel(vision_config, text_config)
    if init_params is None:
        init_clip_model_(model, cfg.seed)
    else:
        model.load_state_dict(init_params, strict=True)
    model.to(dev)

    rows = list(rows)
    steps_per_epoch = max(1, len(rows) // cfg.batch_size)
    total_steps = steps_per_epoch * cfg.num_epochs
    params = dict(model.named_parameters())
    optimizer, _ = make_pretrain_optimizer(cfg, total_steps, params)
    mask = trainable_mask(params)
    it = CaptionedBatchIterator(
        rows, tokenize_fn, cfg.batch_size, vision_config.image_size,
        seed=cfg.seed,
        batch_rows=None if mesh is None else mesh.batch_rows(cfg.batch_size))
    writer = mesh is None or mesh.rank == 0
    mlog = (metrics_logger or MetricsLogger(project="geoguessr-tpu-pretrain")
            if writer else NullMetricsLogger())

    def save_checkpoint(name: str) -> None:
        if checkpoint_dir is None or not writer:
            return
        path = os.path.join(os.path.abspath(checkpoint_dir), name)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        host = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"params": host}, os.path.join(path, PARAMS_FILE))

    losses: List[float] = []
    step = 0
    for _ in range(cfg.num_epochs):
        for batch in it:
            pixels = torch.from_numpy(batch["pixel_values"]).to(dev)
            device_batch = {
                "pixel_values": fused_preprocess(
                    pixels, C.CLIP_NORM_MEAN, C.CLIP_NORM_STD,
                    vision_config.image_size),
                "input_ids": torch.from_numpy(batch["input_ids"]).long()
                .to(dev),
            }
            loss = pretrain_step(model, optimizer, device_batch, mask, mesh)
            step += 1
            losses.append(float(loss))
            if step % 10 == 0 or step == 1:
                mlog.log({"pretrain/loss": losses[-1]}, step)
            if cfg.save_every_steps and step % cfg.save_every_steps == 0:
                save_checkpoint(f"step_{step:07d}")
            if max_steps is not None and step >= max_steps:
                break
        if max_steps is not None and step >= max_steps:
            break
    save_checkpoint("last")
    if mesh is not None:
        mesh.barrier()  # rank 0's last write lands before any rank reads
    mlog.finish()
    return {"params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
            "losses": losses}


def hash_tokenizer(vocab_size: int = 49408, max_length: int = 77):
    """Deterministic fallback tokenizer (tests, no BPE assets): whitespace
    split, a stable hash into the vocabulary, EOT = vocab_size - 1."""

    def tokenize(texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [49406 % vocab_size]  # BOS
            for w in t.lower().split()[:max_length - 2]:
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16) \
                    % (vocab_size - 3)
                toks.append(1 + h)
            toks.append(vocab_size - 1)  # EOT (max id -> pooling target)
            out[i, :len(toks)] = toks
        return out

    return tokenize

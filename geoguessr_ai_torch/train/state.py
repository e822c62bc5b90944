"""Train state and optimizer (counterpart of geoguessr_ai_tpu/train/state.py).

The JAX package builds its optimizer from optax:
``multi_transform({"train": chain(clip_by_global_norm, adamw(sched)),
"freeze": set_to_zero()})``.  ``AdamW`` here takes the same step on a dict
of named parameters, in the same order of f32 operations:

* the global norm for clipping covers the trainable parameters only (the
  inner chain of ``multi_transform`` sees only its own leaves), and the
  gradients are scaled by max_norm / norm only when norm >= max_norm; a
  ``max_grad_norm`` of None clips nothing (a bare ``optax.adamw``);
* Adam moments with bias correction, eps outside the square root, then
  decoupled weight decay: ``p - lr * (adam + wd * p)``;
* frozen parameters get no update, no decay and no moments;
* the learning rate of step t (counted from 0) is ``sched(t)``.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import re
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from geoguessr_ai_torch.config import OptimizerConfig


#: Top-level TinyViT modules that stay trainable under
#: freeze_all_but_last_stage: the last stage, the PatchMerging that leads
#: into it and the head norm.
LAST_STAGE_PREFIXES = ("stage3", "downsample2", "norm_head")

_LAYER = re.compile(r"layer(\d+)")


def last_stage_prefixes(backbone_children: Iterable[str]) -> tuple:
    """The top-level backbone modules that stay trainable under
    freeze_all_but_last_stage, read from the backbone's own names as the
    JAX ``_last_stage_prefixes`` reads them: a tower of ``layer0`` ..
    ``layerN`` (CLIP) keeps ``layerN`` and ``post_layernorm``; anything
    else is TinyViT (``LAST_STAGE_PREFIXES``)."""
    ids = [int(m.group(1)) for n in backbone_children
           if (m := _LAYER.fullmatch(n))]
    if ids:
        return (f"layer{max(ids)}", "post_layernorm")
    return LAST_STAGE_PREFIXES


def backbone_freeze_mask(names: Iterable[str], freeze_base: bool = False,
                         freeze_all_but_last_stage: bool = False
                         ) -> Dict[str, bool]:
    """Parameter name -> trainable, for the names of a SuperGuessr state
    dict ("backbone.stage3_block0.attn.qkv.weight", "cell_layer.bias").
    freeze_base freezes the whole backbone; freeze_all_but_last_stage
    keeps its last stage trainable (``last_stage_prefixes``; a prefix
    match, as in the JAX mask).  Everything outside the backbone always
    trains.  Raises if freeze_all_but_last_stage would freeze the whole
    backbone.

    Under CLIP's rule ``post_layernorm`` is trainable though SuperGuessr's
    mean-token embedding never reads it: its gradient is zero, and
    AdamW's weight decay still moves it, as in the JAX step."""
    names = list(names)
    children = {n.split(".")[1] for n in names if n.startswith("backbone.")}
    prefixes = last_stage_prefixes(children)
    mask = {}
    any_trainable = False
    for name in names:
        parts = name.split(".")
        if parts[0] != "backbone":
            mask[name] = True
        elif freeze_base:
            mask[name] = False
        elif freeze_all_but_last_stage:
            keep = parts[1].startswith(prefixes)
            any_trainable |= keep
            mask[name] = keep
        else:
            mask[name] = True
    if (freeze_all_but_last_stage and not freeze_base and children
            and not any_trainable):
        raise ValueError(
            "freeze_all_but_last_stage matched no backbone params "
            f"(children={sorted(children)}, wanted prefixes "
            f"{prefixes}): the whole backbone would be frozen")
    return mask


def cosine_warm_restarts(base_lr: float, steps_per_cycle: int,
                         t_mult: int = 2, num_cycles: int = 8,
                         warmup_steps: int = 0) -> Callable[[int], float]:
    """SGDR: cosine decay to 0 restarting with periods growing by t_mult
    (optax.join_schedules of cosine_decay_schedule, after an optional
    linear warm-up).  Returns step -> learning rate."""
    periods = []
    t = max(1, steps_per_cycle)
    for _ in range(num_cycles):
        periods.append(t)
        t *= max(1, t_mult)
    boundaries = list(itertools.accumulate(periods))[:-1]

    def sched(step: int) -> float:
        if warmup_steps > 0:
            if step < warmup_steps:
                return base_lr * step / warmup_steps
            step -= warmup_steps
        i = bisect.bisect_right(boundaries, step)
        start = boundaries[i - 1] if i else 0
        count = min(step - start, periods[i])
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / periods[i]))

    return sched


def linear_value(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps)(count), in f32 as optax
    computes it."""
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return float(np.float32(init - end) * frac + np.float32(end))


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int
                        ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps) in f32: a linear warm-up from 0 (none when warmup_steps
    is 0), then a cosine from ``peak`` to 0 over ``decay_steps -
    warmup_steps`` steps (``decay_steps`` counts the warm-up).  Step ->
    learning rate."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")

    def sched(step: int) -> float:
        if step < warmup_steps:
            return linear_value(0.0, peak, warmup_steps, step)
        c = np.float32(min(step - warmup_steps, span))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(np.pi) * c / np.float32(span)))
        return float(np.float32(peak) * cos)

    return sched


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class AdamW:
    """optax's clip_by_global_norm + adamw under a freeze mask, over a dict
    of named f32 parameters.  Moments live beside the trainable
    parameters on their device."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: OptimizerConfig,
                 schedule: Callable[[int], float],
                 trainable: Optional[Dict[str, bool]] = None):
        self.cfg = cfg
        self.schedule = schedule
        self.names = [n for n in params if trainable is None or trainable[n]]
        self.mu = {n: torch.zeros_like(params[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(params[n]) for n in self.names}
        #: updates taken so far; step t uses schedule(t)
        self.count = 0

    def _bias_correction(self, decay: float, count: int) -> float:
        # 1 - decay**count in f32, as optax computes it
        return float(np.float32(1) - np.float32(decay) ** np.float32(count))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> float:
        """Updates the trainable ``params`` in place; returns the learning
        rate used."""
        cfg = self.cfg
        g = {n: grads[n].float() for n in self.names}
        if cfg.max_grad_norm is not None:
            norm = global_norm(g.values())
            clip = norm >= cfg.max_grad_norm  # a device scalar: no host sync
            g = {n: torch.where(clip, (t / norm) * cfg.max_grad_norm, t)
                 for n, t in g.items()}
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = self._bias_correction(cfg.beta1, self.count)
        bc2 = self._bias_correction(cfg.beta2, self.count)
        for n in self.names:
            p, t = params[n], g[n]
            self.mu[n] = (1 - cfg.beta1) * t + cfg.beta1 * self.mu[n]
            self.nu[n] = (1 - cfg.beta2) * (t * t) + cfg.beta2 * self.nu[n]
            update = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                           + cfg.eps)
            update = update + cfg.weight_decay * p
            p.add_(-lr * update)
        return lr

    def state_dict(self) -> Dict:
        """The moments and the update count (the config and schedule come
        from the caller)."""
        return {"mu": dict(self.mu), "nu": dict(self.nu),
                "count": self.count}

    def load_state_dict(self, sd: Dict) -> None:
        """Copies moments of the same names and shapes into place."""
        for key in ("mu", "nu"):
            mine, theirs = getattr(self, key), sd[key]
            if set(theirs) != set(mine):
                raise KeyError(
                    f"optimizer {key} holds {sorted(set(theirs) ^ set(mine))}"
                    " where this optimizer's trainable parameters differ")
            for n, t in theirs.items():
                if t.shape != mine[n].shape:
                    raise ValueError(f"optimizer {key}[{n!r}] has shape "
                                     f"{tuple(t.shape)}, expected "
                                     f"{tuple(mine[n].shape)}")
                mine[n] = t.to(mine[n].device, mine[n].dtype).clone()
        self.count = int(sd["count"])


def make_optimizer(params: Dict[str, torch.Tensor], cfg: OptimizerConfig,
                   steps_per_epoch: int,
                   trainable_mask: Optional[Dict[str, bool]] = None
                   ) -> AdamW:
    """AdamW over ``params`` with the SGDR schedule of ``cfg`` (cycle
    length steps_per_epoch * cosine_t0); parameters whose mask entry is
    False get no update at all."""
    sched = cosine_warm_restarts(
        cfg.learning_rate,
        steps_per_cycle=max(1, steps_per_epoch * cfg.cosine_t0),
        t_mult=cfg.cosine_t_mult,
        warmup_steps=cfg.warmup_steps,
    )
    return AdamW(params, cfg, sched, trainable_mask)


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances: the model (its parameters and
    BatchNorm running statistics), the optimizer's moments, the step count
    and the generator DropPath draws from."""

    model: torch.nn.Module
    optimizer: AdamW
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> Dict:
        """Everything a resume needs, as tensors, numbers and plain
        containers (loadable with ``torch.load(..., weights_only=True)``):
        the model's state dict, the optimizer's moments and count, the
        generator's state and the step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
                "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        """Loads ``state_dict()``'s form in place (the model strictly)."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])


def create_train_state(model: torch.nn.Module, optimizer_cfg: OptimizerConfig,
                       steps_per_epoch: int, seed: int = 0,
                       trainable_mask: Optional[Dict[str, bool]] = None
                       ) -> TrainState:
    """A TrainState for ``model`` on its current device.  Every parameter
    requires grad: the step's grad_norm covers all of them."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    return TrainState(
        model=model,
        optimizer=make_optimizer(params, optimizer_cfg, steps_per_epoch,
                                 trainable_mask),
        generator=torch.Generator(device=device).manual_seed(seed),
    )

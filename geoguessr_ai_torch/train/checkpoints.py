"""Checkpoint store: last / best / top-K with pruning, and resume
(counterpart of geoguessr_ai_tpu/train/checkpoints.py), written as torch
files; and reading PyTorch reference checkpoints (``load_torch_checkpoint``).

Each checkpoint is a directory ``<dir>/<name>/`` holding ``state.pt``:
``{"state": TrainState.state_dict(), "meta": {epoch, monitored_value,
best_value, global_step, ...}}``, tensors, numbers and plain containers
only, so it loads with ``weights_only=True``.  The retention rules are the
JAX store's: ``last`` every epoch, ``best`` on improvement of the monitored
metric, per-epoch ``epoch_%04d_%.6f`` directories kept while in the top K
(the metric parsed back out of the name).  The JAX store's upload of kept
checkpoints as W&B artifacts is left out: W&B is not installed where the
port runs.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_EPOCH_DIR_RE = re.compile(r"^epoch_(\d{4})_(-?[\d.]+)$")

#: The file of a checkpoint directory.
STATE_FILE = "state.pt"


@dataclass
class CheckpointConfig:
    directory: str
    keep_top_k: int = 3
    monitored_mode: str = "min"  # "min" (loss) or "max" (score)
    #: When True, save_epoch returns once the state is copied to the host;
    #: the write, the last/best copies and the pruning run on a background
    #: thread, overlapping checkpoint IO with the next epoch.  The store
    #: waits for it before touching the directory again, and an error
    #: raised there surfaces at that next store operation.
    async_save: bool = False
    #: False on every rank of a mesh but rank 0: save_epoch resolves the
    #: best value and writes nothing (rank 0 writes; every rank reads).
    #: Every rank still calls save_epoch, since the state dict of a model
    #: axis is a collective (its shards gathered) and every rank needs the
    #: best value; the store itself knows no mesh.
    write: bool = True


def _to_host(tree):
    """A copy of ``tree`` with every tensor on the CPU, detached from the
    live state (the step after a save updates parameters in place)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointStore:
    """Filesystem layout:
        <dir>/last/state.pt                 newest state, every epoch
        <dir>/best/state.pt                 best monitored metric so far
        <dir>/epoch_0018_4.610809/state.pt  top-K per-epoch checkpoints
    """

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._bg: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None

    # -- helpers ---------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.cfg.directory), name)

    def _is_better(self, value: float, reference: float) -> bool:
        if self.cfg.monitored_mode == "min":
            return value < reference
        return value > reference

    def _epoch_dirs(self) -> List[Tuple[str, int, float]]:
        out = []
        for name in os.listdir(self.cfg.directory):
            m = _EPOCH_DIR_RE.match(name)
            if m:
                out.append((name, int(m.group(1)), float(m.group(2))))
        return out

    def _save_tree(self, name: str, tree: Dict) -> None:
        import torch

        # Defensive re-creation: the checkpoint directory may have been
        # removed mid-run.
        os.makedirs(self.cfg.directory, exist_ok=True)
        path = self._path(name)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(tree, os.path.join(path, STATE_FILE))

    def _copy_tree(self, src_name: str, dst_name: str) -> None:
        src, dst = self._path(src_name), self._path(dst_name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)

    def _join(self) -> None:
        """Finishes an in-flight async save; raises its error, if any."""
        if self._bg is not None:
            self._bg.join()
            self._bg = None
        if self._bg_error is not None:
            err, self._bg_error = self._bg_error, None
            raise err

    def wait_until_finished(self) -> None:
        """Blocks until an in-flight async save has fully committed (the
        write, the last/best copies and pruning)."""
        self._join()

    # -- public API ------------------------------------------------------

    def save_epoch(
        self,
        state: Any,
        epoch: int,
        monitored_value: float,
        best_value: Optional[float],
        extra: Optional[Dict] = None,
    ) -> float:
        """Saves last/best/top-K for this epoch.  Returns the new best value.

        ``state`` is a TrainState (or anything with ``state_dict()``, or a
        plain tree of tensors); ``extra`` metadata (e.g. global_step) rides
        along in ``meta``.
        """
        # The new best is resolved before anything is written, so that
        # 'last' carries the post-epoch best (a resume after an improving
        # epoch must not revert to the stale best).  A NaN monitored value
        # never becomes best: NaN comparisons would poison every later
        # _is_better.
        monitored_is_valid = not np.isnan(monitored_value)
        improved = monitored_is_valid and (
            best_value is None
            or np.isnan(best_value)
            or self._is_better(monitored_value, best_value)
        )
        new_best = monitored_value if improved else best_value
        # (a collective on a model axis: every rank takes the state dict)
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        if not self.cfg.write:
            return float(new_best) if new_best is not None else float("nan")
        tree = {
            "state": _to_host(sd),
            "meta": {
                "epoch": int(epoch),
                "monitored_value": float(monitored_value),
                "best_value": float(new_best if new_best is not None
                                    else monitored_value),
                **{k: (v.item() if hasattr(v, "item") else v)
                   for k, v in (extra or {}).items()},
            },
        }

        # The tree is written once; 'last' and 'best' are copies of it.  A
        # NaN epoch gets no metric-named directory, so 'last' is primary.
        self._join()
        if monitored_is_valid:
            primary = f"epoch_{epoch:04d}_{monitored_value:.6f}"
        else:
            primary = "last"

        def commit() -> None:
            self._save_tree(primary, tree)
            if primary != "last":
                self._copy_tree(primary, "last")
            if improved:
                self._copy_tree(primary, "best")
            if monitored_is_valid:
                self._prune()

        if self.cfg.async_save:
            def run() -> None:
                try:
                    commit()
                except Exception as e:  # surfaced at the next store op
                    self._bg_error = e

            self._bg = threading.Thread(target=run, daemon=True)
            self._bg.start()
        else:
            commit()
        return float(new_best) if new_best is not None else float("nan")

    def _prune(self) -> None:
        dirs = self._epoch_dirs()
        if len(dirs) <= self.cfg.keep_top_k:
            return
        reverse = self.cfg.monitored_mode == "max"
        dirs.sort(key=lambda t: t[2], reverse=reverse)
        for name, _, _ in dirs[self.cfg.keep_top_k:]:
            shutil.rmtree(self._path(name), ignore_errors=True)

    def kept_epochs(self) -> List[str]:
        self._join()
        return sorted(n for n, _, _ in self._epoch_dirs())

    def restore(self, target: Any, name: str = "last") -> Tuple[Any, Dict]:
        """Loads <dir>/<name> into ``target`` (a TrainState, in place) and
        returns (target, meta); a checkpoint without ``global_step`` gets
        0."""
        self._join()
        tree = read_checkpoint(self._path(name))
        target.load_state_dict(tree["state"])
        meta = dict(tree["meta"])
        meta.setdefault("global_step", 0)
        return target, meta

    def has(self, name: str) -> bool:
        self._join()
        return os.path.isdir(self._path(name))


def read_checkpoint(path: str) -> Dict:
    """A store checkpoint directory's ``{"state", "meta"}`` tree, on the
    CPU.  Only tensors and plain containers are unpickled
    (``weights_only``)."""
    import torch

    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` state dict (or a training checkpoint that wraps one under
    ``model_state_dict``) as numpy arrays; entries that are not tensors
    are dropped.  Only tensors and plain containers are unpickled
    (``weights_only``): a checkpoint file cannot run code."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in blob.items()
            if isinstance(v, torch.Tensor)}

"""Reading PyTorch training checkpoints (counterpart of
``load_torch_checkpoint`` in geoguessr_ai_tpu/train/checkpoints.py).

The JAX package's ``CheckpointStore`` (orbax directories: save, resume,
best/last, retention) is not ported yet: it waits for torch checkpoint
files of the port's own train loop (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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

"""Model output containers."""

from typing import NamedTuple

import torch


class TopK(NamedTuple):
    """torch.topk's (values, indices) pair of the geocell probabilities."""

    values: torch.Tensor  # (B, k) probabilities
    indices: torch.Tensor  # (B, k) int64 geocell indices

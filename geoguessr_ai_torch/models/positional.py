"""Sinusoidal positional encoding (counterpart of
geoguessr_ai_tpu/models/positional.py): the transformer sin/cos table added
residually, then dropout."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geoguessr_ai_torch.parallel.mesh import rand_rows


def sinusoidal_table(max_len: int, d_model: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """(max_len, d_model) table: sin on even dims, cos on odd dims."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    # the factor in f32, as the JAX package takes it
    factor = -torch.log(torch.tensor(10000.0, device=device)) / d_model
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * factor)
    angles = position * div_term  # (max_len, ceil(d / 2))
    pe = torch.zeros(max_len, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : d_model // 2])
    return pe.to(dtype)


class PositionalEncoder(nn.Module):
    """Residual sinusoidal table + dropout over a (B, T, C) sequence.

    The f32 table is built once, on the CPU, and kept as a buffer that
    moves with the module and is not part of its state dict.  Dropout
    applies in train mode only, drawn from the caller's ``generator`` (on
    a data axis for the global batch, this rank's rows kept)."""

    #: a data-axis ``parallel.mesh.Mesh`` (``shard_module_``)
    mesh = None

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 1000):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.max_len = max_len
        self.register_buffer("table", sinusoidal_table(max_len, d_model),
                             persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq_len = x.shape[1]
        x = x + self.table[None, :seq_len, :].to(x.dtype)
        return dropout(x, self.dropout_rate, train, generator,
                       mesh=self.mesh)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            shape=None, mesh=None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keeps each element with
    probability 1 - rate and scales it by 1 / (1 - rate).  ``shape``
    broadcasts one keep mask over the axes where it is 1.  ``mesh``: x's
    rows are this rank's of a data axis (``parallel.mesh.rand_rows``)."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = rand_rows(shape or x.shape, generator, mesh) < keep_prob
    return torch.where(keep.to(x.device), x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))

"""Device-side preprocessing: uint8 pixels -> normalised model input."""

from __future__ import annotations

from typing import Tuple

import torch


def fused_preprocess(
    images_u8: torch.Tensor,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
    out_size: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> ((x / 255 - mean) / std) as ``dtype``.

    Only the equal-size branch is ported: the serving path decodes straight
    to the model's size.  A resize raises."""
    h, w = images_u8.shape[-3], images_u8.shape[-2]
    if (h, w) != (out_size, out_size):
        raise NotImplementedError(
            f"fused_preprocess: resizing {h}x{w} to {out_size}x{out_size} "
            "(the JAX package's antialiased bilinear branch) is not ported; "
            "decode to the model's size first"
        )
    x = images_u8.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)

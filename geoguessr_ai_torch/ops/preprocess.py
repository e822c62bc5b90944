"""Device-side preprocessing: uint8 pixels -> resized, normalised model
input (counterpart of geoguessr_ai_tpu/ops/preprocess.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def fused_preprocess(
    images_u8: torch.Tensor,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
    out_size: int,
    dtype: torch.dtype = torch.bfloat16,
    antialias: bool = True,
) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> ((x / 255 - mean) / std) as ``dtype``,
    (..., out_size, out_size, 3).

    Views that are not out_size x out_size are resized in f32 on the
    tensor's device first: bilinear, half-pixel centres, antialiased when
    downscaling (``jax.image.resize(..., "bilinear", antialias=True)``)."""
    x = images_u8.float() / 255.0
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) != (out_size, out_size):
        lead = x.shape[:-3]
        nchw = x.reshape((-1, h, w, x.shape[-1])).permute(0, 3, 1, 2)
        nchw = F.interpolate(nchw, size=(out_size, out_size),
                             mode="bilinear", align_corners=False,
                             antialias=antialias)
        x = nchw.permute(0, 2, 3, 1).reshape(
            lead + (out_size, out_size, x.shape[-1]))
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)

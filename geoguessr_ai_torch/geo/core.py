"""Geodesy on (lon, lat) degree tensors, distances in km."""

from __future__ import annotations

import math

import torch

from geoguessr_ai_torch.config import EARTH_RADIUS_MODEL_M


def haversine(x: torch.Tensor, y: torch.Tensor,
              radius_m: float = EARTH_RADIUS_MODEL_M) -> torch.Tensor:
    """Distance between aligned (..., 2) (lon, lat) point sets -> (...,) km."""
    x_rad, y_rad = x * (math.pi / 180.0), y * (math.pi / 180.0)
    delta = y_rad - x_rad
    a = (
        torch.sin(delta[..., 1] / 2) ** 2
        + torch.cos(x_rad[..., 1])
        * torch.cos(y_rad[..., 1])
        * torch.sin(delta[..., 0] / 2) ** 2
    )
    c = 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    return radius_m * c / 1000.0

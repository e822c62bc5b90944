"""Geodesy on (lon, lat) degree tensors, distances in km."""

from __future__ import annotations

import math

import torch

from geoguessr_ai_torch.config import (
    EARTH_RADIUS_MODEL_M,
    GEOGUESSR_DECAY_CONSTANT_KM,
    LABEL_SMOOTHING_CONSTANT_KM,
)


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


def haversine_matrix(x: torch.Tensor, y: torch.Tensor,
                     radius_m: float = EARTH_RADIUS_MODEL_M) -> torch.Tensor:
    """All-pairs distances between (N, 2) and (M, 2) (lon, lat) point
    lists -> (N, M) km."""
    return haversine(x[:, None, :], y[None, :, :], radius_m)


def smooth_labels(distances: torch.Tensor,
                  smoothing_km: float = LABEL_SMOOTHING_CONSTANT_KM
                  ) -> torch.Tensor:
    """Unnormalised soft labels exp(-(d - min(d)) / smoothing_km) over the
    last axis, NaN and infinities mapped to 0."""
    adj = distances - distances.min(dim=-1, keepdim=True).values
    return torch.nan_to_num(torch.exp(-adj / smoothing_km), nan=0.0,
                            posinf=0.0, neginf=0.0)


def geoguessr_score(distance_km: torch.Tensor,
                    decay_km: float = GEOGUESSR_DECAY_CONSTANT_KM
                    ) -> torch.Tensor:
    """GeoGuessr score: clamp(5000 * exp(-d / decay), 0, 5000)."""
    return torch.clamp(5000.0 * torch.exp(-distance_km / decay_km), 0.0,
                       5000.0)


def nearest_centroid_labels(coords: torch.Tensor, centroids: torch.Tensor,
                            radius_m: float = EARTH_RADIUS_MODEL_M
                            ) -> torch.Tensor:
    """(B, 2) (lon, lat) -> (B,) index of the nearest geocell centroid."""
    d = haversine_matrix(coords, centroids, radius_m=radius_m)
    return torch.argmin(d, dim=-1)

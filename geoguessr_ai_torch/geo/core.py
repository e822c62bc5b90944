"""Geodesy on (lon, lat) degree tensors, distances in km."""

from __future__ import annotations

import math

import torch

from geoguessr_ai_torch.config import (
    EARTH_RADIUS_MODEL_M,
    GEOGUESSR_DECAY_CONSTANT_KM,
    LABEL_SMOOTHING_CONSTANT_KM,
    WGS84_FLATTENING,
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


def lla2ecef(coords: torch.Tensor,
             radius_m: float = EARTH_RADIUS_MODEL_M) -> torch.Tensor:
    """(..., 2) (lon, lat) degrees -> (..., 3) ECEF (x, y, z) meters on the
    WGS84 ellipsoid."""
    rad = coords * (math.pi / 180.0)
    cos_lat = torch.cos(rad[..., 1])
    sin_lat = torch.sin(rad[..., 1])
    ff = (1.0 - WGS84_FLATTENING) ** 2
    c = 1.0 / torch.sqrt(cos_lat ** 2 + ff * sin_lat ** 2)
    s = c * ff
    x = radius_m * c * cos_lat * torch.cos(rad[..., 0])
    y = radius_m * c * cos_lat * torch.sin(rad[..., 0])
    z = radius_m * s * sin_lat
    return torch.stack([x, y, z], dim=-1)


def ecef2lla(coords: torch.Tensor, radius_m: float = EARTH_RADIUS_MODEL_M,
             num_iters: int = 5) -> torch.Tensor:
    """(..., 3) ECEF meters -> (..., 2) (lon, lat) degrees by Bowring's
    fixed-point iteration, ``num_iters`` rounds from Bowring's 1985
    starting values (the JAX package's static count)."""
    a = radius_m
    f = WGS84_FLATTENING
    b = (1.0 - f) * a
    e2 = f * (2.0 - f)
    ae2 = a * e2
    bep2 = b * e2 / (1.0 - e2)

    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    lon = torch.atan2(y, x)
    rho = torch.sqrt(x ** 2 + y ** 2)
    r = torch.sqrt(rho ** 2 + z ** 2)

    def norm_cs(u, v):
        # (cos, sin) of the angle whose tangent is v / u, sign-correct
        hyp = torch.clamp(torch.sqrt(u ** 2 + v ** 2), min=1e-30)
        return u / hyp, v / hyp

    cosb, sinb = norm_cs(a * rho,
                         b * z * (1.0 + bep2 / torch.clamp(r, min=1e-9)))
    for _ in range(num_iters):
        cosb, sinb = norm_cs(a * (rho - ae2 * cosb ** 3),
                             b * (z + bep2 * sinb ** 3))
    lat = torch.atan2(z + bep2 * sinb ** 3, rho - ae2 * cosb ** 3)
    return torch.stack([lon, lat], dim=-1) * (180.0 / math.pi)


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

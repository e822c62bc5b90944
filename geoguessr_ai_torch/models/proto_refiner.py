"""ProtoRefiner: prototype-based guess refinement, vectorised over the
batch (counterpart of geoguessr_ai_tpu/models/proto_refiner.py without
the member-bank stage, which is not ported yet).

  bank.embeddings: (num_cells, P, D)  per-cell cluster prototypes, padded
  bank.coords:     (num_cells, P, 2)  (lng, lat) per prototype
  bank.mask:       (num_cells, P)     1 for real prototypes
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.geo.core import haversine

DEFAULT_TOPK = 5
DEFAULT_MAX_REFINEMENT_KM = 1000.0
DEFAULT_TEMPERATURE = 1.6
_NO_PROTO_AFFINITY = -1.0e5


@dataclasses.dataclass
class PrototypeBank:
    """Fixed-shape prototype store (one row per geocell)."""

    embeddings: np.ndarray  # (num_cells, P, D) float32
    coords: np.ndarray  # (num_cells, P, 2) float32 (lng, lat)
    mask: np.ndarray  # (num_cells, P) float32

    def save(self, path: str) -> None:
        np.savez_compressed(path, embeddings=self.embeddings,
                            coords=self.coords, mask=self.mask)

    @staticmethod
    def load(path: str) -> "PrototypeBank":
        with np.load(path) as z:
            return PrototypeBank(embeddings=z["embeddings"],
                                 coords=z["coords"], mask=z["mask"])


def refine(
    bank_embeddings: torch.Tensor,  # (num_cells, P, D)
    bank_coords: torch.Tensor,  # (num_cells, P, 2)
    bank_mask: torch.Tensor,  # (num_cells, P)
    query_emb: torch.Tensor,  # (B, D) fused panorama embedding
    topk_ids: torch.Tensor,  # (B, K) int
    topk_probs: torch.Tensor,  # (B, K)
    initial_lnglat: torch.Tensor,  # (B, 2)
    temperature: float = DEFAULT_TEMPERATURE,
    max_refinement_km: float = DEFAULT_MAX_REFINEMENT_KM,
):
    """Returns (refined_lnglat (B, 2), refined_cell (B,), changed (B,))."""
    cand_emb = bank_embeddings[topk_ids]  # (B, K, P, D)
    cand_coords = bank_coords[topk_ids]  # (B, K, P, 2)
    cand_mask = bank_mask[topk_ids]  # (B, K, P)

    diff = cand_emb - query_emb[:, None, None, :]
    d2 = (diff * diff).sum(dim=-1)
    neg_d = -torch.sqrt(torch.clamp(d2, min=1e-12))
    neg_d = torch.where(cand_mask > 0, neg_d,
                        torch.full_like(neg_d, _NO_PROTO_AFFINITY))

    best_p = torch.argmax(neg_d, dim=-1)  # (B, K)
    affinity = neg_d.max(dim=-1).values  # (B, K)
    best_coords = torch.gather(
        cand_coords, 2, best_p[..., None, None].expand(-1, -1, 1, 2)
    )[:, :, 0, :]  # (B, K, 2)
    has_proto = (cand_mask > 0).any(dim=-1)
    best_coords = torch.where(has_proto[..., None], best_coords,
                              initial_lnglat[:, None, :].expand_as(best_coords))

    proto_probs = torch.softmax(affinity / temperature, dim=-1)
    final_probs = topk_probs * proto_probs

    initial_choice = torch.argmax(topk_probs, dim=-1)
    refined_choice = torch.argmax(final_probs, dim=-1)
    refined_coords = torch.gather(
        best_coords, 1, refined_choice[:, None, None].expand(-1, 1, 2)
    )[:, 0, :]

    dist = haversine(initial_lnglat, refined_coords)
    too_far = dist > max_refinement_km
    final_choice = torch.where(too_far, initial_choice, refined_choice)
    final_coords = torch.where(too_far[:, None], initial_lnglat,
                               refined_coords)
    final_cell = torch.gather(topk_ids, 1, final_choice[:, None])[:, 0]
    return final_coords, final_cell, final_choice != initial_choice


class ProtoRefiner:
    """Pairs a PrototypeBank, held on ``device``, with ``refine``."""

    def __init__(self, bank: PrototypeBank, topk: int = DEFAULT_TOPK,
                 max_refinement: float = DEFAULT_MAX_REFINEMENT_KM,
                 temperature: float = DEFAULT_TEMPERATURE, device=None):
        self.device = C.resolve_device(device)
        self.topk = topk
        self.max_refinement = float(max_refinement)
        self.temperature = float(temperature)
        self._emb = torch.as_tensor(bank.embeddings, device=self.device)
        self._coords = torch.as_tensor(bank.coords, device=self.device)
        self._mask = torch.as_tensor(bank.mask, device=self.device)

    @torch.inference_mode()
    def __call__(self, query_emb, topk_ids, topk_probs, initial_lnglat):
        dev = self.device
        coords, cells, changed = refine(
            self._emb, self._coords, self._mask,
            torch.as_tensor(query_emb, dtype=torch.float32, device=dev),
            torch.as_tensor(topk_ids, dtype=torch.int64, device=dev)[:, : self.topk],
            torch.as_tensor(topk_probs, dtype=torch.float32, device=dev)[:, : self.topk],
            torch.as_tensor(initial_lnglat, dtype=torch.float32, device=dev),
            temperature=self.temperature,
            max_refinement_km=self.max_refinement,
        )
        return coords.cpu().numpy(), cells.cpu().numpy(), changed.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _default_refiner(bank_path: str, device: str) -> ProtoRefiner:
    return ProtoRefiner(PrototypeBank.load(bank_path), device=device)


def try_refine(result, device=None) -> Optional[Tuple[float, float]]:
    """Refines one InferenceResult with the repo's default bank
    (``GEOCELL_DIR/prototype_bank.npz``).  Returns (lat, lon), or None
    when there is no bank."""
    bank_path = os.path.join(C.GEOCELL_DIR, "prototype_bank.npz")
    if not os.path.exists(bank_path):
        return None
    if os.path.exists(os.path.join(C.GEOCELL_DIR,
                                   "prototype_member_bank.npz")):
        raise NotImplementedError(
            "member-bank refinement is not ported yet; remove "
            "prototype_member_bank.npz to refine with prototypes only")
    refiner = _default_refiner(bank_path, str(C.resolve_device(device)))
    emb = result.embedding
    if emb.ndim == 2:  # (V, D) views -> fused
        emb = emb.mean(axis=0)
    coords, _, _ = refiner(
        emb[None],
        np.asarray(result.top_ids)[None],
        np.asarray(result.top_probs)[None],
        np.array([[result.lon, result.lat]], np.float32),
    )
    return float(coords[0, 1]), float(coords[0, 0])

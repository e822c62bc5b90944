"""ProtoRefiner: prototype-based guess refinement, vectorised over the
batch (counterpart of geoguessr_ai_tpu/models/proto_refiner.py).

  bank.embeddings: (num_cells, P, D)  per-cell cluster prototypes, padded
  bank.coords:     (num_cells, P, 2)  (lng, lat) per prototype
  bank.mask:       (num_cells, P)     1 for real prototypes

An optional MemberBank adds a second stage: each candidate's guess moves
to the closest stored member image of its best-matching prototype.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import functools
import math
import os
from typing import Dict, Iterable, Optional, Tuple

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


@dataclasses.dataclass
class MemberBank:
    """Fixed-shape per-(cell, prototype) member store: up to M member
    embeddings a prototype, padded, optionally reduced to Dr dims by an
    orthonormal projection (``make_projection``)."""

    embeddings: np.ndarray  # (num_cells, P, M, Dr) float16/32
    coords: np.ndarray  # (num_cells, P, M, 2) float32 (lng, lat)
    mask: np.ndarray  # (num_cells, P, M) float32
    projection: Optional[np.ndarray] = None  # (D, Dr) or None (Dr == D)

    def save(self, path: str) -> None:
        arrs = dict(embeddings=self.embeddings, coords=self.coords,
                    mask=self.mask)
        if self.projection is not None:
            arrs["projection"] = self.projection
        np.savez_compressed(path, **arrs)

    @staticmethod
    def load(path: str) -> "MemberBank":
        with np.load(path) as z:
            return MemberBank(
                embeddings=z["embeddings"], coords=z["coords"],
                mask=z["mask"],
                projection=z["projection"] if "projection" in z else None)


def make_projection(embed_dim: int, reduce_dim: int,
                    seed: int = 0) -> Optional[np.ndarray]:
    """Seeded Gaussian (D, Dr) projection with orthonormal columns (the QR
    of numpy's ``default_rng(seed)`` normals), or None when Dr >= D."""
    if reduce_dim >= embed_dim:
        return None
    g = np.random.default_rng(seed).normal(size=(embed_dim, reduce_dim))
    q, _ = np.linalg.qr(g)
    return np.ascontiguousarray(q, np.float32)


def build_prototype_bank(
    proto_rows: Iterable,
    embeddings_by_index: Dict[int, np.ndarray],
    coords_by_index: Dict[int, Tuple[float, float]],
    num_cells: int,
    embed_dim: int,
    max_protos: int = 8,
) -> PrototypeBank:
    """The bank from cluster rows and an embedding lookup.

    proto_rows: records (dicts or objects with attributes) with
      ``geocell_index``, ``count``, ``indices`` (a list, or its string
      form), ``centroid_lat`` and ``centroid_lng``.
    embeddings_by_index: dataset row index -> (D,) embedding.
    coords_by_index: dataset row index -> (lng, lat).

    Each row is one prototype: the mean embedding of its member images and
    the mean of their coordinates (the cluster centroid when none has
    any).  A cell keeps its ``max_protos`` largest clusters."""
    emb = np.zeros((num_cells, max_protos, embed_dim), np.float32)
    coords = np.zeros((num_cells, max_protos, 2), np.float32)
    mask = np.zeros((num_cells, max_protos), np.float32)

    by_cell = collections.defaultdict(list)
    for r in proto_rows:
        get = r.get if isinstance(r, dict) else functools.partial(getattr, r)
        by_cell[int(get("geocell_index"))].append(get)
    for cell_idx in sorted(by_cell):
        rows = sorted(by_cell[cell_idx],
                      key=lambda g: -int(g("count")))[:max_protos]
        for p, get in enumerate(rows):
            idxs = get("indices")
            if isinstance(idxs, str):
                idxs = ast.literal_eval(idxs)
            members = [embeddings_by_index[i] for i in idxs
                       if i in embeddings_by_index]
            member_coords = [coords_by_index[i] for i in idxs
                             if i in coords_by_index]
            if members:
                emb[cell_idx, p] = np.mean(members, axis=0)
                mask[cell_idx, p] = 1.0
            if member_coords:
                coords[cell_idx, p] = np.mean(member_coords, axis=0)
            else:
                coords[cell_idx, p] = (float(get("centroid_lng")),
                                       float(get("centroid_lat")))
    return PrototypeBank(embeddings=emb, coords=coords, mask=mask)


def project_f32(q: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """q @ projection as exact f32 products summed in f32: a broadcast
    multiply and a sum, which no TF32 setting of the matmul reaches (a
    TF32 product could flip the argmin over near members)."""
    return (q[:, :, None] * projection[None]).sum(dim=1)


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
    member_emb: Optional[torch.Tensor] = None,  # (num_cells, P, M, Dr)
    member_coords: Optional[torch.Tensor] = None,  # (num_cells, P, M, 2)
    member_mask: Optional[torch.Tensor] = None,  # (num_cells, P, M)
    projection: Optional[torch.Tensor] = None,  # (D, Dr)
):
    """Returns (refined_lnglat (B, 2), refined_cell (B,), changed (B,)).

    With a member bank, each candidate's coordinates become those of the
    closest member (in f32, members of float16 banks cast after the
    gather; masked members at distance inf; ties to the first index) of
    its best prototype, where that prototype has members, before the
    candidate choice and the max-refinement gate."""
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

    if member_emb is not None:
        q = query_emb if projection is None else project_f32(query_emb,
                                                             projection)
        # the best prototype's members of each candidate cell
        members = member_emb[topk_ids, best_p]  # (B, K, M, Dr)
        m_coords = member_coords[topk_ids, best_p]  # (B, K, M, 2)
        m_mask = member_mask[topk_ids, best_p]  # (B, K, M)
        mdiff = members.float() - q[:, None, None, :]
        md2 = (mdiff * mdiff).sum(dim=-1)  # (B, K, M)
        md2 = torch.where(m_mask > 0, md2, torch.full_like(md2, math.inf))
        best_m = torch.argmin(md2, dim=-1)  # (B, K)
        m_best = torch.gather(
            m_coords, 2, best_m[..., None, None].expand(-1, -1, 1, 2)
        )[:, :, 0, :]  # (B, K, 2)
        has_member = (m_mask > 0).any(dim=-1)
        # clusters without stored members keep the prototype's coordinates
        best_coords = torch.where(has_member[..., None], m_best, best_coords)

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
    """Pairs a PrototypeBank (and optionally a MemberBank), held on
    ``device``, with ``refine``."""

    def __init__(self, bank: PrototypeBank, topk: int = DEFAULT_TOPK,
                 max_refinement: float = DEFAULT_MAX_REFINEMENT_KM,
                 temperature: float = DEFAULT_TEMPERATURE,
                 member_bank: Optional[MemberBank] = None, device=None):
        self.device = C.resolve_device(device)
        self.bank = bank
        self.member_bank = member_bank
        self.topk = topk
        self.max_refinement = float(max_refinement)
        self.temperature = float(temperature)
        self._emb = torch.as_tensor(bank.embeddings, device=self.device)
        self._coords = torch.as_tensor(bank.coords, device=self.device)
        self._mask = torch.as_tensor(bank.mask, device=self.device)
        self._members = {}
        if member_bank is not None:
            mb = member_bank
            self._members = dict(
                member_emb=torch.as_tensor(mb.embeddings, device=self.device),
                member_coords=torch.as_tensor(mb.coords, device=self.device),
                member_mask=torch.as_tensor(mb.mask, device=self.device),
                projection=(None if mb.projection is None else
                            torch.as_tensor(mb.projection,
                                            dtype=torch.float32,
                                            device=self.device)))

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
            **self._members,
        )
        return coords.cpu().numpy(), cells.cpu().numpy(), changed.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _default_refiner(bank_path: str, member_path: Optional[str],
                     device: str) -> ProtoRefiner:
    members = None if member_path is None else MemberBank.load(member_path)
    return ProtoRefiner(PrototypeBank.load(bank_path), member_bank=members,
                        device=device)


def try_refine(result, device=None) -> Optional[Tuple[float, float]]:
    """Refines one InferenceResult with the repo's default bank
    (``GEOCELL_DIR/prototype_bank.npz``, and its members from
    ``prototype_member_bank.npz`` when that file exists).  Returns
    (lat, lon), or None when there is no bank."""
    bank_path = os.path.join(C.GEOCELL_DIR, "prototype_bank.npz")
    if not os.path.exists(bank_path):
        return None
    member_path = os.path.join(C.GEOCELL_DIR, "prototype_member_bank.npz")
    refiner = _default_refiner(
        bank_path, member_path if os.path.exists(member_path) else None,
        str(C.resolve_device(device)))
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

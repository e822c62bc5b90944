"""Build the ProtoRefiner prototype bank (and optionally the member bank)
from an embedding SQLite and the finished geocells (the port of
tools/build_prototype_bank.py).

    python -m geoguessr_ai_torch.tools.build_prototype_bank \
        --embeddings emb.sqlite \
        [--geocell-dir data/geocells/finished_geocells] \
        [--out data/geocells/prototype_bank.npz] [--max-protos 8] \
        [--max-members 16 --reduce-dim 64]

Each location's heading embeddings are mean-fused first (the panorama
embedding the refiner receives), keyed by its coordinates rounded to
``coord_decimals`` with numpy's rounding, as the JAX tool's pandas
``Series.round``; the groups come in sorted key order, each group's rows
in table order, as pandas' ``groupby`` gives them.  Cluster membership is
joined by coordinates through the manager's point index, whose keys are
rounded with Python's ``round``, as the JAX tool rounds them.  Runs on the
host alone.
"""

from __future__ import annotations

import argparse
import math
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.data.sqlite_dataset import read_embeddings
from geoguessr_ai_torch.geocells.manager import GeocellManager
from geoguessr_ai_torch.models.proto_refiner import (
    MemberBank,
    PrototypeBank,
    make_projection,
)


def _fused_by_location(emb_rows, coord_decimals: int
                       ) -> Dict[Tuple[float, float], np.ndarray]:
    """(rounded lat, rounded lon) -> the mean of that location's
    embeddings, in sorted key order; rows with a NaN coordinate drop, as
    in a pandas groupby."""
    groups: Dict[Tuple[float, float], list] = {}
    for r in emb_rows:
        key = (float(np.round(r.lat, coord_decimals)),
               float(np.round(r.lon, coord_decimals)))
        if math.isnan(key[0]) or math.isnan(key[1]):
            continue
        groups.setdefault(key, []).append(r.embedding)
    return {key: np.mean(np.stack(groups[key]), axis=0)
            for key in sorted(groups)}


def _members(mgr: GeocellManager, fused, coord_decimals: int):
    """(cell index, cluster id) -> [(fused embedding, (lng, lat))], over
    the manager's points in its index order."""
    members: dict = defaultdict(list)
    for (lat, lng), rec in mgr.point_info.items():
        key = (round(lat, coord_decimals), round(lng, coord_decimals))
        emb = fused.get(key)
        if emb is not None:
            members[(rec.geocell_index, rec.cluster_id)].append(
                (emb, (lng, lat))
            )
    per_cell: dict = defaultdict(list)
    for (cell_idx, _), items in members.items():
        per_cell[cell_idx].append(items)
    return per_cell


def build_bank_from_manager(
    mgr: GeocellManager,
    emb_rows,
    max_protos: int = 8,
    coord_decimals: int = 6,
) -> PrototypeBank:
    """The (num_cells, max_protos) prototype bank: per cell its largest
    clusters (by joined locations), each the mean of its members' fused
    embeddings and of their (lng, lat).  ``emb_rows``: ``read_embeddings``
    rows (``lat``, ``lon``, ``embedding``)."""
    fused = _fused_by_location(emb_rows, coord_decimals)
    embed_dim = len(next(iter(fused.values())))
    num_cells = mgr.num_cells
    bank_emb = np.zeros((num_cells, max_protos, embed_dim), np.float32)
    bank_coords = np.zeros((num_cells, max_protos, 2), np.float32)
    bank_mask = np.zeros((num_cells, max_protos), np.float32)
    for cell_idx, clusters in _members(mgr, fused, coord_decimals).items():
        clusters.sort(key=len, reverse=True)
        for p, items in enumerate(clusters[:max_protos]):
            embs = np.stack([e for e, _ in items])
            coords = np.array([c for _, c in items], np.float64)
            bank_emb[cell_idx, p] = embs.mean(axis=0)
            bank_coords[cell_idx, p] = coords.mean(axis=0)
            bank_mask[cell_idx, p] = 1.0
    return PrototypeBank(
        embeddings=bank_emb, coords=bank_coords, mask=bank_mask
    )


def build_member_bank_from_manager(
    mgr: GeocellManager,
    emb_rows,
    max_protos: int = 8,
    max_members: int = 16,
    reduce_dim: int = 64,
    coord_decimals: int = 6,
    seed: int = 0,
) -> MemberBank:
    """The member bank for within-cluster refinement: prototype slot p
    holds the cluster of ``build_bank_from_manager``'s slot p; of its
    members the ``max_members`` closest to the cluster mean are kept,
    reduced by ``make_projection`` and stored as float16."""
    fused = _fused_by_location(emb_rows, coord_decimals)
    embed_dim = len(next(iter(fused.values())))
    proj = make_projection(embed_dim, reduce_dim, seed=seed)
    dr = embed_dim if proj is None else proj.shape[1]
    num_cells = mgr.num_cells
    m_emb = np.zeros((num_cells, max_protos, max_members, dr), np.float16)
    m_coords = np.zeros((num_cells, max_protos, max_members, 2), np.float32)
    m_mask = np.zeros((num_cells, max_protos, max_members), np.float32)
    for cell_idx, clusters in _members(mgr, fused, coord_decimals).items():
        clusters.sort(key=len, reverse=True)
        for p, items in enumerate(clusters[:max_protos]):
            embs = np.stack([e for e, _ in items])
            mean = embs.mean(axis=0)
            order = np.argsort(((embs - mean) ** 2).sum(axis=1))
            for m, i in enumerate(order[:max_members]):
                e = embs[i] if proj is None else embs[i] @ proj
                m_emb[cell_idx, p, m] = e.astype(np.float16)
                m_coords[cell_idx, p, m] = items[int(i)][1]
                m_mask[cell_idx, p, m] = 1.0
    return MemberBank(
        embeddings=m_emb, coords=m_coords, mask=m_mask, projection=proj
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--embeddings", required=True, help="embedding sqlite")
    ap.add_argument(
        "--geocell-dir",
        default=f"{C.GEOCELL_DIR}/finished_geocells",
        help="directory of finished geocell pickles",
    )
    ap.add_argument("--out", default=f"{C.GEOCELL_DIR}/prototype_bank.npz")
    ap.add_argument("--max-protos", type=int, default=8)
    ap.add_argument(
        "--max-members",
        type=int,
        default=0,
        help="if >0, also build the member bank for within-cluster "
        "refinement (prototype_member_bank.npz next to --out)",
    )
    ap.add_argument("--reduce-dim", type=int, default=64)
    args = ap.parse_args(argv)

    mgr = GeocellManager(args.geocell_dir)
    emb_rows = read_embeddings(args.embeddings)
    bank = build_bank_from_manager(mgr, emb_rows, max_protos=args.max_protos)
    bank.save(args.out)
    filled = int((bank.mask.sum(axis=1) > 0).sum())
    print(
        f"bank: {bank.embeddings.shape[0]} cells x {bank.embeddings.shape[1]}"
        f" protos (dim {bank.embeddings.shape[-1]}); {filled} cells "
        f"populated -> {args.out}"
    )
    if args.max_members > 0:
        mbank = build_member_bank_from_manager(
            mgr,
            emb_rows,
            max_protos=args.max_protos,
            max_members=args.max_members,
            reduce_dim=args.reduce_dim,
        )
        mout = os.path.join(
            os.path.dirname(args.out) or ".", "prototype_member_bank.npz"
        )
        mbank.save(mout)
        proj = None if mbank.projection is None else mbank.projection.shape
        print(f"member bank: {mbank.embeddings.shape} (proj {proj}) -> "
              f"{mout}")


if __name__ == "__main__":
    main()

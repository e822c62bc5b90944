"""Build the vendored CLIP BPE assets (data/clip_bpe/vocab.json +
merges.txt) by learning merges from the caption synthesizer's own corpus
(the port of tools/build_clip_bpe.py: the same corpus, merges and files).

No OpenAI CLIP vocabulary ships with the repo; these assets are
structurally identical files (OpenAI token ordering: 256 byte tokens,
256 ``</w>`` variants, merge products, 2 specials) learned from the text
distribution the pretrain loop actually tokenizes — country/admin names
from the centroid table, Köppen climate descriptions, months, and the
caption templates (reference pretrain_idun.py:71-174).  Drop a real
OpenAI vocab.json/merges.txt pair into the same directory (or point
CLIP_BPE_DIR at one) for real-CLIP-checkpoint interop.

Usage: python -m geoguessr_ai_torch.tools.build_clip_bpe [--num-merges 4096]
       [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence

import numpy as np

from geoguessr_ai_torch.config import REPO_ROOT
from geoguessr_ai_torch.train.captions import (
    CLIMATE_DICT,
    MONTHS,
    select_caption,
)
from geoguessr_ai_torch.train.clip_bpe import learn_bpe, write_assets


def build_corpus(seed: int = 0) -> list:
    rng = random.Random(seed)
    corpus = []

    table = os.path.join(REPO_ROOT, "data", "geocells", "centroid_table.npz")
    countries, regions = [], []
    if os.path.exists(table):
        d = np.load(table, allow_pickle=True)
        countries = sorted({str(c) for c in d["country"] if str(c)})
        regions = sorted({str(a) for a in d["admin1"] if str(a)})

    climates = list(CLIMATE_DICT.values())
    months = list(MONTHS.values())

    # every caption template realization, several randomizations each
    for _ in range(6):
        for country in countries or ["Norway", "Japan", "Brazil"]:
            sample = {
                "country": country,
                "region": rng.choice(regions) if regions else None,
                "climate_zone": rng.choice(climates),
                "drive_right": rng.random() > 0.3,
                "month": rng.choice(months),
                "lat": rng.uniform(-60, 70),
                "lon": rng.uniform(-180, 180),
            }
            corpus.append(select_caption(sample, rng))
    # coordinate-only and bare templates
    for _ in range(200):
        corpus.append(
            select_caption(
                {
                    "lat": rng.uniform(-60, 70),
                    "lon": rng.uniform(-180, 180),
                },
                rng,
            )
        )
    corpus.append("A Street View photo.")
    # raw vocab source strings so rare climate/month words always appear
    corpus.extend(climates * 3)
    corpus.extend(months * 3)
    corpus.extend(regions)
    return corpus


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-merges", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(REPO_ROOT, "data",
                                                  "clip_bpe"))
    args = ap.parse_args(argv)
    corpus = build_corpus()
    print(f"corpus: {len(corpus)} texts")
    vocab, merges = learn_bpe(corpus, num_merges=args.num_merges)
    write_assets(vocab, merges, args.out)
    print(
        f"wrote {args.out}: vocab={len(vocab)} tokens, "
        f"merges={len(merges)}"
    )


if __name__ == "__main__":
    main()

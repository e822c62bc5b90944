#!/usr/bin/env python3
"""Geocell generation over ``chip_smoke.py``'s phase 35 world on the card
and on the host's CPU: each step's wall time, run card, CPU, card (the
first card run pays CUDA's start-up), and whether every run gives the same
cells and clusters.  The world is seeded from ``data/geocells/proto_df.csv``
(``chip_smoke._gen_world``).

    python3 scripts/geocell_gen_check.py [--cpu]

Prints the card's name and power limit, one line a run, then a JSON object
of the runs.  Needs a GPU; ``--cpu`` makes the one CPU run alone, without
one (the cell count and ordering steps a card run must equal).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.geocells.generate import GenerateGeocells  # noqa
from geoguessr_ai_torch.geocells.optics import _buckets  # noqa: E402


def _cells(gen):
    """Every cell's country, admin1 and clusters (id, size, centroid), in
    order: equal lists mean the same cells and clusters."""
    return [(c.country, c.admin_1, [(k, len(v["points"]), v["centroid"])
                                    for k, v in sorted(c.clusters.items())])
            for cells in gen.cells.values() for c in cells]


def _run(admin, points, device):
    gen = GenerateGeocells(admin, points, device=device)
    secs, steps = {}, None
    for step in cs.GEN_STEPS:
        if step == "cluster_cells":
            sizes = [len(c) for cells in gen.cells.values() for c in cells
                     if len(c) > 5]
            steps = sum(max(sizes[i] for i in b) for b in _buckets(sizes, 5))
        t = time.perf_counter()
        getattr(gen, step)()
        if device == "cuda":
            torch.cuda.synchronize()
        secs[step] = round(time.perf_counter() - t, 3)
    return secs, steps, _cells(gen)


def main():
    cpu_only = "--cpu" in sys.argv[1:]
    card = "none" if cpu_only else cs.phase_device()
    t = time.perf_counter()
    admin, points, big, n_proto = cs._gen_world(np.random.default_rng(
        cs.SEED))
    cs.log(f"world: {n_proto} proto cells, {len(admin)} countries, "
           f"{sum(map(len, admin.values()))} admin1 boxes, "
           f"{sum(map(len, points.values()))} points in "
           f"{time.perf_counter() - t:.2f} s; host threads "
           f"{torch.get_num_threads()}")
    runs, first = [], None
    for device in ("cpu",) if cpu_only else ("cuda", "cpu", "cuda"):
        secs, steps, cells = _run(admin, points, device)
        first = cells if first is None else first
        same = cells == first
        runs.append({"device": device, "secs": secs,
                     "total_s": round(sum(secs.values()), 3),
                     "cells": len(cells), "same_as_first": same,
                     "cluster_steps": steps,
                     "us_per_step": round(1e6 * secs["cluster_cells"]
                                          / steps, 1)})
        cs.log(f"{device}: {len(cells)} cells in {runs[-1]['total_s']} s "
               f"{secs}; cluster_cells {steps} ordering steps (the buckets' "
               f"largest sets), {runs[-1]['us_per_step']} us a step; same "
               f"cells as the first run: {same}")
        if not same:
            cs.fail(f"{device} gave other cells than the first run")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()

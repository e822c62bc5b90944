"""Build the geocell centroid table and the proto rows from finished
geocell pickles (the port of tools/build_centroid_table.py).

    python -m geoguessr_ai_torch.tools.build_centroid_table \
        --geocell-dir <dir-of-pickles> \
        [--out-npz data/geocells/centroid_table.npz] \
        [--out-csv data/geocells/proto_df.csv]

The .npz is the only geocell artifact the model loads to train or serve
(``geocells.manager.CentroidTable.load``).  Runs on the host alone.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from geoguessr_ai_torch.geocells.manager import GeocellManager


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geocell-dir", required=True)
    ap.add_argument("--out-npz", default="data/geocells/centroid_table.npz")
    ap.add_argument("--out-csv", default="data/geocells/proto_df.csv")
    args = ap.parse_args(argv)

    mgr = GeocellManager(args.geocell_dir)
    print(f"Loaded {mgr.num_cells} geocells, {len(mgr.point_info)} points")
    tab = mgr.build_centroid_table()
    tab.save(args.out_npz)
    print(f"Wrote centroid table {tab.centroids.shape} -> {args.out_npz}")
    rows = mgr.generate_proto_df(args.out_csv)
    print(f"Wrote proto_df ({len(rows)} cluster rows) -> {args.out_csv}")


if __name__ == "__main__":
    main()

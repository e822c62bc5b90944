"""Upload a model checkpoint to the object store's registry (the port of
tools/upload_checkpoint.py).

    python -m geoguessr_ai_torch.tools.upload_checkpoint PATH [--store-url URL]

PATH is a checkpoint file or directory, e.g. a run's ``best`` written by
``train()``.  The store is ``--store-url``, else ``GEO_TPU_STORE_URL``,
else the S3 bucket.  Prints the registry prefix it wrote
(``v1/saved_models/run_ts=<ts>``); ``run_benchmark
--clip-checkpoint-index 0`` serves it back.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from geoguessr_ai_torch.data.s3 import ObjectStore


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="checkpoint file or directory")
    ap.add_argument("--store-url", default=None)
    args = ap.parse_args(argv)
    print(ObjectStore(args.store_url).upload_model_checkpoint(args.path))


if __name__ == "__main__":
    main()

"""Two-rank dry run of the multi-card plumbing on the CPU (counterpart of
the repo's tools/multihost_dryrun.py).

Starts two gloo ranks (``parallel.mesh.spawn_ranks``, a ``file://``
rendezvous in a temporary directory) and checks on both what one process cannot: the
process group forms, ``host_shard_range`` gives contiguous, disjoint
ranges that cover the rows, a padded gather of ragged shards
(``Mesh.gather_rows``) recovers every row with its rank's values, and a
dp=2 ``train_step`` of a small TinyViT SuperGuessr (f32, BatchNorm in train
mode) equals the one-process step on the global batch.

    python -m geoguessr_ai_torch.tools.multihost_dryrun

prints ``MULTIHOST DRYRUN OK`` and exits 0 when every check passed on
both ranks.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

ROWS = 103


def _step(mesh):
    """One train_step on a seeded global batch of 4 (this rank's rows on
    ``mesh``): (loss, the whole parameters after it)."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.models.super_guessr import (
        SuperGuessr,
        init_parameters_,
    )
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
    from geoguessr_ai_torch.parallel.mesh import batch_slice, shard_module_
    from geoguessr_ai_torch.train.state import create_train_state
    from geoguessr_ai_torch.train.steps import train_step

    cfg = TinyViTConfig.test_tiny(dtype=torch.float32)
    model = SuperGuessr(16, TinyViT(cfg), embed_dim=cfg.embed_dim)
    init_parameters_(model, 0)
    if mesh is not None:
        shard_module_(model, mesh)
    state = create_train_state(model, OptimizerConfig(learning_rate=1e-3), 10,
                               mesh=mesh)
    rng = np.random.default_rng(0)
    shift = np.arange(4, dtype=np.float32)[:, None, None, None, None]
    batch = {"pixel_values": torch.from_numpy(
        rng.normal(0, 1, (4, 4, 64, 64, 3)).astype(np.float32) + shift),
        "coords": torch.from_numpy(
            rng.uniform(-60, 60, (4, 2)).astype(np.float32))}
    cells = torch.from_numpy(rng.uniform(-60, 60, (16, 2)).astype(np.float32))
    state, metrics = train_step(state, batch_slice(batch, mesh), cells,
                                mesh=mesh)
    return float(metrics["loss"]), state.state_dict()["model"]


def worker() -> None:
    """One rank's checks; raises AssertionError on the first that fails."""
    import torch.distributed as dist

    from geoguessr_ai_torch.config import MeshConfig
    from geoguessr_ai_torch.parallel.mesh import create_mesh, host_shard_range

    torch.set_num_threads(2)
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2, world
    mesh = create_mesh(MeshConfig(), device="cpu")
    assert (mesh.dp, mesh.mp, mesh.data_index) == (2, 1, rank), mesh

    # 1) host shard ranges: contiguous, disjoint, covering
    lo, hi = host_shard_range(ROWS)
    ranges = mesh.gather_rows(torch.tensor([[lo, hi]], dtype=torch.float32))
    ranges = ranges.long().tolist()
    assert ranges[0][0] == 0 and ranges[-1][1] == ROWS, ranges
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), ranges

    # 2) ragged shards padded for the collective, with their true counts
    local = torch.full((hi - lo, 8), float(rank + 1))
    rows = mesh.gather_rows(local)
    assert rows.shape == (ROWS, 8), rows.shape
    for r, (a, b) in enumerate(ranges):
        assert torch.all(rows[a:b] == r + 1), r

    # 3) a dp=2 train step equals one process's on the global batch
    loss, params = _step(mesh)
    want_loss, want = _step(None)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    for name, t in want.items():
        # Adam's first step is about lr * sign(g): a near-zero gradient's
        # sum in another order can flip it, moving the update by 2 lr
        assert torch.allclose(params[name], t, rtol=1e-4, atol=2.5e-3), name
    print(f"[rank {rank}] all multi-host checks passed", flush=True)


def main() -> None:
    from geoguessr_ai_torch.parallel.mesh import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(worker, 2, f"file://{os.path.join(tmp, 'rendezvous')}",
                    timeout=300)
    print("MULTIHOST DRYRUN OK (2 gloo ranks)")


if __name__ == "__main__":
    main()

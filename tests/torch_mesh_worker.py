"""The rank side of tests/test_torch_port_mesh.py.

Each scenario is a function of a ``parallel.mesh.Mesh`` (None: one
process) over inputs made here from numpy seeds, so that the test's
one-process references and the JAX references read the same inputs.
``main(OUT)`` runs every scenario on the ranks of a gloo process group
(started by ``parallel.mesh.spawn_ranks``) and writes each rank's results
to ``OUT/rank<r>.pt``.  It imports
torch and the port only.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
NUM_CELLS = 32
#: the global batch of the step scenarios; rows differ in mean and scale,
#: so that any two shards of it have different batch statistics
B = 8
LEARNING_RATE = 1e-3
#: (data_parallel, model_parallel, grad_accum_steps, what) of the
#: train_step scenarios
STEPS = {
    "dp": (2, 1, 1, {}),
    "dp_accum": (2, 1, 2, {}),
    "dp_qat": (2, 1, 1, {"qat": True}),
    "dp_drop_path": (2, 1, 1, {"drop_path_rate": 0.3}),
    "dp_per_rank_bn": (2, 1, 1, {"per_rank_bn": True}),
    "mp": (1, 2, 1, {}),
    # 31 cells over two ranks: shards of 16, the last padded
    "mp_odd_cells": (1, 2, 1, {"num_cells": 31}),
}
#: evaluate_model's batch: 3 rows on 2 data ranks are shards of 2 and 1
EVAL_BATCH = 3
EMBED_ROWS = 11
EMBED_BATCH = 4


#: test_tiny with one block a stage (the JAX references trace faster)
DEPTHS = (1, 1, 1, 1)


def tiny_config(**fields):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig

    return dataclasses.replace(TinyViTConfig.test_tiny(dtype=torch.float32),
                               depths=DEPTHS, **fields)


def make_model(qat=False, drop_path_rate=0.0, num_cells=NUM_CELLS):
    """The test_tiny SuperGuessr (f32) with seeded weights; ``qat``: int8
    storage at TRAIN_QUANT_SITES, calibrated as ``train()`` calibrates."""
    from geoguessr_ai_torch.models.super_guessr import (
        SuperGuessr,
        init_parameters_,
    )
    from geoguessr_ai_torch.models.tinyvit import TRAIN_QUANT_SITES, TinyViT
    from geoguessr_ai_torch.train.coordinator import calibrate_qat_

    fields = {"drop_path_rate": drop_path_rate}
    if qat:
        fields.update(quant_mode="static", quant_sites=TRAIN_QUANT_SITES)
    cfg = tiny_config(**fields)
    model = SuperGuessr(num_cells, TinyViT(cfg), embed_dim=cfg.embed_dim)
    init_parameters_(model, 0)
    if qat:
        calibrate_qat_(model, 0, cfg.image_size)
    return model


def step_inputs(num_cells=NUM_CELLS):
    """(global batch of B panoramas, centroids) as numpy."""
    rng = np.random.default_rng(1)
    shift = np.linspace(-1.0, 2.0, B)[:, None, None, None, None]
    scale = np.linspace(0.5, 2.5, B)[:, None, None, None, None]
    x = rng.normal(0, 1, (B, 4, 64, 64, 3)) * scale + shift
    coords = rng.uniform(-60, 60, (B, 2))
    cells = np.random.default_rng(0).uniform(-60, 60, (num_cells, 2))
    return ({"pixel_values": x.astype(np.float32),
             "coords": coords.astype(np.float32)}, cells.astype(np.float32))


def _bn_stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def run_step(kind, mesh=None):
    """One train_step of scenario ``kind`` on ``mesh``: metrics, the whole
    state dict after it, BatchNorm's running statistics, the cell layer's
    local weight shape."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.models.tinyvit import _BN
    from geoguessr_ai_torch.parallel.mesh import batch_slice, shard_module_
    from geoguessr_ai_torch.train.state import create_train_state
    from geoguessr_ai_torch.train.steps import train_step

    _, _, k, what = STEPS[kind]
    num_cells = what.get("num_cells", NUM_CELLS)
    model = make_model(what.get("qat", False),
                       what.get("drop_path_rate", 0.0), num_cells)
    if mesh is not None:
        shard_module_(model, mesh)
        if what.get("per_rank_bn"):
            for m in model.modules():
                if isinstance(m, _BN):
                    m.mesh = None
    state = create_train_state(
        model, OptimizerConfig(learning_rate=LEARNING_RATE), 10, mesh=mesh)
    batch, cells = step_inputs(num_cells)
    batch = batch_slice({n: torch.from_numpy(v) for n, v in batch.items()},
                        mesh, k)
    state, metrics = train_step(state, batch, torch.from_numpy(cells),
                                grad_accum_steps=k, mesh=mesh)
    return {"metrics": {n: float(v) for n, v in metrics.items()},
            "state": state.state_dict()["model"],
            "bn": _bn_stats(state.model),
            "cell_layer_local": tuple(model.cell_layer.weight.shape)}


def run_mp_restore(mesh, directory):
    """A model-axis state saved (rank 0 writes) and restored into a fresh
    model-axis state: (the restored cell layer's local shape, whether every
    local tensor equals the saved state's)."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.parallel.mesh import shard_module_
    from geoguessr_ai_torch.train.checkpoints import (
        CheckpointConfig,
        CheckpointStore,
    )
    from geoguessr_ai_torch.train.state import create_train_state
    from geoguessr_ai_torch.train.steps import train_step

    def fresh():
        model = shard_module_(make_model(), mesh)
        return create_train_state(
            model, OptimizerConfig(learning_rate=LEARNING_RATE), 10,
            mesh=mesh)

    state = fresh()
    batch, cells = step_inputs()
    train_step(state, {n: torch.from_numpy(v) for n, v in batch.items()},
               torch.from_numpy(cells), mesh=mesh)
    store = CheckpointStore(CheckpointConfig(directory,
                                             write=mesh.rank == 0))
    store.save_epoch(state, 0, 1.0, None)
    mesh.barrier()  # the write lands before any read
    restored = fresh()
    store.restore(restored, "best")
    want = dict(state.model.state_dict())
    got = dict(restored.model.state_dict())
    moments = all(torch.equal(restored.optimizer.mu[n], state.optimizer.mu[n])
                  for n in state.optimizer.mu)
    return {"local": tuple(restored.model.cell_layer.weight.shape),
            "equal": all(torch.equal(got[n], want[n]) for n in want)
            and moments}


def fixture_records(n):
    with open(os.path.join(FIXTURES, "heading=000.jpg"), "rb") as f:
        blob = f.read()
    rng = np.random.default_rng(0)
    return [{"location_id": f"l{i}", "lat": float(rng.uniform(-50, 50)),
             "lon": float(rng.uniform(-170, 170)),
             "images": [blob] * (4 if i % 3 else 3)} for i in range(n)]


def tiny_table():
    from geoguessr_ai_torch.geocells.manager import CentroidTable

    rng = np.random.default_rng(3)
    return CentroidTable(
        centroids=rng.uniform(-60, 60, (NUM_CELLS, 2)).astype(np.float32),
        country=np.array(["X"] * NUM_CELLS),
        admin1=np.array(["Y"] * NUM_CELLS),
        cell_id=np.array([str(i) for i in range(NUM_CELLS)]))


def run_eval(mesh=None):
    """evaluate_model over 7 fixture records in batches of EVAL_BATCH."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.parallel.mesh import shard_module_
    from geoguessr_ai_torch.train.state import create_train_state
    from geoguessr_ai_torch.train.train_eval_loop import evaluate_model

    model = make_model()
    if mesh is not None:
        shard_module_(model, mesh)
    state = create_train_state(model, OptimizerConfig(), 10, mesh=mesh)
    return evaluate_model(state, fixture_records(7), tiny_table(),
                          batch_size=EVAL_BATCH)


def _train_config(epochs, **fields):
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    bb = BackboneConfig(image_size=64, embed_dim=80, dtype="float32")
    return TrainConfig(batch_size=4, num_epochs=epochs, seed=0,
                       log_every_steps=1, eval_every_steps=0,
                       optimizer=OptimizerConfig(learning_rate=1e-3),
                       model=ModelConfig(backbone=bb), **fields)


def run_train(directory, epochs):
    """train() (its mesh from the process group) for ``epochs`` epochs of
    3 steps of 4 into ``directory``, resuming from its ``last``; returns
    (the summary, the state ``last`` holds)."""
    from geoguessr_ai_torch.train.checkpoints import read_checkpoint
    from geoguessr_ai_torch.train.coordinator import train

    records = fixture_records(16)
    summary = train(_train_config(epochs), records[:12], records[12:],
                    tiny_table(), checkpoint_dir=directory, device="cpu",
                    model_config=tiny_config())
    last = read_checkpoint(os.path.join(directory, "last"))["state"]
    return {k: v for k, v in summary.items() if isinstance(v, (int, float))
            }, last["model"]


#: Seconds rank 0's checkpoint write waits before it starts in
#: ``run_train_slow_write``.
SLOW_WRITE_S = 1.0


def run_train_slow_write(directory):
    """train() for one epoch into ``directory`` with async checkpoints,
    rank 0's write held back SLOW_WRITE_S; returns which of ``last`` and
    ``best`` hold their file when train() has returned on this rank."""
    import time

    from geoguessr_ai_torch.train import checkpoints
    from geoguessr_ai_torch.train.coordinator import train

    save = checkpoints.CheckpointStore._save_tree

    def slow(self, name, tree):
        time.sleep(SLOW_WRITE_S)
        save(self, name, tree)

    checkpoints.CheckpointStore._save_tree = slow
    records = fixture_records(16)
    try:
        train(_train_config(1, async_checkpoints=True), records[:12],
              records[12:], tiny_table(), checkpoint_dir=directory,
              device="cpu", model_config=tiny_config())
    finally:
        checkpoints.CheckpointStore._save_tree = save
    return {d: os.path.exists(os.path.join(directory, d,
                                           checkpoints.STATE_FILE))
            for d in ("last", "best")}


def clip_configs():
    from geoguessr_ai_torch.models.clip_text import CLIPTextConfig
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig

    return (CLIPVisionConfig.test_tiny(dtype=torch.float32),
            CLIPTextConfig.test_tiny(dtype=torch.float32))


def run_pretrain(mesh=None, steps=3):
    """``steps`` pretrain_steps of one global batch of 4 pairs: the losses
    and the trainable parameters after them."""
    from geoguessr_ai_torch.config import PretrainConfig
    from geoguessr_ai_torch.models.clip_text import CLIPModel
    from geoguessr_ai_torch.parallel.mesh import batch_slice
    from geoguessr_ai_torch.train import pretrain_clip as tpc

    vc, tc = clip_configs()
    model = CLIPModel(vc, tc, projection_dim=32)
    tpc.init_clip_model_(model, 0)
    cfg = PretrainConfig(batch_size=4, grad_accum_steps=1,
                         learning_rate=1e-2)
    params = dict(model.named_parameters())
    optimizer, _ = tpc.make_pretrain_optimizer(cfg, 10, params)
    mask = tpc.trainable_mask(params)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, tc.vocab_size - 1, (4, tc.max_length))
    ids[:, -3:] = tc.vocab_size - 1  # the eos id repeats as padding
    batch = batch_slice({
        "pixel_values": torch.from_numpy(rng.normal(
            0, 1, (4, vc.image_size, vc.image_size, 3)).astype(np.float32)),
        "input_ids": torch.from_numpy(ids)}, mesh)
    losses = [float(tpc.pretrain_step(model, optimizer, batch, mask, mesh))
              for _ in range(steps)]
    return {"losses": losses,
            "params": {n: p.detach().clone() for n, p in params.items()
                       if mask[n]}}


def write_embed_source(path):
    """A raw SQLite of EMBED_ROWS fixture images."""
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    blobs = []
    for h in ("000", "090", "180", "270"):
        with open(os.path.join(FIXTURES, f"heading={h}.jpg"), "rb") as f:
            blobs.append(f.read())
    create_sqlite_from_records(path, [
        {"location_id": f"e{i // 4}", "lat": float(i), "lon": float(-i),
         "heading": 90 * (i % 4), "image": blobs[i % 4]}
        for i in range(EMBED_ROWS)])


def run_embed(src, out, mesh=None):
    """build_embedding_sqlite of ``src`` into ``out`` in batches of
    EMBED_BATCH (the test_tiny TinyViT, seeded); returns the rows written."""
    from geoguessr_ai_torch.config import BackboneConfig, EmbedBuildConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
    )

    embedder = Embedder(BackboneConfig.tinyvit(), device="cpu",
                        model_config=tiny_config(), seed=0, mesh=mesh)
    return build_embedding_sqlite(
        src, out, EmbedBuildConfig(quant_mode="none",
                                   batch_size=EMBED_BATCH),
        embedder=embedder)


def run_embedder_call(mesh=None):
    """``Embedder(mesh=...)`` on one batch of 6 seeded images."""
    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import Embedder

    images = np.random.default_rng(7).integers(0, 256, (6, 64, 64, 3),
                                               dtype=np.uint8)
    embedder = Embedder(BackboneConfig.tinyvit(), device="cpu",
                        model_config=tiny_config(), seed=0, mesh=mesh)
    return embedder(images)


def main(out):
    import torch.distributed as dist

    from geoguessr_ai_torch.config import MeshConfig
    from geoguessr_ai_torch.parallel.mesh import create_mesh

    torch.set_num_threads(2)
    rank = dist.get_rank()
    results = {}
    for kind, (dp, mp, _, _) in STEPS.items():
        mesh = create_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                           device="cpu")
        results[kind] = run_step(kind, mesh)
    dp2 = create_mesh(MeshConfig(data_parallel=2), device="cpu")
    mp2 = create_mesh(MeshConfig(data_parallel=1, model_parallel=2),
                      device="cpu")
    results["mp_restore"] = run_mp_restore(mp2, os.path.join(out, "mp_ckpt"))
    results["eval"] = run_eval(dp2)
    results["eval_mp"] = run_eval(mp2)
    results["pretrain"] = run_pretrain(dp2)
    results["embedder_call"] = run_embedder_call(dp2)
    results["embed_written"] = run_embed(
        os.path.join(out, "embed_src.sqlite"),
        os.path.join(out, "embed_dp2.sqlite"), dp2)
    results["train"] = run_train(os.path.join(out, "train_a"), 2)
    results["train_slow_write"] = run_train_slow_write(
        os.path.join(out, "train_b"))
    results["train_resumed"] = run_train(os.path.join(out, "train_b"), 2)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))

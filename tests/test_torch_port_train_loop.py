"""The port's training loop up to the coordinator's surface, held against
the JAX package on the CPU: the checkpoint store's retention and resume,
embedding-only ``train()``, ``train_step`` for hierarchical fusion, a
single-image model and QAT storage, the QAT calibration, the embedding
batches, the native JPEG decoder, the step profiler, serving a store
directory and ``main()``.

Inputs come from numpy with a fixed seed; models run at test_tiny widths
in f32.  Each test states its tolerance.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_torch.models.convert import from_jax_variables, to_jax_variables
from test_torch_port_train import (
    STEP_NORM_ATOL,
    STEP_RTOL,
    _assert_trees_close,
    _leaves,
    _randomise,
    _records,
    _tiny_backbone,
    _tiny_table,
)

NUM_CELLS = 8
D = 80  # test_tiny's embed width; 16 fusion heads of 5


def _cfg_pair(**fields):
    """The same TrainConfig in the JAX package and in the port (the JAX
    one's mesh spans conftest's 8 CPU devices, the port's one device);
    ``fields`` may hold ``backbone``, ``model`` and ``optimizer`` dicts."""
    from geoguessr_ai_tpu import config as JC

    from geoguessr_ai_torch import config as C

    def make(mod):
        f = dict(fields)
        bb = mod.BackboneConfig(**{"image_size": 64, "embed_dim": D,
                                   **f.pop("backbone", {})})
        model = mod.ModelConfig(backbone=bb, **f.pop("model", {}))
        opt = mod.OptimizerConfig(**f.pop("optimizer", {}))
        return mod.TrainConfig(model=model, optimizer=opt, **f)

    return make(JC), make(C)


class _Recorder:
    """A metrics logger for both packages: keeps every logged row."""

    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def summary(self, key, value):
        pass

    def finish(self):
        pass

    def losses(self):
        return [m["train/loss"] for _, m in self.rows if "train/loss" in m]


# ---------------------------------------------------------------------------
# The checkpoint store
# ---------------------------------------------------------------------------

#: (epoch, monitored value) sequences, a NaN epoch among them.
STORE_SEQUENCE = [(0, 4.5), (1, 3.25), (2, float("nan")), (3, 3.75),
                  (4, 2.5), (5, 5.0), (6, 2.75)]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_store_keeps_the_names_the_jax_store_keeps(mode, tmp_path):
    """The same (epoch, metric) sequence into both stores with keep_top_k
    2: after each save the same epoch directories, the same last/best and
    the same returned best (exactly); best's and last's meta hold the same
    epochs."""
    from geoguessr_ai_tpu.train.checkpoints import (
        CheckpointConfig as JaxConfig,
        CheckpointStore as JaxStore,
    )

    from geoguessr_ai_torch.train.checkpoints import (
        CheckpointConfig,
        CheckpointStore,
        read_checkpoint,
    )

    jstore = JaxStore(JaxConfig(str(tmp_path / "jax"), keep_top_k=2,
                                monitored_mode=mode))
    store = CheckpointStore(CheckpointConfig(str(tmp_path / "port"),
                                             keep_top_k=2,
                                             monitored_mode=mode))
    jbest = best = None
    for epoch, value in STORE_SEQUENCE:
        tree = {"w": np.full((3,), epoch, np.float32)}
        jbest = jstore.save_epoch(tree, epoch, value, jbest)
        best = store.save_epoch({"w": torch.from_numpy(tree["w"])}, epoch,
                                value, best)
        assert best == jbest or (np.isnan(best) and np.isnan(jbest))
        assert store.kept_epochs() == jstore.kept_epochs()
        for name in ("last", "best"):
            assert store.has(name) == jstore.has(name), (epoch, name)
    for name in ("last", "best"):
        want = jstore.restore({"w": np.zeros((3,), np.float32)}, name)
        got = read_checkpoint(str(tmp_path / "port" / name))
        assert got["meta"]["epoch"] == int(want[1]["epoch"])
        assert got["meta"]["best_value"] == float(want[1]["best_value"])
        np.testing.assert_array_equal(got["state"]["w"].numpy(),
                                      np.asarray(want[0]["w"]))
    assert len(store.kept_epochs()) == 2


def _tiny_state(seed=0):
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.models.super_guessr import (
        SuperGuessr,
        init_parameters_,
    )
    from geoguessr_ai_torch.train.state import create_train_state

    model = SuperGuessr(NUM_CELLS, None, embed_dim=D, hierarchical=True)
    init_parameters_(model, seed)
    return create_train_state(model, OptimizerConfig(), 4, seed=seed)


def test_async_save_writes_the_sync_files_and_bits(tmp_path):
    """An async store writes the same directories and the same state.pt
    bytes as a sync one, from a copy taken before save_epoch returns (the
    live parameters change right after); an error in the background write
    surfaces at the next store operation."""
    from geoguessr_ai_torch.train.checkpoints import (
        STATE_FILE,
        CheckpointConfig,
        CheckpointStore,
    )

    state = _tiny_state()
    stores = {k: CheckpointStore(CheckpointConfig(
        str(tmp_path / k), keep_top_k=1, async_save=(k == "async")))
        for k in ("sync", "async")}
    best = {k: None for k in stores}
    for epoch, value in [(0, 2.0), (1, 1.5), (2, 1.75)]:
        for k, store in stores.items():
            best[k] = store.save_epoch(state, epoch, value, best[k],
                                       extra={"global_step": 3 * epoch})
        with torch.no_grad():
            state.model.cell_layer.weight.add_(1.0)  # the next step's update
    stores["async"].wait_until_finished()
    assert best["sync"] == best["async"] == 1.5
    names = {k: sorted(os.listdir(tmp_path / k)) for k in stores}
    assert names["sync"] == names["async"] == [
        "best", "epoch_0001_1.500000", "last"]
    for name in names["sync"]:
        a = (tmp_path / "sync" / name / STATE_FILE).read_bytes()
        b = (tmp_path / "async" / name / STATE_FILE).read_bytes()
        assert a == b, name

    bad = CheckpointStore(CheckpointConfig(str(tmp_path / "bad"),
                                           async_save=True))
    bad.save_epoch({"w": lambda: 0}, 0, 1.0, None)  # a lambda: unpicklable
    with pytest.raises(AttributeError, match="local object"):
        bad.kept_epochs()
    bad.wait_until_finished()  # the error was raised once


def test_resume_is_bitwise_an_uninterrupted_run(fixtures_dir, monkeypatch,
                                                tmp_path):
    """3 epochs straight against 2 epochs, then a resume for the third
    from ``last`` (and again through ``resume_path``): every tensor of the
    final state (model, moments, generator), the step losses of the third
    epoch and the kept names are bitwise equal on the CPU.  Mirrors the JAX
    package's test_resume_matches_uninterrupted_training."""
    from geoguessr_ai_torch.train import coordinator
    from geoguessr_ai_torch.train.checkpoints import read_checkpoint

    _tiny_backbone(monkeypatch)
    # hierarchical fusion's dropout draws from the state's generator
    _, cfg = _cfg_pair(seed=0, batch_size=4, num_epochs=3, eval_every_steps=0,
                       log_every_steps=1, keep_last_n=2,
                       model=dict(hierarchical=True),
                       optimizer=dict(learning_rate=1e-3))
    records = _records(fixtures_dir, n=12)
    table = _tiny_table()

    def run(directory, **changes):
        rec = _Recorder()
        coordinator.train(dataclasses.replace(cfg, **changes), records[:8],
                          records[8:], table, checkpoint_dir=directory,
                          metrics_logger=rec, device="cpu")
        return rec.losses()

    straight = run(str(tmp_path / "straight"))
    assert run(str(tmp_path / "resumed"), num_epochs=2) == straight[:4]
    assert run(str(tmp_path / "resumed")) == straight[4:]
    via_path = str(tmp_path / "via_path")
    run(via_path, num_epochs=2)
    assert run(str(tmp_path / "elsewhere"),
               resume_path=os.path.join(via_path, "last")) == straight[4:]
    assert sorted(os.listdir(tmp_path / "straight")) == sorted(
        os.listdir(tmp_path / "resumed"))
    a = read_checkpoint(str(tmp_path / "straight" / "last"))
    for other in ("resumed", "elsewhere"):
        b = read_checkpoint(str(tmp_path / other / "last"))
        assert a["meta"] == b["meta"]
        assert a["meta"]["global_step"] == 6
        _assert_bitwise(a["state"], b["state"], other)


def _assert_bitwise(a, b, where):
    """Two checkpoint trees equal leaf for leaf, tensors bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# Embedding-only training
# ---------------------------------------------------------------------------


def _embedding_records(n, seed=0, views=4):
    """Panorama records of float32 embedding blobs; every fifth has a
    missing view."""
    rng = np.random.default_rng(seed)
    return [{"location_id": f"e{i:03d}", "lat": float(rng.uniform(-50, 50)),
             "lon": float(rng.uniform(-170, 170)),
             "images": [rng.normal(0, 1, D).astype(np.float32).tobytes()
                        for _ in range(views - (i % 5 == 0))]}
            for i in range(n)]


def test_embedding_batches_match_jax():
    """Shuffled, with a short panorama (a zero row, mask 0) and the last
    batch padded or dropped: every array exactly equal."""
    import pandas as pd

    from geoguessr_ai_tpu.data.pipeline import (
        EmbeddingBatchIterator as JaxIterator,
    )

    from geoguessr_ai_torch.data.pipeline import EmbeddingBatchIterator

    records = _embedding_records(11)
    for kw in (dict(shuffle=True, seed=4), dict(drop_remainder=True)):
        it = EmbeddingBatchIterator(records, 4, D, **kw)
        jit = JaxIterator(pd.DataFrame(records), 4, D, **kw)
        for _ in range(2):  # two epochs: seed + epoch
            got, want = list(it), list(jit)
            assert len(got) == len(want) == len(it)
            for a, b in zip(got, want):
                for key in ("embedding", "view_mask", "coords"):
                    np.testing.assert_array_equal(a[key], b[key])
                assert a["location_id"] == b["location_id"]
                assert a["num_real"] == b["num_real"]
    assert got[0]["embedding"].shape == (4, 4, D)


def test_embedding_only_train_matches_jax_train(monkeypatch):
    """Backbone "none": the JAX train() and the port's on the same
    embedding records and the same initial weights (the JAX model.init
    weights, loaded into the port through from_jax_variables), two epochs
    with validation.  Gate: every step loss within a relative 1e-4 (both
    f32; the sums run in different orders)."""
    import pandas as pd

    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.train import coordinator as jcoord

    from geoguessr_ai_torch.train import coordinator

    jcfg, cfg = _cfg_pair(seed=3, batch_size=8, num_epochs=2,
                          eval_every_steps=3, log_every_steps=1,
                          backbone=dict(name="none"),
                          optimizer=dict(learning_rate=1e-2))
    records = _embedding_records(28, seed=1)
    table = _tiny_table(NUM_CELLS)
    jm = JaxSuperGuessr(num_cells=NUM_CELLS, backbone=None, embed_dim=D)
    variables = jm.init(jax.random.PRNGKey(jcfg.seed),
                        embedding=jnp.zeros((1, 4, D), jnp.float32))
    monkeypatch.setattr(
        coordinator, "init_parameters_",
        lambda model, seed: model.load_state_dict(
            from_jax_variables(jax.device_get(variables)), strict=True))
    jrec, rec = _Recorder(), _Recorder()
    jsum = jcoord.train(jcfg, pd.DataFrame(records[:18]),
                        pd.DataFrame(records[18:]), table,
                        metrics_logger=jrec)
    summary = coordinator.train(cfg, records[:18], records[18:], table,
                                metrics_logger=rec, device="cpu")
    assert len(rec.losses()) == len(jrec.losses()) == 4
    np.testing.assert_allclose(rec.losses(), jrec.losses(), rtol=1e-4)
    assert rec.losses()[-1] < rec.losses()[0]
    np.testing.assert_allclose(summary["val_loss"], jsum["val_loss"],
                               rtol=1e-4)
    assert [s for s, m in rec.rows if "val_loss" in m] == [
        s for s, m in jrec.rows if "val_loss" in m]


# ---------------------------------------------------------------------------
# train_step: hierarchical fusion, a single-image model, QAT storage
# ---------------------------------------------------------------------------


def _jax_step(jm, variables, batch, cells, opt, extra=None):
    """The JAX train_step on the CPU (the default freeze when the model has
    a backbone): (new state, metrics, the gradients it applies)."""
    from geoguessr_ai_tpu.config import OptimizerConfig as JaxOptCfg
    from geoguessr_ai_tpu.train import state as jstate
    from geoguessr_ai_tpu.train import steps as jsteps

    mask = None
    if "backbone" in variables["params"]:
        mask = jstate.backbone_freeze_mask(variables["params"],
                                           freeze_all_but_last_stage=True)
    tx, _ = jstate.make_optimizer(JaxOptCfg(**opt), 10, mask)
    captured = {}

    class Capture(jstate.TrainState):
        def apply_gradients(self, *, grads, **kw):
            captured["grads"] = grads
            return super().apply_gradients(grads=grads, **kw)

    js = Capture.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                        batch_stats=variables.get("batch_stats", {}),
                        extra_variables=extra,
                        dropout_rng=jax.random.PRNGKey(0))

    def step(s, b, c):
        new, metrics = jsteps.train_step(s, b, c)
        return new, metrics, captured["grads"]

    return jax.jit(step)(js, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(cells))


def _port_step(pm, batch, cells, opt):
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.train import state as tstate
    from geoguessr_ai_torch.train import steps as tsteps

    names = [n for n, _ in pm.named_parameters()]
    state = tstate.create_train_state(
        pm, OptimizerConfig(**opt), 10,
        trainable_mask=tstate.backbone_freeze_mask(
            names, freeze_all_but_last_stage=True))
    grads = {}
    real_step = state.optimizer.step
    state.optimizer.step = lambda p, g: (grads.update(g), real_step(p, g))[1]
    state, met = tsteps.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(cells))
    return state, met, grads


def _jax_tinyvit_config(qat=False):
    from geoguessr_ai_tpu.models import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.models.tinyvit import TRAIN_QUANT_SITES

    jcfg = JaxConfig.test_tiny(dtype=jnp.float32)
    if qat:
        jcfg = dataclasses.replace(jcfg, quant_mode="static",
                                   quant_sites=TRAIN_QUANT_SITES)
    return jcfg


def _port_tinyvit(jcfg):
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    shared = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TinyViTConfig) if f.name != "dtype"}
    return TinyViT(TinyViTConfig(dtype=torch.float32, **shared))


def _pair(backbone=True, panorama=True, hierarchical=False, qat=False,
          seed=0):
    """(flax SuperGuessr, seeded variables, the port model loaded with
    them), f32; the TinyViT at test_tiny (QAT storage: static int8 at
    TRAIN_QUANT_SITES) or no backbone."""
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT

    from geoguessr_ai_torch.models.super_guessr import SuperGuessr

    jcfg = _jax_tinyvit_config(qat)
    jm = JaxSuperGuessr(num_cells=NUM_CELLS,
                        backbone=JaxTinyViT(jcfg) if backbone else None,
                        panorama=panorama, hierarchical=hierarchical,
                        embed_dim=D, dtype=jnp.float32)
    lead = (1, 4) if panorama else (1,)
    sample = ({"pixel_values": jnp.zeros(lead + (64, 64, 3), jnp.float32)}
              if backbone else
              {"embedding": jnp.zeros(lead + (D,), jnp.float32)})
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **sample))
    variables = _randomise({k: v for k, v in shapes.items()
                            if k in ("params", "batch_stats")}, seed)
    pm = SuperGuessr(NUM_CELLS, _port_tinyvit(jcfg) if backbone else None,
                     embed_dim=D, hierarchical=hierarchical,
                     panorama=panorama, dtype=torch.float32)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


def _step_batch(B, seed, pixels=None, embedding=None):
    rng = np.random.default_rng(seed)
    batch = {"coords": np.stack([rng.uniform(-170, 170, B),
                                 rng.uniform(-60, 60, B)], -1)
             .astype(np.float32)}
    if pixels is not None:
        batch["pixel_values"] = rng.normal(0, 1, (B,) + pixels).astype(
            np.float32)
    if embedding is not None:
        batch["embedding"] = rng.normal(0, 1, (B,) + embedding).astype(
            np.float32)
        mask = np.ones((B, embedding[0]), np.float32)
        mask[0, -1] = mask[1, 0] = 0.0  # padded views, view 0 among them
        batch["view_mask"] = mask
    cells = np.stack([rng.uniform(-170, 170, NUM_CELLS),
                      rng.uniform(-60, 60, NUM_CELLS)], -1).astype(np.float32)
    return batch, cells


def _assert_steps_match(jout, pout, variables, pm, rtol, metric_rtol=1e-5):
    """Loss and metrics, every gradient, every parameter's update and
    batch_stats of one step, as test_train_step_matches_jax_train_step
    holds them."""
    jnew, jmet, jgrads = jout
    _, met, grads = pout
    for key in ("loss", "grad_norm", "param_norm", "top1", "top5",
                "mean_km", "median_km", "score"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=metric_rtol, err_msg=key)
    _assert_trees_close(to_jax_variables(grads, num_heads=16)["params"],
                        jgrads,
                        rtol=rtol, rel_atol=1e-4,
                        atol=STEP_NORM_ATOL * float(jmet["grad_norm"]))
    new = to_jax_variables(pm.state_dict(), num_heads=16)
    delta = jax.tree_util.tree_map(lambda a, b: a - np.asarray(b),
                                   new["params"], variables["params"])
    want = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                  jnew.params, variables["params"])
    _assert_trees_close(delta, want, rtol=rtol, rel_atol=0.0, atol=1e-6)
    if "batch_stats" in variables:
        _assert_trees_close(new["batch_stats"], jnew.batch_stats, rtol=1e-5,
                            rel_atol=1e-6)


class _NoDropoutAttention:
    """The JAX fusion's attention and positional encoding with their
    dropout rates at 0 (the port's are set to 0 too): both sides then take
    the same deterministic train step."""

    @staticmethod
    def patch(monkeypatch):
        import flax.linen as nn

        from geoguessr_ai_tpu.models import super_guessr as jsg

        class Attention(nn.MultiHeadDotProductAttention):
            def __post_init__(self):
                object.__setattr__(self, "dropout_rate", 0.0)
                super().__post_init__()

        class Positional(jsg.PositionalEncoder):
            dropout_rate: float = 0.0

        monkeypatch.setattr(nn, "MultiHeadDotProductAttention", Attention)
        monkeypatch.setattr(jsg, "PositionalEncoder", Positional)


def test_hierarchical_train_step_matches_jax_train_step(monkeypatch):
    """Hierarchical fusion (positional encoding + 16-head self-attention
    over the views, masked keys, the masked mean of the outputs) trained on
    embeddings with dropout at 0 on both sides: loss, metrics, every
    gradient (self_attn's and cell_layer's) and every update within
    test_train_step_matches_jax_train_step's tolerances (rtol 1e-3 and 1e-4
    of each leaf's largest value)."""
    _NoDropoutAttention.patch(monkeypatch)
    jm, variables, pm = _pair(backbone=False, hierarchical=True, seed=5)
    pm.pos_encoder.dropout_rate = 0.0
    pm.self_attn.dropout_rate = 0.0
    batch, cells = _step_batch(4, seed=6, embedding=(4, D))
    opt = dict(learning_rate=0.1, eps=1.0)
    jout = _jax_step(jm, variables, batch, cells, opt)
    pout = _port_step(pm, batch, cells, opt)
    _assert_steps_match(jout, pout, variables, pm, rtol=STEP_RTOL[1])
    grads = pout[2]
    for name in ("self_attn.query.weight", "self_attn.out.bias",
                 "cell_layer.weight"):
        assert float(grads[name].abs().max()) > 0, name


def test_single_image_train_step_matches_jax_train_step():
    """A single-image model (panorama=False) on (B, H, W, C) pixels at
    test_tiny with the default freeze: as
    test_train_step_matches_jax_train_step holds a panorama step."""
    jm, variables, pm = _pair(panorama=False, seed=7)
    batch, cells = _step_batch(4, seed=8, pixels=(64, 64, 3))
    opt = dict(learning_rate=0.1, eps=1.0)
    jout = _jax_step(jm, variables, batch, cells, opt)
    pout = _port_step(pm, batch, cells, opt)
    _assert_steps_match(jout, pout, variables, pm, rtol=STEP_RTOL[1])


def test_train_refuses_a_single_image_model_as_the_jax_train_fails():
    """The JAX train() hands its single-image model the iterator's
    (B, V, H, W, C) batches and fails inside the backbone; the port's
    train() refuses before any step, naming the mismatch."""
    from geoguessr_ai_torch.train import coordinator

    _, cfg = _cfg_pair(model=dict(panorama=False))
    with pytest.raises(ValueError, match="view axis"):
        coordinator.train(cfg, [], [], _tiny_table(), device="cpu")


@pytest.fixture(scope="module")
def qat_calibration():
    """The JAX coordinator's start-up calibration (train/coordinator.py,
    qat_storage) on seeded test_tiny variables: (flax model, variables
    with the calibrated act_scales, the port model without them)."""
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.ops.quant import calibrate_act_stats

    jm, variables, pm = _pair(qat=True, seed=9)
    cal_model = jm.clone(backbone=JaxTinyViT(dataclasses.replace(
        jm.backbone.config, quant_mode="calibrate", dtype=jnp.float32)))
    cal_x = jnp.asarray(np.random.default_rng(9).normal(
        0, 1, (1, 4, 64, 64, 3)), jnp.float32)
    stats = calibrate_act_stats(
        jax.jit(lambda vv, xx: cal_model.apply(vv, pixel_values=xx,
                                               mutable=["act_stats"])),
        variables, [cal_x])
    return jm, {**variables, "act_scales": jax.device_get(stats)}, pm


def test_qat_calibration_matches_jax(qat_calibration):
    """``coordinator.calibrate_qat_`` (one f32 CPU forward of the
    calibrate model over N(0, 1) from the seed) against the JAX
    coordinator's: every site's amax within a relative 1e-5, all finite
    and positive."""
    from geoguessr_ai_torch.train.coordinator import calibrate_qat_

    _, variables, pm = qat_calibration
    calibrate_qat_(pm, 9, 64)
    got = to_jax_variables({f"backbone.act_scales.{k}": v for k, v in
                            pm.backbone.act_scales.items()})["act_scales"]
    _assert_trees_close(got, variables["act_scales"], rtol=1e-5,
                        rel_atol=0.0)
    amax = np.array(list(_leaves(got).values()))
    assert amax.size >= 5 and np.all(np.isfinite(amax)) and np.all(amax > 0)


def _cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _flat(tree):
    leaves = _leaves(tree)
    return np.concatenate([np.ravel(leaves[k]) for k in sorted(leaves)])


def test_qat_storage_train_step_matches_jax_train_step(qat_calibration):
    """QAT storage (static int8 round trips with a straight-through
    gradient at the stem, depthwise and local-conv inputs) with the JAX
    calibration's scales on both sides.

    The step is discontinuous: where an f32 value lands on the other side
    of a rounding boundary of the int8 grid, one stored element moves by a
    whole quantization step.  Measured on these inputs, moving the port's
    own input by 1e-6 relative moves its loss by 5e-5 relative and leaves
    its whole gradient at cosine 0.99993 to the unmoved one (single leaves
    by up to 3.5 % of their largest value), the same as its distance to
    JAX (0.99994).  So the gates are whole-tree ones: the loss within 1e-3
    relative, the whole gradient and the whole update at cosine >= 0.9999,
    each top-level module's gradient at cosine >= 0.99, the running
    statistics within 1e-3 relative in L2 norm, and only the trainable
    leaves moved."""
    from geoguessr_ai_tpu.train import state as jstate

    jm, variables, pm = qat_calibration
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    batch, cells = _step_batch(4, seed=10, pixels=(4, 64, 64, 3))
    opt = dict(learning_rate=0.1, eps=1.0)
    jnew, jmet, jgrads = _jax_step(
        jm, {k: variables[k] for k in ("params", "batch_stats")}, batch,
        cells, opt, extra={"act_scales": variables["act_scales"]})
    _, met, grads = _port_step(pm, batch, cells, opt)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-3)
    got = to_jax_variables(grads)["params"]
    assert _cosine(_flat(got), _flat(jgrads)) >= 0.9999
    for name in jgrads["backbone"]:
        assert _cosine(_flat(got["backbone"][name]),
                       _flat(jgrads["backbone"][name])) >= 0.99, name
    new = to_jax_variables(pm.state_dict())
    delta = jax.tree_util.tree_map(lambda a, b: a - np.asarray(b),
                                   new["params"], variables["params"])
    want = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                  jnew.params, variables["params"])
    assert _cosine(_flat(delta), _flat(want)) >= 0.9999
    mask = _leaves(jstate.backbone_freeze_mask(
        variables["params"], freeze_all_but_last_stage=True))
    for key, d in _leaves(delta).items():
        assert (np.abs(d).max() > 0) == bool(mask[key]), key
    stats, want_stats = _flat(new["batch_stats"]), _flat(jnew.batch_stats)
    assert (np.linalg.norm(stats - want_stats)
            <= 1e-3 * np.linalg.norm(want_stats))


def test_qat_storage_train_runs_with_scales_from_start_up(fixtures_dir,
                                                          monkeypatch):
    """train() with qat_storage: the backbone turns static at the
    training sites, its scales come from one calibration at start-up, and
    the losses are finite."""
    from geoguessr_ai_torch.models.tinyvit import (
        TRAIN_QUANT_SITES,
        TinyViTConfig,
    )
    from geoguessr_ai_torch.train import coordinator

    calls = []
    real = coordinator.calibrate_qat_
    monkeypatch.setattr(coordinator, "calibrate_qat_",
                        lambda *a: (calls.append(a), real(*a)))
    base = coordinator.build_backbone
    monkeypatch.setattr(
        coordinator, "build_backbone", lambda cfg, mc=None: base(
            cfg, TinyViTConfig.test_tiny(dtype=torch.float32)))
    _, cfg = _cfg_pair(batch_size=4, num_epochs=1, log_every_steps=1,
                       backbone=dict(qat_storage=True))
    rec = _Recorder()
    coordinator.train(cfg, _records(fixtures_dir, n=8), [], _tiny_table(),
                      metrics_logger=rec, device="cpu")
    assert len(calls) == 1
    model = calls[0][0]
    assert model.backbone.config.quant_mode == "static"
    assert model.backbone.config.quant_sites == TRAIN_QUANT_SITES
    assert len(model.backbone.act_scales) > 0
    assert len(rec.losses()) == 2 and np.all(np.isfinite(rec.losses()))


# ---------------------------------------------------------------------------
# The native JPEG decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_pair():
    from geoguessr_ai_tpu.data.native import jpeg as jax_jpeg

    from geoguessr_ai_torch.data.native import jpeg

    if not jpeg.available() or not jax_jpeg.available():
        pytest.skip(f"no native decoder here: {jpeg.build_error()}")
    return jpeg, jax_jpeg


def test_native_decode_equals_the_jax_native_decode(native_pair,
                                                    fixtures_dir):
    """The port's library, built from its own copy of the source into
    build/native/, against the JAX package's: bitwise at 512 from the
    640 px fixture and from a 384 px re-encode, one view at a time and
    batched; a corrupt blob decodes to zeros in a batch and raises alone;
    ``decode_jpeg`` takes the native path."""
    import glob
    import io

    from PIL import Image

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data import pipeline

    jpeg, jax_jpeg = native_pair
    assert jpeg.SO_PATH.startswith(os.path.join(C.REPO_ROOT, "build",
                                                "native"))
    blobs = [open(p, "rb").read() for p in sorted(
        glob.glob(os.path.join(fixtures_dir, "heading=*.jpg")))]
    with Image.open(io.BytesIO(blobs[0])) as im:
        buf = io.BytesIO()
        im.convert("RGB").resize((384, 384)).save(buf, "JPEG", quality=90)
    blobs.append(buf.getvalue())
    for blob in blobs:
        for size in (512, 224):
            got = jpeg.decode_resize(blob, size)
            np.testing.assert_array_equal(got, jax_jpeg.decode_resize(blob,
                                                                      size))
        np.testing.assert_array_equal(pipeline.decode_jpeg(blob, 512),
                                      jpeg.decode_resize(blob, 512))
    batch = jpeg.decode_batch(blobs + [b"not a jpeg"], 512, n_threads=2)
    np.testing.assert_array_equal(batch[:-1], jax_jpeg.decode_batch(
        blobs, 512, n_threads=2))
    assert not batch[-1].any()
    with pytest.raises(ValueError):
        jpeg.decode_resize(b"not a jpeg", 64)
    # a stream the native decoder refuses (CMYK) falls back to PIL, as the
    # JAX package's does
    cmyk = io.BytesIO()
    Image.new("CMYK", (32, 32), (10, 20, 30, 40)).save(cmyk, "JPEG")
    with pytest.raises(ValueError):
        jpeg.decode_resize(cmyk.getvalue(), 16)
    np.testing.assert_array_equal(pipeline.decode_jpeg(cmyk.getvalue(), 16),
                                  pipeline._pil_decode(cmyk.getvalue(), 16))


def test_native_build_refused_by_the_override(monkeypatch, tmp_path):
    """With GEO_TPU_NO_NATIVE=1 a missing library is not built:
    ``available()`` is False, ``build_error()`` says why, and
    ``decode_jpeg`` decodes with PIL."""
    from geoguessr_ai_torch.data import pipeline
    from geoguessr_ai_torch.data.native import jpeg

    monkeypatch.setattr(jpeg, "SO_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg, "_error", None)
    monkeypatch.setenv("GEO_TPU_NO_NATIVE", "1")
    assert not jpeg.available()
    assert jpeg.build_error() == "GEO_TPU_NO_NATIVE=1"
    assert not os.path.exists(tmp_path / "none.so")
    blob = open(os.path.join(os.path.dirname(__file__), "fixtures",
                             "heading=000.jpg"), "rb").read()
    np.testing.assert_array_equal(pipeline.decode_jpeg(blob, 64),
                                  pipeline._pil_decode(blob, 64))


# ---------------------------------------------------------------------------
# The step profiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", [(2, 2, 10, 2), (0, 1, 2, 3),
                                      (1, 0, 1, 1)])
def test_step_profiler_starts_and_stops_where_the_jax_one_does(schedule,
                                                               monkeypatch,
                                                               tmp_path):
    """Over 40 step() calls and a close(): the calls at which a trace
    starts and stops, the JAX profiler's (``jax.profiler.start_trace`` /
    ``stop_trace`` recorded) against the port's (its torch.profiler
    recorded)."""
    from geoguessr_ai_tpu.utils import profiling as jprof

    from geoguessr_ai_torch.utils import profiling

    events = {"jax": [], "port": []}
    clock = {"n": 0}
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: events["jax"].append(("start", clock["n"])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: events["jax"].append(("stop", clock["n"])))

    class FakeProfile:
        def start(self):
            events["port"].append(("start", clock["n"]))

        def stop(self):
            events["port"].append(("stop", clock["n"]))

    monkeypatch.setattr(profiling, "_profile", lambda d: FakeProfile())
    w, u, a, r = schedule
    jp = jprof.StepProfiler(str(tmp_path / "j"),
                            jprof.ProfileSchedule(w, u, a, r))
    pp = profiling.StepProfiler(str(tmp_path / "p"),
                                profiling.ProfileSchedule(w, u, a, r))
    for n in range(40):
        clock["n"] = n
        jp.step()
        pp.step()
    clock["n"] = 40
    jp.close()
    pp.close()
    assert events["port"] == events["jax"]
    assert len(events["port"]) == 2 * r


def test_step_profiler_writes_a_trace_with_the_annotated_steps(tmp_path):
    """A real torch.profiler trace on the CPU: the JSON file appears in
    the log directory when the trace stops, and holds the ``annotate``
    regions of the traced steps."""
    import glob

    from geoguessr_ai_torch.train.train_eval_loop import generate_profiler
    from geoguessr_ai_torch.utils.profiling import (
        ProfileSchedule,
        StepProfiler,
        annotate,
        trace,
    )

    assert generate_profiler(str(tmp_path / "g")).schedule == \
        ProfileSchedule(2, 2, 10, 2)
    prof = StepProfiler(str(tmp_path / "s"), ProfileSchedule(0, 1, 3, 1))
    for i in range(6):
        with annotate(f"step{i}"):
            torch.ones(8).sum()
        prof.step()
    prof.close()
    files = glob.glob(str(tmp_path / "s" / "*.pt.trace.json"))
    assert len(files) == 1
    text = open(files[0]).read()
    assert "step2" in text and "step3" in text and "step5" not in text
    with trace(str(tmp_path / "t")):
        with annotate("whole"):
            torch.ones(8).sum()
    assert "whole" in open(glob.glob(
        str(tmp_path / "t" / "*.pt.trace.json"))[0]).read()


# ---------------------------------------------------------------------------
# Serving a store directory, the loop entry points and main()
# ---------------------------------------------------------------------------


def _tiny_engine(table, **kw):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    return ServingEngine(
        centroid_table=table, device="cpu",
        backbone_config=TinyViTConfig(
            image_size=64, embed_dims=(16, 32, 64, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 5), window_sizes=(2, 2, 4, 2),
            dtype=torch.float32), **kw)


def test_engine_serves_a_store_directory_bitwise(fixtures_dir, tmp_path):
    """A TrainState after one step, saved by the store: the engine built
    on ``<dir>/best`` answers the fixture panorama bitwise as the engine
    built on the same weights in memory.  Another cell count or fusion
    raises ValueError naming the entries, before any weight changes; a
    directory without state.pt (an orbax one) raises
    NotImplementedError."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.inference import fixture_panorama
    from geoguessr_ai_torch.train import steps
    from geoguessr_ai_torch.train.checkpoints import (
        CheckpointConfig,
        CheckpointStore,
    )
    from geoguessr_ai_torch.train.state import create_train_state

    table = _tiny_table()
    seeded = _tiny_engine(table, seed=3)
    model = seeded.model.float()
    state = create_train_state(model, OptimizerConfig(learning_rate=1e-2), 1)
    x, cells = _step_batch(2, seed=11, pixels=(4, 64, 64, 3))
    steps.train_step(state, {k: torch.from_numpy(v) for k, v in x.items()},
                     torch.from_numpy(table.centroids))
    store = CheckpointStore(CheckpointConfig(str(tmp_path / "run")))
    store.save_epoch(state, 0, 1.0, None, extra={"global_step": 1})
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}

    served = _tiny_engine(table, checkpoint=str(tmp_path / "run" / "best"))
    in_memory = _tiny_engine(table, state_dict=weights)
    assert served.loaded == {"head": 1, "backbone": True}
    paths = fixture_panorama()
    a, b = served.predict_images(paths), in_memory.predict_images(paths)
    np.testing.assert_array_equal(a.embedding, b.embedding)
    assert (a.lat, a.lon, a.top_ids, a.top_probs) == (
        b.lat, b.lon, b.top_ids, b.top_probs)

    for other in (dict(table=_tiny_table(NUM_CELLS + 1)),
                  dict(table=table, hierarchical=True)):
        engine = _tiny_engine(**other)
        before = {k: v.clone() for k, v in engine.model.state_dict().items()}
        with pytest.raises(ValueError, match="cell_layer|self_attn"):
            engine.load_checkpoint(str(tmp_path / "run" / "best"))
        for k, v in engine.model.state_dict().items():
            assert torch.equal(v, before[k]), k
    orbax_dir = tmp_path / "orbax"
    orbax_dir.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        _tiny_engine(table, checkpoint=str(orbax_dir))


def _fixture_sqlite(path, fixtures_dir, locations):
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    blob = open(os.path.join(fixtures_dir, "heading=000.jpg"), "rb").read()
    rng = np.random.default_rng(0)
    coords = rng.uniform((-50, -170), (50, 170), (locations, 2))
    create_sqlite_from_records(path, (
        {"location_id": f"loc{i // 4:03d}", "lat": coords[i // 4, 0],
         "lon": coords[i // 4, 1], "heading": 90 * (i % 4), "image": blob}
        for i in range(4 * locations)))


def test_main_trains_the_newest_sqlite_into_the_checkpoint_dir(
        fixtures_dir, monkeypatch, tmp_path):
    """``main()``: the dataset from DATASET_SQLITE_PATH, split by
    val_fraction (8 train, 4 validation panoramas), one epoch to the end,
    checkpoints in CHECKPOINT_DIR (last, best, one epoch directory)."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train import coordinator

    _tiny_backbone(monkeypatch)
    db = str(tmp_path / "dataset_sqlite_main.sqlite")
    _fixture_sqlite(db, fixtures_dir, 12)
    monkeypatch.setenv("DATASET_SQLITE_PATH", db)
    monkeypatch.setattr(C, "CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(C, "CENTROID_TABLE_PATH", str(tmp_path / "t.npz"))
    _tiny_table().save(str(tmp_path / "t.npz"))
    _, cfg = _cfg_pair(batch_size=4, num_epochs=1, val_fraction=1 / 3,
                       log_every_steps=1)
    summary = coordinator.main(cfg, device="cpu")
    assert summary["epoch"] == 0 and summary["global_step"] == 2
    assert np.isfinite(summary["val_loss"])
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names[:1] == ["best"] and names[-1] == "last"
    assert len(names) == 3 and names[1].startswith("epoch_0000_")


def test_train_model_and_evaluate_model(fixtures_dir, monkeypatch, tmp_path):
    """``train_model`` applies its scalar overrides and trains into a
    checkpoint directory; ``evaluate_model`` on the restored state gives
    eval_step's metrics over the records with the whole-set median, and
    refuses a mesh of more than one device."""
    from geoguessr_ai_torch.config import MeshConfig
    from geoguessr_ai_torch.train import coordinator
    from geoguessr_ai_torch.train.checkpoints import (
        CheckpointConfig,
        CheckpointStore,
    )
    from geoguessr_ai_torch.train.train_eval_loop import (
        evaluate_model,
        train_model,
    )

    _tiny_backbone(monkeypatch)
    _, cfg = _cfg_pair(num_epochs=5, batch_size=8, log_every_steps=1)
    records = _records(fixtures_dir, n=12)
    table = _tiny_table()
    summary = train_model(cfg, records[:8], records[8:], table, num_epochs=1,
                          batch_size=4, learning_rate=1e-3,
                          checkpoint_dir=str(tmp_path / "run"), device="cpu")
    assert summary["epoch"] == 0 and summary["global_step"] == 2
    state, _, _, _ = coordinator.create_state(
        dataclasses.replace(cfg, batch_size=4), table.num_cells, 2, "cpu")
    CheckpointStore(CheckpointConfig(str(tmp_path / "run"))).restore(
        state, "last")
    out = evaluate_model(state, records[8:], table, batch_size=4)
    np.testing.assert_allclose(out["loss"], summary["val_loss"], rtol=1e-6)
    assert {"top1", "top5", "mean_km", "median_km", "score"} <= set(out)
    with pytest.raises(NotImplementedError, match="item 11"):
        evaluate_model(state, records, table,
                       mesh_cfg=MeshConfig(data_parallel=2))


def test_embedding_sqlite_trains_end_to_end(monkeypatch, tmp_path):
    """The embed -> train loop: an embedding SQLite (the builder's schema)
    grouped into panoramas trains the head alone, with hierarchical
    fusion, through train(); the loss falls."""
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
        load_sqlite_panorama_dataset,
    )
    from geoguessr_ai_torch.train import coordinator

    rng = np.random.default_rng(12)
    path = str(tmp_path / "emb.sqlite")
    create_sqlite_from_records(path, (
        {"location_id": f"l{i // 4:03d}", "lat": float(i // 4 % 40),
         "lon": float(i // 4 % 7 * 20), "heading": 90 * (i % 4),
         "embedding": rng.normal(0, 1, D).astype(np.float32).tobytes(),
         "embedding_dim": D} for i in range(4 * 24)), embedding=True)
    panos = load_sqlite_panorama_dataset(path)
    assert len(panos) == 24 and len(panos[0].images) == 4
    _, cfg = _cfg_pair(batch_size=8, num_epochs=4, log_every_steps=1,
                       backbone=dict(name="none"),
                       model=dict(hierarchical=True),
                       optimizer=dict(learning_rate=1e-2))
    rec = _Recorder()
    summary = coordinator.train(cfg, panos[:16], panos[16:], _tiny_table(),
                                metrics_logger=rec, device="cpu")
    losses = rec.losses()
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert np.isfinite(summary["val_loss"])


def test_new_modules_import_with_jax_blocked():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'pandas', "
        "'geoguessr_ai_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import geoguessr_ai_torch.train.checkpoints\n"
        "import geoguessr_ai_torch.train.train_eval_loop\n"
        "import geoguessr_ai_torch.utils.profiling\n"
        "import geoguessr_ai_torch.data.native.jpeg\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_checkpoint_files_load_with_weights_only(tmp_path):
    """Everything a checkpoint holds (the model, the moments, the count,
    the generator state, the step, the meta) unpickles with
    ``weights_only=True``, and loads back into a fresh TrainState."""
    from geoguessr_ai_torch.train.checkpoints import (
        STATE_FILE,
        CheckpointConfig,
        CheckpointStore,
    )

    state = _tiny_state(seed=1)
    state.step, state.optimizer.count = 5, 5
    state.generator.manual_seed(77)
    CheckpointStore(CheckpointConfig(str(tmp_path))).save_epoch(
        state, 4, 0.5, None, extra={"global_step": 5})
    tree = torch.load(str(tmp_path / "last" / STATE_FILE),
                      weights_only=True)
    assert tree["meta"] == {"epoch": 4, "monitored_value": 0.5,
                            "best_value": 0.5, "global_step": 5}
    fresh = _tiny_state(seed=2)
    _, meta = CheckpointStore(CheckpointConfig(str(tmp_path))).restore(
        fresh, "best")
    assert meta["global_step"] == 5 and fresh.step == 5
    assert fresh.optimizer.count == 5
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k

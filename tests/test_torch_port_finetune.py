"""The port's TinyViT country finetune held against the JAX package on the
CPU.

* ``prepare_country_dataset`` on rows (the port) and on a DataFrame (JAX):
  the same rows in the same order and the same class map;
* ``finetune`` at ``test_tiny`` in f32 (no DropPath, one warm-up step,
  B=4, 3 steps) from the same flax init (the JAX ``Classifier``'s
  ``model.init(PRNGKey(seed))``, carried by ``convert.
  from_jax_variables``): final parameters and running statistics within
  1e-4 of the tree's range (the entries whose gradient is zero
  analytically, which Adam moves by its scaling of rounding noise, held to
  the update's bound instead), top-1 and top-5 equal; the best
  checkpoint, the class map and the NaN result without a validation batch;
  the schedule and AdamW without clipping against optax;
* ``extract_embeddings_parquet`` (within 1e-5, the Parquet columns equal)
  and ``mmpretrain_export`` (identical JSON files);
* the TinyViT-5M-224 geometry at full widths and depths (1, 1, 1, 1): the
  eval logits within 1e-5, one train step's loss within 1e-5 relative and
  its gradient at cosine >= 0.99999; the three 224 presets field for
  field.
"""

import dataclasses
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.data import pipeline as jax_pipeline
from geoguessr_ai_tpu.geocells.manager import GeocellManager as JaxManager
from geoguessr_ai_tpu.models import tinyvit as jtv
from geoguessr_ai_tpu.train import finetune_tinyvit as jft

from geoguessr_ai_torch.data import pipeline
from geoguessr_ai_torch.geocells.manager import GeocellManager
from geoguessr_ai_torch.models import tinyvit as ttv
from geoguessr_ai_torch.models.convert import (from_jax_variables,
                                               to_jax_variables)
from geoguessr_ai_torch.models.super_guessr import init_parameters_
from geoguessr_ai_torch.train import finetune_tinyvit as tft

from test_torch_port_geocells import make_geocell_pickles
from test_torch_port_train import _same_decoder

#: Final parameters (and running statistics): max |port - jax| over the
#: determinate entries <= PARAM_REL * max |jax| over the tree.
PARAM_REL = 1e-4
#: The 5M-224 forward and loss in f32: relative to the largest value.
F32_REL = 1e-5
MIN_GRAD_COSINE = 0.99999


@pytest.fixture(scope="module")
def world(tmp_path_factory, fixtures_dir):
    """The geocell pickles, both managers and 30 rows: 12 Testland, 9
    Beta, 7 Alpha and 2 points in no cell, cycling the fixture JPEGs."""
    out = tmp_path_factory.mktemp("geocells")
    points = make_geocell_pickles(out)
    blobs = []
    for h in ("000", "090", "180", "270"):
        with open(os.path.join(fixtures_dir, f"heading={h}.jpg"), "rb") as f:
            blobs.append(f.read())
    picks = (points["Testland"][::13][:12] + points["Beta"][:9]
             + points["Alpha"][::5][:7]
             + [{"latitude": -33.3, "longitude": 151.1},
                {"latitude": 5.5, "longitude": -120.25}])
    rng = np.random.default_rng(0)
    order = rng.permutation(len(picks))
    rows = [{"location_id": f"loc{i}", "lat": picks[j]["latitude"],
             "lon": picks[j]["longitude"], "image": blobs[i % 4]}
            for i, j in enumerate(order)]
    return JaxManager(str(out)), GeocellManager(str(out)), rows


def _records(df):
    return df.to_dict("records")


@pytest.mark.parametrize("min_count,val_fraction,seed", [
    (2, 0.25, 0), (8, 0.1, 3), (2, 0.5, 7)])
def test_prepare_country_dataset_matches(world, min_count, val_fraction,
                                         seed):
    jm, tm, rows = world
    kw = dict(min_count=min_count, val_fraction=val_fraction, seed=seed)
    jtrain, jval, jmap = jft.prepare_country_dataset(pd.DataFrame(rows), jm,
                                                     **kw)
    train, val, class_map = tft.prepare_country_dataset(rows, tm, **kw)
    assert class_map == jmap
    assert train == _records(jtrain)
    assert val == _records(jval)
    assert len(train) + len(val) <= len(rows) - 2  # the unknown points drop
    if min_count == 8:
        assert "Alpha" not in class_map  # 7 rows


def _jax_classifier(tv_cfg, num_classes):
    """The JAX finetune's ``Classifier`` (train/finetune_tinyvit.py)."""

    class Classifier(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            emb = jtv.TinyViT(tv_cfg, name="backbone")(x, train=train)
            return nn.Dense(num_classes, dtype=jnp.float32, name="head")(emb)

    return Classifier()


def _tiny_configs():
    return (jtv.TinyViTConfig.test_tiny(dtype=jnp.float32,
                                        drop_path_rate=0.0),
            ttv.TinyViTConfig.test_tiny(dtype=torch.float32,
                                        drop_path_rate=0.0))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def finetuned(world, fixtures_dir):
    """Both finetunes, 3 steps of 4 from one flax init, into no
    checkpoint directory."""
    jm, tm, rows = world
    mp = pytest.MonkeyPatch()
    _same_decoder(mp, jax_pipeline, pipeline)
    # the JAX finetune's model.init, jitted (the same bits as op by op,
    # which takes ~40 s here, in one compile) and kept: the port starts
    # from the variables the JAX finetune drew
    init, drawn = nn.Module.init, []

    def jit_init(self, rngs, *args, **kw):
        drawn.append(jax.tree_util.tree_map(np.array, jax.jit(
            lambda r, *a: init(self, r, *a, **kw))(rngs, *args)))
        return drawn[-1]

    mp.setattr(nn.Module, "init", jit_init)
    kw = dict(min_count=2, val_fraction=0.25, seed=0)
    jtrain, jval, class_map = jft.prepare_country_dataset(pd.DataFrame(rows),
                                                          jm, **kw)
    train, val, _ = tft.prepare_country_dataset(rows, tm, **kw)
    jcfg, tcfg = _tiny_configs()
    cfg = jft.FinetuneConfig(batch_size=4, num_epochs=2, warmup_steps=1,
                             learning_rate=1e-3)
    pcfg = tft.FinetuneConfig(**dataclasses.asdict(cfg))
    want = jft.finetune(jtrain, jval, len(class_map), cfg,
                        tinyvit_config=jcfg, max_steps=3)
    (variables,) = drawn
    got = tft.finetune(train, val, len(class_map), pcfg,
                       tinyvit_config=tcfg, max_steps=3,
                       init_state=from_jax_variables(variables),
                       device="cpu")
    mp.undo()
    return want, got, variables, (train, val, class_map)


def _indeterminate(name, value, cfg):
    """The entries of a leaf whose gradient is zero analytically, so that
    each framework's update is Adam's scaling of its own rounding noise
    (up to the learning rate either way): the k part of every qkv bias (a
    per-query constant in the scores, which softmax drops) and the
    fc2 bias of each stage's last attention block, a per-channel shift
    that the next PatchMerging's 1x1 conv and batch-statistics BatchNorm
    remove; and that BatchNorm's running mean, which records the shift."""
    mask = torch.zeros(value.shape, dtype=torch.bool)
    parts = name.split(".")
    if name.endswith("attn.qkv.bias"):
        heads = cfg.num_heads[int(parts[1][len("stage")])]
        hd = value.numel() // (3 * heads)
        mask.view(heads, 3, hd)[:, 1] = True  # channel c: (head, slot, dim)
    for s in range(1, len(cfg.depths) - 1):
        if name in (f"backbone.stage{s}_block{cfg.depths[s] - 1}.mlp.fc2.bias",
                    f"backbone.downsample{s}.conv1.bn.running_mean"):
            mask[:] = True
    return mask


def test_finetune_matches_the_jax_finetune(finetuned):
    want, got, variables, _ = finetuned
    assert set(got) == set(want)
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"]) \
        == (0, 3)
    assert got["best_checkpoint"] is want["best_checkpoint"] is None
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    _, tcfg = _tiny_configs()
    init = from_jax_variables(variables)
    refs = tft.split_state(from_jax_variables(jax.tree_util.tree_map(
        np.array, {"params": want["params"],
                   "batch_stats": want["batch_stats"]})))
    for key, ref in zip(("params", "batch_stats"), refs):
        mine = got[key]
        assert set(mine) == set(ref)
        scale = max(float(t.abs().max()) for t in ref.values())
        worst, moved = 0.0, 0.0
        for n, t in ref.items():
            odd = _indeterminate(n, t, tcfg)
            d = (mine[n] - t).abs()
            worst = max(worst, float(d[~odd].max()) if (~odd).any() else 0.0)
            if odd.any() and key == "params":
                for side in (mine[n], t):
                    moved = max(moved, float((side - init[n])[odd].abs()
                                             .max()))
        assert worst <= PARAM_REL * scale, (key, worst, scale)
        # two updates at rate at most lr move an entry at most ~2 lr
        assert moved <= 4e-3, moved
    # the updates moved the weights (the first runs at rate 0)
    assert not torch.equal(got["params"]["head.weight"], init["head.weight"])


def test_finetune_saves_best_and_class_map(finetuned, tmp_path,
                                           monkeypatch):
    _, _, variables, (train, val, class_map) = finetuned
    monkeypatch.setattr(pipeline, "decode_jpeg", pipeline._pil_decode)
    _, tcfg = _tiny_configs()
    cfg = tft.FinetuneConfig(batch_size=4, num_epochs=1, warmup_steps=0)
    ckpt = tmp_path / "run"
    ckpt.mkdir()
    out = tft.finetune(train, val, len(class_map), cfg, tinyvit_config=tcfg,
                       checkpoint_dir=str(ckpt), class_map=class_map,
                       init_state=from_jax_variables(variables),
                       device="cpu")
    assert out["best_checkpoint"] == str(ckpt / "best")
    assert json.loads((ckpt / "class_map.json").read_text()) == class_map
    saved = tft.read_finetune_checkpoint(out["best_checkpoint"])
    assert set(saved) == {"params", "batch_stats"}
    for key in ("params", "batch_stats"):
        assert saved[key].keys() == out[key].keys()
        for n, t in out[key].items():
            assert torch.equal(saved[key][n], t)
    # no full validation batch: NaN, nothing saved
    empty = tmp_path / "empty"
    empty.mkdir()
    out = tft.finetune(train[:8], val[:3], len(class_map), cfg,
                       tinyvit_config=tcfg, checkpoint_dir=str(empty),
                       class_map=class_map, device="cpu")
    assert np.isnan(out["top1"]) and np.isnan(out["top5"])
    assert out["best_checkpoint"] is None and not os.listdir(empty)


@pytest.mark.parametrize("warmup,decay", [(1, 4), (0, 5), (3, 10)])
def test_schedule_and_adamw_match_optax(warmup, decay):
    """``warmup_cosine_decay`` against optax's schedule at every step, and
    three AdamW updates without clipping against ``optax.adamw`` (decay on
    every leaf, the first update at rate ``sched(0)``)."""
    import optax

    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.train.state import AdamW, warmup_cosine_decay

    lr, wd = 5e-3, 0.05
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    got = warmup_cosine_decay(lr, warmup, decay)
    for t in range(decay + 3):
        assert abs(got(t) - float(want(t))) <= 1e-7 * lr, t
    rng = np.random.default_rng(warmup)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    tx = optax.adamw(want, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(tp, OptimizerConfig(learning_rate=lr, weight_decay=wd,
                                    max_grad_norm=None), got)
    for _ in range(3):
        grads = {k: rng.normal(0, 10, v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()})
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_entry_points_refuse_the_cpu_unless_asked(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card")
    _, _, rows = world
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tft.finetune(rows, rows, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tft.extract_embeddings(rows)


def test_extract_embeddings_parquet_matches(finetuned, world, tmp_path,
                                            monkeypatch):
    """From the classifier's variables (the backbone part taken), seven
    rows in batches of 3."""
    _, _, variables, _ = finetuned
    _same_decoder(monkeypatch, jax_pipeline, pipeline)
    rows = world[2][:7]
    jcfg, tcfg = _tiny_configs()
    n = jft.extract_embeddings_parquet(
        pd.DataFrame(rows), str(tmp_path / "jax.parquet"),
        tinyvit_config=jcfg, params=variables["params"],
        batch_stats=variables["batch_stats"], batch_size=3)
    params, stats = tft.split_state(from_jax_variables(variables))
    m = tft.extract_embeddings_parquet(
        rows, str(tmp_path / "port" / "emb.parquet"), tinyvit_config=tcfg,
        params=params, batch_stats=stats, batch_size=3, device="cpu")
    assert n == m == 7
    want = pd.read_parquet(tmp_path / "jax.parquet")
    got = pd.read_parquet(tmp_path / "port" / "emb.parquet")
    assert list(got.columns) == list(want.columns)
    for col in ("location_id", "lat", "lon"):
        assert got[col].tolist() == want[col].tolist()
    a = np.stack(got["embedding"].to_list())
    b = np.stack(want["embedding"].to_list())
    assert a.shape == b.shape == (7, tcfg.embed_dim)
    assert _close(a, b, F32_REL)
    # a bare TinyViT state gives the same embeddings
    bare = {k[len("backbone."):]: v for k, v in {**params, **stats}.items()
            if k.startswith("backbone.")}
    again = tft.extract_embeddings(rows, tcfg, bare, None, 3, device="cpu")
    np.testing.assert_array_equal(again, a.astype(np.float32))


def _manifests(tmp_path, manifest):
    for name, rows in (("train", manifest), ("val", manifest[:3])):
        with open(tmp_path / f"{name}.csv", "w") as f:
            f.write("filepath,country\n")
            for p, c in rows:
                f.write(f'{p},"{c}"\n' if "," in c else f"{p},{c}\n")


@pytest.mark.parametrize("missing", [False, True])
def test_mmpretrain_export_writes_the_jax_files(tmp_path, missing):
    """Without a label map the classes are the sorted train countries; a
    country pandas reads as missing ("NA", an empty field) is "nan", which
    a given label map can name (the JAX export's own class list then
    depends on the pandas version: pandas 3 keeps the missing value and
    cannot sort it)."""
    manifest = [("a/x.jpg", "France"), ("b/y.jpg", "Chile"),
                ("d.jpg", "Bosnia, Herzegovina"), ("e.jpg", "France")]
    givens = [None, {"France": 2, "Chile": 0, "Bosnia, Herzegovina": 1}]
    if missing:
        manifest += [("f.jpg", "NA"), ("g.jpg", "")]
        givens = [{"France": 2, "nan": 3, "Chile": 0,
                   "Bosnia, Herzegovina": 1}]
    _manifests(tmp_path, manifest)
    for given in givens:
        jdir, tdir = tmp_path / "jax", tmp_path / "port"
        want = jft.mmpretrain_export(str(tmp_path / "train.csv"),
                                     str(tmp_path / "val.csv"), str(jdir),
                                     given)
        got = tft.mmpretrain_export(str(tmp_path / "train.csv"),
                                    str(tmp_path / "val.csv"), str(tdir),
                                    given)
        assert got == want
        for name in ("train.json", "val.json", "label_map.json"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()


def test_224_presets_match_field_for_field():
    for name in ("tiny_vit_21m_224", "tiny_vit_5m_224", "tiny_vit_11m_224"):
        want = dataclasses.asdict(getattr(jtv.TinyViTConfig, name)())
        got = dataclasses.asdict(getattr(ttv.TinyViTConfig, name)())
        common = set(want) & set(got) - {"dtype"}
        assert {k: got[k] for k in common} == {k: want[k] for k in common}, \
            name
        assert str(got["dtype"]).split(".")[-1] == \
            jnp.dtype(want["dtype"]).name


def test_5m_224_forward_and_train_step_match():
    """Full widths at depths (1, 1, 1, 1), f32, B=2, 7 classes: every
    window is ragged (N = 49, 196, 49), so each stage runs the plain
    forward and K4's plain backward."""
    jcfg = dataclasses.replace(
        jtv.TinyViTConfig.tiny_vit_5m_224(dtype=jnp.float32),
        depths=(1, 1, 1, 1))
    tcfg = dataclasses.replace(
        ttv.TinyViTConfig.tiny_vit_5m_224(dtype=torch.float32),
        depths=(1, 1, 1, 1))
    classes = 7
    # the port's seeded weights carried to flax (no JAX init to compile)
    port = tft.Classifier(tcfg, classes)
    init_parameters_(port, 3)
    model = _jax_classifier(jcfg, classes)
    variables = to_jax_variables(port.state_dict())
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    labels = np.array([3, 5], np.int32)

    def loss_fn(p):
        logits, _ = model.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                             axis=-1))

    @jax.jit
    def reference(v):  # one compile: the eval logits, the train loss, grad
        return model.apply(v, jnp.asarray(x)), jax.value_and_grad(loss_fn)(
            v["params"])

    want_logits, (want_loss, want_grads) = reference(variables)
    want_g = from_jax_variables(
        {"params": jax.tree_util.tree_map(np.array, want_grads)})

    with torch.no_grad():
        logits = port(torch.from_numpy(x))
    assert _close(logits.numpy(), want_logits, F32_REL)
    params = dict(port.named_parameters())
    loss, _ = tft.finetune_loss(port, torch.from_numpy(x),
                                torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert abs(float(loss.detach()) - float(want_loss)) <= F32_REL * abs(
        float(want_loss))
    assert set(grads) == set(want_g)
    a = torch.cat([grads[n].flatten() for n in want_g]).double()
    b = torch.cat([want_g[n].flatten() for n in want_g]).double()
    cosine = float(a @ b / (a.norm() * b.norm()))
    assert cosine >= MIN_GRAD_COSINE, cosine

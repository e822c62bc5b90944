"""The PyTorch port's CLIP training held against the JAX package on the CPU.

The same numpy-seeded inputs and JAX-made parameters (carried by
``convert.from_jax_variables``) go through both packages at
``CLIPVisionConfig.test_tiny`` widths (D=64, H=2, hd=32, N=17):

* ``CLIPVisionTower(pallas_attention=False)`` (flax's
  MultiHeadDotProductAttention) against the JAX tower, f32 within 1e-5 of
  the largest value, bf16 at cosine >= 0.999;
* ``clip_vision_to_hf`` read back by the JAX ``clip_vision_from_hf``;
* the freeze mask against the JAX ``backbone_freeze_mask`` on the same
  trees, CLIP (``layer{max}`` + ``post_layernorm``) and TinyViT;
* one CLIP SuperGuessr ``train_step`` against the JAX step: the loss
  within 1e-5, the whole gradient at cosine >= 0.9999, ``post_layernorm``
  decayed with a zero gradient, every frozen leaf bitwise unchanged;
* ``train()`` and ``main()`` with the CLIP backbone (the preset cut to
  test_tiny): checkpoints, a bitwise resume, and the run's ``best``
  served by ``ServingEngine(backbone="clip")``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import clip_vit as jcv
from geoguessr_ai_tpu.train import state as jstate

from geoguessr_ai_torch.models import clip_vit as tcv
from geoguessr_ai_torch.models.convert import (
    from_jax_variables,
    to_jax_variables,
)
from geoguessr_ai_torch.train import state as tstate

from test_torch_port_clip import _randomise, _tiny_tower_variables
from test_torch_port_train import _leaves, _records, _tiny_table
from test_torch_port_train_loop import _assert_bitwise, _fixture_sqlite

#: f32: max |port - jax| <= F32_REL * max |jax|.
F32_REL = 1e-5
BF16_COSINE = 0.999
#: The train step: the loss to a relative 1e-5, the whole gradient (every
#: leaf, flattened) at cosine >= GRAD_COSINE.
LOSS_RTOL = 1e-5
GRAD_COSINE = 0.9999
NUM_CELLS = 8


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_attention_tower_matches_flax(dtype):
    """last_hidden_state, the pooled CLS token and the mean-token embedding
    of the tower with pallas_attention=False."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmod = jcv.CLIPVisionTower(jcv.CLIPVisionConfig.test_tiny(
        dtype=jd, pallas_attention=False))
    px = np.random.default_rng(5).normal(0, 1, (2, 56, 56, 3)).astype(
        np.float32)
    variables = _tiny_tower_variables()

    @jax.jit
    def run(variables, x):
        out = jmod.apply(variables, x)
        return (out.last_hidden_state, out.pooler_output,
                jcv.clip_mean_token_embedding(out))

    want = [np.asarray(a, np.float32)
            for a in run(variables, jnp.asarray(px, jd))]
    tower = tcv.CLIPVisionTower(tcv.CLIPVisionConfig.test_tiny(
        dtype=td, pallas_attention=False))
    tower.load_state_dict(from_jax_variables(variables), strict=True)
    calls = []
    real = tcv.ca.clip_attention
    tcv.ca.clip_attention = lambda *a: (calls.append(1), real(*a))[1]
    try:
        with torch.no_grad():
            out = tower(torch.from_numpy(px).to(td))
    finally:
        tcv.ca.clip_attention = real
    assert calls == []  # the fused op is not on this path
    got = [out.last_hidden_state, out.pooler_output,
           tcv.clip_mean_token_embedding(out)]
    assert got[0].dtype == td
    for g, w in zip(got, want):
        g = g.float().numpy()
        if dtype == "f32":
            assert np.abs(g - w).max() <= F32_REL * np.abs(w).max()
        else:
            assert _cos(g, w) >= BF16_COSINE


@pytest.mark.parametrize("prefix", ["vision_model.", ""])
def test_clip_tower_exports_to_the_hf_layout(prefix):
    """``clip_vision_to_hf`` of a flax CLIP tree (a tower trained here, in
    flax layout through ``to_jax_variables``), read back by the JAX
    package's ``clip_vision_from_hf``, gives the same tree leaf by leaf;
    HF's key names and (out, in) layouts."""
    from geoguessr_ai_tpu.models.torch_convert import (
        clip_vision_from_hf as jax_from_hf,
    )

    from geoguessr_ai_torch.models.torch_convert import clip_vision_to_hf

    variables = _tiny_tower_variables()
    cfg = tcv.CLIPVisionConfig.test_tiny()
    sd = clip_vision_to_hf(variables["params"], cfg, prefix=prefix)
    assert sd[f"{prefix}encoder.layers.1.self_attn.out_proj.weight"].shape \
        == (64, 64)
    assert sd[f"{prefix}embeddings.patch_embedding.weight"].shape == (
        64, 3, 14, 14)
    back = jax_from_hf(sd, jcv.CLIPVisionConfig.test_tiny())
    want = _leaves(variables["params"])
    got = _leaves(back)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The freeze rule
# ---------------------------------------------------------------------------


def _jax_clip_model(dtype=jnp.float32, **fields):
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr

    class ClipEmbed(jcv.CLIPVisionTower):
        """The JAX coordinator's ``_ClipEmbed`` for any config."""

        def __call__(self, pixel_values, train: bool = False):
            return jcv.clip_mean_token_embedding(
                super().__call__(pixel_values))

    cfg = jcv.CLIPVisionConfig.test_tiny(dtype=dtype, **fields)
    return JaxSuperGuessr(num_cells=NUM_CELLS, backbone=ClipEmbed(cfg),
                          panorama=True, embed_dim=cfg.hidden_size,
                          dtype=dtype)


def _port_clip_model(dtype=torch.float32, **fields):
    from geoguessr_ai_torch.models.super_guessr import SuperGuessr

    cfg = tcv.CLIPVisionConfig.test_tiny(dtype=dtype, **fields)
    return SuperGuessr(NUM_CELLS, tcv.CLIPEmbed(cfg), embed_dim=64)


def _jax_tinyvit_pair():
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models import TinyViTConfig as JaxConfig

    from geoguessr_ai_torch.models.super_guessr import SuperGuessr
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    jcfg = JaxConfig.test_tiny(dtype=jnp.float32)
    jm = JaxSuperGuessr(num_cells=NUM_CELLS, backbone=JaxTinyViT(jcfg),
                        panorama=True, embed_dim=jcfg.embed_dim)
    shared = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TinyViTConfig) if f.name != "dtype"}
    pm = SuperGuessr(NUM_CELLS, TinyViT(TinyViTConfig(dtype=torch.float32,
                                                      **shared)),
                     embed_dim=jcfg.embed_dim)
    return jm, pm, jcfg.image_size


@pytest.mark.parametrize("policy", ["last_stage", "base", "none"])
@pytest.mark.parametrize("backbone", ["clip", "tinyvit"])
def test_freeze_mask_matches_jax(backbone, policy):
    """The port's mask over the state dict's names, carried into the flax
    tree, equals the JAX mask over the flax tree, leaf by leaf."""
    if backbone == "clip":
        jm, pm, size = _jax_clip_model(), _port_clip_model(), 56
    else:
        jm, pm, size = _jax_tinyvit_pair()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, size, size, 3)))
    kw = dict(freeze_base=policy == "base",
              freeze_all_but_last_stage=policy == "last_stage")
    want = _leaves(jstate.backbone_freeze_mask(shapes["params"], **kw))
    params = dict(pm.named_parameters())
    mask = tstate.backbone_freeze_mask(params, **kw)
    tree = to_jax_variables({n: torch.full(p.shape, float(mask[n]))
                             for n, p in params.items()}, num_heads=2)
    got = {k: bool(v.flat[0]) for k, v in _leaves(tree["params"]).items()}
    assert got == {k: bool(v) for k, v in want.items()}
    if backbone == "clip" and policy == "last_stage":
        kept = {n.split(".")[1] for n, m in mask.items()
                if m and n.startswith("backbone.")}
        assert kept == {"layer1", "post_layernorm"}
        assert tstate.last_stage_prefixes(
            [f"layer{i}" for i in range(24)] + ["pre_layrnorm"]) == (
                "layer23", "post_layernorm")


# ---------------------------------------------------------------------------
# One CLIP train step against the JAX train_step
# ---------------------------------------------------------------------------


def _step_inputs(B=2, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 4, 56, 56, 3)).astype(np.float32)
    coords = np.stack([rng.uniform(-170, 170, B), rng.uniform(-60, 60, B)],
                      -1).astype(np.float32)
    cells = np.stack([rng.uniform(-170, 170, NUM_CELLS),
                      rng.uniform(-60, 60, NUM_CELLS)], -1).astype(np.float32)
    return x, coords, cells


#: The step runs at eps=1 and lr=0.1 (as the TinyViT step test does), so
#: that each update is a smooth function of its gradient.
OPT = dict(learning_rate=0.1, eps=1.0)


def _jax_clip_step(jm, variables, x, coords, cells):
    from geoguessr_ai_tpu.config import OptimizerConfig as JaxOptCfg
    from geoguessr_ai_tpu.train import steps as jsteps

    mask = jstate.backbone_freeze_mask(variables["params"],
                                       freeze_all_but_last_stage=True)
    tx, _ = jstate.make_optimizer(JaxOptCfg(**OPT), 10, mask)
    captured = {}

    class Capture(jstate.TrainState):
        def apply_gradients(self, *, grads, **kw):
            captured["grads"] = grads
            return super().apply_gradients(grads=grads, **kw)

    js = Capture.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                        batch_stats={}, dropout_rng=jax.random.PRNGKey(0))

    def step(s, batch, c):
        new, metrics = jsteps.train_step(s, batch, c)
        return new.params, metrics, captured["grads"]

    return jax.jit(step)(js, {"pixel_values": jnp.asarray(x),
                              "coords": jnp.asarray(coords)},
                         jnp.asarray(cells))


def test_clip_train_step_matches_jax_train_step():
    """Loss and metrics, the whole gradient, each updated leaf against the
    JAX update, the frozen leaves bitwise unchanged and post_layernorm
    decayed under a zero gradient (the mean-token embedding never reads
    it), in f32 with the default freeze (layer1 + post_layernorm)."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.train import steps as tsteps

    jm = _jax_clip_model()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 56, 56, 3)))
    variables = _randomise(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), 21)
    x, coords, cells = _step_inputs()
    jparams, jmet, jgrads = _jax_clip_step(jm, variables, x, coords, cells)

    pm = _port_clip_model()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    names = [n for n, _ in pm.named_parameters()]
    state = tstate.create_train_state(
        pm, OptimizerConfig(**OPT), 10,
        trainable_mask=tstate.backbone_freeze_mask(
            names, freeze_all_but_last_stage=True))
    grads = {}
    real = state.optimizer.step
    state.optimizer.step = lambda p, g: (grads.update(g), real(p, g))[1]
    state, met = tsteps.train_step(
        state, {"pixel_values": torch.from_numpy(x),
                "coords": torch.from_numpy(coords)},
        torch.from_numpy(cells))

    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    for key in ("grad_norm", "param_norm", "top1", "mean_km"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-4, err_msg=key)
    pg = _leaves(to_jax_variables(grads, num_heads=2)["params"])
    jg = _leaves(jgrads)
    assert pg.keys() == jg.keys()
    keys = sorted(jg)
    assert _cos(np.concatenate([pg[k].ravel() for k in keys]),
                np.concatenate([np.ravel(jg[k]) for k in keys])) \
        >= GRAD_COSINE
    new = _leaves(to_jax_variables(pm.state_dict(), num_heads=2)["params"])
    init, want = _leaves(variables["params"]), _leaves(jparams)
    mask = _leaves(jstate.backbone_freeze_mask(
        variables["params"], freeze_all_but_last_stage=True))
    for k in keys:
        if not mask[k]:
            np.testing.assert_array_equal(new[k], init[k], err_msg=k)
            np.testing.assert_array_equal(want[k], init[k], err_msg=k)
            continue
        delta, want_delta = new[k] - init[k], want[k] - init[k]
        assert np.abs(delta).max() > 0, k
        np.testing.assert_allclose(delta, want_delta, rtol=1e-3,
                                   atol=1e-6, err_msg=k)
        if "post_layernorm" in k:
            assert not pg[k].any() and not np.asarray(jg[k]).any()
            # decay alone: p - lr * wd * p
            np.testing.assert_allclose(new[k], init[k] * (1 - 0.1 * 0.01),
                                       rtol=1e-6)
    assert any("post_layernorm" in k for k in keys)


# ---------------------------------------------------------------------------
# train() and main() with the CLIP backbone
# ---------------------------------------------------------------------------


def _tiny_clip_preset(monkeypatch):
    """CLIP's "clip" preset cut to test_tiny (f32), for train()."""
    monkeypatch.setattr(tcv.CLIPVisionConfig, "vit_l_14_336", staticmethod(
        lambda **kw: tcv.CLIPVisionConfig.test_tiny(
            **dict(kw, dtype=torch.float32))))


def _clip_cfg(**changes):
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    return TrainConfig(**{
        "seed": 0, "batch_size": 2, "num_epochs": 2, "eval_every_steps": 0,
        "log_every_steps": 1, "keep_last_n": 1, "decode_threads": 2,
        "optimizer": OptimizerConfig(learning_rate=1e-2),
        "model": ModelConfig(backbone=dataclasses.replace(
            BackboneConfig.clip(), image_size=56, embed_dim=64)),
        **changes})


class _Losses:
    def __init__(self):
        self.losses = []

    def log(self, metrics, step):
        if "train/loss" in metrics:
            self.losses.append(float(metrics["train/loss"]))

    def summary(self, key, value):
        pass

    def finish(self):
        pass


def test_train_with_a_clip_backbone_checkpoints_resumes_and_serves(
        fixtures_dir, monkeypatch, tmp_path):
    """Two epochs straight against one epoch and a resume from ``last``:
    the second epoch's losses and every tensor of the final state bitwise
    equal; only layer{max}, post_layernorm and the head move; the run's
    ``best`` served by the CLIP engine bitwise as the in-memory weights."""
    from geoguessr_ai_torch.inference import fixture_panorama
    from geoguessr_ai_torch.models.super_guessr import init_parameters_
    from geoguessr_ai_torch.serving.engine import ServingEngine
    from geoguessr_ai_torch.train import coordinator
    from geoguessr_ai_torch.train.checkpoints import read_checkpoint

    _tiny_clip_preset(monkeypatch)
    records = _records(fixtures_dir, n=6)
    table = _tiny_table()

    def run(name, **changes):
        rec = _Losses()
        summary = coordinator.train(
            _clip_cfg(**changes), records[:4], records[4:], table,
            checkpoint_dir=str(tmp_path / name), metrics_logger=rec,
            device="cpu")
        return rec.losses, summary

    straight, summary = run("straight")
    assert len(straight) == 4 and np.isfinite(straight).all()
    assert summary["global_step"] == 4 and np.isfinite(summary["val_loss"])
    assert run("resumed", num_epochs=1)[0] == straight[:2]
    assert run("resumed")[0] == straight[2:]
    a = read_checkpoint(str(tmp_path / "straight" / "last"))
    b = read_checkpoint(str(tmp_path / "resumed" / "last"))
    _assert_bitwise(a["state"], b["state"], "state")

    seeded = coordinator.build_model(_clip_cfg(), NUM_CELLS)[0]
    init_parameters_(seeded, 0)
    final = a["state"]["model"]
    kept = {n.split(".")[1] for n, t in final.items()
            if n.startswith("backbone.")
            and not torch.equal(t, seeded.state_dict()[n])}
    assert kept == {"layer1", "post_layernorm"}
    assert set(a["state"]["optimizer"]["mu"]) == {
        n for n in final if not n.startswith("backbone.")
        or n.split(".")[1] in kept}

    cfg = tcv.CLIPVisionConfig.test_tiny(dtype=torch.float32)
    best = read_checkpoint(str(tmp_path / "straight" / "best"))
    served = ServingEngine(backbone="clip", centroid_table=table,
                           device="cpu", backbone_config=cfg,
                           checkpoint=str(tmp_path / "straight" / "best"))
    in_memory = ServingEngine(backbone="clip", centroid_table=table,
                              device="cpu", backbone_config=cfg,
                              state_dict=best["state"]["model"])
    assert served.loaded == {"head": 1, "backbone": True}
    paths = fixture_panorama()
    x, y = served.predict_images(paths), in_memory.predict_images(paths)
    np.testing.assert_array_equal(x.embedding, y.embedding)
    assert (x.lat, x.lon, x.top_ids, x.top_probs) == (
        y.lat, y.lon, y.top_ids, y.top_probs)


def test_main_trains_a_clip_backbone(fixtures_dir, monkeypatch, tmp_path):
    """``main()`` with the CLIP backbone over a fixture SQLite: one epoch,
    checkpoints in CHECKPOINT_DIR."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train import coordinator

    _tiny_clip_preset(monkeypatch)
    db = str(tmp_path / "dataset_sqlite_clip.sqlite")
    _fixture_sqlite(db, fixtures_dir, 6)
    monkeypatch.setenv("DATASET_SQLITE_PATH", db)
    monkeypatch.setattr(C, "CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(C, "CENTROID_TABLE_PATH", str(tmp_path / "t.npz"))
    _tiny_table().save(str(tmp_path / "t.npz"))
    summary = coordinator.main(_clip_cfg(num_epochs=1, val_fraction=1 / 3),
                               device="cpu")
    assert summary["epoch"] == 0 and summary["global_step"] == 2
    assert np.isfinite(summary["val_loss"])
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names[0] == "best" and names[-1] == "last" and len(names) == 3

"""The PyTorch port's CLIP pretraining held against the JAX package on the
CPU.

The same numpy-seeded inputs and JAX-made parameters (carried by
``convert.from_jax_variables``) go through both packages:

* the text tower and the whole ``CLIPModel`` (loss, both logits, both
  embeddings) at ``test_tiny`` widths, f32 within 1e-5 of the largest
  value, bf16 at cosine >= 0.999; EOT pooling where the eos id repeats;
* the BPE tokenizer, whose word scanner uses ``unicodedata`` where the
  JAX one uses the ``regex`` package: ids equal on a battery, the scanner
  equal to the pattern on random strings, ``learn_bpe`` equal;
* the captions (``select_caption`` over 50 seeds, ``enrich_rows``
  against ``enrich_dataframe``) and ``CaptionedBatchIterator``;
* ``make_pretrain_optimizer``'s schedule, ``pretrain_step`` with
  ``grad_accum_steps`` 1 and 2 (the trainable leaves close, every frozen
  leaf bitwise unchanged) and ``pretrain()`` end to end.
"""

import dataclasses
import functools
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import clip_text as jct
from geoguessr_ai_tpu.models import clip_vit as jcv
from geoguessr_ai_tpu.train import captions as jcap
from geoguessr_ai_tpu.train import clip_bpe as jbpe
from geoguessr_ai_tpu.train import pretrain_clip as jpc

from geoguessr_ai_torch.models import clip_text as tct
from geoguessr_ai_torch.models import clip_vit as tcv
from geoguessr_ai_torch.models.convert import (
    from_jax_variables,
    to_jax_variables,
)
from geoguessr_ai_torch.train import captions as tcap
from geoguessr_ai_torch.train import clip_bpe as tbpe
from geoguessr_ai_torch.train import pretrain_clip as tpc

from test_torch_port_clip import _randomise
from test_torch_port_train import _same_decoder

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: f32 outputs: max |port - jax| <= F32_REL * max |jax|.
F32_REL = 1e-5
#: bf16 outputs: the cosine of the port's to JAX's, per tensor.
BF16_COSINE = 0.999
PROJ = 32
T = 16


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _configs(dtype):
    jd, td = DTYPES[dtype]
    return ((jcv.CLIPVisionConfig.test_tiny(dtype=jd),
             jct.CLIPTextConfig.test_tiny(dtype=jd)),
            (tcv.CLIPVisionConfig.test_tiny(dtype=td),
             tct.CLIPTextConfig.test_tiny(dtype=td)))


@functools.lru_cache(maxsize=None)
def _clip_variables():
    """Seeded random values for every leaf of the test_tiny CLIPModel tree
    (its f32 parameters do not depend on the compute dtype)."""
    (jvc, jtc), _ = _configs("f32")
    model = jct.CLIPModel(jvc, jtc, projection_dim=PROJ)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)),
                            jnp.zeros((1, T), jnp.int32))
    return _randomise(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), 3)


def _inputs(B=3, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(0, 1, (B, 56, 56, 3)).astype(np.float32)
    ids = rng.integers(1, 126, (B, T)).astype(np.int32)
    ids[:, 9:] = 127  # eos padding: the largest id repeats
    ids[1, 4:] = 127  # a short caption
    return px, ids


def _port_model(dtype, variables=None):
    _, (tvc, ttc) = _configs(dtype)
    model = tct.CLIPModel(tvc, ttc, projection_dim=PROJ)
    model.load_state_dict(from_jax_variables(variables or _clip_variables()),
                          strict=True)
    return model


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_model_matches_flax(dtype):
    """The text tower's hidden state and pooled output, then CLIPModel's
    loss, logits and embeddings."""
    (jvc, jtc), _ = _configs(dtype)
    jd, td = DTYPES[dtype]
    variables = _clip_variables()
    px, ids = _inputs()
    jm = jct.CLIPModel(jvc, jtc, projection_dim=PROJ)
    want = jax.jit(jm.apply)(variables, jnp.asarray(px, jd),
                             jnp.asarray(ids))
    jtext = jct.CLIPTextTower(jtc)
    want_text = jax.jit(jtext.apply)(
        {"params": variables["params"]["text_model"]}, jnp.asarray(ids))
    model = _port_model(dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(px).to(td),
                    torch.from_numpy(ids).long())
        got_text = model.text_model(torch.from_numpy(ids).long())
    pairs = [(got_text[0], want_text[0]), (got_text[1], want_text[1])]
    pairs += [(getattr(got, k), getattr(want, k)) for k in (
        "logits_per_image", "logits_per_text", "image_embeds",
        "text_embeds")]
    for g, w in pairs:
        assert g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "f32":
            assert np.abs(g - w).max() <= F32_REL * np.abs(w).max()
        else:
            assert _cos(g, w) >= BF16_COSINE
    rel = F32_REL if dtype == "f32" else 1e-2
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=rel)
    np.testing.assert_array_equal(got.logits_per_image.numpy(),
                                  got.logits_per_text.numpy().T)


def test_eot_pooling_takes_the_first_of_repeated_eos():
    """The pooled token is the first position of the largest id (the eos
    that closes the caption), where eos padding repeats it."""
    _, ids = _inputs()
    assert (ids == 127).sum(-1).min() > 1
    model = _port_model("f32")
    with torch.no_grad():
        hidden, pooled = model.text_model(torch.from_numpy(ids).long())
    first = [int(np.argmax(row == 127)) for row in ids]
    assert first == [9, 4, 9]
    for b, t in enumerate(first):
        np.testing.assert_array_equal(pooled[b].numpy(), hidden[b, t].numpy())
    # causality: the pooled state ignores every token after it
    later = ids.copy()
    later[:, 10:] = 5
    later[1, 5:] = 7
    with torch.no_grad():
        _, again = model.text_model(torch.from_numpy(later).long())
    np.testing.assert_array_equal(again.numpy(), pooled.numpy())


def test_plain_attention_matches_flax_mha_with_a_causal_mask():
    """One text layer (flax MultiHeadDotProductAttention under
    make_causal_mask) in f32 and bf16."""
    for dtype in DTYPES:
        jd, td = DTYPES[dtype]
        jtc = jct.CLIPTextConfig.test_tiny(dtype=jd)
        layer = jct.CLIPTextLayer(jtc)
        x = np.random.default_rng(4).normal(0, 1, (2, T, 64)).astype(
            np.float32)
        mask = np.tril(np.ones((T, T), bool))[None, None]
        shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, T, 64)), mask)
        variables = _randomise(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes), 5)
        want = np.asarray(jax.jit(layer.apply)(
            variables, jnp.asarray(x, jd), jnp.asarray(mask)), np.float32)
        port = tcv.CLIPEncoderLayer(tct._layer_config(
            tct.CLIPTextConfig.test_tiny(dtype=td)))
        port.load_state_dict(from_jax_variables(variables), strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x).to(td), td,
                       tct.causal_mask(T)).float().numpy()
        if dtype == "f32":
            assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()
        else:
            assert _cos(got, want) >= BF16_COSINE


def test_convert_carries_the_clip_model_tree_both_ways():
    """from_jax_variables -> to_jax_variables is the identity on the whole
    CLIPModel tree (token embedding, DenseGeneral kernels, projections,
    the scalar logit_scale); heads by tower where they differ."""
    variables = _clip_variables()
    sd = from_jax_variables(variables)
    assert sd["text_model.token_embedding.weight"].shape == (128, 64)
    assert sd["logit_scale"].shape == ()
    assert sd["visual_projection.weight"].shape == (PROJ, 64)
    for heads in (2, {"vision_model": 2, "text_model": 2}):
        back = to_jax_variables(sd, num_heads=heads)
        want = jax.tree_util.tree_flatten_with_path(variables)[0]
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(got) == len(want)
        for path, v in want:
            assert got[path].shape == np.shape(v), path
            np.testing.assert_array_equal(got[path], np.asarray(v))
    with pytest.raises(ValueError, match="num_heads"):
        to_jax_variables(sd, num_heads={"vision_model": 2})


def test_configs_match_the_jax_package():
    from geoguessr_ai_tpu import config as JC

    from geoguessr_ai_torch import config as C

    assert dataclasses.asdict(C.PretrainConfig()) == \
        dataclasses.asdict(JC.PretrainConfig())
    for name in ("vit_l_text", "test_tiny"):
        j, t = getattr(jct.CLIPTextConfig, name)(), \
            getattr(tct.CLIPTextConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name)
    layer = tct._layer_config(tct.CLIPTextConfig())
    assert (layer.hidden_size, layer.num_heads, layer.mlp_dim,
            layer.pallas_attention) == (768, 12, 3072, False)


# ---------------------------------------------------------------------------
# The BPE tokenizer
# ---------------------------------------------------------------------------


def _battery():
    rng = random.Random(7)
    climates = list(tcap.CLIMATE_DICT.values())
    texts = [tcap.select_caption({
        "country": country, "region": "Trøndelag", "town": "Hell",
        "climate_zone": rng.choice(climates),
        "drive_right": rng.random() > 0.5, "month": "December",
        "capture_date": "2019-03"}, rng)
        for country in ("Norway", "United States Of America", "Japan",
                        "Philippines", "Curaçao", "Côte d'Ivoire")
        for _ in range(3)]
    texts += [
        "A Street View photo taken around latitude 63.430, longitude 10.395.",
        "IT'S WE'RE THEY'VE I'M WE'LL HE'D DON'T 'S 'T",
        "it'ſ x'RE'Ll",
        "naïve café señor Zürich ÅÄÖ İstanbul ǅemal",
        "東京 北京市 서울 日本語テキスト",
        "x² + y³ = ½ · ٣ ٤ ¼ Ⅻ 12,345",
        "punctuation!?: yes... (really) #1 100% -- it's fine!!!",
        "<|startoftext|>hi<|endoftext|> !!<|endoftext|>",
        "aͅb  WEIRD   spacing\tand\nnewlines\x1cend",
        "",
        "word " * 200,
    ]
    return texts


@pytest.mark.parametrize("max_length", [77, 16])
def test_bpe_tokenizer_matches_jax(max_length):
    """Ids equal the JAX tokenizer's on the battery (truncation at 16 and
    at 77 keeps the eos; padding is the eos id); decode too."""
    ours = tbpe.load_default_tokenizer(max_length)
    theirs = jbpe.load_default_tokenizer(max_length)
    texts = _battery()
    got, want = ours(texts), theirs(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), max_length)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == ours.eos_id).all()
    for t in texts[:4] + texts[-4:]:
        assert ours.tokenize(t) == theirs.tokenize(t)
        assert ours.decode(ours.encode(t)) == theirs.decode(theirs.encode(t))
    assert tbpe.asset_dir() == jbpe.asset_dir()


def test_word_scanner_matches_the_regex_pattern():
    """find_tokens against the JAX pattern's findall on 3000 random strings
    over letters, numbers, marks, spaces, punctuation, the contractions'
    characters in both cases and the specials."""
    pattern = jbpe._token_pattern()
    rng = random.Random(0)
    alphabet = ("abcXYZ'sStTrReEvVmMlLdD <|>!?.,-²½٣12éÅßſǅİͅ中文\x1c\t\n"
                "ⅠⅡ①")
    for _ in range(3000):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 24)))
        if rng.random() < 0.2:
            s = s + rng.choice(["<|endoftext|>", "<|StartOfText|>"]) + s
        assert tbpe.find_tokens(s) == pattern.findall(s), repr(s)


def test_learn_bpe_matches_jax(tmp_path):
    rng = random.Random(3)
    corpus = [tcap.select_caption({"country": c, "region": r, "month": m},
                                  rng)
              for c in ("Norway", "Japan", "Brazil", "Côte d'Ivoire")
              for r in ("Oslo", "Tōhoku", "São Paulo")
              for m in ("May", "June")]
    corpus += ["x² ½ ٣ it's 東京"]
    want = jbpe.learn_bpe(corpus, num_merges=60)
    got = tbpe.learn_bpe(corpus, num_merges=60)
    assert got == want and len(got[1]) == 60
    assert tbpe.learn_bpe(corpus, num_merges=500) == jbpe.learn_bpe(
        corpus, num_merges=500)
    tbpe.write_assets(*got, str(tmp_path / "port"))
    jbpe.write_assets(*want, str(tmp_path / "jax"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    tok = tbpe.CLIPBPETokenizer(str(tmp_path / "port" / "vocab.json"),
                                str(tmp_path / "port" / "merges.txt"))
    np.testing.assert_array_equal(tok(corpus[:5]), jbpe.CLIPBPETokenizer(
        str(tmp_path / "jax" / "vocab.json"),
        str(tmp_path / "jax" / "merges.txt"))(corpus[:5]))


def test_default_tokenize_fn_and_hash_fallback(tmp_path, monkeypatch):
    texts = ["A Street View photo in Norway.", "", "x y z"]
    assert isinstance(tbpe.default_tokenize_fn(), tbpe.CLIPBPETokenizer)
    monkeypatch.setenv("CLIP_BPE_DIR", str(tmp_path))
    for max_length in (77, 8):
        fn = tbpe.default_tokenize_fn(max_length)
        assert not isinstance(fn, tbpe.CLIPBPETokenizer)
        np.testing.assert_array_equal(
            fn(texts), jbpe.default_tokenize_fn(max_length)(texts))
    np.testing.assert_array_equal(
        tpc.hash_tokenizer(128, 16)(texts), jpc.hash_tokenizer(128, 16)(texts))


# ---------------------------------------------------------------------------
# Captions
# ---------------------------------------------------------------------------


SAMPLES = [
    {"country": "Japan", "region": "Kantō", "town": "Tokyo",
     "climate_zone": jcap.CLIMATE_DICT[14], "drive_right": False,
     "month": "May", "capture_date": "2021-05"},
    {"country": "United States Of America", "region": "Ohio",
     "drive_right": True, "capture_date": "2019-11-02"},
    {"country": "Netherlands", "town": "Delft", "climate_zone": "",
     "drive_right": True, "month": float("nan")},
    {"lat": 59.91391, "lon": 10.75225, "capture_date": "2023-13"},
    {},
]


def test_select_caption_matches_jax_for_50_seeds():
    """Each seed's stream of captions over the samples, and the generator
    left behind, equal the JAX module's (one extra draw would shift every
    later caption)."""
    for seed in range(50):
        a, b = random.Random(seed), random.Random(seed)
        got = [tcap.select_caption(s, a) for s in SAMPLES * 3]
        want = [jcap.select_caption(s, b) for s in SAMPLES * 3]
        assert got == want, seed
        assert a.random() == b.random()
    assert tcap.drives_on_right("Japan") is False
    assert (tcap.MONTHS, tcap.CLIMATE_DICT, tcap.THE_COUNTRIES,
            tcap.LEFT_DRIVE) == (jcap.MONTHS, jcap.CLIMATE_DICT,
                                 jcap.THE_COUNTRIES, jcap.LEFT_DRIVE)


class _Cells:
    """A duck-typed geocell manager."""

    def get_geocell_id(self, point):
        lat, lon = point["latitude"], point["longitude"]
        country = "Japan" if lon > 100 else "Norway" if lat > 50 else "Chile"
        return int(lat + lon) % 7, country, f"r{int(lat)}"


def test_enrich_rows_matches_enrich_dataframe():
    import pandas as pd

    rows = [{"lat": 59.9, "lon": 10.7, "capture_date": "2023-07"},
            {"lat": 35.6, "lon": 139.7, "capture_date": "2019-12-01"},
            {"lat": -33.4, "lon": -70.6, "capture_date": None},
            {"lat": 10.0, "lon": 10.0, "capture_date": "20-x"}]
    for cells in (None, _Cells()):
        got = tcap.enrich_rows(rows, cells)
        want = jcap.enrich_dataframe(pd.DataFrame(rows), cells)
        assert [set(r) for r in got] == [set(want.columns)] * len(rows)
        for r, (_, w) in zip(got, want.iterrows()):
            for k in want.columns:
                if k != "capture_date":
                    assert r[k] == w[k], k
    assert "capture_date" in rows[0] and "month" not in rows[0]
    batch = [{"lat": 1.0, "lon": 2.0, "batch_date": "2020-02"}]
    got = tcap.enrich_rows(batch)
    assert got[0]["month"] == jcap.enrich_dataframe(
        pd.DataFrame(batch))["month"][0] == "February"
    with pytest.raises(NotImplementedError, match="rasterio"):
        tcap.enrich_rows(rows, climate_raster="koppen.tif")


def _caption_rows(fixtures_dir, n):
    with open(os.path.join(fixtures_dir, "heading=000.jpg"), "rb") as f:
        blob = f.read()
    rng = np.random.default_rng(1)
    return [{"image": blob, "lat": float(rng.uniform(-50, 60)),
             "lon": float(rng.uniform(-170, 170)),
             "country": ["Norway", "Japan", "Netherlands"][i % 3],
             "region": "R", "capture_date": f"2020-{1 + i % 12:02d}",
             "drive_right": bool(i % 2)} for i in range(n)]


def test_captioned_batches_match_jax(fixtures_dir, monkeypatch):
    """Pixels and ids of two passes (seed + epoch), the last partial batch
    dropped, with the same decoder on both sides."""
    import pandas as pd

    from geoguessr_ai_tpu.data import pipeline as jax_pipeline

    from geoguessr_ai_torch.data import pipeline

    _same_decoder(monkeypatch, jax_pipeline, pipeline)
    rows = _caption_rows(fixtures_dir, 11)
    tok = tbpe.load_default_tokenizer(T)
    ours = tpc.CaptionedBatchIterator(rows, tok, 4, 32, seed=5)
    theirs = jpc.CaptionedBatchIterator(pd.DataFrame(rows), tok, 4, 32,
                                        seed=5)
    passes = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a["pixel_values"].shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(a["pixel_values"],
                                          b["pixel_values"])
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            assert a["input_ids"].dtype == np.int32
        passes.append(got)
    assert not np.array_equal(passes[0][0]["input_ids"],
                              passes[1][0]["input_ids"])


# ---------------------------------------------------------------------------
# The optimizer and the step
# ---------------------------------------------------------------------------


def _pcfg(k, **kw):
    from geoguessr_ai_tpu.config import PretrainConfig as JaxCfg

    from geoguessr_ai_torch.config import PretrainConfig

    kw = dict(dict(grad_accum_steps=k, learning_rate=1e-2, warmup_ratio=0.2,
                   batch_size=4), **kw)
    return JaxCfg(**kw), PretrainConfig(**kw)


@pytest.mark.parametrize("warmup_ratio", [0.2, 0.0, 1.0])
def test_pretrain_schedule_matches_optax(warmup_ratio):
    jcfg, tcfg = _pcfg(1, warmup_ratio=warmup_ratio, learning_rate=3e-4)
    _, jsched = jpc.make_pretrain_optimizer(jcfg, 10)
    params = {"visual_projection.weight": torch.zeros(2, 2),
              "text_model.x": torch.zeros(2)}
    opt, sched = tpc.make_pretrain_optimizer(tcfg, 10, params)
    assert opt.names == ["visual_projection.weight"]
    for step in range(13):
        assert sched(step) == float(jsched(step)), step


def _jax_pretrain_steps(variables, batches, k):
    jcfg, _ = _pcfg(k)
    (jvc, jtc), _ = _configs("f32")
    model = jct.CLIPModel(jvc, jtc, projection_dim=PROJ)
    tx, _ = jpc.make_pretrain_optimizer(jcfg, 10)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    mask = jpc.trainable_mask(params)
    step = jax.jit(lambda p, o, b: jpc.pretrain_step(p, o, b, model, tx,
                                                     mask))
    opt_state = tx.init(params)
    losses = []
    for px, ids in batches:
        params, opt_state, loss = step(params, opt_state, {
            "pixel_values": jnp.asarray(px), "input_ids": jnp.asarray(ids)})
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params), losses


def _port_pretrain_steps(variables, batches, k):
    _, tcfg = _pcfg(k)
    model = _port_model("f32", variables)
    params = dict(model.named_parameters())
    opt, _ = tpc.make_pretrain_optimizer(tcfg, 10, params)
    mask = tpc.trainable_mask(params)
    losses = [float(tpc.pretrain_step(
        model, opt, {"pixel_values": torch.from_numpy(px),
                     "input_ids": torch.from_numpy(ids).long()}, mask))
        for px, ids in batches]
    return model, opt, losses


@pytest.mark.parametrize("k", [1, 2])
def test_pretrain_step_matches_jax(k):
    """``2 * k`` micro-steps (two updates, the first at the warm-up's lr 0):
    losses, visual_projection within 1e-5, logit_scale within 1e-6, and
    every other leaf bitwise unchanged; STOP_GRAD_FROZEN off gives the
    same bits."""
    variables = _clip_variables()
    batches = [_inputs(B=4, seed=s) for s in range(2 * k)]
    want, jlosses = _jax_pretrain_steps(variables, batches, k)
    model, opt, losses = _port_pretrain_steps(variables, batches, k)
    assert opt.inner.count == 2 and opt.mini_step == 0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = to_jax_variables(model.state_dict(), num_heads=2)["params"]
    init = variables["params"]
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path]
        i = dict(jax.tree_util.tree_flatten_with_path(init)[0])[path]
        name = jax.tree_util.keystr(path)
        if "visual_projection" in name:
            assert np.abs(g - i).max() > 1e-4
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        elif "logit_scale" in name:
            assert g != i
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, i, err_msg=name)
            np.testing.assert_array_equal(w, i, err_msg=name)
    try:
        tpc.STOP_GRAD_FROZEN = False
        again, _, again_losses = _port_pretrain_steps(variables, batches, k)
    finally:
        tpc.STOP_GRAD_FROZEN = True
    assert again_losses == losses
    for (n, a), b in zip(again.state_dict().items(),
                         model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_pretrain_writes_steps_and_last_with_the_vendored_bpe(fixtures_dir,
                                                            tmp_path):
    from geoguessr_ai_torch.config import MeshConfig, PretrainConfig

    tok = tbpe.load_default_tokenizer(T)
    vc = tcv.CLIPVisionConfig.test_tiny(dtype=torch.float32)
    tc = dataclasses.replace(tct.CLIPTextConfig.test_tiny(
        dtype=torch.float32), vocab_size=tok.vocab_size)
    cfg = PretrainConfig(batch_size=4, grad_accum_steps=2, num_epochs=2,
                         learning_rate=1e-2, warmup_ratio=0.0,
                         save_every_steps=2)
    rows = tcap.enrich_rows(_caption_rows(fixtures_dir, 9), _Cells())
    logged = []

    class Probe:
        def log(self, metrics, step):
            logged.append(step)

        def finish(self):
            pass

    out = tpc.pretrain(rows, tok, cfg, vc, tc, metrics_logger=Probe(),
                       checkpoint_dir=str(tmp_path), device="cpu")
    # 9 rows, batches of 4: two micro-steps an epoch, one update an epoch
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert logged == [1]
    assert sorted(os.listdir(tmp_path)) == ["last", "step_0000002",
                                            "step_0000004"]
    last = tpc.read_pretrain_checkpoint(str(tmp_path / "last"))
    assert last.keys() == out["params"].keys()
    init = tct.CLIPModel(vc, tc)
    tpc.init_clip_model_(init, cfg.seed)
    # the first update runs at the schedule's step 0, whose rate is 0
    step2 = tpc.read_pretrain_checkpoint(str(tmp_path / "step_0000002"))
    for n, t in init.state_dict().items():
        torch.testing.assert_close(last[n], out["params"][n], rtol=0, atol=0)
        torch.testing.assert_close(step2[n], t, rtol=0, atol=0)
        moved = not torch.equal(out["params"][n], t)
        assert moved == n.startswith(tpc.TRAINABLE_SUBTREES), n
    # the data axis is ported (tests/test_torch_port_mesh.py): a mesh of
    # two in one process does not cover its one rank
    with pytest.raises(ValueError, match="does not cover 1"):
        tpc.pretrain(rows, tok, PretrainConfig(mesh=MeshConfig(
            data_parallel=2)), vc, tc, device="cpu")

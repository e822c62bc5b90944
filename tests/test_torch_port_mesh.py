"""The port's mesh (geoguessr_ai_torch/parallel/mesh.py) held against the
JAX package's on the CPU.

The pure parts (``host_shard_range``, the mesh's resolution,
``dcn_aware_order``, ``param_spec``) against the JAX functions on the
conftest's forced CPU devices.  Then two gloo ranks, started once for the
module (``ranks``, a ``file://`` rendezvous in a temporary directory, so no
TCP port is taken), run every scenario of tests/torch_mesh_worker.py,
while this process computes the references on the same seeded inputs:

* a dp=2 ``train_step`` (BatchNorm in train mode, smoothed labels; the
  batch's rows differ in mean and scale, so the two halves' statistics
  differ) against the JAX ``make_sharded_steps`` on a dp=2 mesh, with
  grad_accum_steps=2 and with QAT storage too, at the tolerances of the
  JAX package's ``test_dp8_matches_single_device``; a per-rank BatchNorm
  fails them;
* an mp=2 step (the cell layer's shard holds num_cells / 2 rows) against
  the JAX step on ``MeshConfig(data_parallel=1, model_parallel=2)``;
* against the port on one process: DropPath's global masks,
  ``evaluate_model`` (a batch of 3 in shards of 2 and 1), ``pretrain_step``
  (the contrastive logits over both ranks' pairs), ``Embedder(mesh=)``,
  ``build_embedding_sqlite`` (one SQLite) and ``train()`` with a resume;
* a model-axis checkpoint restored keeps its shards.

The new dry-run tool runs by subprocess.
"""

import dataclasses
import os
import pickle
import sqlite3
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_worker as W
from geoguessr_ai_torch.models.convert import to_jax_variables
from geoguessr_ai_torch.parallel import mesh as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

#: test_dp8_matches_single_device's tolerances
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 2.5e-3, 1e-4


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _params_close(port_state, want):
    """Every parameter of a port state dict against the flat leaves of a
    flax params tree at PARAM_ATOL / PARAM_RTOL: (the names that fail, the
    largest gap)."""
    got = _leaves(to_jax_variables(port_state)["params"])
    assert got.keys() == want.keys()
    bad = [k for k in want if not np.allclose(got[k], want[k], rtol=PARAM_RTOL,
                                              atol=PARAM_ATOL)]
    return bad, max(float(np.abs(got[k] - want[k]).max()) for k in want)


#: BatchNorm's running statistics: 0.1 of a batch mean over ~1e5
#: activations of size 1-3, summed in another order (the port's and the
#: JAX one-device step differ by up to 1.7e-7 on these inputs); a
#: per-rank BatchNorm moves them by 1e-2
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def _stats_close(port_state, want):
    """The running statistics that differ from the JAX ones (flat
    leaves)."""
    got = _leaves(to_jax_variables(port_state)["batch_stats"])
    assert got.keys() == want.keys()
    return [k for k in want if not np.allclose(
        got[k], want[k], rtol=STATS_RTOL, atol=STATS_ATOL)]


def _flat(leaves):
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


# ---------------------------------------------------------------------------
# The pure parts against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_host_shard_range_matches_jax(world, monkeypatch):
    from geoguessr_ai_tpu.parallel import mesh as jmesh

    for total in (0, 1, 7, 8, 103, 1100):
        ranges = []
        for rank in range(world):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            want = jmesh.host_shard_range(total)
            assert M.host_shard_range(total, rank, world) == want
            ranges.append(want)
        assert ranges[0][0] == 0 and ranges[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


MESH_CASES = [(dict(), 8), (dict(model_parallel=2), 8),
              (dict(data_parallel=4, model_parallel=2), 8),
              (dict(data_parallel=2), 2), (dict(model_parallel=2), 2),
              (dict(data_parallel=3, model_parallel=2), 8),
              (dict(model_parallel=3), 8), (dict(data_parallel=2), 1)]


@pytest.mark.parametrize("fields,world", MESH_CASES)
def test_mesh_resolution_and_its_error_match_jax(fields, world):
    from geoguessr_ai_tpu.config import MeshConfig as JaxMeshConfig
    from geoguessr_ai_tpu.parallel import mesh as jmesh

    from geoguessr_ai_torch.config import MeshConfig

    devices = jax.devices()[:world]
    try:
        jm = jmesh.create_mesh(JaxMeshConfig(**fields), devices=devices)
    except ValueError:
        with pytest.raises(ValueError, match="does not cover"):
            M.mesh_shape(MeshConfig(**fields), world)
        return
    assert M.mesh_shape(MeshConfig(**fields), world) == (
        jm.shape["data"], jm.shape["model"])


def test_a_mesh_that_does_not_cover_the_ranks_raises():
    """In one process (no group): create_mesh, and train(), pretrain(),
    evaluate_model and the builder through it, raise ValueError for a mesh
    of two."""
    from geoguessr_ai_torch.config import MeshConfig

    assert M.maybe_initialize_distributed("gloo") == 1
    with pytest.raises(ValueError, match="does not cover 1"):
        M.create_mesh(MeshConfig(data_parallel=2), device="cpu")
    with pytest.raises(ValueError, match="does not cover 1"):
        M.mesh_for(MeshConfig(model_parallel=2), "cpu")
    assert M.mesh_for(MeshConfig(), "cpu") is None
    mesh = M.create_mesh(MeshConfig(), device="cpu")
    assert (mesh.dp, mesh.mp, mesh.size) == (1, 1, 1)
    rows = {"x": torch.arange(8)}
    assert M.batch_slice(rows, None) is rows


def test_dcn_aware_order_matches_jax():
    """The cases of the JAX test_dcn_aware_order, a rank's node where JAX
    reads a device's slice_index."""
    from geoguessr_ai_tpu.parallel import mesh as jmesh

    class D:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s

    def both(n, slices, mp):
        jd = [D(i, i % slices) for i in range(n)]
        pd = [M.Rank(i, i % slices) for i in range(n)]
        return jd, pd, mp

    for n, slices, mp in ((8, 2, 2), (4, 1, 2), (8, 2, 1), (8, 2, 4)):
        jd, pd, mp = both(n, slices, mp)
        want = [d.id for d in jmesh.dcn_aware_order(jd, mp)]
        got = [r.rank for r in M.dcn_aware_order(pd, mp)]
        assert got == want, (n, slices, mp)
        rows = [got[i:i + mp] for i in range(0, n, mp)]
        assert all(len({r % slices for r in row}) == 1 for row in rows)
    jd, pd, mp = both(6, 3, 4)
    with pytest.raises(ValueError, match="DCN"):
        jmesh.dcn_aware_order(jd, mp)
    with pytest.raises(ValueError, match="DCN"):
        M.dcn_aware_order(pd, mp)


def test_param_spec_matches_jax_on_every_parameter():
    """Every parameter of a converted test_tiny SuperGuessr: a weight the
    JAX rule shards on flax axis a (of its (in, out) kernel) is sharded on
    torch dim 1 - a; a column-sharded layer's bias is sharded on dim 0
    where the JAX rule replicates it (the port splits that layer's
    compute); everything else is replicated on both."""
    from geoguessr_ai_tpu.config import MeshConfig as JaxMeshConfig
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.parallel import mesh as jmesh

    from geoguessr_ai_torch.models.convert import from_jax_variables

    jcfg = dataclasses.replace(JaxConfig.test_tiny(dtype=jnp.float32),
                               depths=W.DEPTHS)
    jm = JaxSuperGuessr(num_cells=W.NUM_CELLS, backbone=JaxTinyViT(jcfg),
                        panorama=True, embed_dim=jcfg.embed_dim,
                        dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 64, 64, 3)))
    mc = JaxMeshConfig()

    def code(path, leaf):  # 1 + the sharded flax axis, 0 replicated
        spec = tuple(jmesh.param_spec(path, leaf, mc))
        axis = spec.index(mc.model_axis) if mc.model_axis in spec else -1
        return np.full(leaf.shape, axis + 1, np.float32)

    codes = from_jax_variables({"params": jax.tree_util.tree_map_with_path(
        code, shapes["params"])})
    model = W.make_model()
    params = dict(model.named_parameters())
    assert set(codes) == set(params)
    col = set()
    for name, t in params.items():
        axis = int(codes[name].flatten()[0]) - 1
        got = M.param_spec(name, t)
        if name.endswith(".weight") and axis >= 0:
            assert t.ndim == 2 and got == 1 - axis, name
            if got == 0:
                col.add(name[:-len(".weight")])
        elif name.endswith(".bias") and name[:-len(".bias")] in col:
            assert axis == -1 and got == 0, name
        else:
            assert axis == -1 and got is None, name
    assert "cell_layer" in col
    assert M.param_spec("cell_layer.bias", params["cell_layer.bias"]) == 0
    assert M.param_spec("backbone.stage1_block0.attn.proj.bias",
                        params["backbone.stage1_block0.attn.proj.bias"]
                        ) is None
    with pytest.raises(NotImplementedError, match="vision_model"):
        from geoguessr_ai_torch.models.clip_text import CLIPModel

        mesh = M.Mesh(1, 2, 0, 0, 0, None, None, torch.device("cpu"))
        M.shard_module_(CLIPModel(*W.clip_configs(), projection_dim=32),
                        mesh)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------


def _jax_step(kind, path):
    """The JAX sharded step of a STEPS scenario on the port's initial
    weights, pickled to ``path``: the flat leaves of its new params and
    batch_stats, its metrics, the cell layer's local column count.  Runs
    in a process of its own (``_jax_steps``)."""
    from geoguessr_ai_tpu.config import MeshConfig as JaxMeshConfig
    from geoguessr_ai_tpu.config import OptimizerConfig as JaxOptCfg
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.models.tinyvit import TRAIN_QUANT_SITES
    from geoguessr_ai_tpu.parallel import mesh as jmesh
    from geoguessr_ai_tpu.train.state import create_train_state
    from geoguessr_ai_tpu.train.steps import make_sharded_steps

    dp, mp, k, what = W.STEPS[kind]
    fields = {}
    if what.get("qat"):
        fields = dict(quant_mode="static", quant_sites=TRAIN_QUANT_SITES)
    jcfg = dataclasses.replace(JaxConfig.test_tiny(dtype=jnp.float32),
                               depths=W.DEPTHS, **fields)
    jm = JaxSuperGuessr(num_cells=W.NUM_CELLS, backbone=JaxTinyViT(jcfg),
                        panorama=True, embed_dim=jcfg.embed_dim,
                        dtype=jnp.float32)
    variables = to_jax_variables(W.make_model(what.get("qat", False))
                                 .state_dict())
    mc = JaxMeshConfig(data_parallel=dp, model_parallel=mp)
    mesh = jmesh.create_mesh(mc, devices=jax.devices()[:dp * mp])
    variables = jmesh.put_variables(variables, mesh, mc)
    state = create_train_state(jm, variables,
                               JaxOptCfg(learning_rate=W.LEARNING_RATE), 10)
    if what.get("qat"):
        assert "act_scales" in state.extra_variables
    jit_train, _ = make_sharded_steps(mesh, mc, grad_accum_steps=k)
    batch, cells = W.step_inputs()
    batch = jax.device_put(batch, jmesh.batch_sharding(mesh, mc))
    state, metrics = jit_train(state, batch, jnp.asarray(cells))
    k = state.params["cell_layer"]["kernel"]
    with open(path, "wb") as f:
        pickle.dump({"params": _leaves(state.params),
                     "batch_stats": _leaves(state.batch_stats),
                     "metrics": {n: float(v) for n, v in metrics.items()},
                     "cell_shard": k.sharding.shard_shape(k.shape)[-1]}, f)


JAX_KINDS = ("dp", "dp_accum", "dp_qat", "mp")


def _jax_steps(out, env):
    """Starts one process a JAX reference step (their tracing holds the
    GIL: one process runs them one after the other); returns a function
    that waits for them and loads their results."""
    code = ("import sys; sys.path[:0] = [{here!r}]; import conftest; "
            "import test_torch_port_mesh as T; T._jax_step({kind!r}, {path!r})")
    paths = {k: os.path.join(out, f"jax_{k}.pkl") for k in JAX_KINDS}
    env = dict(env, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(here=HERE, kind=k, path=paths[k])],
        cwd=REPO, env=env) for k in JAX_KINDS]

    def results():
        codes = [p.wait(timeout=300) for p in procs]
        assert not any(codes), codes
        out = {}
        for k, path in paths.items():
            with open(path, "rb") as f:
                out[k] = pickle.load(f)
        return out

    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks, the JAX reference steps and the dry-run tool,
    computes the one-process references meanwhile, and returns (the ranks'
    results, the references, the output directory)."""
    out = str(tmp_path_factory.mktemp("mesh"))
    W.write_embed_source(os.path.join(out, "embed_src.sqlite"))
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    failed = []

    def run_ranks():
        try:
            M.spawn_ranks(W.main, 2,
                          f"file://{os.path.join(out, 'rendezvous')}", [out],
                          timeout=240)
        except Exception as e:  # a rank's error, shown by the assert below
            failed.append(e)

    jax_results = _jax_steps(out, env)
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "geoguessr_ai_torch.tools.multihost_dryrun"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    t = threading.Thread(target=run_ranks)
    t.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks and the JAX steps run meanwhile
    refs = {"drop_path": W.run_step("dp_drop_path"),
            "mp_odd_cells": W.run_step("mp_odd_cells"), "eval": W.run_eval(),
            "pretrain": W.run_pretrain(),
            "embedder_call": W.run_embedder_call(),
            "embed_written": W.run_embed(
                os.path.join(out, "embed_src.sqlite"),
                os.path.join(out, "embed_one.sqlite")),
            "train": W.run_train(os.path.join(out, "train_one"), 2)}
    torch.set_num_threads(threads)
    refs["jax"] = jax_results()
    refs["dryrun"] = dryrun.communicate(timeout=300) + (dryrun.returncode,)
    t.join()
    assert not failed, failed
    results = [torch.load(os.path.join(out, f"rank{r}.pt"),
                          weights_only=False) for r in (0, 1)]
    return results, refs, out


@pytest.mark.parametrize("kind", ["dp", "dp_accum", "dp_qat"])
def test_dp2_train_step_matches_the_jax_dp2_step(ranks, kind):
    """Loss, grad_norm and every updated parameter at the JAX dp=8 test's
    tolerances; BatchNorm's running statistics (the global batch's)
    against JAX's and bitwise equal on both ranks.

    QAT storage makes the step discontinuous (an activation on the other
    side of an int8 rounding boundary moves by a whole step; see
    test_qat_storage_train_step_matches_jax_train_step), and the global
    batch statistics summed in another order than XLA's move activations
    across such boundaries.  So the QAT case holds the loss and grad_norm
    within 5e-3 and the running statistics within 1e-3 in L2 norm, and
    every parameter at the dp=8 test's tolerance (which takes a flipped
    Adam sign)."""
    results, refs, _ = ranks
    ref = refs["jax"][kind]
    jmet = ref["metrics"]
    a, b = results[0][kind]["bn"], results[1][kind]["bn"]
    assert all(torch.equal(a[n], b[n]) for n in a)
    if kind == "dp_qat":
        for r in results:
            got = r[kind]
            new = to_jax_variables(got["state"])
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][key],
                                           jmet[key], rtol=5e-3)
            bad, gap = _params_close(got["state"], ref["params"])
            assert not bad, (bad, gap)
            stats = _flat(_leaves(new["batch_stats"]))
            want_stats = _flat(ref["batch_stats"])
            assert (np.linalg.norm(stats - want_stats)
                    <= 1e-3 * np.linalg.norm(want_stats))
        return
    for r in results:
        got = r[kind]
        np.testing.assert_allclose(got["metrics"]["loss"], jmet["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   jmet["grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
        bad, gap = _params_close(got["state"], ref["params"])
        assert not bad, (bad, gap)
        assert not _stats_close(got["state"], ref["batch_stats"])


def test_a_per_rank_batch_norm_fails_the_dp2_comparison(ranks):
    """The halves of the batch have different statistics: BatchNorm over
    each rank's rows alone gives each rank other running statistics and
    moves the step away from the JAX one."""
    results, refs, _ = ranks
    ref = refs["jax"]["dp"]
    jmet = ref["metrics"]
    a, b = (r["dp_per_rank_bn"] for r in results)
    assert not all(torch.equal(a["bn"][n], b["bn"][n]) for n in a["bn"])
    assert _stats_close(a["state"], ref["batch_stats"])
    rel = abs(a["metrics"]["loss"] - jmet["loss"]) / jmet["loss"]
    assert rel > 10 * LOSS_RTOL


def test_mp2_train_step_shards_the_cell_layer_and_matches_jax(ranks):
    results, refs, _ = ranks
    ref = refs["jax"]["mp"]
    jmet = ref["metrics"]
    assert ref["cell_shard"] == W.NUM_CELLS // 2
    for r in results:
        got = r["mp"]
        assert got["cell_layer_local"] == (W.NUM_CELLS // 2, 80)
        np.testing.assert_allclose(got["metrics"]["loss"], jmet["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   jmet["grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
        np.testing.assert_allclose(got["metrics"]["param_norm"],
                                   jmet["param_norm"], rtol=1e-5)
        bad, gap = _params_close(got["state"], ref["params"])
        assert not bad, (bad, gap)
    a, b = (r["mp"]["state"] for r in results)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_mp2_splits_an_odd_cell_count_into_padded_shards(ranks):
    """31 cells over two ranks (which the JAX mesh refuses: its shards
    must be equal; the repo's table has 12647): shards of 16 rows, the
    last padded with zeros, and the one-process step."""
    results, refs, _ = ranks
    want = refs["mp_odd_cells"]
    for r in results:
        got = r["mp_odd_cells"]
        assert got["cell_layer_local"] == (16, 80)
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
        assert got["state"]["cell_layer.weight"].shape == (31, 80)
        for n, t in want["state"].items():
            torch.testing.assert_close(got["state"][n], t, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


def test_mp2_checkpoint_restore_keeps_the_shards(ranks):
    results, _, _ = ranks
    for r in results:
        assert r["mp_restore"] == {"local": (W.NUM_CELLS // 2, 80),
                                   "equal": True}


def test_dp2_drop_path_draws_the_global_batch_masks(ranks):
    """DropPath at rate 0.3: each rank keeps its rows of the one-process
    masks, so the step equals the one-process step."""
    results, refs, _ = ranks
    want = refs["drop_path"]
    for r in results:
        got = r["dp_drop_path"]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=LOSS_RTOL)
        for n, t in want["state"].items():
            torch.testing.assert_close(got["state"][n], t, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


def test_evaluate_model_on_two_ranks_equals_one_process(ranks):
    """Batches of 3 over two data ranks (shards of 2 and 1) and on a model
    axis: the one-process metrics, the whole-set median included."""
    results, refs, _ = ranks
    want = refs["eval"]
    assert set(want) == {"loss", "top1", "top5", "mean_km", "median_km",
                         "score"}
    for r in results:
        for key in ("eval", "eval_mp"):
            assert set(r[key]) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(r[key][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{key} {k}")


def test_dp2_pretrain_step_takes_the_global_contrastive_loss(ranks):
    """Three pretrain_steps of a global batch of 4 on two ranks: the
    one-process losses (each rank's logits matrix spans both ranks' pairs)
    and trainable parameters."""
    results, refs, _ = ranks
    want = refs["pretrain"]
    for r in results:
        np.testing.assert_allclose(r["pretrain"]["losses"], want["losses"],
                                   rtol=1e-5)
        assert r["pretrain"]["params"].keys() == want["params"].keys()
        for n, t in want["params"].items():
            torch.testing.assert_close(r["pretrain"]["params"][n], t,
                                       rtol=1e-5, atol=1e-6)
    # the first update runs at rate 0; the later ones move the projection
    assert not torch.equal(want["params"]["visual_projection.weight"],
                           W.run_pretrain(steps=1)["params"][
                               "visual_projection.weight"])


def test_dp2_embedder_and_build_embedding_sqlite_equal_one_process(ranks):
    """``Embedder(mesh=)`` returns every rank's rows; the dp=2 build writes
    one SQLite (rank 0) with the one-process rows, embeddings to 1e-5."""
    results, refs, out = ranks
    for r in results:
        np.testing.assert_allclose(r["embedder_call"], refs["embedder_call"],
                                   atol=1e-5, rtol=1e-5)
        assert r["embed_written"] == refs["embed_written"] == W.EMBED_ROWS

    def rows(name):
        with sqlite3.connect(os.path.join(out, name)) as c:
            return {(loc, h): np.frombuffer(e, np.float32) for loc, h, e in
                    c.execute("SELECT location_id, heading, embedding "
                              "FROM samples")}

    got, want = rows("embed_dp2.sqlite"), rows("embed_one.sqlite")
    assert got.keys() == want.keys() and len(got) == W.EMBED_ROWS
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, atol=1e-5, rtol=1e-5)


def test_train_with_a_resume_on_two_ranks_equals_one_process(ranks):
    """train() for two epochs on two ranks, and for one epoch then resumed
    for the second: the same checkpoint bit for bit; the summary of one
    process's run (the batch statistics and every metric global)."""
    results, refs, _ = ranks
    want_summary, want_state = refs["train"]
    for r in results:
        summary, state = r["train"]
        resumed_summary, resumed = r["train_resumed"]
        assert state.keys() == resumed.keys() == want_state.keys()
        assert all(torch.equal(state[n], resumed[n]) for n in state)
        timeless = {k for k in summary if not k.endswith("time_s")}
        assert {k: resumed_summary[k] for k in timeless} == {
            k: summary[k] for k in timeless}
        for k in ("val_loss", "val_top5", "val_median_km", "epoch/loss",
                  "global_step", "best_value"):
            np.testing.assert_allclose(summary[k], want_summary[k],
                                       rtol=1e-5, err_msg=k)


def test_train_returns_on_every_rank_after_rank_0s_last_write(ranks):
    """train() with async checkpoints, rank 0's write held back a second:
    neither rank returns before ``last`` and ``best`` hold their file (the
    barrier at train()'s end waits for rank 0's write)."""
    results, _, _ = ranks
    for r in results:
        assert r["train_slow_write"] == {"last": True, "best": True}


def test_multihost_dryrun_tool_passes(ranks):
    """``python -m geoguessr_ai_torch.tools.multihost_dryrun``, started by
    the fixture beside the ranks."""
    stdout, stderr, code = ranks[1]["dryrun"]
    assert code == 0, stderr[-3000:]
    assert "MULTIHOST DRYRUN OK" in stdout
    assert stdout.count("all multi-host checks passed") == 2

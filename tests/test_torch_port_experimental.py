"""The port's experimental kernels' plain versions held against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

K12a / K12b (``ops/experimental/fused_mbconv.py``) against
``fused_mbconv`` / ``fused_mbconv_v2`` under
``pltpu.force_tpu_interpret_mode()``, as tests/test_experimental_kernels.py
runs them, and the unfused ``xla_mbconv`` of both packages; K13
(``ops/experimental/tiled_gemm.py``) against the tool's ``pallas_matmul``,
taken from tools/exp_int8_pallas.py's syntax tree (it is nested in the
tool's ``main()``) without editing the tool; K14
(``ops/experimental/smem_probe.py``) against tools/exp_r4_vmem.py's
``probe`` and its kernel ``kern`` in interpret mode, and the port's tool
against the JAX tool's cases.  Inputs come from numpy seeds.
"""

import ast
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from geoguessr_ai_tpu.ops.experimental import fused_mbconv as JM

from geoguessr_ai_torch.ops.experimental import fused_mbconv as TM
from geoguessr_ai_torch.ops.experimental import smem_probe as SP
from geoguessr_ai_torch.ops.experimental import tiled_gemm as TG
from geoguessr_ai_torch.tools import exp_r4_vmem as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (B, H, W, C), E: W + 2 = 26 is not a multiple of the Pallas kernel's 8.
SHAPE, E = (2, 32, 24, 96), 384


def _mbconv_args(seed=0):
    """x, w1, b1, wdw, b2, w3, b3 as f32 numpy, normal * 0.3."""
    rng = np.random.default_rng(seed)
    B, H, W, C = SHAPE
    shapes = [(B, H, W, C), (C, E), (E,), (3, 3, E), (E,), (E, C), (C,)]
    arrs = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]
    return arrs


def _both(arrs, low):
    """The same values as (jax arrays, torch tensors); with ``low``, x and
    the 1x1 weights in bf16, the taps and biases f32."""
    low_idx = (0, 1, 5) if low else ()
    j = [jnp.asarray(a, jnp.bfloat16 if i in low_idx else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(torch.bfloat16 if i in low_idx
                                else torch.float32)
         for i, a in enumerate(arrs)]
    return j, t


#: The bf16 comparisons count ulps at each element's magnitude, floored at
#: 0.5 (the outputs' scale is ~1): GELU's negative tail turns a one-ulp
#: flip of a hidden value upstream into many ulps of a near-zero output.
ULP_FLOOR = 0.5


def _ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude (at least
    ULP_FLOOR)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), ULP_FLOOR)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(got - want) / ulp


@pytest.fixture(scope="module")
def pallas_outputs():
    """fused_mbconv and fused_mbconv_v2 in interpret mode, f32 and bf16."""
    out = {}
    for low in (False, True):
        j, _ = _both(_mbconv_args(), low)
        with pltpu.force_tpu_interpret_mode():
            out[low] = (np.asarray(JM.fused_mbconv(*j).astype(jnp.float32)),
                        np.asarray(JM.fused_mbconv_v2(*j).astype(jnp.float32)))
    return out


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16"])
def test_fused_mbconv_plain_matches_the_pallas_kernels(pallas_outputs, low):
    """The plain mirror against K12a's and K12b's Pallas kernels: f32
    within 1e-5, bf16 within one bf16 ulp (``_ulps``)."""
    _, t = _both(_mbconv_args(), low)
    got = TM.fused_mbconv(*t)
    assert torch.equal(got, TM.fused_mbconv_v2(*t))  # one plain version
    got = got.float().numpy()
    for want in pallas_outputs[low]:
        if low:
            assert _ulps(got, want).max() <= 1.0
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(*pallas_outputs[low])  # v1 == v2


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16"])
def test_xla_mbconv_matches_the_jax_reference(low):
    j, t = _both(_mbconv_args(seed=1), low)
    want = np.asarray(JM.xla_mbconv(*j).astype(jnp.float32))
    got = TM.xla_mbconv(*t).float().numpy()
    if low:
        assert _ulps(got, want).max() <= 1.0
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_gap_between_the_kernel_and_the_unfused_reference():
    """The kernels keep the taps f32 and the depthwise sum unrounded, the
    unfused reference rounds both to bf16: in bf16 the two differ (max
    0.0625 at this shape and seed), in f32 they agree."""
    _, t = _both(_mbconv_args(), True)
    gap = (TM.fused_mbconv(*t).float() - TM.xla_mbconv(*t).float()).abs()
    assert 0.0 < float(gap.max()) <= 0.125
    _, t32 = _both(_mbconv_args(), False)
    np.testing.assert_allclose(TM.fused_mbconv(*t32).numpy(),
                               TM.xla_mbconv(*t32).numpy(), atol=1e-5,
                               rtol=1e-4)


def test_fused_mbconv_refuses_rows_off_the_strip():
    _, t = _both(_mbconv_args(), False)
    t[0] = t[0][:, :24]
    for fn in (TM.fused_mbconv, TM.fused_mbconv_v2):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(*t)
    assert TM.LAUNCHES == {"_fused_mbconv_cuda": 0,
                           "_fused_mbconv_v2_cuda": 0}


def _pallas_matmul():
    """The tool's nested ``matmul_kernel`` and ``pallas_matmul``, compiled
    from its syntax tree into a namespace of jax, jnp, pl, pltpu and
    functools."""
    path = os.path.join(REPO, "tools", "exp_int8_pallas.py")
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef)
            and n.name in ("matmul_kernel", "pallas_matmul")]
    assert len(defs) == 2
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu,
          "functools": functools}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns["pallas_matmul"]


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_tiled_matmul_plain_matches_the_pallas_gemm(kind):
    """K13's plain version against ``pallas_matmul`` in interpret mode at
    (256, 384, 256) with 128 x 128 blocks: int8 -> int32 equal (and equal
    to an int64 product), bf16 -> f32 within 2e-5 of its scale."""
    pallas_matmul = _pallas_matmul()
    rng = np.random.default_rng(2)
    M, K, N = 256, 384, 256
    if kind == "int8":
        a = rng.integers(-127, 128, (M, K), dtype=np.int8)
        b = rng.integers(-127, 128, (K, N), dtype=np.int8)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                                            128, 128, jnp.int32))
        got = TG.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              torch.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      a.astype(np.int64) @ b.astype(np.int64))
    else:
        a = rng.normal(size=(M, K)).astype(np.float32)
        b = rng.normal(size=(K, N)).astype(np.float32)
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pallas_matmul(ja, jb, 128, 128, jnp.float32))
        ta = torch.from_numpy(a).bfloat16()
        tb = torch.from_numpy(b).bfloat16()
        got = TG.tiled_matmul(ta, tb, torch.float32)
        assert got.dtype == torch.float32
        exact = ta.double().numpy() @ tb.double().numpy()
        scale = np.abs(exact).max()
        assert np.abs(got.numpy() - want).max() <= 2e-5 * scale
        assert np.abs(got.numpy() - exact).max() <= 2e-5 * scale


def test_tiled_matmul_refuses_mixed_or_wrong_types():
    a8 = torch.zeros(128, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        TG.tiled_matmul(a8, a8.t().contiguous(), torch.float32)
    with pytest.raises(ValueError, match="both"):
        TG.tiled_matmul(a8, torch.zeros(64, 128), torch.int32)
    with pytest.raises(ValueError, match="a \\(M, K\\)"):
        TG.tiled_matmul(a8, a8, torch.int32)


def _jax_vmem_tool():
    """tools/exp_r4_vmem.py, loaded by path (its top level imports no
    JAX)."""
    path = os.path.join(REPO, "tools", "exp_r4_vmem.py")
    spec = importlib.util.spec_from_file_location("jax_exp_r4_vmem", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every pl.pallas_call in interpret mode, as the tool cannot ask."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_smem_probe_plain_matches_the_jax_probe(interpret_pallas, capsys):
    """The JAX probe (no vmem_limit_bytes) in interpret mode prints s =
    21.0 for x = ones; K14's plain version gives 21 x exactly there."""
    _jax_vmem_tool().probe(None)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"result": "ok", "s": 21.0}
    got = SP.smem_probe(torch.ones(1, 1024, 1024))
    assert got.shape == (1024, 1024)
    assert torch.equal(got, torch.full((1024, 1024), 21.0))
    assert SP.LAUNCHES == {"_smem_probe_cuda": 0}


def _probe_kern():
    """The probe's nested kernel ``kern``, compiled from the tool's syntax
    tree."""
    path = os.path.join(REPO, "tools", "exp_r4_vmem.py")
    tree = ast.parse(open(path).read())
    probe = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "probe")
    (kern,) = [n for n in probe.body
               if isinstance(n, ast.FunctionDef) and n.name == "kern"]
    ns = {}
    exec(compile(ast.Module(body=[kern], type_ignores=[]), path, "exec"), ns)
    return ns["kern"]


def test_smem_probe_plain_matches_the_pallas_kernel_on_normal_x():
    """``kern`` through its 24 MiB scratch in interpret mode against K14's
    plain version on a seeded normal x: within 1e-6 of max |ref| (six f32
    products summed in another order)."""
    x = np.random.default_rng(3).normal(size=(1, 1024, 1024)).astype(
        np.float32)
    f = pl.pallas_call(
        _probe_kern(),
        out_shape=jax.ShapeDtypeStruct((1024, 1024), jnp.float32),
        scratch_shapes=[pltpu.VMEM((6, 1024, 1024), jnp.float32)],
        interpret=True)
    want = np.asarray(f(jnp.asarray(x)))
    got = SP.smem_probe(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_smem_probe_refuses_what_the_kernel_does_not_take():
    for bad in (torch.ones(1, 1020, 1024), torch.ones(2, 1024, 16),
                torch.ones(1, 1024, 16, dtype=torch.float64)):
        with pytest.raises(ValueError, match="multiple of 8"):
            SP.smem_probe(bad)
    assert SP.smem_bytes(1024) == 6 * 8 * 1024 * 4 > 48 * 1024


def test_smem_probe_refuses_rows_of_no_whole_float4():
    """K14 moves x in float4: C must be a multiple of 4, on the CPU too."""
    for cols in (1022, 3):
        with pytest.raises(ValueError, match="C of 4"):
            SP.smem_probe(torch.ones(1, 8, cols))
    assert SP.smem_probe(torch.ones(1, 8, 4)).shape == (8, 4)


def test_vmem_tool_has_the_jax_tools_cases():
    """The port's tool names the JAX tool's cases, in its order; the seven
    that set JAX window-attention tile knobs each state those knobs as the
    JAX tool's case sets them (read from its syntax tree), whether the case
    embeds or trains, and map every knob to a port knob of
    ``ops/window_attention.py`` or to ``no_counterpart``."""
    from geoguessr_ai_torch.ops import window_attention as wa

    assert list(TV.CASES) == list(_jax_vmem_tool().CASES)
    assert set(TV.KNOB_CASES) == set(TV.CASES) - {"probe_default",
                                                  "probe_v64"}
    path = os.path.join(REPO, "tools", "exp_r4_vmem.py")
    (cases,) = [n.value for n in ast.parse(open(path).read()).body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CASES"]
    for key, lam in zip(cases.keys, cases.values):
        if key.value not in TV.KNOB_CASES:
            continue
        case = TV.KNOB_CASES[key.value]
        assert lam.body.func.id == f"{case['run']}_case", key.value
        knobs = eval(compile(ast.Expression(lam.body.args[0]), path, "eval"),
                     {"V64": TV.V64})
        assert case["jax"] == knobs, key.value
        assert len(case["port"]) + len(case["no_counterpart"]) == len(knobs)
        assert set(case["port"]) <= set(wa.TILE_KNOBS)
        assert set(case["no_counterpart"]) <= set(knobs)


def test_vmem_tool_needs_a_gpu():
    """Without a card the probe and the tool exit non-zero and run nothing
    on the CPU."""
    for run in (lambda: TV.probe(None), lambda: TV.main(["probe_v64"])):
        with pytest.raises(SystemExit):
            run()
    out = subprocess.run(
        [sys.executable, "-m", "geoguessr_ai_torch.tools.exp_r4_vmem",
         "probe_default,probe_v64"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    assert out.returncode != 0
    assert '"result"' not in out.stdout

"""TinyViT forward (eval and train) in PyTorch, NHWC like the JAX package.

Counterpart of geoguessr_ai_tpu/models/tinyvit.py.  Modules carry the
flax module names (``patch_embed``, ``stage1_block0.attn.qkv``, ...), so a
flax parameter tree maps onto the state dict by name
(models/convert.py).  Activations stay NHWC; the convolutions see an
NCHW view with channels-last strides.

Attention per stage follows the JAX config's kernel stage lists, selected
exactly as the JAX ``WindowAttention`` selects them:

* ``fused_block_noproj_stages`` and N % 128 == 0: K2
  (``fused_block_attention_noproj``), then the out-projection;
* ``fused_block_stages`` and N % 128 == 0: K1 (``fused_block_attention``);
* ``pallas_attention_stages``, N % 128 == 0 and N >= the module constant
  ``ops.window_attention.QKV_KERNEL_MIN_N``: LN and qkv GEMM, K3
  (``window_attention_qkv``), out-projection;
* ``pallas_attention_stages`` and N % 128 == 0 (N below that constant):
  the head-major route, q, k and v emitted (W, H, N, hd) by the projection
  einsums, K8a/K8b (``window_attention``), the back-projection consuming
  head-major;
* otherwise the plain attention forward with the kernel backward
  (``window_attention_qkv_xla``: K4, or K5/K7, on the card).

Two opt-in knobs of the JAX config, both off by default and both turned on
by the bulk-embedding configuration, route through further kernels under
the JAX gates: ``fused_mbconv`` runs each eval-mode stage-0 MBConv as K10
(``ops/mbconv.py fused_mbconv``), and ``fused_block_4d`` runs a
multi-window ``fused_block_stages`` stage as K9 over the raw map
(``fused_block_attention_4d``), with no window partition copies.

``train=True`` (the flax ``train`` argument) normalises BatchNorm with
the batch statistics and updates the running ones, and applies DropPath
with the caller's ``torch.Generator``.  Training keeps the parameters in
f32 and casts them per use; ``TinyViT.cast_weights_`` is for serving.

The memory knobs of the JAX config: ``remat`` checkpoints each MBConv and
TinyViTBlock of ``remat_stages`` (all when None) with
``torch.utils.checkpoint`` ("full" recomputes everything; "dots" keeps the
outputs of the plain GEMMs, as ``dots_with_no_batch_dims_saveable``).  The
recompute draws DropPath's masks again from the generator state the
forward drew them from, and leaves the BatchNorm running statistics as the
forward moved them.  ``scan_stages`` runs as the unrolled loop it computes
the same as (``scan_remat`` checkpoints each block), with the JAX
package's checks and its silent fallback for a stage of depth 1; its flax
parameter layout, ``stage{N}_scan/block/...`` stacked along axis 0, is
mapped to and from the per-block modules by ``models/convert.py``.

Quantization (``quant_mode``, ``quant_sites``, ``quant_stages``; inference
only, ``ops/quant.py``), site for site as the JAX module:

* int8 GEMM sites, through ``_quant_gemm``: "conv" (the 1x1 convs of
  MBConv, PatchMerging), "qkv" and "proj" (the attention projections of the
  branches that have them) and "fc1" / "fc2" (the MLP);
* int8 storage sites (``fake_quant_static_ste``, static mode only), through
  ``_maybe_quant_store``: "dw" (the tensor feeding each depthwise conv),
  "dwout" (the depthwise output), "stem" (patch_embed conv1's output) and
  "localdw" (the attention residual feeding local_conv);
* ``CONV_INT8_EMITTER`` sends the "conv" site of the convs the JAX package
  lowers as convolutions (the stem's 3x3s, MBConv / PatchMerging conv1)
  through ``int8_static_conv``.

"calibrate" runs the exact forward and records each site's running
activation abs-max into ``act_stats``; "static" reads them back from
``act_scales``.  Both are flat dicts of f32 scalars keyed by the flax path
(``stage1_block0.mlp.fc1_in_amax``), kept beside the parameters: state
dicts carry them as ``act_scales.<path>`` / ``act_stats.<path>`` and
``models/convert.py`` maps them to the flax collections.  The int8 sites
keep their weights f32 through ``cast_weights_`` (they are quantized per
output channel from f32 at each call, as the JAX forward does).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from geoguessr_ai_torch.ops import mbconv
from geoguessr_ai_torch.ops import quant as Q
from geoguessr_ai_torch.ops import window_attention as wa
from geoguessr_ai_torch.ops.window_attention import (
    window_partition,
    window_unpartition,
)


_ALL_QUANT_SITES = ("conv", "qkv", "proj", "fc1", "fc2")
#: The static-int8 sites of the production embed path: the MLP GEMMs in
#: int8 and int8 storage of the tensors feeding the depthwise convs, the
#: stem's conv1 output and the local_conv input.
PROD_QUANT_SITES = ("fc1", "fc2", "dw", "stem", "localdw")
#: The storage sites a train step can use (their STE passes gradients).
TRAIN_QUANT_SITES = ("dw", "stem", "localdw")

#: Conv sites whose JAX lowering is a convolution (the stem's 3x3s,
#: MBConv / PatchMerging conv1) quantize through ``int8_static_conv`` in
#: the static and calibrate modes, as the JAX module constant of the same
#: name; read at each call.  Calibration must run with the value the static
#: forward uses: the recorded paths differ.
CONV_INT8_EMITTER = False


@dataclasses.dataclass(frozen=True)
class TinyViTConfig:
    image_size: int = 512
    in_channels: int = 3
    embed_dims: Tuple[int, ...] = (96, 192, 384, 576)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 18)
    window_sizes: Tuple[int, ...] = (16, 16, 32, 16)
    mlp_ratio: float = 4.0
    mbconv_expand_ratio: float = 4.0
    #: stochastic depth at the last block (linear ramp from 0, as timm).
    drop_path_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    #: tanh-approximated GELU, the JAX default.
    exact_gelu: bool = False
    pallas_attention_stages: Tuple[int, ...] = (3,)
    fused_block_stages: Tuple[int, ...] = (1,)
    fused_block_noproj_stages: Tuple[int, ...] = (2,)
    #: Eval-mode stage-0 MBConv as one kernel (K10) with folded BatchNorm.
    fused_mbconv: bool = False
    #: Multi-window ``fused_block_stages`` stages (stage 1 at 64x64, w=16)
    #: through the 4D fused block (K9) on the raw map.
    fused_block_4d: bool = False
    #: Checkpoint the blocks of ``remat_stages`` (None: every stage) in the
    #: backward, trading a second forward for their activation memory.
    remat: bool = False
    remat_stages: Optional[Tuple[int, ...]] = None
    #: "full" recomputes everything; "dots" keeps the plain GEMM outputs.
    remat_policy: str = "full"
    #: Stages whose blocks the JAX package runs under ``lax.scan`` (a stage
    #: of depth > 1 other than stage 0; drop_path_rate 0, no remat_stages
    #: overlap).  Kept for parity with the JAX config: here a scanned stage
    #: is the unrolled loop and the field only runs the JAX checks; the
    #: stacked flax layout is read and written by ``models/convert.py``.
    scan_stages: Tuple[int, ...] = ()
    #: remat "full" on the blocks of the scanned stages (``_stage_remat``).
    scan_remat: bool = False
    #: Legacy alias: True selects quant_mode="dynamic".
    quantize_gemms: bool = False
    #: "none"; "dynamic" (per-row activation scales at each GEMM);
    #: "static" (calibrated scales from ``act_scales``); "calibrate" (the
    #: exact forward, recording each site's abs-max into ``act_stats``).
    quant_mode: str = "none"
    #: Sites the int8 modes apply to (calibration records every site).
    quant_sites: Tuple[str, ...] = _ALL_QUANT_SITES
    #: Stages that quantize (0 is the MBConv stage; patch_embed and each
    #: downsample follow the stage they feed).
    quant_stages: Tuple[int, ...] = (0, 1, 2, 3)

    @staticmethod
    def tiny_vit_21m_512(**overrides) -> "TinyViTConfig":
        return TinyViTConfig(**overrides)

    @property
    def embed_dim(self) -> int:
        return self.embed_dims[-1]

    @property
    def effective_quant_mode(self) -> str:
        if self.quant_mode != "none":
            return self.quant_mode
        return "dynamic" if self.quantize_gemms else "none"


def _gelu(x, exact: bool):
    return F.gelu(x, approximate="none" if exact else "tanh")


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class _ActScales:
    """A TinyViT's per-site activation abs-max: ``scales`` (read by the
    static mode) and ``stats`` (recorded by the calibrate mode), flat dicts
    of f32 scalars keyed by flax path.  Shared by the model's quantizing
    modules; not parameters or buffers."""

    def __init__(self):
        self.scales = {}
        self.stats = {}


class _Quant(nn.Module):
    """A module with quantization sites: its stage's mode (``quant``), the
    config's sites, its flax path and the model's ``_ActScales``, set by
    ``TinyViT.__init__``."""

    quant = "none"
    quant_sites = _ALL_QUANT_SITES
    _qpath = ""
    _act = None

    def _key(self, name):
        return f"{self._qpath}.{name}" if self._qpath else name

    def _record(self, x, name):
        """calibrate: the running max of |x| (f32) under ``name``."""
        key = self._key(name)
        amax = x.detach().float().abs().max()
        prev = self._act.stats.get(key)
        self._act.stats[key] = (amax if prev is None else
                                torch.maximum(prev.to(amax.device), amax))

    def _amax(self, name, device):
        """static: the calibrated abs-max of ``name``, on ``device``."""
        key = self._key(name)
        try:
            t = self._act.scales[key]
        except KeyError:
            raise KeyError(f"no act_scales entry {key!r}: the static mode "
                           "reads scales recorded by a calibrate forward") \
                from None
        if t.device != device:
            t = self._act.scales[key] = t.to(device)
        return t

    def _quant_gemm(self, x, lin: nn.Linear, dtype, name, site):
        """The JAX ``_quant_gemm``: ``x @ lin`` in the int8 modes when
        ``site`` is one of the sites (the weight quantized from f32),
        recording the input's abs-max in calibrate, plain otherwise."""
        quant = self.quant
        if quant in ("dynamic", "static") and site not in self.quant_sites:
            quant = "none"
        if quant == "dynamic":
            return Q.int8_einsum_nc_cd(x, lin.weight.t(), bias=lin.bias,
                                       out_dtype=dtype)
        if quant == "static":
            return Q.int8_static_einsum_nc_cd(
                x, lin.weight.t(), self._amax(name, x.device), bias=lin.bias,
                out_dtype=dtype)
        if quant == "calibrate":
            self._record(x, name)
        return _linear(x, lin, dtype)

    def _maybe_quant_store(self, x, site, name):
        """The JAX ``_maybe_quant_store``: int8 storage of x with its
        static scale (straight-through gradient) in static mode at a listed
        site; calibrate records."""
        if self.quant == "calibrate":
            self._record(x, name)
            return x
        if self.quant == "static" and site in self.quant_sites:
            return Q.fake_quant_static_ste(x, self._amax(name, x.device))
        return x

    def _conv_quant_active(self):
        return self.quant == "calibrate" or (
            self.quant in ("dynamic", "static")
            and "conv" in self.quant_sites)


#: ``active`` while a checkpointed block recomputes its forward.
_RECOMPUTE = threading.local()

#: The GEMMs whose outputs remat_policy="dots" keeps: plain products, not
#: batched ones, not convolutions.
_SAVED_GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_GEMMS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(block, x, dtype, train, generator, policy):
    """``block(x, dtype, train, generator)`` under
    ``torch.utils.checkpoint``: the backward runs the block again, with a
    generator restored to the state the forward drew from (``checkpoint``
    restores only the global generators) and with the BatchNorm running
    statistics left as the forward moved them."""
    state = None if generator is None else generator.get_state()
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return block(x, dtype, train, generator)
        gen = None
        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        _RECOMPUTE.active = True
        try:
            return block(x, dtype, train, gen)
        finally:
            _RECOMPUTE.active = False

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


class _BN(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NHWC tensor."""

    MOMENTUM = 0.9

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, dtype, train: bool = False):
        """f32 arithmetic, result in the compute dtype.  Eval normalises
        with the running statistics.  Train normalises with the batch mean
        and flax's fast variance max(E[x^2] - E[x]^2, 0), both f32 over
        (N, H, W), and moves the running statistics 0.1 of the way to them
        (the biased variance, unlike ``F.batch_norm``), except in a remat
        recompute."""
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            m = self.MOMENTUM
            if not getattr(_RECOMPUTE, "active", False):
                with torch.no_grad():
                    self.running_mean.copy_(
                        m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(
                        m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        return ((xf - mean) * mul + self.bias).to(dtype)

    def folded(self):
        """Eval BatchNorm as f32 (scale, bias) from the running statistics."""
        return mbconv.fold_bn(self.weight, self.bias, self.running_mean,
                              self.running_var)


class DropPath(nn.Module):
    """Stochastic depth: zeroes a whole sample's residual branch with
    probability ``rate`` in train mode and scales the kept ones by
    1 / (1 - rate); the identity otherwise or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool, generator=None):
        if self.rate == 0.0 or not train:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator,
                          device=generator.device) < keep
        return torch.where(mask.to(x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBN(_Quant):
    """Conv (no bias, padding k // 2 as flax) + BatchNorm, on NHWC.
    ``pointwise_lowering`` is the JAX module's: "conv" for the 1x1 convs
    it lowers as convolutions (MBConv / PatchMerging conv1), which
    ``CONV_INT8_EMITTER`` sends through ``int8_static_conv``."""

    def __init__(self, cin, cout, kernel=1, stride=1, groups=1,
                 pointwise_lowering="einsum"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = _BN(cout)
        self.pointwise_lowering = pointwise_lowering

    def forward(self, x, dtype, train: bool = False):
        c = self.conv
        k, stride = c.kernel_size[0], c.stride[0]
        active = self._conv_quant_active()
        if (CONV_INT8_EMITTER and active and c.groups == 1
                and self.quant in ("static", "calibrate")
                and (k > 1 or self.pointwise_lowering == "conv")):
            if self.quant == "static":
                y = Q.int8_static_conv(
                    x, c.weight.permute(2, 3, 1, 0),
                    self._amax("in_amax", x.device), stride=stride,
                    padding=k // 2, out_dtype=dtype)
                return self.bn(y, dtype, train)
            self._record(x, "in_amax")
        elif active and k == 1 and stride == 1 and c.groups == 1:
            # the JAX _PointwiseConv named "conv": a GEMM site
            lin = _PointwiseLinear(c.weight)
            if self.quant != "calibrate":
                return self.bn(self._quant_gemm(x, lin, dtype, "conv.in_amax",
                                                "conv"), dtype, train)
            self._record(x, "conv.in_amax")
        y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(dtype), None,
                     c.stride, c.padding, c.dilation, c.groups)
        return self.bn(y.permute(0, 2, 3, 1), dtype, train)


class _PointwiseLinear:
    """A 1x1 conv weight (out, in, 1, 1) seen as a bias-free Linear."""

    def __init__(self, conv_weight):
        self.weight = conv_weight[:, :, 0, 0]
        self.bias = None


class MBConv(_Quant):
    def __init__(self, dim, expand_ratio, exact_gelu, drop_path=0.0,
                 fused=False):
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.exact_gelu = exact_gelu
        self.fused = fused
        self.conv1 = ConvBN(dim, hidden, 1, pointwise_lowering="conv")
        self.conv2 = ConvBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = ConvBN(hidden, dim, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, dtype, train: bool = False, generator=None):
        g = self.exact_gelu
        # K10 engages only while no conv site quantizes and not in
        # calibration (which records the conv sites), as the JAX gate.
        if self.fused and not train and not self._conv_quant_active():
            c1, c2, c3 = self.conv1, self.conv2, self.conv3
            return mbconv.fused_mbconv(
                x.to(dtype),
                c1.conv.weight[:, :, 0, 0].t(), *c1.bn.folded(),
                c2.conv.weight[:, 0].permute(1, 2, 0), *c2.bn.folded(),
                c3.conv.weight[:, :, 0, 0].t(), *c3.bn.folded(),
                exact_gelu=g)
        y = _gelu(self.conv1(x, dtype, train), g)
        y = self._maybe_quant_store(y, "dw", "dw_in_amax")
        y = _gelu(self.conv2(y, dtype, train), g)
        y = self._maybe_quant_store(y, "dwout", "dwout_amax")
        y = self.drop_path(self.conv3(y, dtype, train), train, generator)
        return _gelu(x + y, g)


class PatchEmbed(_Quant):
    def __init__(self, cin, dim, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.conv1 = ConvBN(cin, dim // 2, 3, stride=2)
        self.conv2 = ConvBN(dim // 2, dim, 3, stride=2)

    def forward(self, x, dtype, train: bool = False, generator=None):
        x = _gelu(self.conv1(x, dtype, train), self.exact_gelu)
        x = self._maybe_quant_store(x, "stem", "stem_amax")
        return self.conv2(x, dtype, train)


class PatchMerging(_Quant):
    """1x1 -> depthwise 3x3 stride 2 -> 1x1, BN and GELU between."""

    def __init__(self, cin, cout, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.conv1 = ConvBN(cin, cout, 1, pointwise_lowering="conv")
        self.conv2 = ConvBN(cout, cout, 3, stride=2, groups=cout)
        self.conv3 = ConvBN(cout, cout, 1)

    def forward(self, x, dtype, train: bool = False, generator=None):
        g = self.exact_gelu
        x = _gelu(self.conv1(x, dtype, train), g)
        x = self._maybe_quant_store(x, "dw", "dw_in_amax")
        x = _gelu(self.conv2(x, dtype, train), g)
        x = self._maybe_quant_store(x, "dwout", "dwout_amax")
        return self.conv3(x, dtype, train)


def _relative_bias_index(window: int) -> np.ndarray:
    """(N, N) index into the unique-offset bias table for an N = window^2
    window: offsets |dy| * window + |dx| renumbered in sorted order
    (np.unique), as the JAX package does; not timm's insertion order."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)
    rel = np.abs(coords[:, None, :] - coords[None, :, :])
    offsets = rel[..., 0] * window + rel[..., 1]
    _, inv = np.unique(offsets, return_inverse=True)
    return inv.reshape(offsets.shape).astype(np.int64)


class WindowAttention(_Quant):
    """LeViT-style attention with learned relative biases; (B, N, C)
    window tokens in, its own pre-LayerNorm inside.  The qkv and proj
    GEMMs of the K3 and plain branches, and the proj after K2, are int8
    sites; the K1, K9 and head-major branches have none."""

    def __init__(self, dim, num_heads, window, use_kernel_qkv=False,
                 fused_block=False, fused_block_noproj=False):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel_qkv = use_kernel_qkv
        self.fused_block = fused_block
        self.fused_block_noproj = fused_block_noproj
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        idx = _relative_bias_index(window)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, int(idx.max()) + 1))
        self.register_buffer("bias_idx", torch.from_numpy(idx),
                             persistent=False)

    def forward_map(self, x, dtype, window):
        """The fused block over the raw (B, H, W, C) map (the JAX module's
        ``four_d``): K9 on the card.  -> (B, H, W, C)."""
        C = x.shape[-1]
        H = self.num_heads
        n, q, p = self.norm, self.qkv, self.proj
        return wa.fused_block_attention_4d(
            x.to(dtype), n.weight, n.bias, q.weight.t(), q.bias,
            p.weight.t(), p.bias, self.attention_biases[:, self.bias_idx],
            (C // H) ** -0.5, H, window)

    def forward(self, x, dtype):
        B, N, C = x.shape
        H = self.num_heads
        scale = (C // H) ** -0.5
        bias = self.attention_biases[:, self.bias_idx]  # (H, N, N)
        x = x.to(dtype)
        n, q, p = self.norm, self.qkv, self.proj
        if self.fused_block_noproj and N % 128 == 0:
            out = wa.fused_block_attention_noproj(
                x, n.weight, n.bias, q.weight.t(), q.bias, bias, scale, H)
            return self._quant_gemm(out, p, dtype, "proj_in_amax", "proj")
        if self.fused_block and N % 128 == 0:
            return wa.fused_block_attention(
                x, n.weight, n.bias, q.weight.t(), q.bias, p.weight.t(),
                p.bias, bias, scale, H)
        x = F.layer_norm(x.float(), (C,), n.weight, n.bias, 1e-5).to(dtype)
        kernel = self.use_kernel_qkv and N % 128 == 0
        if kernel and N < wa.QKV_KERNEL_MIN_N:
            return self._head_major(x, dtype, bias, scale)
        qkv = self._quant_gemm(x, q, dtype, "qkv_in_amax", "qkv")
        if kernel:
            out = wa.window_attention_qkv(qkv, bias, scale, H)
        else:
            out = wa.window_attention_qkv_xla(qkv, bias, scale, H)
        return self._quant_gemm(out, p, dtype, "proj_in_amax", "proj")

    def _head_major(self, x, dtype, bias, scale):
        """The JAX module's head-major branch: q, k, v (B, H, N, hd), each
        product rounded to the compute dtype and its bias slice added in
        it, ``window_attention``, and the back-projection from head-major
        plus the proj bias in the compute dtype."""
        C = x.shape[-1]
        H = self.num_heads
        hd = C // H
        # qkv output channel c -> (head c // 3hd, q|k|v slot, dim)
        wk = self.qkv.weight.t().reshape(C, H, 3, hd).to(dtype)
        wb = self.qkv.bias.reshape(H, 3, 1, hd).to(dtype)
        q, k, v = (
            (torch.einsum("bnc,chd->bhnd", x, wk[:, :, i]) + wb[:, i])
            .contiguous() for i in range(3))
        out = wa.window_attention(q, k, v, bias, scale)
        wp = self.proj.weight.t().reshape(H, hd, C).to(dtype)
        return (torch.einsum("bhnd,hdc->bnc", out, wp)
                + self.proj.bias.to(dtype))


class Mlp(_Quant):
    def __init__(self, dim, hidden, exact_gelu):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        n = self.norm
        x = F.layer_norm(x.float(), n.normalized_shape, n.weight, n.bias,
                         1e-5).to(dtype)
        x = _gelu(self._quant_gemm(x, self.fc1, dtype, "fc1_in_amax", "fc1"),
                  self.exact_gelu)
        return self._quant_gemm(x, self.fc2, dtype, "fc2_in_amax", "fc2")


class TinyViTBlock(_Quant):
    """Window attention -> depthwise local conv -> MLP, all residual."""

    def __init__(self, dim, num_heads, window, mlp_ratio, exact_gelu,
                 use_kernel_qkv, fused_block, fused_block_noproj,
                 drop_path=0.0, fused_block_4d=False):
        super().__init__()
        self.window = window
        self.four_d = fused_block_4d and fused_block and not fused_block_noproj
        self.attn = WindowAttention(dim, num_heads, window, use_kernel_qkv,
                                    fused_block, fused_block_noproj)
        self.local_conv = ConvBN(dim, dim, 3, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), exact_gelu)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, dtype, train: bool = False, generator=None):
        B, H, W, C = x.shape
        w = min(self.window, H, W)
        if (H, W) == (w, w):
            attn_out = self.attn(x.reshape(B, H * W, C), dtype)
            attn_out = attn_out.reshape(B, H, W, C)
        elif self.four_d and H % w == 0 and W % w == 0 and (w * w) % 128 == 0:
            attn_out = self.attn.forward_map(x, dtype, w)
        else:
            pad_h, pad_w = (-H) % w, (-W) % w
            xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            win = self.attn(window_partition(xp, w), dtype)
            attn_out = window_unpartition(win, w, (H + pad_h, W + pad_w))
            attn_out = attn_out[:, :H, :W, :]
        x = x + self.drop_path(attn_out, train, generator)
        x = self._maybe_quant_store(x, "localdw", "localdw_in_amax")
        x = self.local_conv(x, dtype, train)
        mlp_out = self.mlp(x.reshape(B, H * W, C), dtype).reshape(B, H, W, C)
        return x + self.drop_path(mlp_out, train, generator)


class TinyViT(nn.Module):
    """(B, H, W, 3) pixels -> (B, embed_dim) f32 pooled, normed features."""

    def __init__(self, config: TinyViTConfig):
        super().__init__()
        cfg = self.config = config
        g = cfg.exact_gelu
        self.patch_embed = PatchEmbed(cfg.in_channels, cfg.embed_dims[0], g)
        self._order = ["patch_embed"]
        dpr = iter(np.linspace(0.0, cfg.drop_path_rate,
                               sum(cfg.depths)).tolist())
        res = -(-cfg.image_size // 4)  # the stem's two stride-2 convs
        #: block name -> remat policy, for the blocks run under checkpoint
        self._remat = {}
        for stage, depth in enumerate(cfg.depths):
            dim = cfg.embed_dims[stage]
            policy = self._stage_remat(stage)
            # a window larger than the map shrinks to it, as the JAX block's
            # w = min(window, H, W) does; its bias table follows
            window = min(cfg.window_sizes[stage], res)
            for d in range(depth):
                name = f"stage{stage}_block{d}"
                if stage == 0:
                    block = MBConv(dim, cfg.mbconv_expand_ratio, g, next(dpr),
                                   fused=cfg.fused_mbconv)
                else:
                    block = TinyViTBlock(
                        dim, cfg.num_heads[stage], window,
                        cfg.mlp_ratio, g,
                        use_kernel_qkv=stage in cfg.pallas_attention_stages,
                        fused_block=stage in cfg.fused_block_stages,
                        fused_block_noproj=(
                            stage in cfg.fused_block_noproj_stages),
                        drop_path=next(dpr),
                        fused_block_4d=cfg.fused_block_4d,
                    )
                self.add_module(name, block)
                self._order.append(name)
                if policy is not None:
                    self._remat[name] = policy
            if stage < len(cfg.depths) - 1:
                name = f"downsample{stage}"
                self.add_module(name, PatchMerging(
                    dim, cfg.embed_dims[stage + 1], g))
                self._order.append(name)
                res = -(-res // 2)
        self.norm_head = nn.LayerNorm(cfg.embed_dims[-1], eps=1e-5)
        self._act = _ActScales()
        for name in self._order:
            if name == "patch_embed":
                stage = 0
            elif name.startswith("downsample"):
                stage = int(name[len("downsample"):]) + 1
            else:
                stage = int(name[len("stage"):name.index("_")])
            for sub, m in getattr(self, name).named_modules(prefix=name):
                if isinstance(m, _Quant):
                    m.quant = self._stage_quant(stage)
                    m.quant_sites = tuple(cfg.quant_sites)
                    m._qpath = sub
                    m._act = self._act

    def _stage_quant(self, stage: int) -> str:
        """A stage's quant mode: the int8 modes honor quant_stages;
        calibration records every stage."""
        mode = self.config.effective_quant_mode
        if mode in ("static", "dynamic") and \
                stage not in self.config.quant_stages:
            return "none"
        return mode

    @property
    def act_scales(self):
        """The calibrated abs-max per site that the static mode reads."""
        return self._act.scales

    @act_scales.setter
    def act_scales(self, scales):
        self._act.scales = dict(scales)

    @property
    def act_stats(self):
        """The abs-max per site that the calibrate mode records."""
        return self._act.stats

    @act_stats.setter
    def act_stats(self, stats):
        self._act.stats = dict(stats)

    _ACT_COLLECTIONS = ("act_scales", "act_stats")

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for col in self._ACT_COLLECTIONS:
            for k, v in getattr(self, col).items():
                destination[f"{prefix}{col}.{k}"] = v if keep_vars \
                    else v.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        """Takes ``act_scales.<path>`` / ``act_stats.<path>`` entries into
        the two dicts (replacing them when any is given)."""
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        for col in self._ACT_COLLECTIONS:
            head = f"{prefix}{col}."
            got = {k[len(head):]: v.detach().clone().float()
                   for k, v in state_dict.items() if k.startswith(head)}
            if got:
                setattr(self, col, got)
            unexpected_keys[:] = [k for k in unexpected_keys
                                  if not k.startswith(head)]

    def _int8_weight_modules(self):
        """The Linear / Conv2d modules whose weight feeds an int8 GEMM
        under the config (kept f32 by ``cast_weights_``)."""
        out = set()
        for m in self.modules():
            if not isinstance(m, _Quant) or m.quant not in ("dynamic",
                                                            "static"):
                continue
            if isinstance(m, Mlp):
                pairs = (("fc1", m.fc1), ("fc2", m.fc2))
            elif isinstance(m, WindowAttention):
                pairs = (("qkv", m.qkv), ("proj", m.proj))
            elif isinstance(m, ConvBN) and m.conv.groups == 1:
                pairs = (("conv", m.conv),)
            else:
                pairs = ()
            out.update(mod for site, mod in pairs if site in m.quant_sites)
        return out

    def _stage_remat(self, stage: int) -> Optional[str]:
        """The remat policy of a stage's blocks, or None, with the JAX
        module's checks on a scanned stage.  A listed stage of depth 1, or
        stage 0, is not scanned (the JAX package falls back to the unrolled
        loop without a word); a scanned stage must not quantize."""
        cfg = self.config
        remat_stages = (set(range(len(cfg.depths)))
                        if cfg.remat_stages is None else set(cfg.remat_stages))
        if stage > 0 and stage in cfg.scan_stages and cfg.depths[stage] > 1:
            if self._stage_quant(stage) != "none":
                raise ValueError("scan_stages: per-block act_scales don't "
                                 "stack")
            if cfg.drop_path_rate != 0.0:
                raise ValueError("scan_stages needs homogeneous blocks "
                                 "(drop_path_rate == 0)")
            if cfg.remat and stage in remat_stages:
                raise ValueError(
                    "a scanned stage cannot also be remat'd via "
                    "remat_stages: use scan_remat (per-block checkpoint "
                    "inside the scan body) instead")
            return "full" if cfg.scan_remat else None
        if cfg.remat and stage in remat_stages:
            return "dots" if cfg.remat_policy == "dots" else "full"
        return None

    def cast_weights_(self) -> "TinyViT":
        """Stores conv and linear weights in the compute dtype once, so the
        forward's per-use casts are no-ops.  Norm parameters, biases and
        attention biases stay f32, as the JAX forward reads them, and so do
        the weights of int8 GEMM sites, which are quantized per output
        channel from f32."""
        keep = self._int8_weight_modules()
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)) and m not in keep:
                m.weight.data = m.weight.data.to(self.config.dtype)
        return self

    def forward(self, pixel_values: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        """``train``: batch-statistics BatchNorm (updating the running
        statistics) and DropPath drawn from ``generator``."""
        dtype = self.config.dtype
        x = pixel_values.to(dtype)
        for name in self._order:
            block = getattr(self, name)
            policy = self._remat.get(name)
            if policy is not None and torch.is_grad_enabled():
                x = _checkpointed(block, x, dtype, train, generator, policy)
            else:
                x = block(x, dtype, train, generator)
        x = x.reshape(x.shape[0], -1, x.shape[-1]).float().mean(dim=1)
        n = self.norm_head
        return F.layer_norm(x, n.normalized_shape, n.weight, n.bias, 1e-5)

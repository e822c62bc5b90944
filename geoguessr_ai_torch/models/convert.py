"""Flax variables <-> the port's state dict.

The port's modules carry the flax module names, so the mapping is by
name; only leaf names and layouts change:

* conv ``kernel`` HWIO (incl. depthwise (3, 3, 1, C)) -> ``weight`` OIHW;
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* norm ``scale`` -> ``weight``; ``bias`` stays;
* BatchNorm ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
* ``attention_biases`` stays (H, num_offsets);
* CLIP's ``class_embedding`` (D,) and ``position_embedding`` (N, D) stay;
* CLIP's DenseGeneral attention projections ``self_attn/{query,key,value}``
  (kernel (D, H, hd), bias (H, hd)) and ``self_attn/out`` (kernel
  (H, hd, D), bias (D,)) -> (D, D) Linear weights in (out, in) layout and
  (D,) biases; channel h*hd + d is head h's dim d.  Going back needs the
  head count (``to_jax_variables(..., num_heads=H)``, or a mapping from
  the top-level module to its count where two towers differ, as in the
  full-width ``CLIPModel``: ``{"vision_model": 16, "text_model": 12}``);
* the CLIP text tower's ``token_embedding`` ``embedding`` (V, D) ->
  ``nn.Embedding`` ``weight`` (V, D), and ``CLIPModel``'s scalar
  ``logit_scale`` stays.

A TinyViT stage that the JAX package scans (``TinyViTConfig.scan_stages``)
keeps its blocks' leaves stacked along axis 0 under ``stage{N}_scan/block``;
``from_jax_variables`` unstacks them into the port's ``stage{N}_block{d}``
modules, and ``to_jax_variables(..., scan_stages=...)`` stacks them back
for the listed stages that have more than one block, stage 0 (the MBConv
stage) excepted: the JAX package scans no other.

TinyViT's per-site activation abs-max, the flax collections ``act_scales``
(read by quant_mode="static") and ``act_stats`` (written by "calibrate"),
travel by flax path as ``act_scales.<path>`` / ``act_stats.<path>``
entries, the names ``TinyViT`` loads them under; below a module of the
tree (SuperGuessr's ``backbone``) the collection name follows the module's.

``from_jax_variables`` takes ``{"params": ..., "batch_stats": ...}`` (and
the two act collections when present) as nested dicts of numpy arrays;
``to_jax_variables`` is its inverse, so that
gradients, updated parameters and running statistics of the port can be
compared with the JAX tree leaf by leaf.  Nothing here sees JAX.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


_SCAN = re.compile(r"stage(\d+)_scan$")


def _unstacked(leaves):
    """(path, value) leaves with every ``stage{N}_scan/block`` leaf split
    along axis 0 into its ``stage{N}_block{d}`` leaves."""
    for path, value in leaves:
        i = next((i for i, k in enumerate(path[:-1])
                  if _SCAN.match(k) and path[i + 1] == "block"), None)
        if i is None:
            yield path, value
            continue
        stage = _SCAN.match(path[i]).group(1)
        for d, v in enumerate(value):
            yield path[:i] + (f"stage{stage}_block{d}",) + path[i + 2:], v


#: Leaves that keep their name and layout.
_AS_IS = ("bias", "attention_biases", "class_embedding", "position_embedding",
          "logit_scale")
_HEAD_PROJS = ("query", "key", "value", "out")
#: Modules that are flax ``nn.Embed`` (leaf ``embedding``) in the JAX tree
#: and ``nn.Embedding`` (leaf ``weight``, the same layout) in the port.
_EMBEDS = ("token_embedding",)


def _array(value, dtype=None) -> np.ndarray:
    """A C-contiguous copy of ``value`` that keeps its shape (0-d too,
    which ``np.ascontiguousarray`` would make 1-d)."""
    return np.array(value, dtype=dtype, order="C")


def _is_head_proj(mods) -> bool:
    """A CLIP DenseGeneral attention projection (``self_attn/query``...)."""
    return len(mods) >= 2 and mods[-2] == "self_attn" and mods[-1] in _HEAD_PROJS


def _param(path, value):
    *mods, leaf = path
    if _is_head_proj(mods):
        # query/key/value: (D, H, hd) kernel, (H, hd) bias; out: (H, hd, D)
        n_in = 2 if mods[-1] == "out" else 1
        if leaf == "kernel":
            d_in = int(np.prod(value.shape[:n_in]))
            return ".".join(mods + ["weight"]), value.reshape(d_in, -1).T
        return ".".join(mods + [leaf]), value.reshape(-1)
    if leaf == "embedding" and mods and mods[-1] in _EMBEDS:
        return ".".join(mods + ["weight"]), value
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf not in _AS_IS:
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join(mods + [leaf]), value


_STATS = {"mean": "running_mean", "var": "running_var"}


#: Flax collections of per-site activation abs-max (TinyViT quantization).
ACT_COLLECTIONS = ("act_scales", "act_stats")
#: Modules a TinyViT may sit under in a flax tree (SuperGuessr's backbone).
_ACT_ROOTS = ("backbone",)


def _act_name(col, path):
    head = path[:1] if path[0] in _ACT_ROOTS else ()
    return ".".join(head + (col,) + path[len(head):])


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves), and
    ``act_scales`` / ``act_stats`` when present -> state dict."""
    out = {}
    for path, value in _unstacked(_flatten(variables["params"])):
        name, value = _param(path, value)
        out[name] = torch.from_numpy(_array(value, np.float32))
    for path, value in _unstacked(_flatten(variables.get("batch_stats",
                                                         {}))):
        *mods, leaf = path
        if leaf not in _STATS:
            raise ValueError(f"unknown batch stat {'/'.join(path)}")
        out[".".join(mods + [_STATS[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(value, np.float32))
    for col in ACT_COLLECTIONS:
        for path, value in _flatten(variables.get(col, {})):
            out[_act_name(col, path)] = torch.from_numpy(
                np.array(value, np.float32))
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_STATS_BACK = {v: k for k, v in _STATS.items()}


_BLOCK = re.compile(r"stage(\d+)_block(\d+)$")


def _stack_leaves(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack_scanned(tree, scan_stages):
    """Under every dict of a flax tree, the ``stage{N}_block{d}`` subtrees
    of each stage N > 0 in ``scan_stages`` that has more than one block
    become ``stage{N}_scan/block``, their leaves stacked along axis 0."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _stack_scanned(v, scan_stages) for k, v in tree.items()}
    by_stage = collections.defaultdict(dict)
    for k in tree:
        m = _BLOCK.match(k)
        if m and int(m.group(1)) in scan_stages - {0}:
            by_stage[m.group(1)][int(m.group(2))] = k
    for stage, blocks in by_stage.items():
        if len(blocks) > 1:
            subtrees = [tree.pop(blocks[d]) for d in sorted(blocks)]
            tree[f"stage{stage}_scan"] = {"block": _stack_leaves(subtrees)}
    return tree


def to_jax_variables(named: Dict[str, torch.Tensor],
                     num_heads: Union[int, Mapping[str, int], None] = None,
                     scan_stages: Iterable[int] = ()):
    """Port state dict (or any name -> tensor dict with its names, such as
    gradients) -> ``{"params": ..., "batch_stats": ...}`` of f32 numpy
    arrays in flax layout; ``batch_stats`` only when running statistics are
    among the names, ``act_scales`` / ``act_stats`` when theirs are.
    ``num_heads`` splits CLIP's attention projections
    back into their DenseGeneral shapes (an int, or top-level module name
    -> int); it is needed only when they are among the names.
    ``scan_stages`` (a TinyViT config's) stacks those
    stages' blocks in the scanned layout."""
    params, stats = {}, {}
    acts = {col: {} for col in ACT_COLLECTIONS}
    for name, t in named.items():
        *mods, leaf = name.split(".")
        value = t.detach().float().cpu().numpy()
        col = next((c for c in ACT_COLLECTIONS if c in mods), None)
        if col is not None:
            i = mods.index(col)
            _put(acts[col], mods[:i] + mods[i + 1:] + [leaf], value)
            continue
        if leaf in _STATS_BACK:
            _put(stats, mods + [_STATS_BACK[leaf]], value)
            continue
        if _is_head_proj(mods):
            heads = (num_heads.get(mods[0]) if isinstance(num_heads, Mapping)
                     else num_heads)
            if heads is None:
                raise ValueError(f"{name}: the head split needs num_heads")
            out = mods[-1] == "out"
            if leaf == "weight":
                value, leaf = value.T, "kernel"
                shape = ((heads, -1, value.shape[1]) if out
                         else (value.shape[0], heads, -1))
                value = value.reshape(shape)
            elif not out:
                value = value.reshape(heads, -1)
            _put(params, mods + [leaf], np.ascontiguousarray(value))
            continue
        if leaf == "weight" and mods and mods[-1] in _EMBEDS:
            leaf = "embedding"
        elif leaf == "weight":
            if value.ndim == 4:
                value, leaf = value.transpose(2, 3, 1, 0), "kernel"
            elif value.ndim == 2:
                value, leaf = value.T, "kernel"
            else:
                leaf = "scale"
        elif leaf not in _AS_IS:
            raise ValueError(f"unknown parameter {name}")
        _put(params, mods + [leaf], _array(value))
    scan_stages = set(scan_stages)
    out = {"params": _stack_scanned(params, scan_stages)}
    if stats:
        out["batch_stats"] = _stack_scanned(stats, scan_stages)
    out.update((col, tree) for col, tree in acts.items() if tree)
    return out

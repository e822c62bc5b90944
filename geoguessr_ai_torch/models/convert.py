"""Flax variables <-> the port's state dict.

The port's modules carry the flax module names, so the mapping is by
name; only leaf names and layouts change:

* conv ``kernel`` HWIO (incl. depthwise (3, 3, 1, C)) -> ``weight`` OIHW;
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* norm ``scale`` -> ``weight``; ``bias`` stays;
* BatchNorm ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
* ``attention_biases`` stays (H, num_offsets).

``from_jax_variables`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays; ``to_jax_variables`` is its inverse, so that
gradients, updated parameters and running statistics of the port can be
compared with the JAX tree leaf by leaf.  Nothing here sees JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _param(path, value):
    *mods, leaf = path
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
    elif leaf not in ("bias", "attention_biases"):
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join(mods + [leaf]), value


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves) -> state dict."""
    out = {}
    for path, value in _flatten(variables["params"]):
        name, value = _param(path, value)
        out[name] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        if leaf not in _STATS:
            raise ValueError(f"unknown batch stat {'/'.join(path)}")
        out[".".join(mods + [_STATS[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(value, np.float32))
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_STATS_BACK = {v: k for k, v in _STATS.items()}


def to_jax_variables(named: Dict[str, torch.Tensor]):
    """Port state dict (or any name -> tensor dict with its names, such as
    gradients) -> ``{"params": ..., "batch_stats": ...}`` of f32 numpy
    arrays in flax layout; ``batch_stats`` only when running statistics are
    among the names."""
    params, stats = {}, {}
    for name, t in named.items():
        *mods, leaf = name.split(".")
        value = t.detach().float().cpu().numpy()
        if leaf in _STATS_BACK:
            _put(stats, mods + [_STATS_BACK[leaf]], value)
            continue
        if leaf == "weight":
            if value.ndim == 4:
                value, leaf = value.transpose(2, 3, 1, 0), "kernel"
            elif value.ndim == 2:
                value, leaf = value.T, "kernel"
            else:
                leaf = "scale"
        elif leaf not in ("bias", "attention_biases"):
            raise ValueError(f"unknown parameter {name}")
        _put(params, mods + [leaf], np.ascontiguousarray(value))
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out

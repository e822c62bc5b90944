"""PyTorch checkpoint layouts <-> flax-shaped parameter trees (the port's
own copy of geoguessr_ai_tpu/models/torch_convert.py, numpy only).

  * HF ``CLIPVisionModel`` state dicts <-> the CLIP tower's tree.
  * timm TinyViT state dicts -> TinyViT's ``params`` and ``batch_stats``.
  * Reference SuperGuessr ``.pt`` checkpoints -> the head's tree
    (cell_layer, the hierarchical fusion's self_attn), shape-filtered as
    the reference loads them; and the inverse exporters.

Every converter takes and returns plain ``dict``s of numpy arrays (see
``train.checkpoints.load_torch_checkpoint``).  The trees are flax's, so
``models.convert.from_jax_variables`` carries them into the port's state
dict: the port keeps one name map, not two.  Torch Linear weights are
(out, in) -> (in, out); Conv2d weights (O, I, kH, kW) -> (kH, kW, I, O).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
from geoguessr_ai_torch.models.tinyvit import TinyViTConfig


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    # (O, I, kH, kW) -> (kH, kW, I, O); a depthwise (C, 1, kH, kW) becomes
    # flax's feature_group_count=C layout (kH, kW, 1, C)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_inv(w: np.ndarray) -> np.ndarray:
    # flax (kH, kW, I, O) -> torch (O, I, kH, kW)
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def clip_vision_from_hf(
    sd: Dict[str, np.ndarray], cfg: CLIPVisionConfig
) -> Dict:
    """Convert an HF CLIPVisionModel state dict to CLIPVisionTower params.

    Handles both bare vision-model dicts and full-CLIP dicts with the
    ``vision_model.`` prefix.
    """
    if not any(k.startswith("vision_model.") for k in sd):
        sd = {f"vision_model.{k}": v for k, v in sd.items()}

    def g(key: str) -> np.ndarray:
        return np.asarray(sd[f"vision_model.{key}"])

    D = cfg.hidden_size
    H = cfg.num_heads
    hd = D // H

    params: Dict = {
        "patch_embedding": {
            "kernel": _conv(g("embeddings.patch_embedding.weight"))
        },
        "class_embedding": g("embeddings.class_embedding").reshape(D),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_layrnorm": {
            "scale": g("pre_layrnorm.weight"),
            "bias": g("pre_layrnorm.bias"),
        },
        "post_layernorm": {
            "scale": g("post_layernorm.weight"),
            "bias": g("post_layernorm.bias"),
        },
    }

    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        qw, kw, vw = (
            g(pre + "self_attn.q_proj.weight"),
            g(pre + "self_attn.k_proj.weight"),
            g(pre + "self_attn.v_proj.weight"),
        )
        qb, kb, vb = (
            g(pre + "self_attn.q_proj.bias"),
            g(pre + "self_attn.k_proj.bias"),
            g(pre + "self_attn.v_proj.bias"),
        )
        ow, ob = (
            g(pre + "self_attn.out_proj.weight"),
            g(pre + "self_attn.out_proj.bias"),
        )
        # flax MultiHeadDotProductAttention: kernel (D, H, hd), out (H, hd, D)
        attn = {
            "query": {
                "kernel": _t(qw).reshape(D, H, hd),
                "bias": qb.reshape(H, hd),
            },
            "key": {
                "kernel": _t(kw).reshape(D, H, hd),
                "bias": kb.reshape(H, hd),
            },
            "value": {
                "kernel": _t(vw).reshape(D, H, hd),
                "bias": vb.reshape(H, hd),
            },
            "out": {
                "kernel": _t(ow).reshape(H, hd, D),
                "bias": ob,
            },
        }
        params[f"layer{i}"] = {
            "layer_norm1": {
                "scale": g(pre + "layer_norm1.weight"),
                "bias": g(pre + "layer_norm1.bias"),
            },
            "layer_norm2": {
                "scale": g(pre + "layer_norm2.weight"),
                "bias": g(pre + "layer_norm2.bias"),
            },
            "self_attn": attn,
            "mlp_fc1": {
                "kernel": _t(g(pre + "mlp.fc1.weight")),
                "bias": g(pre + "mlp.fc1.bias"),
            },
            "mlp_fc2": {
                "kernel": _t(g(pre + "mlp.fc2.weight")),
                "bias": g(pre + "mlp.fc2.bias"),
            },
        }
    return params


def clip_vision_to_hf(params: Dict, cfg: CLIPVisionConfig,
                      prefix: str = "vision_model.") -> Dict[str, np.ndarray]:
    """The CLIP tower's tree -> an HF CLIPVisionModel state dict (keys
    under ``prefix``), the inverse of ``clip_vision_from_hf``, so a tower
    trained here loads into transformers."""
    D = cfg.hidden_size
    sd: Dict[str, np.ndarray] = {}

    def put(key: str, value) -> None:
        sd[prefix + key] = np.ascontiguousarray(value)

    def put_norm(key: str, p: Dict) -> None:
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])

    def put_linear(key: str, kernel, bias, n_in: int = 1) -> None:
        # a flax kernel whose first n_in axes are fan-in -> (out, in)
        kernel = np.asarray(kernel)
        put(f"{key}.weight",
            kernel.reshape(int(np.prod(kernel.shape[:n_in])), -1).T)
        put(f"{key}.bias", np.asarray(bias).reshape(-1))

    put("embeddings.patch_embedding.weight",
        _conv_inv(np.asarray(params["patch_embedding"]["kernel"])))
    put("embeddings.class_embedding", np.asarray(params["class_embedding"])
        .reshape(D))
    put("embeddings.position_embedding.weight",
        params["position_embedding"])
    put_norm("pre_layrnorm", params["pre_layrnorm"])
    put_norm("post_layernorm", params["post_layernorm"])
    for i in range(cfg.num_layers):
        layer, pre = params[f"layer{i}"], f"encoder.layers.{i}."
        for flax_name, hf_name in (("query", "q_proj"), ("key", "k_proj"),
                                   ("value", "v_proj"), ("out", "out_proj")):
            a = layer["self_attn"][flax_name]
            put_linear(f"{pre}self_attn.{hf_name}", a["kernel"], a["bias"],
                       n_in=2 if flax_name == "out" else 1)
        put_norm(pre + "layer_norm1", layer["layer_norm1"])
        put_norm(pre + "layer_norm2", layer["layer_norm2"])
        for name in ("fc1", "fc2"):
            m = layer[f"mlp_{name}"]
            put_linear(f"{pre}mlp.{name}", m["kernel"], m["bias"])
    return sd


# ---------------------------------------------------------------------------
# TinyViT (timm naming)
# ---------------------------------------------------------------------------


def _convbn(sd, torch_prefix: str) -> Dict:
    conv_w = np.asarray(sd[f"{torch_prefix}.conv.weight"])
    return {
        "conv": {"kernel": _conv(conv_w)},
        "bn": {
            "scale": np.asarray(sd[f"{torch_prefix}.bn.weight"]),
            "bias": np.asarray(sd[f"{torch_prefix}.bn.bias"]),
        },
    }


def _convbn_stats(sd, torch_prefix: str) -> Dict:
    return {
        "bn": {
            "mean": np.asarray(sd[f"{torch_prefix}.bn.running_mean"]),
            "var": np.asarray(sd[f"{torch_prefix}.bn.running_var"]),
        }
    }


def tinyvit_from_timm(
    sd: Dict[str, np.ndarray], cfg: TinyViTConfig
) -> Dict:
    """Convert a timm tiny_vit state dict -> (params, batch_stats).

    timm layout: patch_embed.conv{1,2}.*; stages.{s}.downsample.conv{1,2,3}
    (downsample lives at the START of stages 1..3, producing that stage's
    dim — our downsample{s-1} at the end of stage s-1 is the same op);
    stages.{s}.blocks.{b}.{conv1,conv2,conv3} for the MBConv stage and
    .{attn,local_conv,mlp} for transformer stages; head.norm for the final
    LayerNorm (num_classes=0 keeps it).
    """
    params: Dict = {}
    stats: Dict = {}

    params["patch_embed"] = {
        "conv1": _convbn(sd, "patch_embed.conv1"),
        "conv2": _convbn(sd, "patch_embed.conv2"),
    }
    stats["patch_embed"] = {
        "conv1": _convbn_stats(sd, "patch_embed.conv1"),
        "conv2": _convbn_stats(sd, "patch_embed.conv2"),
    }

    for s in range(len(cfg.depths)):
        for b in range(cfg.depths[s]):
            tpre = f"stages.{s}.blocks.{b}"
            name = f"stage{s}_block{b}"
            if s == 0:
                params[name] = {
                    "conv1": _convbn(sd, f"{tpre}.conv1"),
                    "conv2": _convbn(sd, f"{tpre}.conv2"),
                    "conv3": _convbn(sd, f"{tpre}.conv3"),
                }
                stats[name] = {
                    "conv1": _convbn_stats(sd, f"{tpre}.conv1"),
                    "conv2": _convbn_stats(sd, f"{tpre}.conv2"),
                    "conv3": _convbn_stats(sd, f"{tpre}.conv3"),
                }
            else:
                params[name] = {
                    "attn": {
                        "norm": {
                            "scale": np.asarray(sd[f"{tpre}.attn.norm.weight"]),
                            "bias": np.asarray(sd[f"{tpre}.attn.norm.bias"]),
                        },
                        "qkv": {
                            "kernel": _t(np.asarray(sd[f"{tpre}.attn.qkv.weight"])),
                            "bias": np.asarray(sd[f"{tpre}.attn.qkv.bias"]),
                        },
                        "proj": {
                            "kernel": _t(np.asarray(sd[f"{tpre}.attn.proj.weight"])),
                            "bias": np.asarray(sd[f"{tpre}.attn.proj.bias"]),
                        },
                        "attention_biases": np.asarray(
                            sd[f"{tpre}.attn.attention_biases"]
                        ),
                    },
                    "local_conv": _convbn(sd, f"{tpre}.local_conv"),
                    "mlp": {
                        "norm": {
                            "scale": np.asarray(sd[f"{tpre}.mlp.norm.weight"]),
                            "bias": np.asarray(sd[f"{tpre}.mlp.norm.bias"]),
                        },
                        "fc1": {
                            "kernel": _t(np.asarray(sd[f"{tpre}.mlp.fc1.weight"])),
                            "bias": np.asarray(sd[f"{tpre}.mlp.fc1.bias"]),
                        },
                        "fc2": {
                            "kernel": _t(np.asarray(sd[f"{tpre}.mlp.fc2.weight"])),
                            "bias": np.asarray(sd[f"{tpre}.mlp.fc2.bias"]),
                        },
                    },
                }
                stats[name] = {
                    "local_conv": _convbn_stats(sd, f"{tpre}.local_conv")
                }
        if s < len(cfg.depths) - 1:
            # timm: the op producing stage s+1's dim is stages.{s+1}.downsample
            dpre = f"stages.{s + 1}.downsample"
            params[f"downsample{s}"] = {
                "conv1": _convbn(sd, f"{dpre}.conv1"),
                "conv2": _convbn(sd, f"{dpre}.conv2"),
                "conv3": _convbn(sd, f"{dpre}.conv3"),
            }
            stats[f"downsample{s}"] = {
                "conv1": _convbn_stats(sd, f"{dpre}.conv1"),
                "conv2": _convbn_stats(sd, f"{dpre}.conv2"),
                "conv3": _convbn_stats(sd, f"{dpre}.conv3"),
            }

    # final head norm (timm NormMlpClassifierHead keeps norm at head.norm)
    for key in ("head.norm.weight", "norm_head.weight"):
        if key in sd:
            base = key.rsplit(".", 1)[0]
            params["norm_head"] = {
                "scale": np.asarray(sd[f"{base}.weight"]),
                "bias": np.asarray(sd[f"{base}.bias"]),
            }
            break
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# SuperGuessr head (reference checkpoints)
# ---------------------------------------------------------------------------


def super_guessr_head_from_reference(
    sd: Dict[str, np.ndarray],
    num_cells: Optional[int] = None,
    num_attention_heads: int = 16,
) -> Dict:
    """Extract head params from a reference SuperGuessr state dict.

    Shape-filtered like the reference's partial load (inference.py:126-156):
    a cell_layer whose num_cells mismatches is skipped.  Returns a params
    subtree to merge over a freshly initialized model.
    """
    out: Dict = {}
    if "cell_layer.weight" in sd:
        w = np.asarray(sd["cell_layer.weight"])  # (num_cells, D)
        if num_cells is None or w.shape[0] == num_cells:
            out["cell_layer"] = {
                "kernel": _t(w),
                "bias": np.asarray(sd["cell_layer.bias"]),
            }
    if "self_attn.in_proj_weight" in sd:
        w = np.asarray(sd["self_attn.in_proj_weight"])  # (3D, D)
        b = np.asarray(sd["self_attn.in_proj_bias"])
        D = w.shape[1]
        H = num_attention_heads  # reference NUM_ATTENTION_HEADS=16
        hd = D // H
        qw, kw, vw = np.split(w, 3, axis=0)
        qb, kb, vb = np.split(b, 3, axis=0)
        out["self_attn"] = {
            "query": {"kernel": _t(qw).reshape(D, H, hd), "bias": qb.reshape(H, hd)},
            "key": {"kernel": _t(kw).reshape(D, H, hd), "bias": kb.reshape(H, hd)},
            "value": {"kernel": _t(vw).reshape(D, H, hd), "bias": vb.reshape(H, hd)},
            "out": {
                "kernel": _t(np.asarray(sd["self_attn.out_proj.weight"])).reshape(H, hd, D),
                "bias": np.asarray(sd["self_attn.out_proj.bias"]),
            },
        }
    return out


def super_guessr_head_to_reference(
    params: Dict, num_attention_heads: int = 16
) -> Dict[str, np.ndarray]:
    """Export SuperGuessr head params to the reference's state-dict
    naming (inverse of super_guessr_head_from_reference) so models
    trained here can be loaded by the PyTorch reference
    (cell_layer.weight/bias, self_attn.in_proj_weight/bias,
    self_attn.out_proj.*; super_guessr.py:89-103)."""
    out: Dict[str, np.ndarray] = {}
    if "cell_layer" in params:
        k = np.asarray(params["cell_layer"]["kernel"])  # (D, num_cells)
        out["cell_layer.weight"] = _t(k)  # (num_cells, D)
        out["cell_layer.bias"] = np.asarray(params["cell_layer"]["bias"])
    if "self_attn" in params:
        sa = params["self_attn"]
        H = num_attention_heads

        def flat_qkv(name):
            kk = np.asarray(sa[name]["kernel"])  # (D, H, hd)
            D = kk.shape[0]
            return _t(kk.reshape(D, D)), np.asarray(
                sa[name]["bias"]
            ).reshape(D)

        qw, qb = flat_qkv("query")
        kw, kb = flat_qkv("key")
        vw, vb = flat_qkv("value")
        out["self_attn.in_proj_weight"] = np.concatenate([qw, kw, vw], 0)
        out["self_attn.in_proj_bias"] = np.concatenate([qb, kb, vb], 0)
        ok = np.asarray(sa["out"]["kernel"])  # (H, hd, D)
        D = ok.shape[-1]
        out["self_attn.out_proj.weight"] = _t(ok.reshape(D, D))
        out["self_attn.out_proj.bias"] = np.asarray(sa["out"]["bias"])
    return out


def tinyvit_to_timm(
    variables: Dict, cfg: TinyViTConfig
) -> Dict[str, np.ndarray]:
    """Export TinyViT params+batch_stats to a timm-format state dict —
    the inverse of tinyvit_from_timm, so models finetuned here load into
    timm/PyTorch (same key naming as timm tiny_vit; held against
    the JAX package's exporter in tests/test_torch_port_guess_path.py)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def put_convbn(prefix: str, p: Dict, st: Dict) -> None:
        sd[f"{prefix}.conv.weight"] = _conv_inv(
            np.asarray(p["conv"]["kernel"])
        )
        sd[f"{prefix}.bn.weight"] = np.asarray(p["bn"]["scale"])
        sd[f"{prefix}.bn.bias"] = np.asarray(p["bn"]["bias"])
        sd[f"{prefix}.bn.running_mean"] = np.asarray(st["bn"]["mean"])
        sd[f"{prefix}.bn.running_var"] = np.asarray(st["bn"]["var"])

    def put_linear(prefix: str, p: Dict) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]))
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_norm(prefix: str, p: Dict) -> None:
        sd[f"{prefix}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    for c in ("conv1", "conv2"):
        put_convbn(
            f"patch_embed.{c}",
            params["patch_embed"][c],
            stats["patch_embed"][c],
        )
    for s_i in range(len(cfg.depths)):
        if s_i > 0:
            dname = f"downsample{s_i - 1}"
            for c in ("conv1", "conv2", "conv3"):
                put_convbn(
                    f"stages.{s_i}.downsample.{c}",
                    params[dname][c],
                    stats[dname][c],
                )
        for b in range(cfg.depths[s_i]):
            name = f"stage{s_i}_block{b}"
            tpre = f"stages.{s_i}.blocks.{b}"
            if s_i == 0:
                for c in ("conv1", "conv2", "conv3"):
                    put_convbn(
                        f"{tpre}.{c}", params[name][c], stats[name][c]
                    )
            else:
                blk = params[name]
                put_norm(f"{tpre}.attn.norm", blk["attn"]["norm"])
                put_linear(f"{tpre}.attn.qkv", blk["attn"]["qkv"])
                put_linear(f"{tpre}.attn.proj", blk["attn"]["proj"])
                sd[f"{tpre}.attn.attention_biases"] = np.asarray(
                    blk["attn"]["attention_biases"]
                )
                put_convbn(
                    f"{tpre}.local_conv",
                    blk["local_conv"],
                    stats[name]["local_conv"],
                )
                put_norm(f"{tpre}.mlp.norm", blk["mlp"]["norm"])
                put_linear(f"{tpre}.mlp.fc1", blk["mlp"]["fc1"])
                put_linear(f"{tpre}.mlp.fc2", blk["mlp"]["fc2"])
    put_norm("head.norm", params["norm_head"])
    return sd

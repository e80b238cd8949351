"""Pretrained-encoder weight import: an HF ConvNeXt (``ConvNextModel``,
the checkpoint format of facebook/convnext-*) or ViT (``ViTModel``,
google/vit-*) state dict -> the Flax-named variables tree of the
registry's encoders (the JAX package's models/import_weights.py), which
``train-recognizer --checkpoint`` warm-starts from.

The converters are numpy relayouts and give the JAX package's trees array
for array.  The weights are read without ``safetensors`` or
``transformers``: ``model.safetensors`` through interop/safetensors.py,
``pytorch_model.bin`` through ``torch.load(weights_only=True)``.  The
structure check compares against the port's own module
(``state_dict_to_flax`` of its state dict).  Our LayerNorms use the timm
eps 1e-6 where HF ViT configs default to 1e-12, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

CONVNEXT_PRESETS = {
    ((2, 2, 6, 2), (40, 80, 160, 320)): "convnext_atto",
    ((2, 2, 6, 2), (48, 96, 192, 384)): "convnext_femto",
    ((2, 2, 8, 2), (80, 160, 320, 640)): "convnext_nano",
    ((3, 3, 9, 3), (96, 192, 384, 768)): "convnext_tiny",
    ((3, 3, 27, 3), (96, 192, 384, 768)): "convnext_small",
}
VIT_PRESETS = {(192, 12, 3, 16): "vit_tiny_patch16_224",
               (384, 12, 6, 16): "vit_small_patch16_224"}


def _t(w) -> np.ndarray:
    """torch Linear [out, in] -> Flax Dense kernel [in, out]."""
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _conv(w) -> np.ndarray:
    """torch Conv2d OIHW -> Flax HWIO."""
    return np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def _ln(sd, key) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _f32(sd, key) -> np.ndarray:
    return np.asarray(sd[key], np.float32)


def convert_hf_convnext(sd: Mapping[str, Any], depths, dims
                        ) -> Dict[str, Any]:
    """HF ConvNextModel state dict -> our ConvNeXt params tree."""
    sd = dict(sd)
    p: Dict[str, Any] = {
        "stem": {"kernel": _conv(sd["embeddings.patch_embeddings.weight"]),
                 "bias": _f32(sd, "embeddings.patch_embeddings.bias")},
        "stem_norm": _ln(sd, "embeddings.layernorm"),
        "head_norm": _ln(sd, "layernorm"),
    }
    for i, depth in enumerate(depths):
        if i > 0:
            base = f"encoder.stages.{i}.downsampling_layer"
            p[f"downsample_norm{i}"] = _ln(sd, f"{base}.0")
            p[f"downsample{i}"] = {"kernel": _conv(sd[f"{base}.1.weight"]),
                                   "bias": _f32(sd, f"{base}.1.bias")}
        for j in range(depth):
            b = f"encoder.stages.{i}.layers.{j}"
            p[f"stage{i}_block{j}"] = {
                # depthwise [dim, 1, 7, 7] -> [7, 7, 1, dim]
                "dwconv": {"kernel": _conv(sd[f"{b}.dwconv.weight"]),
                           "bias": _f32(sd, f"{b}.dwconv.bias")},
                "LayerNorm_0": _ln(sd, f"{b}.layernorm"),
                "mlp_up": {"kernel": _t(sd[f"{b}.pwconv1.weight"]),
                           "bias": _f32(sd, f"{b}.pwconv1.bias")},
                "mlp_down": {"kernel": _t(sd[f"{b}.pwconv2.weight"]),
                             "bias": _f32(sd, f"{b}.pwconv2.bias")},
                "gamma": _f32(sd, f"{b}.layer_scale_parameter"),
            }
    return p


def convert_hf_vit(sd: Mapping[str, Any], depth: int) -> Dict[str, Any]:
    """HF ViTModel state dict -> our ViT params tree (fused qkv)."""
    sd = dict(sd)
    p: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _conv(
                sd["embeddings.patch_embeddings.projection.weight"]),
            "bias": _f32(sd, "embeddings.patch_embeddings.projection.bias"),
        },
        "cls": _f32(sd, "embeddings.cls_token"),
        "pos": _f32(sd, "embeddings.position_embeddings"),
        "norm": _ln(sd, "layernorm"),
    }
    for i in range(depth):
        b = f"encoder.layer.{i}"
        att = f"{b}.attention.attention"
        qkv_w = np.concatenate(
            [_t(sd[f"{att}.{n}.weight"]) for n in ("query", "key", "value")],
            axis=1)
        qkv_b = np.concatenate(
            [_f32(sd, f"{att}.{n}.bias") for n in ("query", "key", "value")])
        p[f"block{i}"] = {
            "LayerNorm_0": _ln(sd, f"{b}.layernorm_before"),
            "SelfAttention_0": {
                "qkv": {"kernel": qkv_w, "bias": qkv_b},
                "proj": {
                    "kernel": _t(sd[f"{b}.attention.output.dense.weight"]),
                    "bias": _f32(sd, f"{b}.attention.output.dense.bias"),
                },
            },
            "LayerNorm_1": _ln(sd, f"{b}.layernorm_after"),
            "Mlp_0": {
                "Dense_0": {
                    "kernel": _t(sd[f"{b}.intermediate.dense.weight"]),
                    "bias": _f32(sd, f"{b}.intermediate.dense.bias"),
                },
                "Dense_1": {"kernel": _t(sd[f"{b}.output.dense.weight"]),
                            "bias": _f32(sd, f"{b}.output.dense.bias")},
            },
        }
    return p


def _load_hf_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    st = os.path.join(model_dir, "model.safetensors")
    bn = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st):
        from effocr_torch.interop.safetensors import load_file

        sd = load_file(st)
    elif os.path.exists(bn):
        import torch

        sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
              for k, v in torch.load(bn, map_location="cpu",
                                     weights_only=True).items()}
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin in {model_dir}")
    # bare-model checkpoints may carry the model-type prefix
    for prefix in ("convnext.", "vit."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v
                  for k, v in sd.items()}
    return sd


def tree_shapes(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The same nesting with each leaf's shape (structure checks)."""
    return {k: tree_shapes(v) if isinstance(v, Mapping) else np.shape(v)
            for k, v in tree.items()}


def check_tree(model, variables: Mapping[str, Any], what: str) -> None:
    """Raise unless ``variables`` has the port module's tree: the same
    collections, names and shapes as ``state_dict_to_flax`` of its state
    dict."""
    from effocr_torch.interop.flax_bridge import state_dict_to_flax

    ref = state_dict_to_flax(model.state_dict())
    for col in set(ref) | set(variables):
        want = tree_shapes(ref.get(col, {}))
        got = tree_shapes(variables.get(col, {}))
        if want != got:
            raise ValueError(
                f"converted {col} does not match {what}:\n"
                f"expected {want}\ngot {got}")


def sorted_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The same tree with every level's keys sorted: the order in which
    the JAX package writes a checkpoint (its pytree functions sort dict
    keys), so both packages write the same bytes."""
    return {k: sorted_tree(tree[k]) if isinstance(tree[k], Mapping)
            else tree[k] for k in sorted(tree)}


def stem_channels(kernel: np.ndarray) -> int:
    """Input channels of a converted HWIO stem kernel."""
    return int(np.shape(kernel)[2])


def import_hf_encoder(model_dir: str, arch: Optional[str] = None
                      ) -> Tuple[Dict[str, Any], str, int]:
    """HF checkpoint dir -> (variables, registry arch name, image_size).

    The converted tree is checked against a fresh ``create_encoder`` of
    the arch (names and shapes), as the JAX package checks it against its
    module's init."""
    from effocr_torch.models.factory import create_encoder

    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    sd = _load_hf_state_dict(model_dir)
    model_type = cfg.get("model_type", "")

    if model_type == "convnext":
        depths = list(cfg["depths"])
        dims = list(cfg["hidden_sizes"])
        name = arch or CONVNEXT_PRESETS.get((tuple(depths), tuple(dims)))
        if name is None:
            raise ValueError(
                f"no registry preset for ConvNeXt depths={depths} "
                f"dims={dims}; pass --arch to override")
        params = convert_hf_convnext(sd, depths, dims)
        image_size = int(cfg.get("image_size", 224))
        stem = params["stem"]["kernel"]
    elif model_type == "vit":
        depth = int(cfg["num_hidden_layers"])
        key = (int(cfg["hidden_size"]), depth,
               int(cfg["num_attention_heads"]), int(cfg["patch_size"]))
        name = arch or VIT_PRESETS.get(key)
        if name is None:
            raise ValueError(
                f"no registry preset for ViT (dim, depth, heads, patch)="
                f"{key}; pass --arch to override")
        params = convert_hf_vit(sd, depth)
        image_size = int(cfg.get("image_size", 224))
        stem = params["patch_embed"]["kernel"]
    else:
        raise ValueError(
            f"unsupported model_type {model_type!r} (have: convnext, vit)")

    model = create_encoder(name, in_channels=stem_channels(stem),
                           image_size=image_size)
    variables = {"params": sorted_tree(params)}
    check_tree(model, variables, "the registry module")
    return variables, name, image_size

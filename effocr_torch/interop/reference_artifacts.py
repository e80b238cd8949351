"""Importers for the original EffOCR's trained-artifact formats (the JAX
package's interop/reference_artifacts.py).

A reference-format ``recognizer_dir`` holds:

- ``enc_best.pth``: the torch state dict of a timm encoder (or
  ``enc_best.onnx``, read by interop/onnx_import.py);
- ``ref.index``: a FAISS ``IndexFlatIP`` over L2-normalized glyph
  prototype embeddings;
- ``ref.txt``: one char per index row.

This module converts it into the artifact layout both packages read
(``enc_best.msgpack`` + ``model.json`` + ``ref.npz``/``ref.txt``) without
faiss, timm or onnxruntime: the FAISS flat-index binary is parsed
directly, and timm's names are mapped onto the Flax-named tree, array for
array the JAX converter's.  ``cli/infer.py`` converts such a directory on
first use into ``<dir>/tpu_converted``, the name the JAX package uses, so
each package finds and reuses a conversion the other made.

Encoders: timm ConvNeXt (convnext_atto..small), timm MobileNetV3-Small
(050/100) and timm/facebook XCiT p8 (tiny/small; the patch-embed
BatchNorms folded, the Fourier positional encoding baked into a table).
One extension over the JAX package: the encoder's input channels are read
from its stem (the JAX importer builds a 3-channel module and refuses a
1-channel checkpoint).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from effocr_torch.models.import_weights import (
    CONVNEXT_PRESETS,
    _conv,
    _ln,
    _t,
    check_tree,
    sorted_tree,
    stem_channels,
)

CONVERTED_DIR = "tpu_converted"

# --------------------------------------------------------------------- faiss

_FLAT_FOURCC = {b"IxFI": "ip", b"IxF2": "l2", b"IxFl": "flat"}


def read_faiss_flat_index(path: str) -> Tuple[np.ndarray, str]:
    """Parse a serialized FAISS ``IndexFlat`` (``faiss.write_index`` file).

    Layout (faiss/impl/index_write.cpp): fourcc (IxFI inner product, IxF2
    L2, IxFl other), then the header (int32 d, int64 ntotal, two int64
    dummies, bool is_trained, int32 metric_type, and a float metric_arg
    when metric_type > 1), then the vectors: a uint64 count and the raw
    data.  Modern faiss stores ``codes`` as bytes (count = ntotal*d*4),
    before 1.7 ``xb`` as floats (count = ntotal*d); both are read.

    Returns (embeddings [ntotal, d] float32, metric name).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 33:
        raise ValueError(f"{path}: too short to be a FAISS flat index")
    fourcc = blob[:4]
    if fourcc not in _FLAT_FOURCC:
        raise ValueError(
            f"{path}: fourcc {fourcc!r} is not a flat index "
            f"(IndexFlatIP/IndexFlatL2); other index types are not "
            f"supported — rebuild with IndexFlatIP like the reference")
    off = 4
    d, = struct.unpack_from("<i", blob, off); off += 4
    ntotal, = struct.unpack_from("<q", blob, off); off += 8
    off += 16                       # two idx_t dummies
    off += 1                        # is_trained
    metric_type, = struct.unpack_from("<i", blob, off); off += 4
    if metric_type > 1:             # metric_arg
        off += 4
    count, = struct.unpack_from("<Q", blob, off); off += 8
    need_f32 = d * ntotal
    if count == need_f32 * 4:       # codes: bytes
        raw = blob[off:off + count]
    elif count == need_f32:         # legacy xb: floats
        raw = blob[off:off + count * 4]
    else:
        raise ValueError(
            f"{path}: vector count {count} inconsistent with "
            f"d={d} ntotal={ntotal}")
    if len(raw) < need_f32 * 4:
        raise ValueError(f"{path}: truncated vector data")
    emb = np.frombuffer(raw, dtype="<f4").reshape(ntotal, d).copy()
    metric = {0: "ip", 1: "l2"}.get(metric_type, "other")
    return emb, metric


def load_reference_ref_txt(path: str) -> List[str]:
    """One char per index row, line by line (``.split()`` would swallow
    the whitespace chars a font-coverage charset holds and shift every
    later row)."""
    chars: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                chars.append(line[0] if len(line) > 1 else line)
    return chars


# ----------------------------------------------------------- timm state dicts

def _bn(sd: Mapping[str, Any], key: str
        ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """torch BatchNorm -> (params {scale, bias}, stats {mean, var})."""
    return (
        {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
         "bias": np.asarray(sd[f"{key}.bias"], np.float32)},
        {"mean": np.asarray(sd[f"{key}.running_mean"], np.float32),
         "var": np.asarray(sd[f"{key}.running_var"], np.float32)},
    )


def _dense(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{key}.weight"]),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _conv_b(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _conv(sd[f"{key}.weight"]),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def detect_timm_arch(sd: Mapping[str, Any]) -> str:
    """Registry arch name from a timm state dict's keys and shapes."""
    if "stem.0.weight" in sd and "stages.0.blocks.0.conv_dw.weight" in sd:
        dims = tuple(
            int(sd[f"stages.{i}.blocks.0.conv_dw.weight"].shape[0])
            for i in range(4))
        depths = tuple(
            sum(1 for k in sd
                if k.startswith(f"stages.{i}.blocks.")
                and k.endswith(".conv_dw.weight"))
            for i in range(4))
        name = CONVNEXT_PRESETS.get((depths, dims))
        if name is None:
            raise ValueError(
                f"unrecognized timm ConvNeXt depths={depths} dims={dims}")
        return name
    if "conv_stem.weight" in sd:
        stem = int(sd["conv_stem.weight"].shape[0])
        if stem == 8:
            return "mobilenetv3_small_050"
        if stem == 16:
            return "mobilenetv3_small_100"
        raise ValueError(f"unrecognized MobileNetV3 stem width {stem}")
    if "cls_token" in sd and "blocks.0.attn.temperature" in sd:
        dim = int(np.shape(sd["cls_token"])[-1])
        heads = int(np.shape(sd["blocks.0.attn.temperature"])[0])
        depth = sum(1 for k in sd if k.endswith(".attn.temperature")
                    and k.startswith("blocks."))
        patch = 2 ** _xcit_convs(sd)
        presets = {
            (384, 12, 8, 8): "xcit_small_12_p8_224",
            (192, 12, 4, 8): "xcit_tiny_12_p8_224",
        }
        name = presets.get((dim, depth, heads, patch))
        if name is None:
            raise ValueError(
                f"unrecognized XCiT dim={dim} depth={depth} heads={heads} "
                f"patch={patch}")
        return name
    raise ValueError(
        "state dict is neither timm ConvNeXt (stages.*.blocks.*), timm "
        "MobileNetV3 (conv_stem.*), nor XCiT (cls_token + "
        "blocks.*.attn.temperature); pass --arch and use import-encoder "
        "for HF-layout checkpoints")


def convert_timm_convnext(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """timm ConvNeXt state dict -> our ConvNeXt params tree.

    timm names: stem.{0 conv,1 norm}, stages.{i}.downsample.{0 norm,
    1 conv} (i > 0), stages.{i}.blocks.{j}.{conv_dw,norm,mlp.fc1,mlp.fc2,
    gamma}, head.norm (num_classes=0 keeps head.norm, drops head.fc).
    """
    sd = dict(sd)
    head_norm = "head.norm" if "head.norm.weight" in sd else "norm"
    p: Dict[str, Any] = {
        "stem": _conv_b(sd, "stem.0"),
        "stem_norm": _ln(sd, "stem.1"),
        "head_norm": _ln(sd, head_norm),
    }
    n_stages = sum(
        1 for i in range(8) if f"stages.{i}.blocks.0.conv_dw.weight" in sd)
    for i in range(n_stages):
        if i > 0:
            p[f"downsample_norm{i}"] = _ln(sd, f"stages.{i}.downsample.0")
            p[f"downsample{i}"] = _conv_b(sd, f"stages.{i}.downsample.1")
        j = 0
        while f"stages.{i}.blocks.{j}.conv_dw.weight" in sd:
            b = f"stages.{i}.blocks.{j}"
            gamma_key = (f"{b}.gamma" if f"{b}.gamma" in sd
                         else f"{b}.weight")  # timm >= 0.9 renamed it
            p[f"stage{i}_block{j}"] = {
                "dwconv": _conv_b(sd, f"{b}.conv_dw"),
                "LayerNorm_0": _ln(sd, f"{b}.norm"),
                "mlp_up": _dense(sd, f"{b}.mlp.fc1"),
                "mlp_down": _dense(sd, f"{b}.mlp.fc2"),
                "gamma": np.asarray(sd[gamma_key], np.float32),
            }
            j += 1
    return p


def convert_timm_mobilenetv3(sd: Mapping[str, Any]
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """timm MobileNetV3-Small state dict -> (params, batch_stats).

    timm names (efficientnet builder): conv_stem/bn1; blocks.{stage}.{j},
    where block 0.0 is DepthwiseSeparable (conv_dw/bn1/se/conv_pw/bn2),
    the inverted residuals conv_pw (expand)/bn1/conv_dw/bn2/se/conv_pwl
    (project)/bn3, and the trailing ConvBnAct stage conv/bn1; then the
    global pool and conv_head (1x1 with bias, after pooling: our Dense
    head).  SE convs: se.conv_reduce/se.conv_expand.
    """
    sd = dict(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["stem"] = {"kernel": _conv(sd["conv_stem.weight"])}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "bn1")

    flat = 0
    stage = 0
    while any(k.startswith(f"blocks.{stage}.") for k in sd):
        j = 0
        while any(k.startswith(f"blocks.{stage}.{j}.") for k in sd):
            b = f"blocks.{stage}.{j}"
            if f"{b}.conv.weight" in sd:        # trailing ConvBnAct
                params["last_conv"] = {"kernel": _conv(sd[f"{b}.conv.weight"])}
                params["last_bn"], stats["last_bn"] = _bn(sd, f"{b}.bn1")
                j += 1
                continue
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            if f"{b}.conv_pwl.weight" in sd:    # InvertedResidual (expand)
                bp["expand"] = {"kernel": _conv(sd[f"{b}.conv_pw.weight"])}
                bp["expand_bn"], bs["expand_bn"] = _bn(sd, f"{b}.bn1")
                dw_bn, pr_bn, project = f"{b}.bn2", f"{b}.bn3", "conv_pwl"
            else:                               # DepthwiseSeparable
                dw_bn, pr_bn, project = f"{b}.bn1", f"{b}.bn2", "conv_pw"
            bp["dw"] = {"kernel": _conv(sd[f"{b}.conv_dw.weight"])}
            bp["dw_bn"], bs["dw_bn"] = _bn(sd, dw_bn)
            if f"{b}.se.conv_reduce.weight" in sd:
                bp["SqueezeExcite_0"] = {
                    "reduce": _conv_b(sd, f"{b}.se.conv_reduce"),
                    "expand": _conv_b(sd, f"{b}.se.conv_expand"),
                }
            bp["project"] = {"kernel": _conv(sd[f"{b}.{project}.weight"])}
            bp["project_bn"], bs["project_bn"] = _bn(sd, pr_bn)
            params[f"block{flat}"] = bp
            stats[f"block{flat}"] = bs
            flat += 1
            j += 1
        stage += 1

    params["head"] = {
        "kernel": np.ascontiguousarray(
            np.asarray(sd["conv_head.weight"], np.float32)[:, :, 0, 0].T),
        "bias": np.asarray(sd["conv_head.bias"], np.float32),
    }
    return params, stats


def _xcit_convs(sd: Mapping[str, Any]) -> int:
    return sum(1 for k in range(0, 8, 2)
               if f"patch_embed.proj.{k}.0.weight" in sd)


def _xcit_fourier_pos(sd, prefix: str, hw: int, dim: int) -> np.ndarray:
    """Bake timm's PositionalEncodingFourier output into a [1, hw*hw, dim]
    table (sinusoidal features of the normalized grid coordinates through
    the learned 1x1 ``token_projection``): at a fixed grid the table holds
    exactly timm's values."""
    proj_w = np.asarray(sd[f"{prefix}.token_projection.weight"], np.float32)
    proj_b = np.asarray(sd[f"{prefix}.token_projection.bias"], np.float32)
    hidden = proj_w.shape[1] // 2
    scale = 2.0 * np.pi
    eps = 1e-6
    coord = (np.arange(1, hw + 1, dtype=np.float32) / (hw + eps)) * scale
    y_embed = np.broadcast_to(coord[:, None], (hw, hw))
    x_embed = np.broadcast_to(coord[None, :], (hw, hw))
    dim_t = np.arange(hidden, dtype=np.float32)
    dim_t = 10000.0 ** (2.0 * (dim_t // 2) / hidden)

    def feats(embed):
        p = embed[:, :, None] / dim_t                       # [hw, hw, hidden]
        return np.stack(
            [np.sin(p[:, :, 0::2]), np.cos(p[:, :, 1::2])], axis=3
        ).reshape(hw, hw, hidden)

    pos = np.concatenate([feats(y_embed), feats(x_embed)], axis=2)
    out = pos @ proj_w[:, :, 0, 0].T + proj_b               # [hw, hw, dim]
    return out.reshape(1, hw * hw, dim).astype(np.float32)


def convert_timm_xcit(sd: Mapping[str, Any], image_size: int = 224
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """timm/facebook XCiT state dict -> (params, batch_stats) for our XCiT.

    timm names: patch_embed.proj.{0,2,4}.{0 conv,1 bn} (GELU between),
    pos_embed.token_projection (``pos_embeder`` in the facebook repo),
    cls_token, blocks.{i}.{norm1,attn.{qkv,proj,temperature},norm3,
    local_mp.{conv1,bn,conv2},norm2,mlp.{fc1,fc2},gamma1..3},
    cls_attn_blocks.{i}.{norm1,attn.{q,k,v,proj},norm2,mlp,gamma1,gamma2},
    norm.  The patch-embed BatchNorms fold into the convs (exact in eval);
    the Fourier positional encoding is baked at ``image_size``.
    """
    sd = dict(sd)
    dim = int(np.shape(sd["cls_token"])[-1])
    n_convs = _xcit_convs(sd)
    hw = image_size // 2 ** n_convs
    pos_prefix = ("pos_embed" if "pos_embed.token_projection.weight" in sd
                  else "pos_embeder")

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_convs):
        k = f"patch_embed.proj.{2 * i}"
        w = np.asarray(sd[f"{k}.0.weight"], np.float32)
        bn_w = np.asarray(sd[f"{k}.1.weight"], np.float32)
        bn_b = np.asarray(sd[f"{k}.1.bias"], np.float32)
        mean = np.asarray(sd[f"{k}.1.running_mean"], np.float32)
        var = np.asarray(sd[f"{k}.1.running_var"], np.float32)
        s = bn_w / np.sqrt(var + 1e-5)                       # BN2d eps
        conv_b = np.asarray(sd.get(f"{k}.0.bias", np.zeros(w.shape[0])),
                            np.float32)
        params[f"patch_conv{i}"] = {
            "kernel": _conv(w * s[:, None, None, None]),
            "bias": (conv_b - mean) * s + bn_b,
        }
    params["pos"] = _xcit_fourier_pos(sd, pos_prefix, hw, dim)
    params["cls"] = np.asarray(sd["cls_token"], np.float32)

    def f32(key):
        return np.asarray(sd[key], np.float32)

    i = 0
    while f"blocks.{i}.attn.temperature" in sd:
        b = f"blocks.{i}"
        params[f"block{i}"] = {
            "LayerNorm_0": _ln(sd, f"{b}.norm1"),
            "XCA_0": {"qkv": _dense(sd, f"{b}.attn.qkv"),
                      "proj": _dense(sd, f"{b}.attn.proj"),
                      "temperature": f32(f"{b}.attn.temperature")},
            "LayerNorm_1": _ln(sd, f"{b}.norm3"),
            "LPI_0": {
                "conv1": _conv_b(sd, f"{b}.local_mp.conv1"),
                "bn": {"scale": f32(f"{b}.local_mp.bn.weight"),
                       "bias": f32(f"{b}.local_mp.bn.bias")},
                "conv2": _conv_b(sd, f"{b}.local_mp.conv2"),
            },
            "LayerNorm_2": _ln(sd, f"{b}.norm2"),
            "Mlp_0": {"Dense_0": _dense(sd, f"{b}.mlp.fc1"),
                      "Dense_1": _dense(sd, f"{b}.mlp.fc2")},
            "gamma1": f32(f"{b}.gamma1"),
            "gamma2": f32(f"{b}.gamma2"),
            "gamma3": f32(f"{b}.gamma3"),
        }
        stats[f"block{i}"] = {"LPI_0": {"bn": {
            "mean": f32(f"{b}.local_mp.bn.running_mean"),
            "var": f32(f"{b}.local_mp.bn.running_var"),
        }}}
        i += 1

    i = 0
    while f"cls_attn_blocks.{i}.norm1.weight" in sd:
        b = f"cls_attn_blocks.{i}"
        if f"{b}.attn.qkv.weight" in sd:     # merged-qkv variants: split
            qkv_w = f32(f"{b}.attn.qkv.weight")
            qkv_b = f32(f"{b}.attn.qkv.bias")
            for j, nm in enumerate(("q", "k", "v")):
                sd[f"{b}.attn.{nm}.weight"] = qkv_w[j * dim:(j + 1) * dim]
                sd[f"{b}.attn.{nm}.bias"] = qkv_b[j * dim:(j + 1) * dim]
        params[f"cls_block{i}"] = {
            "LayerNorm_0": _ln(sd, f"{b}.norm1"),
            **{nm: _dense(sd, f"{b}.attn.{nm}") for nm in ("q", "k", "v")},
            "proj": _dense(sd, f"{b}.attn.proj"),
            "LayerNorm_1": _ln(sd, f"{b}.norm2"),
            "Mlp_0": {"Dense_0": _dense(sd, f"{b}.mlp.fc1"),
                      "Dense_1": _dense(sd, f"{b}.mlp.fc2")},
            "gamma1": f32(f"{b}.gamma1"),
            "gamma2": f32(f"{b}.gamma2"),
        }
        i += 1

    params["norm"] = _ln(sd, "norm")
    return params, stats


# ------------------------------------------------------------- directory glue

def _read_encoder_state_dict(src_dir: str) -> Dict[str, Any]:
    pth = os.path.join(src_dir, "enc_best.pth")
    onnx_path = os.path.join(src_dir, "enc_best.onnx")
    if os.path.exists(pth):
        import torch

        sd = torch.load(pth, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        # nn.DataParallel saves (the reference at > 1 GPU): "module."
        sd = {k[7:] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        return {k: v.float().numpy() if hasattr(v, "numpy") else v
                for k, v in sd.items()}
    if os.path.exists(onnx_path):
        # an ONNX-only dir is a valid reference layout
        from effocr_torch.interop.onnx_import import onnx_to_state_dict

        return onnx_to_state_dict(onnx_path)
    raise FileNotFoundError(
        f"{src_dir}: neither enc_best.pth nor enc_best.onnx")


def import_reference_recognizer_dir(
    src_dir: str,
    out_dir: Optional[str] = None,
    arch: Optional[str] = None,
    image_size: int = 224,
) -> str:
    """Convert a reference-format recognizer_dir into the artifact layout.

    Reads enc_best.pth (or enc_best.onnx) + ref.index + ref.txt; writes
    enc_best.msgpack, model.json, ref.npz and ref.txt into ``out_dir``
    (default <src_dir>/tpu_converted).  Returns out_dir.
    """
    from effocr_torch.models.factory import create_encoder
    from effocr_torch.retrieval.index import PrototypeIndex
    from effocr_torch.train import checkpoint as ckpt

    sd = _read_encoder_state_dict(src_dir)
    name = arch or detect_timm_arch(sd)
    if name.startswith("convnext"):
        params = convert_timm_convnext(sd)
        batch_stats: Dict[str, Any] = {}
    elif name.startswith("mobilenetv3"):
        params, batch_stats = convert_timm_mobilenetv3(sd)
    elif name.startswith("xcit"):
        params, batch_stats = convert_timm_xcit(sd, image_size)
    else:
        raise ValueError(f"unsupported arch {name!r} for timm import")

    kw: Dict[str, Any] = {}
    if name.startswith("mobilenetv3"):
        # timm's conv_head width is a property of the checkpoint (1024
        # for the stock smalls; reduced-width exports exist)
        kw["head_features"] = int(np.shape(params["head"]["bias"])[0])
    stem = params["patch_conv0" if name.startswith("xcit") else "stem"]
    channels = stem_channels(stem["kernel"])
    variables: Dict[str, Any] = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    variables = sorted_tree(variables)
    check_tree(create_encoder(name, in_channels=channels,
                              image_size=image_size, **kw),
               variables, "the registry module")

    out_dir = out_dir or os.path.join(src_dir, CONVERTED_DIR)
    os.makedirs(out_dir, exist_ok=True)
    ckpt.save_variables(variables, ckpt.best_checkpoint_path(out_dir))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump({"arch": name, "image_size": image_size,
                   "num_classes": None, "input_channels": channels,
                   # the reference's inference always cuts full-line-height
                   # crops, so a working reference artifact implies line
                   # geometry
                   "crop_geometry": "line",
                   "imported_from": os.path.abspath(src_dir)}, f)

    idx_path = os.path.join(src_dir, "ref.index")
    txt_path = os.path.join(src_dir, "ref.txt")
    if os.path.exists(idx_path) and os.path.exists(txt_path):
        emb, metric = read_faiss_flat_index(idx_path)
        if metric == "l2":
            raise ValueError(
                f"{idx_path} is an L2 index; the reference builds "
                "IndexFlatIP over L2-normalized embeddings")
        chars = load_reference_ref_txt(txt_path)
        if len(chars) != emb.shape[0]:
            raise ValueError(
                f"ref.txt rows ({len(chars)}) != index rows "
                f"({emb.shape[0]})")
        PrototypeIndex(emb, chars).save(out_dir)
    return out_dir


def maybe_convert_reference_dir(recognizer_dir: str) -> str:
    """infer's auto-convert hook: a reference-format dir (no
    enc_best.msgpack; enc_best.pth or enc_best.onnx) is converted once
    into <dir>/tpu_converted, which is returned; any other dir is
    returned as it is."""
    from effocr_torch.train import checkpoint as ckpt

    if os.path.exists(ckpt.best_checkpoint_path(recognizer_dir)):
        return recognizer_dir
    if (os.path.exists(os.path.join(recognizer_dir, "enc_best.pth"))
            or os.path.exists(os.path.join(recognizer_dir,
                                           "enc_best.onnx"))):
        out = os.path.join(recognizer_dir, CONVERTED_DIR)
        if not os.path.exists(ckpt.best_checkpoint_path(out)):
            print(f"converting reference-format recognizer_dir "
                  f"{recognizer_dir} -> {out}")
            import_reference_recognizer_dir(recognizer_dir, out)
        return out
    return recognizer_dir
